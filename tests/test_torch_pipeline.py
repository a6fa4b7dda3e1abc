"""The port's data pipeline (``repro_torch.data``) against the JAX
package's: the same seed names the same corpus, the same embeddings and the
same batches, raw and curated. The draws are numpy's in both packages, so
the corpus, the embeddings and the raw batches are exact. A curated
window's selection is the reference's indices in its order, up to a tie:
at every round, with the reference's cache folded along the port's picks,
the reference's own fp32 gain of the port's pick must trail its best by at
most ``TIE`` relative (both sum in fp32 in their own orders; on topic data
two candidates' gains can meet within an ulp), and where the two packages
pick differently that window's batches are the port's picks.

On the CPU, ``EvalConfig(backend="cuda")`` runs ``gain_eval``'s plain
version: greedy's ``mincache`` rounds call it once each (``ops.CALLS``),
and the selection equals the ``torch`` backend's.
"""
import numpy as np
import pytest
import torch
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro.core import EvalConfig as RefEvalConfig
from repro.data import pipeline as RP
from repro.data.synthetic import TopicTokenStream as RefStream
from repro_torch.core import EvalConfig
from repro_torch.data import pipeline as TP
from repro_torch.data.synthetic import TopicTokenStream
from repro_torch.kernels import ops


@pytest.mark.parametrize("vocab,topics,seed", [(512, 8, 2), (2048, 12, 0),
                                               (50_304, 16, 7)])
def test_topic_stream_same_draws(vocab, topics, seed):
    a, b = RefStream(vocab, n_topics=topics, seed=seed), \
        TopicTokenStream(vocab, n_topics=topics, seed=seed)
    np.testing.assert_array_equal(a.probs, b.probs)
    for n, L, skew in ((5, 12, 1.0), (16, 31, 6.0)):
        (ta, pa), (tb, pb) = a.sample(n, L, skew), b.sample(n, L, skew)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(pa, pb)
        assert tb.dtype == np.int32 and tb.shape == (n, L + 1)


def test_hashed_embedding_matches_reference():
    toks = np.random.default_rng(0).integers(0, 300, size=(9, 17))
    for dim in (16, 64):
        np.testing.assert_array_equal(TP.hashed_embedding(toks, dim, 300),
                                      RP.hashed_embedding(toks, dim, 300))


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("skew", [1.0, 4.0])
def test_raw_batches_match_reference(skew):
    got = list(TP.token_batches(512, 2, 16, steps=5, seed=3, topic_skew=skew,
                                device="cpu"))
    want = list(RP.token_batches(512, 2, 16, steps=5, seed=3,
                                 topic_skew=skew))
    _same_batches(got, want)
    assert torch.equal(got[0]["labels"][:, :-1], got[0]["tokens"][:, 1:])


TIE = 1e-6


def _same_selection(got, want, pool, ccfg) -> bool:
    """True if identical. Either way, at every round the port's pick must
    be the reference's best up to a tie: the reference's cache folds the
    port's picks, and the reference's gain of the pick may trail its best
    among the candidates left by ``TIE`` relative."""
    from repro.core import ExemplarClustering as RefExemplar
    import jax.numpy as jnp

    f = RefExemplar(jnp.asarray(RP.hashed_embedding(
        pool, ccfg["embed_dim"], 256)))
    cache = f.init_cache()
    every = jnp.arange(len(pool))
    for t, j in enumerate(got):
        g = np.array(f.gains_from_cache(cache, every))
        g[np.asarray(got[:t], dtype=np.int64)] = -np.inf
        assert g.max() - g[j] <= TIE * abs(g.max()), (t, want, got, g)
        cache = f.fold_winner(cache, int(j))
    return list(got) == list(want)


@pytest.mark.parametrize("optimizer", ["greedy", "lazy_greedy"])
def test_curated_batches_match_reference(optimizer):
    ccfg = dict(window=32, select=8, optimizer=optimizer, embed_dim=64)
    got = list(TP.token_batches(256, 4, 16, steps=6, seed=5,
                                curation=TP.CurationConfig(**ccfg),
                                device="cpu"))
    want = list(RP.token_batches(256, 4, 16, steps=6, seed=5,
                                 curation=RP.CurationConfig(**ccfg)))
    stream = RefStream(256, seed=5)
    agree = 0
    for w in range(3):                      # 3 windows of 2 batches each
        pool, _ = stream.sample(32, 16, topic_skew=4.0)
        port = TP.Curator(TP.CurationConfig(**ccfg), 256,
                          device="cpu").select(pool[:, :16])
        ref = RP.Curator(RP.CurationConfig(**ccfg), 256).select(pool[:, :16])
        same = _same_selection(port, ref, pool[:, :16], ccfg)
        agree += same
        chosen = pool[port]
        for b in range(2):
            g = got[2 * w + b]
            rows = chosen[4 * b:4 * b + 4]
            np.testing.assert_array_equal(g["tokens"].numpy(), rows[:, :16])
            np.testing.assert_array_equal(g["labels"].numpy(), rows[:, 1:])
            if same:
                _same_batches([g], [want[2 * w + b]])
    assert agree >= 2


def test_curator_matches_reference_and_cuda_backend():
    """One window: the port's ``torch`` and ``cuda`` (plain version on the
    CPU) backends select the reference's indices in its order, with its
    value; the ``cuda`` route calls ``gain_eval`` once per round."""
    stream = TopicTokenStream(512, n_topics=8, seed=2)
    pool, topics = stream.sample(128, 32, topic_skew=6.0)
    ref = RP.Curator(RP.CurationConfig(window=128, select=16), vocab=512)
    want = ref.select(pool)
    for backend in ("torch", "cuda"):
        cur = TP.Curator(TP.CurationConfig(window=128, select=16), vocab=512,
                         eval_cfg=EvalConfig(backend=backend), device="cpu")
        before = ops.CALLS["gain_eval"]
        got = cur.select(pool)
        calls = ops.CALLS["gain_eval"] - before
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert abs(cur.last_value - ref.last_value) <= 1e-6 * ref.last_value
        assert calls == (16 if backend == "cuda" else 0)
    assert len(set(topics[want])) >= len(set(topics[:16]))


def test_eval_cfg_reaches_the_curator():
    """``token_batches(eval_cfg=...)``: the one keyword the reference's
    lacks; the kernel route runs a window's k rounds through ``gain_eval``
    and yields the ``torch`` backend's batches."""
    ccfg = TP.CurationConfig(window=32, select=8)
    before = ops.CALLS["gain_eval"]
    got = list(TP.token_batches(256, 4, 16, steps=6, seed=5, curation=ccfg,
                                eval_cfg=EvalConfig(backend="cuda"),
                                device="cpu"))
    assert ops.CALLS["gain_eval"] - before == 3 * 8     # 3 windows, k = 8
    want = list(TP.token_batches(256, 4, 16, steps=6, seed=5, curation=ccfg,
                                 device="cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert torch.equal(g["tokens"], w["tokens"])
        assert torch.equal(g["labels"], w["labels"])
    assert RefEvalConfig().backend == "jnp" and EvalConfig().backend == "torch"


def test_unknown_optimizer_rejected():
    with pytest.raises(ValueError, match="optimizer"):
        TP.Curator(TP.CurationConfig(optimizer="nope"), 64, device="cpu")
