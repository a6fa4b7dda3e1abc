"""``examples/streaming_summarization_torch.py`` against the reference's
API, on the CPU.

The twin's ``run(device="cpu")`` goes through every step of
``examples/streaming_summarization.py`` on the port (the ``cuda``
backend: the sieve kernel's plain version on CPU tensors); the same steps
run through the JAX package's API. Members (stream ids for the ingestion
service) and evaluation counts must be identical, values within 1e-5 of
max(1, |reference|), the service's ingested and accepted counts equal.
``chip_smoke.py`` holds the twin's run on the card to constants of the
reference's figures (``STREAMING_FIGURES``); they must equal the figures
computed here afresh. (A file of its own: with the quickstart's, the two
twins and the reference's steps take over a minute on one worker.)
"""
import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import streaming_summarization_torch as twin_mod  # noqa: E402

FP32_TOL = 1e-5
#: The stored constants against the figures computed afresh.
CONSTANT_REL = 1e-6
STEPS = ("offline",) + tuple(name for name, _, _ in twin_mod.STREAMERS) + (
    "service",)


def reference_streaming() -> dict:
    """The example's steps through the JAX package's API, in the twin's
    format (without the seconds)."""
    import jax.numpy as jnp

    from repro.core import ExemplarClustering, StreamIngestionService, greedy
    from repro.core import optimizers as jopt
    from repro.data.synthetic import blobs

    K, BLOCK = twin_mod.K, twin_mod.BLOCK
    X, _ = blobs(n=4000, dim=64, centers=12, seed=1)
    f = ExemplarClustering(jnp.asarray(X))

    def figures(res):
        return {"indices": [int(i) for i in res.indices],
                "value": float(res.value),
                "evaluations": int(res.evaluations)}

    out = {"offline": figures(greedy(f, K))}
    for name, alg, kw in twin_mod.STREAMERS:
        out[name] = figures(getattr(jopt, alg.__name__)(
            f, K, block_size=BLOCK, **kw))

    async def serve():
        order = np.random.default_rng(0).permutation(f.n)
        async with StreamIngestionService(f, k=K, mode="device",
                                          block_size=BLOCK) as svc:
            await svc.offer_batch(X[order])
            await svc.drain()
            return await svc.snapshot()

    snap = asyncio.run(serve())
    out["service"] = {"indices": [int(i) for i in snap.indices],
                      "value": float(snap.value),
                      "evaluations": int(snap.evaluations),
                      "n_ingested": int(snap.n_ingested),
                      "n_accepted": int(snap.n_accepted)}
    return out


@pytest.fixture(scope="module")
def twin():
    return twin_mod.run("cpu")


@pytest.fixture(scope="module")
def reference():
    return reference_streaming()


@pytest.mark.parametrize("step", STEPS)
def test_streaming_step_matches_reference(twin, reference, step):
    got, want = twin[step], reference[step]
    assert got["indices"] == want["indices"]
    assert got["evaluations"] == want["evaluations"]
    assert abs(got["value"] - want["value"]) <= FP32_TOL * max(
        1.0, abs(want["value"]))
    if step == "service":
        assert got["n_ingested"] == want["n_ingested"] == 4000
        assert got["n_accepted"] == want["n_accepted"]


def test_chip_smoke_constants_are_the_reference_figures(reference):
    """``chip_smoke.py``'s ``STREAMING_FIGURES`` equal the reference's
    figures computed afresh: members, evaluations and counts exactly,
    values within ``CONSTANT_REL``."""
    stored = chip_smoke.STREAMING_FIGURES
    assert sorted(stored) == sorted(reference)
    for step in STEPS:
        got, want = dict(stored[step]), dict(reference[step])
        value, want_value = got.pop("value"), want.pop("value")
        assert got == want, step
        assert abs(value - want_value) <= CONSTANT_REL * max(
            1.0, abs(want_value)), step


def test_twin_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin_mod.run("cuda")
