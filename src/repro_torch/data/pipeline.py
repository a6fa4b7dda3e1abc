"""Data pipeline: deterministic batching + submodular coreset curation.

The curation hook is the paper's technique as a first-class training feature:
a sliding window of candidate examples is embedded, an exemplar coreset is
selected by submodular maximization (the multiset evaluation engine does the
heavy lifting), and only the exemplars are emitted as training batches.

The port of the JAX package's ``data/pipeline.py``: the same draws from the
same :class:`~repro_torch.data.synthetic.TopicTokenStream`, so a seed names
the same batches in both packages. The selection runs on the device through
the port's ``ExemplarClustering`` and ``OPTIMIZERS``; with
``EvalConfig(backend="cuda")`` greedy's default ``mincache`` rounds launch
the ``gain_eval`` kernel. :func:`token_batches` takes that ``eval_cfg`` (the
one keyword the reference's lacks: there, the kernel route needs a
``Curator`` built by hand) and yields int32 tensors on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import ExemplarClustering
from repro_torch.core.multiset import resolve_device
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.data.synthetic import TopicTokenStream


def hashed_embedding(tokens: np.ndarray, dim: int = 64,
                     vocab: int = 50_304, seed: int = 7) -> np.ndarray:
    """Deterministic bag-of-tokens random-projection embedding (n, dim).

    Cheap enough to run in the input pipeline; the trainer can swap in model
    activations via `Curator(embed_fn=...)`.
    """
    rng = np.random.default_rng(seed)
    proj = rng.normal(0, 1 / np.sqrt(dim), size=(vocab, dim)).astype(np.float32)
    counts = np.zeros((tokens.shape[0], vocab), np.float32)
    for i, row in enumerate(tokens):
        u, c = np.unique(row, return_counts=True)
        counts[i, u] = c
    counts /= np.maximum(counts.sum(1, keepdims=True), 1)
    return counts @ proj


@dataclasses.dataclass
class CurationConfig:
    window: int = 256          # candidate pool size
    select: int = 64           # exemplars kept per window
    optimizer: str = "greedy"  # any of repro_torch.core.OPTIMIZERS
    embed_dim: int = 64
    enabled: bool = True


class Curator:
    """Window → embed → submodular select → curated examples. The
    selection's function lives on ``device`` (``"cuda"`` unless named)."""

    def __init__(self, ccfg: CurationConfig, vocab: int,
                 eval_cfg: EvalConfig = EvalConfig(), embed_fn=None,
                 device=None):
        if ccfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {ccfg.optimizer!r}; "
                             f"options {sorted(OPTIMIZERS)}")
        self.ccfg = ccfg
        self.vocab = vocab
        self.eval_cfg = eval_cfg
        self.device = resolve_device(device)
        self.embed_fn = embed_fn or (
            lambda toks: hashed_embedding(toks, ccfg.embed_dim, vocab))
        self.last_value: float = 0.0

    def select(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (W, L) → indices of the selected coreset (k,)."""
        emb = self.embed_fn(tokens)
        f = ExemplarClustering(emb, self.eval_cfg, device=self.device)
        res = OPTIMIZERS[self.ccfg.optimizer](f, self.ccfg.select)
        self.last_value = res.value
        return np.asarray(res.indices, dtype=np.int64)


def token_batches(
    vocab: int,
    batch_size: int,
    seq_len: int,
    steps: int,
    seed: int = 0,
    curation: Optional[CurationConfig] = None,
    topic_skew: float = 4.0,
    stream: Optional[TopicTokenStream] = None,
    eval_cfg: EvalConfig = EvalConfig(),
    device=None,
) -> Iterator[dict]:
    """Yields {tokens, labels} batches (B, seq_len) int32 on ``device``
    (``"cuda"`` unless named); curated if a CurationConfig is given, the
    selection evaluated under ``eval_cfg`` on the same device."""
    dev = resolve_device(device)
    stream = stream or TopicTokenStream(vocab, seed=seed)
    curator = (Curator(curation, vocab, eval_cfg, device=dev)
               if curation and curation.enabled else None)
    emitted = 0
    while emitted < steps:
        if curator is None:
            toks, _ = stream.sample(batch_size, seq_len,
                                    topic_skew=topic_skew)
            chosen = toks
        else:
            pool, _ = stream.sample(curation.window, seq_len,
                                    topic_skew=topic_skew)
            idx = curator.select(pool[:, :seq_len])
            chosen = pool[idx]
        for s in range(0, len(chosen) - batch_size + 1, batch_size):
            if emitted >= steps:
                return
            b = chosen[s:s + batch_size]
            yield {
                "tokens": torch.as_tensor(b[:, :seq_len], device=dev),
                "labels": torch.as_tensor(b[:, 1:seq_len + 1], device=dev),
            }
            emitted += 1
