"""Synthetic data: clustered vectors (the paper's workload) + token corpora.

The paper evaluates on randomly generated problems (§V). ``blobs`` gives the
clustered version (so selection quality is measurable); ``uniform_problem``
matches the paper's setting. The token corpus is a topic-mixture Markov
stream so submodular curation has real signal: windows drawn from few topics
are redundant, and exemplar selection prefers topic-diverse subsets. All
three draw from ``np.random.default_rng(seed)`` exactly as the JAX package's
generators do (the same draws in the same order), so a seed names the same
data in both packages.
"""
from __future__ import annotations

import numpy as np


def uniform_problem(n: int, dim: int, seed: int = 0,
                    low: float = 0.0, high: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=(n, dim)).astype(np.float32)


def blobs(n: int, dim: int, centers: int = 8, spread: float = 0.15,
          seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1, 1, size=(centers, dim)).astype(np.float32)
    labels = rng.integers(0, centers, size=n)
    X = mu[labels] + rng.normal(0, spread, size=(n, dim)).astype(np.float32)
    return X.astype(np.float32), labels


class TopicTokenStream:
    """Markov token stream with latent topics (for curation experiments)."""

    def __init__(self, vocab_size: int, n_topics: int = 16, seed: int = 0,
                 topic_sharpness: float = 40.0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.n_topics = n_topics
        # each topic concentrates probability on a subset of the vocabulary
        logits = rng.normal(0, 1, size=(n_topics, vocab_size))
        boost = rng.random((n_topics, vocab_size)) < (64.0 / vocab_size)
        logits = logits + topic_sharpness * boost
        self.probs = np.exp(logits - logits.max(1, keepdims=True))
        self.probs /= self.probs.sum(1, keepdims=True)
        self.rng = rng

    def sample(self, n_seqs: int, seq_len: int,
               topic_skew: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (n, seq_len+1), topics (n,)). Skew >1 → redundant."""
        alpha = np.ones(self.n_topics) / topic_skew
        weights = self.rng.dirichlet(alpha)
        topics = self.rng.choice(self.n_topics, size=n_seqs, p=weights)
        toks = np.stack([
            self.rng.choice(self.vocab, size=seq_len + 1, p=self.probs[t])
            for t in topics
        ])
        return toks.astype(np.int32), topics
