"""Inputs of every cell, drawn on the device from the run's seed.

Each draw takes its own generator, seeded from the run's seed and the draw's
place in the run (the ground set, call i, selection i), so any draw can be
made again after the window from the seed alone: the reference does so.
In the window, the next call's inputs are drawn on a stream of their own
while the program's call runs (``Ahead``), so the draw is not timed as the
program's work.
"""
from __future__ import annotations

import numpy as np
import torch


def seed_of(seed: int, *path: int) -> int:
    """A 64-bit seed for the draw at ``path`` in a run of ``seed``. Any whole
    number is a seed (it is taken modulo 2**64)."""
    ss = np.random.SeedSequence([seed % 2**64, *path])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(device, seed: int, *path: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, *path))
    return g


def blobs(n: int, d: int, centers: int, spread: float,
          gen: torch.Generator) -> torch.Tensor:
    """(n, d) float32 points around ``centers`` means drawn uniformly from
    [-1, 1]^d, each with Gaussian noise of standard deviation ``spread``:
    the clustered ground set of the paper's synthetic problems."""
    dev = gen.device
    mu = torch.rand((centers, d), generator=gen, device=dev) * 2.0 - 1.0
    labels = torch.randint(0, centers, (n,), generator=gen, device=dev)
    noise = torch.randn((n, d), generator=gen, device=dev)
    return torch.addcmul(mu[labels], noise, torch.tensor(spread, device=dev))


def ground_set(config: dict, gen: torch.Generator) -> torch.Tensor:
    data = config["data"]
    if data["kind"] != "blobs":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    return blobs(config["n"], config["d"], data["centers"], data["spread"],
                 gen)


def k_subsets(n: int, l: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """(l, k) int64 indices into [0, n), distinct within each row: k sorted
    draws from [0, n - k] plus 0, 1, ..., k - 1."""
    x = torch.randint(0, n - k + 1, (l, k), generator=gen, device=gen.device)
    x, _ = torch.sort(x, dim=1)
    return x + torch.arange(k, device=gen.device)


class Ahead:
    """Draws made on a stream of their own, beside the program's calls on
    the current stream (on the CPU, in line). ``put`` starts a draw;
    ``take`` hands its tensor to the current stream, which waits for it."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream() if device == "cuda" else None

    def put(self, draw, *args):
        if self.stream is None:
            return draw(*args), None
        with torch.cuda.stream(self.stream):
            x = draw(*args)
            done = torch.cuda.Event()
            done.record(self.stream)
        return x, done

    def take(self, drawn) -> torch.Tensor:
        x, done = drawn
        if done is not None:
            current = torch.cuda.current_stream()
            current.wait_event(done)
            # its memory is not reused until the current stream is done
            x.record_stream(current)
        return x
