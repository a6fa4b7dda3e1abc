"""Streaming data summarization with sieve optimizers on the PyTorch port
(paper §II use case).

The twin of ``examples/streaming_summarization.py``: the same steps, sizes,
seeds and printed lines, plus ``--device`` (``cuda`` unless named; there is
no fallback to the CPU). Every arriving element is offered to all sieves at
once on the ``cuda`` backend: the sieve kernel on a CUDA device, its plain
version on CPU tensors. With ``mode="device"`` each stream block of
``block_size`` elements runs on the device with no host read between its
elements; the ingestion service wraps the same engine behind an async queue
(backpressure and mid-stream snapshots).

:func:`run` returns the figures the script prints (indices, values,
evaluations, the service's ingested and accepted counts), so that tests and
``chip_smoke.py`` can hold them against the reference.

Run: PYTHONPATH=src python examples/streaming_summarization_torch.py
     [--device cpu]
"""
import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.core import (EvalConfig, ExemplarClustering,
                              StreamIngestionService, greedy)
from repro_torch.core.optimizers import (salsa, sieve_streaming,
                                         sieve_streaming_pp, three_sieves)
from repro_torch.data.synthetic import blobs

K = 12
BLOCK = 128
STREAMERS = (
    ("sieve_streaming", sieve_streaming, dict(eps=0.1, mode="device")),
    ("sieve_streaming++", sieve_streaming_pp, dict(eps=0.1, mode="device")),
    ("salsa", salsa, dict(eps=0.1, mode="device")),
    ("three_sieves(T=100)", three_sieves, dict(eps=0.1, T=100)),
)


def card_or_cpu(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the example on the CPU")
    return dev


def _timed(dev, fn):
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return res, time.perf_counter() - t0


def figures(res, seconds) -> dict:
    return {"indices": [int(i) for i in res.indices],
            "value": float(res.value), "evaluations": int(res.evaluations),
            "seconds": seconds}


def run(device="cuda") -> dict:
    """Every step of the example on ``device``; returns its figures."""
    dev = card_or_cpu(device)
    X, _ = blobs(n=4000, dim=64, centers=12, seed=1)
    f = ExemplarClustering(X, EvalConfig(backend="cuda"), device=dev)
    out = {"offline": figures(*_timed(dev, lambda: greedy(f, K)))}
    for name, alg, kw in STREAMERS:
        out[name] = figures(*_timed(
            dev, lambda: alg(f, K, block_size=BLOCK, **kw)))

    # the same engine as a service: queue in, exemplars out
    async def serve():
        order = np.random.default_rng(0).permutation(f.n)
        async with StreamIngestionService(f, k=K, mode="device",
                                          block_size=BLOCK) as svc:
            await svc.offer_batch(X[order])
            await svc.drain()
            return await svc.snapshot()

    snap, seconds = _timed(dev, lambda: asyncio.run(serve()))
    out["service"] = {"indices": [int(i) for i in snap.indices],
                      "value": float(snap.value),
                      "evaluations": int(snap.evaluations),
                      "n_ingested": int(snap.n_ingested),
                      "n_accepted": int(snap.n_accepted), "seconds": seconds}
    out["n"] = f.n
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without one)")
    r = run(ap.parse_args().device)
    off = r["offline"]
    print(f"offline greedy      f = {off['value']:.4f}  "
          f"({off['seconds']:.1f}s, {off['evaluations']} evals)")
    for name, _, _ in STREAMERS:
        res = r[name]
        # device modes: one engine dispatch per stream block (upper bound:
        # three_sieves runs on the host and may stop early)
        dispatches = -(-r["n"] // BLOCK)
        print(f"{name:20s}f = {res['value']:.4f}  ({res['seconds']:.1f}s, "
              f"{res['evaluations']} evals, <={dispatches} engine "
              f"dispatches, {res['value'] / off['value']:.1%} of greedy)")
    svc = r["service"]
    print(f"{'ingestion service':20s}f = {svc['value']:.4f}  "
          f"({svc['n_ingested']} ingested, {svc['n_accepted']} accepted, "
          f"{svc['value'] / off['value']:.1%} of greedy)")


if __name__ == "__main__":
    main()
