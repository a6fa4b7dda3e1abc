"""Quickstart on the PyTorch port: exemplar-based clustering via submodular
maximization.

The twin of ``examples/quickstart.py``: the same steps, sizes, seeds and
printed lines, plus ``--device`` (``cuda`` unless named; there is no
fallback to the CPU). Every function evaluates on the ``cuda`` backend: the
hand-written kernels on a CUDA device, their plain versions on CPU tensors.
The last step, the mesh-sharded plan, runs on a one-rank process group
(NCCL on the card, gloo on the CPU) over a ``FileStore`` in a temporary
directory, destroyed afterwards.

:func:`run` returns the figures the script prints (indices, values,
evaluations, cluster sizes, purity), so that tests and ``chip_smoke.py``
can hold them against the reference.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (EvalConfig, ExemplarClustering,
                              fit_exemplar_clustering, greedy, lazy_greedy)
from repro_torch.core.optimizers import OPTIMIZERS
from repro_torch.data.synthetic import blobs

K = 8
OPTIMIZER_NAMES = ("greedy", "lazy_greedy", "stochastic_greedy",
                   "sieve_streaming", "sieve_streaming_pp", "three_sieves",
                   "salsa")
POLICY_NAMES = ("fp32", "bf16", "fp16")


def card_or_cpu(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the example on the CPU")
    return dev


def figures(res) -> dict:
    return {"indices": [int(i) for i in res.indices],
            "value": float(res.value), "evaluations": int(res.evaluations)}


@contextlib.contextmanager
def one_rank_mesh(dev: torch.device):
    """A 1-D ``DeviceMesh`` named ``data`` over a one-rank process group
    (NCCL for a CUDA device, gloo otherwise), torn down on exit."""
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "quickstart starts its own one-rank group")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            yield DeviceMesh(dev.type, [0], mesh_dim_names=("data",))
        finally:
            dist.destroy_process_group()


def run(device="cuda") -> dict:
    """Every step of the quickstart on ``device``; returns its figures."""
    dev = card_or_cpu(device)
    cfg = EvalConfig(backend="cuda")
    X, true_labels = blobs(n=2000, dim=32, centers=8, seed=0)
    out = {"shape": list(X.shape), "true_clusters": len(set(true_labels))}

    model = fit_exemplar_clustering(X, k=K, optimizer="greedy", cfg=cfg,
                                    device=dev)
    labels = model.assign(X)
    purity = sum(np.bincount(true_labels[labels == c]).max()
                 for c in range(K)) / len(X)
    out["fit"] = dict(figures(model.result),
                      cluster_sizes=np.bincount(labels).tolist(),
                      purity=float(purity))

    # all optimizers, same engine
    f = ExemplarClustering(X, cfg, device=dev)
    out["optimizers"] = {name: figures(OPTIMIZERS[name](f, K))
                         for name in OPTIMIZER_NAMES}

    # low-precision evaluation (paper §V-B)
    out["precision"] = {}
    for pol in POLICY_NAMES:
        m = fit_exemplar_clustering(
            X, k=K, cfg=EvalConfig(policy=pol, backend="cuda"), device=dev)
        out["precision"][pol] = figures(m.result)

    # the selection engine: all k rounds on the device, dense and CELF
    out["greedy_host"] = figures(greedy(f, K, mode="host"))
    out["greedy_device"] = figures(greedy(f, K, mode="device"))
    out["lazy_host"] = figures(lazy_greedy(f, K, mode="host"))
    out["lazy_device"] = figures(lazy_greedy(f, K, mode="device"))

    # the mesh-sharded plan: V and the min-cache row-sharded over the mesh
    with one_rank_mesh(dev) as mesh:
        out["sharded"] = dict(figures(greedy(f, K, mode="device_sharded",
                                             mesh=mesh)),
                              devices=mesh.size())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without one)")
    r = run(ap.parse_args().device)
    print(f"data: {tuple(r['shape'])}, {r['true_clusters']} true clusters")
    print(f"greedy: f(S) = {r['fit']['value']:.4f}, "
          f"cluster sizes = {r['fit']['cluster_sizes']}")
    print(f"cluster purity vs ground truth: {r['fit']['purity']:.2%}")
    base = None
    for name, res in r["optimizers"].items():
        base = base or res["value"]
        print(f"{name:20s} f = {res['value']:.4f} "
              f"({res['value'] / base:6.1%} of greedy)  evaluations = "
              f"{res['evaluations']}")
    for pol, res in r["precision"].items():
        print(f"precision {pol:6s}: f(S) = {res['value']:.5f}")
    dev, host = r["greedy_device"], r["greedy_host"]
    print(f"device greedy matches host: {host['indices'] == dev['indices']} "
          f"(f = {dev['value']:.4f})")
    ldev, lhost = r["lazy_device"], r["lazy_host"]
    print(f"device CELF matches host CELF: "
          f"{lhost['indices'] == ldev['indices']} (evaluations: "
          f"{ldev['evaluations']} vs greedy's {dev['evaluations']})")
    sh = r["sharded"]
    print(f"sharded greedy over {sh['devices']} device(s) matches: "
          f"{sh['indices'] == dev['indices']}")


if __name__ == "__main__":
    main()
