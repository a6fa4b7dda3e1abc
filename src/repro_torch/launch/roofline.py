"""Roofline terms of one device's step, from the dry run's counts.

Hardware model: the NVIDIA H100 data sheets (:data:`PEAKS`), by default
the H100 SXM — 989e12 dense bf16 FLOP/s on the tensor cores and 3.35e12
B/s of HBM3 per card. The collectives cross the network at
:data:`NET_BW`, 50e9 B/s per card: one 400 Gb/s NIC per GPU. A production
mesh of 256 cards spans 32 nodes of 8, so every mesh axis of 16 crosses
nodes; NVLink's 900 GB/s per card applies only inside a node, which no
axis of the production meshes stays in (a second bandwidth for the
intra-node part of an axis is an open point).

The counts are per device (the dry run runs rank 0's step), so the three
terms are per device:

  compute_s    = device_flops / peak FLOP/s
  memory_s     = device_bytes / HBM B/s
  collective_s = device_collective_bytes / NET_BW

``device_bytes`` is the unfused eager step's traffic (every op's
operands and results), so ``memory_s`` measures the code, not the
function: a fusion moves it. A train cell also gets the function's own
memory floor (:func:`floor_terms`), a fixed yardstick no fusion moves.

Collective bytes are the summed **result** sizes of the step's
collectives, as the reference sums the result types of the optimized
HLO's all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute: here from the census's c10d records
(:mod:`repro_torch.analysis.census`), each op mapped to one of those five
kinds by :data:`C10D_KINDS`. An op outside that table raises; none is
dropped.
"""
from __future__ import annotations

#: Dense peaks per card (NVIDIA data sheets): fp32 outside the tensor
#: cores, bf16/fp16 on the tensor cores, device memory bandwidth.
PEAKS = {
    "H100 SXM": {"fp32": 67e12, "half": 989e12, "bw": 3.35e12},
    "H100 NVL": {"fp32": 60e12, "half": 835e12, "bw": 3.9e12},
    "H100 PCIe": {"fp32": 51e12, "half": 756e12, "bw": 2.0e12},
}
DEFAULT = "H100 SXM"
#: B/s per card across nodes: one 400 Gb/s NIC per GPU
NET_BW = 50e9

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")

#: c10d op → the reference's collective kind. The census records each
#: op's result bytes (its output operand), so an all-gather counts p × its
#: input and a reduce-scatter input / p, as the HLO's result types do.
#: The port's steps make no point-to-point op, so ``collective-permute``
#: stays 0 (a ``send`` / ``recv_`` would raise until it has a row).
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def collective_bytes(records) -> dict:
    """Per-kind result-byte totals and counts from ``(c10d op, result
    bytes)`` records (``Census.collective_results``)."""
    out = {op: 0 for op in _COLL_OPS}
    counts = {op: 0 for op in _COLL_OPS}
    for name, nbytes in records:
        kind = C10D_KINDS.get(name)
        if kind is None:
            raise ValueError(f"c10d op {name!r} has no collective kind in "
                             f"the roofline's table")
        out[kind] += int(nbytes)
        counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def roofline_terms(cost: dict, coll_total_bytes: int,
                   peaks: dict = PEAKS[DEFAULT]) -> dict:
    """The three terms and the bottleneck of one device's step. ``peaks``:
    a :data:`PEAKS` row (its ``half`` FLOP/s: the LM steps' products run
    in bf16)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / peaks["half"]
    memory_s = bytes_acc / peaks["bw"]
    collective_s = coll_total_bytes / NET_BW
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", collective_s)), key=lambda kv: kv[1])
    return {
        "device_flops": flops,
        "device_bytes": bytes_acc,
        "device_collective_bytes": float(coll_total_bytes),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": dom[0],
        "bound_s": dom[1],
    }


def floor_terms(terms: dict, floor_bytes: int,
                peaks: dict = PEAKS[DEFAULT]) -> dict:
    """The function-level bound beside :func:`roofline_terms`' eager one:
    ``memory_floor_s`` = the step's memory floor (bytes it must move
    whatever the code fuses) over HBM B/s, and ``floor_bound_s`` the
    largest of it, ``compute_s`` and ``collective_s``."""
    floor_s = floor_bytes / peaks["bw"]
    return {"memory_floor_bytes": int(floor_bytes),
            "memory_floor_s": floor_s,
            "floor_bound_s": max(terms["compute_s"], floor_s,
                                 terms["collective_s"])}


def model_flops(n_params: int, tokens: int, kind: str) -> float:
    """6·N·D for training; 2·N·D forward-only for prefill/decode."""
    if kind == "train":
        return 6.0 * n_params * tokens
    return 2.0 * n_params * tokens
