"""The op census behind the contract audit: one concrete run of an entry
point under a ``TorchDispatchMode`` that records every op.

The reference walks the jaxpr and the lowered StableHLO of a compiled
program. A torch loop has no such artifact: its rounds are Python, and
what they cost is what they dispatch. So the census runs the real code,
once, on real (small) inputs, and records per op:

* its name, and for every tensor it returns that shares no storage with
  its inputs, an allocation (count and bytes);
* **host syncs**: ``_local_scalar_dense`` (behind ``bool(t)``,
  ``.item()``, ``int(t)``, ``float(t)``), ``nonzero``, a boolean-mask
  ``index`` / ``index_put``, ``masked_select``, ``unique``, and a copy to
  the CPU of a CUDA tensor; plus, through a spy, ``Tensor.tolist``,
  ``Tensor.numpy`` and ``Tensor.cpu`` of a CPU tensor, which the
  dispatcher never sees. Each sync is attributed to the innermost line of
  ``src/repro_torch`` that issued it;
* **host staging**: a host value copied to the device (``lift_fresh``
  behind ``torch.tensor``, a copy from the CPU to a CUDA tensor): a
  blocking copy on the card, which ``torch.cuda.set_sync_debug_mode``
  reports as a sync;
* **collectives**: every ``c10d`` op (``allgather_``, ``allreduce_``, …)
  with the bytes of its input operand;
* **precision**: a half-precision tensor widened to fp32, with its size,
  and the matmuls that consume half operands.

The port's kernels are called through ctypes, which the dispatcher cannot
see. Every kernel wrapper counts ``kernels._build.CALLS``, and for the
length of the run the census wraps each wrapper on its module
(``kernels.marginal_gain``, ``kernels.exemplar_eval``, where
``kernels.ops`` looks them up) to read its operands, so the census also
records calls and launches per kernel and the cache buffers the gain and
sieve kernels read and write. Ops issued inside a wrapper
(its plain version on the CPU, its workspace on the card) belong to the
kernel: like the reference's exemption of converts inside a
``pallas_call`` body, they are left out of the syncs, allocations and
widens, and only their half matmuls count.

The census holds a reference to every cache buffer it sees, so a buffer
freed and handed back by the caching allocator at the same address cannot
pass for one reused in place.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import types
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

PKG_DIR = Path(__file__).resolve().parents[1]          # src/repro_torch
_ANALYSIS_DIR = Path(__file__).resolve().parent

#: ops that make the host wait for the device (on any device: the census
#: counts what the card would wait for)
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive"})
#: ops that index with a tensor list, which sync on a boolean mask
_MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                             "_index_put_impl_"})
#: a host value copied onto the device: a blocking copy on the card
STAGING_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
_HALF = (torch.float16, torch.bfloat16)
_MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "addbmm",
                      "linear", "_scaled_mm"})
#: kernels whose third operand is the cache they score against, and the
#: fused ones that also write a new cache (``cache_out``)
_GAIN_KERNELS = frozenset({"gain_eval", "gain_update_eval",
                           "gain_eval_batched", "gain_update_eval_batched"})
FUSED_KERNELS = frozenset({"gain_update_eval", "gain_update_eval_batched"})
#: kernels whose first operand is the sieve table they score
_TABLE_KERNELS = frozenset({"sieve_gain_eval", "sieve_gain_eval_batched"})
#: collectives whose input operand is their second argument (the first is
#: the output list)
_GATHER_LIKE = frozenset({"allgather_", "allgather_coalesced_",
                          "_allgather_base_", "reduce_scatter_",
                          "_reduce_scatter_base_", "allgather_into_tensor_coalesced_"})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return -1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: Functions that widen a half payload to fp32 one row block of at most
#: ``distances.WIDEN_BLOCK_ROWS`` rows at a time, by design: float32
#: accumulation of half products with no payload-sized fp32 copy once n
#: passes the block (their widens are counted as ``blocked_widens``).
BLOCKED_WIDEN = frozenset({("core/distances.py", "_dot"),
                           ("core/distances.py", "sq_norms")})
#: Functions that copy a tensor only when the allocator handed it out off
#: a 128-byte boundary (the batched sieve reduces each partition from an
#: aligned base): their copies follow the allocator, not the rounds — the
#: card's allocator aligns every block to 512 bytes, the CPU's to 64 — so
#: they are counted apart (``align_copies``).
ALIGN_COPY = frozenset({("core/streaming.py", "_aligned")})


def _site_frame():
    """(relative path, line, function) of the innermost frame of the
    package outside this analysis package, or None."""
    f = sys._getframe(1)
    while f is not None:
        p = Path(f.f_code.co_filename).resolve()
        if p.is_relative_to(PKG_DIR) and not p.is_relative_to(_ANALYSIS_DIR):
            return (p.relative_to(PKG_DIR).as_posix(), f.f_lineno,
                    f.f_code.co_name)
        f = f.f_back
    return None


def sync_site() -> str:
    """``path:line`` (relative to ``src/repro_torch``) of the innermost
    frame of the package that is not this analysis package, or "?"."""
    fr = _site_frame()
    return "?" if fr is None else f"{fr[0]}:{fr[1]}"


_ALLOWED: Optional[frozenset] = None


def allowed_sync_sites() -> frozenset:
    """Every ``path:line`` of the package marked
    ``# lint: allow(host-sync)`` — the only lines a round may sync on."""
    global _ALLOWED
    if _ALLOWED is None:
        from repro_torch.analysis.lint import allowed_lines

        _ALLOWED = frozenset(
            f"{p.relative_to(PKG_DIR).as_posix()}:{ln}"
            for p in sorted(PKG_DIR.rglob("*.py"))
            for ln in allowed_lines(p.read_text(), "host-sync"))
    return _ALLOWED


@dataclasses.dataclass
class Census:
    """What one run dispatched. :meth:`summary` flattens it to numbers;
    two summaries subtract (:func:`delta`)."""

    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    #: (op, site) of every host sync outside the kernels
    syncs: list = dataclasses.field(default_factory=list)
    #: sites of every host value staged onto the device
    staging: list = dataclasses.field(default_factory=list)
    collectives: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    collective_bytes: list = dataclasses.field(default_factory=list)
    allocs: int = 0
    alloc_bytes: int = 0
    #: (dtype, shape, elems) of every half → fp32 widen outside the kernels
    widens: list = dataclasses.field(default_factory=list)
    blocked_widens: int = 0
    align_copies: int = 0
    half_matmuls: int = 0
    half_kernel_calls: int = 0
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    #: storage → tensor of every cache buffer a kernel read or wrote
    cache_buffers: dict = dataclasses.field(default_factory=dict)
    #: fused kernel calls that were handed no output buffer (so allocated
    #: their new cache)
    fresh_cache_outs: int = 0
    #: kernel libraries loaded (built or read from disk) during the run
    rebuilds: int = 0

    @property
    def max_collective_bytes(self) -> int:
        return max(self.collective_bytes, default=0)

    def summary(self) -> dict:
        return {
            "syncs": len(self.syncs),
            "allowed_syncs": sum(1 for _, s in self.syncs
                                 if s in allowed_sync_sites()),
            "staging": len(self.staging),
            "launches": dict(self.launches),
            "calls": dict(self.calls),
            "collectives": dict(self.collectives),
            "collective_total": sum(self.collectives.values()),
            "max_collective_bytes": self.max_collective_bytes,
            "allocs": self.allocs,
            "alloc_bytes": self.alloc_bytes,
            "cache_buffers": len(self.cache_buffers),
            "fresh_cache_outs": self.fresh_cache_outs,
            "widens": len(self.widens),
            "blocked_widens": self.blocked_widens,
            "align_copies": self.align_copies,
            "half_matmuls": self.half_matmuls,
            "half_kernel_calls": self.half_kernel_calls,
            "iterations": self.ops.get("sort", 0),
            "rebuilds": self.rebuilds,
            "ops": dict(self.ops),
        }


def delta(a: dict, b: dict) -> dict:
    """``b − a`` of two :meth:`Census.summary` dicts, key by key (dicts
    by their union of keys, zeros dropped; the byte maximum is b's)."""
    out = {}
    for k, vb in b.items():
        va = a.get(k)
        if isinstance(vb, dict):
            va = va or {}
            d = {kk: vb.get(kk, 0) - va.get(kk, 0)
                 for kk in set(vb) | set(va)}
            out[k] = {kk: v for kk, v in sorted(d.items()) if v}
        elif k == "max_collective_bytes":
            out[k] = vb
        else:
            out[k] = vb - (va or 0)
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.c = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        c = self.c
        name = func._opname
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        if func.namespace == "c10d":
            c.collectives[name] += 1
            operand = args[1] if name in _GATHER_LIKE else args[0]
            c.collective_bytes.append(sum(_nbytes(t)
                                          for t in _tensors(operand)))
            return
        if name in _MATMULS and any(t.dtype in _HALF for t in ins):
            c.half_matmuls += 1
        if _in_kernel():
            return
        if name == "clone":
            fr = _site_frame()
            if fr is not None and fr[::2] in ALIGN_COPY:
                c.align_copies += 1
                return
        c.ops[name] += 1
        if name in SYNC_OPS or self._mask_index(name, args) \
                or self._to_host(name, args, kwargs):
            c.syncs.append((name, sync_site()))
        if name in STAGING_OPS or self._to_device(name, args, kwargs):
            c.staging.append(sync_site())
        if name in ("_to_copy", "copy_", "to") and ins:
            src = ins[-1] if name == "copy_" else ins[0]
            dst = args[0] if name == "copy_" else out
            if isinstance(dst, torch.Tensor) and src.dtype in _HALF \
                    and dst.dtype == torch.float32:
                fr = _site_frame()
                if fr is not None and fr[::2] in BLOCKED_WIDEN:
                    c.blocked_widens += 1
                else:
                    c.widens.append((str(src.dtype), tuple(src.shape),
                                     src.numel()))
        in_st = {_storage(t) for t in ins}
        for t in _tensors(out):
            if t.numel() and _storage(t) not in in_st:
                c.allocs += 1
                c.alloc_bytes += _nbytes(t)

    @staticmethod
    def _mask_index(name, args) -> bool:
        if name not in _MASK_INDEX_OPS or len(args) < 2:
            return False
        return any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8)
                   for t in (args[1] or ()))

    @staticmethod
    def _to_host(name, args, kwargs) -> bool:
        if name == "_to_copy":
            dev = kwargs.get("device")
            return args[0].is_cuda and dev is not None \
                and torch.device(dev).type == "cpu"
        if name == "copy_":
            return not args[0].is_cuda and args[1].is_cuda
        return False

    @staticmethod
    def _to_device(name, args, kwargs) -> bool:
        if name == "_to_copy":
            dev = kwargs.get("device")
            return not args[0].is_cuda and dev is not None \
                and torch.device(dev).type == "cuda" \
                and not kwargs.get("non_blocking", False)
        if name == "copy_":
            return args[0].is_cuda and not args[1].is_cuda \
                and not (len(args) > 2 and args[2])
        return False


def _spy(c: Census):
    """Patch the Tensor methods the dispatcher never sees; returns an
    undo callable."""
    saved = {}

    def make(meth, when):
        orig = getattr(torch.Tensor, meth)

        def spy(self, *a, **k):
            if when(self) and not _in_kernel():
                c.syncs.append((meth, sync_site()))
            return orig(self, *a, **k)

        saved[meth] = orig
        setattr(torch.Tensor, meth, spy)

    make("tolist", lambda t: True)
    make("numpy", lambda t: True)
    make("cpu", lambda t: not t.is_cuda)   # on the card: a _to_copy

    def undo():
        for meth, orig in saved.items():
            setattr(torch.Tensor, meth, orig)

    return undo


_DEPTH = threading.local()


def _in_kernel() -> bool:
    """Whether a watched kernel wrapper (its launch or its plain version)
    is running on this thread: ops issued there belong to the kernel, not
    its caller."""
    return getattr(_DEPTH, "n", 0) > 0


def _watch(hook):
    """Wrap every kernel wrapper (a function with a ``.kernel`` name) on
    its module: each call tells ``hook(kernel, args, kwargs)`` its operands
    and marks the ops it issues as the kernel's. Returns an undo
    callable."""
    from repro_torch.kernels import exemplar_eval, marginal_gain

    def watched(fn):
        def call(*a, **kw):
            if not _in_kernel():
                hook(fn.kernel, a, kw)
            _DEPTH.n = getattr(_DEPTH, "n", 0) + 1
            try:
                return fn(*a, **kw)
            finally:
                _DEPTH.n -= 1
        return call

    saved = [(mod, name, fn) for mod in (marginal_gain, exemplar_eval)
             for name, fn in vars(mod).items()
             if isinstance(fn, types.FunctionType) and hasattr(fn, "kernel")]
    for mod, name, fn in saved:
        setattr(mod, name, watched(fn))

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return undo


def take_census(fn, /, *args, sync_debug: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the census. Returns
    ``(result, Census)``. ``sync_debug`` also runs it under
    ``torch.cuda.set_sync_debug_mode("error")``, so a sync the census
    missed raises (on the card only)."""
    c = Census()
    calls0, launches0 = collections.Counter(_build.CALLS), \
        collections.Counter(_build.LAUNCHES)
    libs0 = set(_build._LIBS)

    def hook(kernel, a, kw):
        policy = kw.get("policy")
        if a[0].dtype in _HALF or (
                policy is not None and policy.compute_dtype in _HALF):
            c.half_kernel_calls += 1
        if kernel in _GAIN_KERNELS:
            bufs = [a[2]]
            if kernel in FUSED_KERNELS:
                out = kw.get("cache_out")
                if out is None:
                    c.fresh_cache_outs += 1
                else:
                    bufs.append(out)
        elif kernel in _TABLE_KERNELS:
            bufs = [a[0]]
        else:
            bufs = []
        for t in bufs:
            c.cache_buffers.setdefault(_storage(t), t)

    unwatch = _watch(hook)
    undo = _spy(c)
    debug = sync_debug and torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if debug else None
    try:
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        with _Recorder(c):
            out = fn(*args, **kwargs)
    finally:
        if debug:
            torch.cuda.set_sync_debug_mode(prev)
        undo()
        unwatch()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    c.calls = collections.Counter(_build.CALLS) - calls0
    c.launches = collections.Counter(_build.LAUNCHES) - launches0
    c.rebuilds = len(set(_build._LIBS) - libs0)
    return out, c
