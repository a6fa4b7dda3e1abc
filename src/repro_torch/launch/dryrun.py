"""Multi-pod dry run: one run of every (arch × shape × mesh) cell's real
step on meta tensors.

Proves the distribution config is coherent without hardware: on a
``"fake"`` process group of the production mesh's size (rank 0's view:
its collectives go nowhere), it builds the production ``DeviceMesh``,
places the state by the real sharding rules, and runs the cell's real
train, prefill or serve step once on meta tensors — shapes and dtypes, no
storage, nothing allocated and no card touched. It records memory, cost
and the collective schedule for the H100 roofline.

The port of the JAX package's ``launch/dryrun.py``, where XLA lowers and
compiles the step on 512 placeholder devices. Here the counts come from
the run itself, per device (rank 0's step):

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``. It counts the
  matmul, convolution and attention ops only, while XLA's
  ``cost_analysis`` also counts elementwise FLOPs, so ``useful_flops_ratio``
  is not comparable with any TPU record.
* ``bytes accessed``: the operand bytes plus the result bytes of every
  dispatched aten op that is not a view (nor an ``empty*`` that only
  allocates, nor an op on no tensor, as ``promote_types``); an in-place
  op's tensor counts as read and as written.
  Eager PyTorch sends each op's operands through HBM and writes each
  result back, so the sum is the unfused eager step's traffic: the
  memory term of this code, not of the function (a fused step moves
  less, and moves this bound with it). The collectives are not in it:
  they are the third term.
* ``memory_floor_bytes`` (train cells): the function's own memory floor,
  which no fusion moves (:func:`memory_floor_bytes`); the roofline
  records it beside the eager traffic as ``memory_floor_s`` and
  ``floor_bound_s``.
* collectives: the census's c10d records
  (:func:`~repro_torch.analysis.census.take_census`), as result bytes per
  kind (:func:`~repro_torch.launch.roofline.collective_bytes`).
* memory per device: ``argument_bytes`` are exact — over this rank's
  state and batch leaves, ``prod(rules.local_shape(...)) × itemsize``, the
  layout the reference's ``in_shardings`` give. ``held_argument_bytes``
  are what the port's step is handed on this rank: equal for a train
  step's state (each rank its blocks), but the port's serving holds the
  weights whole on every rank, and every step takes the whole batch.
  ``temp_bytes`` is the run's peak of live storage that the step itself
  allocated, tracked by a finalizer on each new meta storage (it dies
  when its last tensor does); ``peak_bytes_per_device`` is the held
  arguments plus that peak. A train cell's run first holds the placed
  state's bytes leaf by leaf equal to ``argument_leaf_bytes``' and
  raises, naming the leaves, where they differ.

``lower_s`` holds the meta run's seconds and ``compile_s`` 0 (nothing
compiles). A cell fails on meta where the step reads a device value on
the host or has a data-dependent shape; the record then says ``error``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--out results/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES, Shape, cell_supported, input_specs
from repro_torch.distributed.sharding import MeshRules
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import step as St
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def _cfg_for_cell(arch: str, shape: Shape) -> ModelConfig:
    cfg = C.get_config(arch)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, max_seq_len=max(shape.seq_len, 2048))
    return cfg


# ---------------------------------------------------------------------------
# the process group and the mesh
# ---------------------------------------------------------------------------


def ensure_fake_group(world_size: int) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0, when none exists (or when the current one is fake and of
    another size). A real group is left as it is: the mesh then checks
    its size."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 (registers "fake")

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def production_mesh(multi_pod: bool):
    """The production mesh, on a fake group of its size unless a real
    group exists."""
    ensure_fake_group(math.prod(PRODUCTION[multi_pod][0]))
    return make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# the cell's state, inputs and step
# ---------------------------------------------------------------------------


def abstract_state(cfg: ModelConfig, with_opt: bool, rules=None):
    """The meta state of a cell, allocating nothing: the train state
    (a model placed on ``rules``' mesh, each parameter this rank's block,
    and its optimizer state from ``init_opt_state``), or the whole model
    for serving. As ``train.step.init_train_state`` builds the real one."""
    model = M.abstract_model(cfg)
    if not with_opt:
        return model
    model.requires_grad_(True)
    if rules is not None:
        M.place_model(model, rules)
    return {"params": model, "opt": init_opt_state(model)}


def cell_step(cfg: ModelConfig, shape: Shape, rules, microbatches: int = 1):
    """The cell's real step on ``rules``' mesh: ``train_step(state,
    batch)``, ``prefill_step(model, batch)`` or ``serve_step(model,
    batch)``."""
    if shape.kind == "train":
        return St.make_train_step(cfg, OptimizerConfig(),
                                  microbatches=microbatches, rules=rules)
    if shape.kind == "prefill":
        return St.make_prefill_step(cfg, shape.seq_len, rules=rules)
    return St.make_serve_step(cfg, rules=rules)


def cell_args(cfg: ModelConfig, shape: Shape, rules) -> tuple:
    """The step's two arguments on meta tensors, as a caller on ``rules``'
    mesh hands them over: the (placed) state or the model, and the whole
    batch — for decode its tokens, this rank's cache blocks (``zero_caches``
    on meta: the placement of ``cache_dims_tree``) and the position of the
    cache's last slot, ``seq_len − 1`` (the serve step takes a host
    integer)."""
    state = abstract_state(cfg, shape.kind == "train", rules)
    specs = input_specs(cfg, shape)
    if shape.kind != "decode":
        return state, specs
    B, S = shape.global_batch, shape.seq_len
    return state, {"tokens": specs["tokens"],
                   "caches": M.zero_caches(cfg, B, S, device="meta",
                                           rules=rules),
                   "pos": S - 1}


def _ref_path(name: str) -> str:
    """A parameter's path in the reference's trees: ``groups.g0_attn.3.
    attn.wq`` → ``groups/g0_attn/attn/wq`` (a group's layers stacked)."""
    parts = name.split(".")
    if parts[0] == "groups":               # the layer index: stacked
        del parts[2]
    return "/".join(parts)


def argument_leaf_bytes(cfg: ModelConfig, shape: Shape, rules) -> dict:
    """This rank's bytes of each leaf of the step's arguments as the
    reference's ``in_shardings`` lay them out, ``prod(rules.local_shape(
    shape, dims)) × itemsize``, keyed by the leaf's path in the
    reference's trees (``params/groups/g0_attn/attn/wq`` for a group's
    stacked leaf: its layers' blocks added; ``opt/m/…``, ``batch/…``)."""
    def block(shp, dims, dtype) -> int:
        return math.prod(rules.local_shape(tuple(shp), dims)) * \
            dtype.itemsize

    dtype = M.DTYPES[cfg.dtype]
    named = {}
    M._walk_named(cfg, lambda n, s: named.__setitem__(n, s))
    parts = [("params", lambda s: M.leaf_dtype(s, dtype))]
    if shape.kind == "train":     # master, m, v in fp32, and the step
        parts += [(f"opt/{k}", lambda s: torch.float32)
                  for k in ("master", "m", "v")]
    out: dict = {}
    for prefix, dt in parts:
        for n, s in named.items():
            key = f"{prefix}/{_ref_path(n)}"
            out[key] = out.get(key, 0) + block(s.shape, s.dims, dt(s))
    if shape.kind == "train":
        out["opt/step"] = torch.int32.itemsize
    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        dims = {"tokens": (("batch",), (None,)),
                "caches": St.cache_dims_tree(cfg, specs["caches"], rules),
                "pos": ()}
    else:
        dims = St.batch_dims(cfg, specs)
    sizes = M.tree_map(lambda t, d: block(t.shape, d, t.dtype), specs, dims)
    out.update({f"batch{k}": n for k, n in M.tree_leaves(sizes)})
    return out


def argument_bytes(cfg: ModelConfig, shape: Shape, rules) -> int:
    """:func:`argument_leaf_bytes` summed: the reference's per-device
    argument bytes."""
    return sum(argument_leaf_bytes(cfg, shape, rules).values())


def held_leaf_bytes(state: dict) -> dict:
    """The bytes a placed train state holds on this rank, keyed as
    :func:`argument_leaf_bytes` keys its params and opt parts."""
    out: dict = {}

    def add(key, t):
        out[key] = out.get(key, 0) + t.numel() * t.element_size()

    for n, p in state["params"].named_parameters():
        add(f"params/{_ref_path(n)}", p)
    for k in ("master", "m", "v"):
        for n, t in state["opt"][k].items():
            add(f"opt/{k}/{_ref_path(n)}", t)
    add("opt/step", state["opt"]["step"])
    return out


def check_held_state(cfg: ModelConfig, shape: Shape, rules, state) -> None:
    """Raise, naming the leaves, where a placed train state's bytes on this
    rank differ from :func:`argument_leaf_bytes`' (the reference's
    layout)."""
    want = {k: n for k, n in argument_leaf_bytes(cfg, shape, rules).items()
            if not k.startswith("batch")}
    got = held_leaf_bytes(state)
    bad = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
           if got.get(k) != want.get(k)}
    if bad:
        raise ValueError(f"the placed state's bytes differ from the "
                         f"reference's layout (held, reference): "
                         f"{dict(sorted(bad.items()))}")


def memory_floor_bytes(cfg: ModelConfig, shape: Shape, rules) -> int:
    """A train step's memory floor on this rank: the bytes the function
    must move through HBM, whatever the code fuses. AdamW reads the
    gradients, master, m and v once and writes params, master, m and v
    once (2 × the state's bytes, the gradients as large as the params);
    the products read each weight in the forward, the recompute and the
    backward (3 ×, remat on), a weight's block with its data axes
    gathered and its model axis split as the reference lays it out; each
    decoder layer's input is written once and read once (at the tokens'
    rows on this rank: a VLM's image rows and an encoder's frames left
    out); the batch is read once. The logits, the attention scores and
    every other intermediate are left out, so the floor stays a floor."""
    from repro_torch.distributed.sharding import _axes

    args = argument_leaf_bytes(cfg, shape, rules)
    state = sum(n for k, n in args.items() if not k.startswith("batch"))
    batch = sum(n for k, n in args.items() if k.startswith("batch"))
    dtype = M.DTYPES[cfg.dtype]
    data = set(rules.data_axes)
    weights = 0

    def read(name, s):
        nonlocal weights
        spec = rules.spec(tuple(s.shape), s.dims)
        local = [d // math.prod(rules.shape[a] for a in _axes(phys)
                                if a not in data)
                 if phys is not None else d
                 for d, phys in zip(s.shape, spec)]
        weights += math.prod(local) * M.leaf_dtype(s, dtype).itemsize

    M._walk_named(cfg, read)
    tokens = input_specs(cfg, shape)["tokens"]
    rows = math.prod(rules.local_shape(tuple(tokens.shape),
                                       St.batch_dims(cfg, {"tokens": tokens})
                                       ["tokens"]))
    acts = cfg.num_layers * rows * cfg.d_model * dtype.itemsize
    return 2 * state + 3 * weights + 2 * acts + batch


def tensor_leaves(x) -> list:
    """The tensors of a step's arguments or results: dicts, lists and
    tuples walked, a module's parameters."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return [p for p in x.parameters()]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensor_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensor_leaves(v)]
    return []


def nbytes(x) -> int:
    """Summed bytes of the tensors in ``x`` (:func:`tensor_leaves`)."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(x))


# ---------------------------------------------------------------------------
# one measured run
# ---------------------------------------------------------------------------


#: ops that only allocate: no element is read or written
_ALLOC_ONLY = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "empty_permuted"})


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Traffic(TorchDispatchMode):
    """The "bytes accessed" of every dispatched op (operands plus results,
    views, pure allocations and collectives left out) and the peak of the
    live storage the run allocated: an op's result whose storage is none of
    its operands' is new, and a finalizer takes its bytes off when the
    storage dies."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = self.peak = 0
        self._lock = threading.Lock()
        self._seen: set = set()

    def _free(self, sid: int, n: int) -> None:
        with self._lock:
            self.live -= n
            self._seen.discard(sid)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        ins = tensor_leaves(list(args) + list(kwargs.values()))
        outs = tensor_leaves(out)
        name = func._opname
        if not func.is_view and name not in _ALLOC_ONLY and (ins or outs):
            self.ops += 1
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        in_sids = {_sid(t) for t in ins}
        for t in outs:
            sid = _sid(t)
            n = t.untyped_storage().nbytes()
            if sid in in_sids or sid in self._seen or not n:
                continue
            with self._lock:
                self._seen.add(sid)
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(t.untyped_storage(), self._free, sid, n)
        return out


def measure(fn, *args) -> dict:
    """Run ``fn(*args)`` once under the FLOP counter, the census and the
    traffic count. Returns ``{"out", "seconds", "flops", "bytes accessed",
    "temp_bytes", "aten_ops", "collectives", "syncs"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.census import take_census

    traffic = _Traffic()
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, traffic:
        out, census = take_census(fn, *args)
    seconds = time.perf_counter() - t0
    return {"out": out, "seconds": seconds,
            "flops": float(flops.get_total_flops()),
            "bytes accessed": float(traffic.bytes),
            "temp_bytes": traffic.peak, "aten_ops": traffic.ops,
            "collectives": R.collective_bytes(census.collective_results),
            "syncs": len(census.syncs)}


def resolve_shards(rules) -> None:
    """Resolve the mesh's shard groups the steps use — the data axes, the
    model axis, all axes — before a measured run: the first resolution is
    a collective (an object all-gather), which a job pays once, not per
    step."""
    for axes in (rules.data_axes, ("model",), tuple(rules.shape)):
        if axes and all(a in rules.shape for a in axes):
            rules.shards(axes)


def lower_cell(arch: str, shape: Shape, multi_pod: bool,
               cfg: ModelConfig | None = None, microbatches: int = 1,
               mesh=None):
    """One run of the cell's step on meta tensors, on the production mesh
    (on a fake group of its size unless a group exists) or on ``mesh``.
    Returns ``(run, meta)``: :func:`measure`'s counts with the memory
    terms, and the cell's description."""
    if cfg is None:
        cfg = _cfg_for_cell(arch, shape)
    if mesh is None:
        mesh = production_mesh(multi_pod)
    rules = MeshRules.for_mesh(mesh)
    resolve_shards(rules)
    step = cell_step(cfg, shape, rules, microbatches)
    args = cell_args(cfg, shape, rules)
    if shape.kind == "train":
        check_held_state(cfg, shape, rules, args[0])
    run = measure(step, *args)
    run["argument_bytes"] = argument_bytes(cfg, shape, rules)
    if shape.kind == "train":
        run["memory_floor_bytes"] = memory_floor_bytes(cfg, shape, rules)
    run["held_argument_bytes"] = nbytes(args)
    run["output_bytes"] = nbytes(run.pop("out"))
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "multi_pod": multi_pod, "chips": mesh.size(),
            "approx_params": cfg.approx_params()}
    return run, meta


def extrapolated_costs(arch: str, shape: Shape, microbatches: int = 1,
                       mesh=None, cfg: ModelConfig | None = None) -> dict:
    """Depth-extrapolated FLOPs / bytes / collective bytes (see
    extrapolate.py) from shallow variants of the cell's config (or of
    ``cfg``)."""
    from repro_torch.launch import extrapolate as X

    base_cfg = _cfg_for_cell(arch, shape) if cfg is None else cfg
    real = X.layer_kind_counts(base_cfg)
    counts, flops, bytes_, coll, times = [], [], [], [], []
    for cfg_v, cnt in X.depth_variants(base_cfg):
        run, _ = lower_cell(arch, shape, False, cfg=cfg_v,
                            microbatches=microbatches, mesh=mesh)
        counts.append(cnt)
        flops.append(run["flops"])
        bytes_.append(run["bytes accessed"])
        coll.append(float(run["collectives"]["total_bytes"]))
        times.append(round(run["seconds"], 1))
    return {
        "variant_counts": counts,
        "variant_flops": flops,
        "variant_lower_s": times,
        "real_counts": real,
        "flops": X.solve_and_extrapolate(counts, flops, real),
        "bytes": X.solve_and_extrapolate(counts, bytes_, real),
        "collective_bytes": X.solve_and_extrapolate(counts, coll, real),
    }


def cell_record(run: dict, meta: dict, shape: Shape,
                peaks: dict = R.PEAKS[R.DEFAULT]) -> dict:
    """The reference's record of an ``ok`` cell from :func:`lower_cell`'s
    ``(run, meta)``. Its roofline is the full-depth meta run's: every
    layer is dispatched, so the counts are exact (the reference
    extrapolates from shallow variants because XLA counts a scanned
    layer once; :func:`extrapolated_costs` is held equal to these counts
    in the tests)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = R.model_flops(meta["approx_params"], tokens, shape.kind)
    cost = {"flops": run["flops"], "bytes accessed": run["bytes accessed"]}
    terms = R.roofline_terms(cost, run["collectives"]["total_bytes"], peaks)
    terms["source"] = "meta_run (every layer dispatched)"
    if "memory_floor_bytes" in run:
        terms.update(R.floor_terms(terms, run["memory_floor_bytes"], peaks))
    device_flops_global = terms["device_flops"] * meta["chips"]
    return {
        **meta,
        "status": "ok",
        "lower_s": round(run["seconds"], 2),
        "compile_s": 0.0,
        "memory": {
            "argument_bytes": run["argument_bytes"],
            "held_argument_bytes": run["held_argument_bytes"],
            "output_bytes": run["output_bytes"],
            "temp_bytes": run["temp_bytes"],
            "peak_bytes_per_device": (run["held_argument_bytes"]
                                      + run["temp_bytes"]),
        },
        "cost": cost,
        "collectives": run["collectives"],
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / device_flops_global
                               if device_flops_global else None),
        "tokens_per_step": tokens,
        "aten_ops": run["aten_ops"],
        "host_syncs": run["syncs"],
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             microbatches: int = 1) -> dict:
    shape = SHAPES[shape_name]
    cfg = C.get_config(arch)
    ok, reason = cell_supported(cfg, shape)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    out = pathlib.Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch}__{shape_name}__{mesh_tag}.json"
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "skipped", "reason": reason}
        path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {arch} × {shape_name} ({mesh_tag}): {reason}")
        return rec

    try:
        run, meta = lower_cell(arch, shape, multi_pod,
                               microbatches=microbatches)
        rec = cell_record(run, meta, shape)
        path.write_text(json.dumps(rec, indent=2))
        terms = rec["roofline"]
        print(f"[dryrun] OK   {arch} × {shape_name} ({mesh_tag}) "
              f"meta run {run['seconds']:.1f}s "
              f"bottleneck={terms['bottleneck']} "
              f"peak/dev={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB")
        return rec
    except Exception as e:  # record failures — they are bugs to fix
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] FAIL {arch} × {shape_name} ({mesh_tag}): {e}")
        return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=C.ARCH_IDS + ["all"])
    ap.add_argument("--shape", default="all",
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args()

    archs = C.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for mp in meshes:
        # a fake group of the mesh's size (256 or 512 ranks, this rank 0)
        production_mesh(mp)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mp, args.out,
                               microbatches=args.microbatches)
                n_fail += rec.get("status") == "error"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
