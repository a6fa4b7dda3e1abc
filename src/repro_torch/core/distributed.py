"""Distributed submodular evaluation over a ``torch.distributed`` mesh.

The paper's decomposition L(S) = Σ_i L_{v_i}(S) (eq. 5/6) is exactly a
data-parallel sum over the ground set: shard V's rows over the mesh's data
axes, evaluate each shard's partial sums locally, and add them across the
mesh. Each rank holds n/p ground vectors of the working cache state, the
multiset payload is replicated (it is l·k·d ≪ n·d), and the only
communication is one (l,)- or (m,)-sized reduction per evaluation.

Here a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
named dimensions, and a plan runs SPMD: every rank calls the same entry
point with the same arguments and its own copy of the function, slices its
own rows of V (:func:`shard_ground_set`, :func:`_placed_sharded`), runs the
engine's rounds on them, and combines its partial sums with the other
ranks' through the collectives below. ``data_axes`` names the mesh
dimensions V is sharded over; a rank's shard index is its row-major index
over them, and its collectives span the ranks that differ from it only
along them (the other dimensions replicate the work). ``mesh=None`` is a
1-D mesh over the default process group; no process group is an error.

Every sum of partials is :func:`ordered_sum`: one ``all_gather`` into
(p, …) and a left fold in shard order. The argmax, CELF's stale-bound loop
and the sieve thresholds are control flow that every rank repeats on its
own, so every rank must see the same bits (a rank that sees other bits
takes another branch, and the collectives no longer pair up), and the
fixed order of additions is what makes a batched request bit for bit its
unbatched call. An ``all_reduce`` adds in its backend's order, so it is
used only where the sum is exact: :func:`owner_gather`, one real row
against p − 1 rows of zeros.

Three execution plans live here:

* ``device_sharded`` — the candidate payload is replicated (each rank's
  function holds all of V). Each scored candidate batch sends its (m,)
  gain partials and the shard's stat sum through ONE collective: one per
  dense or stochastic round, one per CELF re-score.
* ``device_sharded_pool`` — the payload row-shards with V, so no rank
  reads more than its own rows: candidate blocks and each round's winner
  are gathered from their owners (:func:`owner_gather`, one per block of
  at most n/p candidates).
* ``greedi`` — Mirzasoleiman et al.'s partition-then-merge: each rank
  greedily solves its own partition with no collective, the p·k partial
  solutions are all-gathered, and a merge greedy over them runs under the
  sharded cache; the answer is the better of the merged and the best
  partition solution.

On the ``cuda`` backend each rank runs the port's kernels on its own rows
with the global ``n_total`` as normaliser, so its outputs are exact
partials of the global sums: the gain kernels in every plan, and the
exemplar-eval and gain kernels in the standalone ``make_distributed_*``
evaluators. The other backends score through the plain pairwise path.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import pickle
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import contract
from repro_torch.core import distances as dist_mod
from repro_torch.core import functions as fx
from repro_torch.core.engine import (_at, _device_block_m, _freeze_where,
                                     _score_blocked,
                                     drive_selection_scan,
                                     drive_selection_scan_batched,
                                     mesh_tiles_per_memory)
from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import FnSpec, gains_formula
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.precision import resolve as resolve_policy

#: Timeout of the process groups this module creates: ranks whose control
#: flow diverged fail after it instead of waiting forever.
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Shards:
    """A mesh resolved for one tuple of data axes, as this rank sees it."""

    mesh: object            # the DeviceMesh
    axes: tuple             # the data axes
    p: int                  # shards: the product of the data axes' sizes
    index: int              # this rank's shard, row-major over the axes
    group: object           # process group over this rank's p shards
    order: tuple            # group ranks in shard order
    memory_ids: tuple       # per shard: (host, CUDA device id or None)

    def n_loc(self, n: int) -> int:
        """Rows per shard: n padded up to a multiple of p, over p."""
        return -(-n // self.p)

    def tiles_per_memory(self, device) -> int:
        """Shards whose tiles share this rank's memory for tensors on
        ``device``: the shards on this host for CPU tensors, the shards on
        this card for CUDA tensors."""
        mine = self.memory_ids[self.index]
        if torch.device(device).type == "cuda":
            return sum(1 for m in self.memory_ids if m == mine)
        return sum(1 for m in self.memory_ids if m[0] == mine[0])


_DEFAULT_MESHES: dict = {}
_RESOLVED: dict = {}


def _require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the mesh plans run on a torch.distributed process group and "
            "none is initialised: call torch.distributed.init_process_group("
            "backend, init_method=..., rank=..., world_size=..., timeout=...) "
            "on every rank first, then pass a DeviceMesh (or mesh=None for a "
            "1-D mesh over the default group)")


def mesh_device_type() -> str:
    """The device kind of a ``DeviceMesh`` over the current process group:
    ``"cuda"`` for NCCL ranks, ``"cpu"`` for gloo (and the dry run's fake
    group)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _default_mesh(axis: str):
    from torch.distributed.device_mesh import DeviceMesh

    key = (axis, id(dist.group.WORLD))
    mesh = _DEFAULT_MESHES.get(key)
    if mesh is None:
        mesh = DeviceMesh(mesh_device_type(),
                          list(range(dist.get_world_size())),
                          mesh_dim_names=(axis,))
        _DEFAULT_MESHES[key] = mesh
    return mesh


def _memory_id() -> tuple:
    """This rank's (host, current CUDA device's identity or None)."""
    cuda = None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        cuda = str(getattr(props, "uuid", "")) or \
            f"{props.name}:{torch.cuda.current_device()}"
    return (socket.gethostname(), cuda)


def resolve_mesh(mesh=None, data_axes: Sequence[str] = ("data",)) -> Shards:
    """Resolve ``mesh`` (a ``DeviceMesh``, None for a 1-D mesh over the
    default group, or an already resolved :class:`Shards`) for
    ``data_axes``. The first resolution of a mesh is a collective (the
    process group of a multi-axis split, and one all-gather of each rank's
    memory identity), so every rank resolves the same meshes in the same
    order — which the SPMD entry points do by construction."""
    if isinstance(mesh, Shards):
        return mesh
    _require_process_group()
    axes = tuple(data_axes)
    if mesh is None:
        if len(axes) != 1:
            raise ValueError(
                "the default mesh is 1-D; pass an explicit DeviceMesh to "
                f"shard over several axes {axes}")
        mesh = _default_mesh(axes[0])
    key = (id(mesh), axes)
    hit = _RESOLVED.get(key)
    if hit is not None and hit.mesh is mesh:
        return hit
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing or not axes or len(set(axes)) != len(axes):
        raise ValueError(f"data axes {axes} must be distinct dimensions of "
                         f"the mesh {names}")
    grid = mesh.mesh.cpu().numpy()
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    dims = [names.index(a) for a in axes]
    sizes = [grid.shape[d] for d in dims]
    p = int(np.prod(sizes))

    def shard_of(c):
        s = 0
        for d, size in zip(dims, sizes):
            s = s * size + int(c[d])
        return s

    def members(c):
        """Global ranks that differ from coordinate ``c`` only along the
        data axes, in shard order."""
        out = []
        for sub in itertools.product(*[range(s) for s in sizes]):
            cc = list(c)
            for d, v in zip(dims, sub):
                cc[d] = v
            out.append(int(grid[tuple(cc)]))
        return out

    mine = members(coord)
    if len(dims) == grid.ndim and grid.size == dist.get_world_size():
        group = dist.group.WORLD
    elif len(dims) == 1:
        group = mesh.get_group(axes[0])
    else:
        # one group per combination of the other axes, created by every
        # rank in the same order (new_group is collective over the world)
        others = [d for d in range(grid.ndim) if d not in dims]
        group = None
        for rest in itertools.product(*[range(grid.shape[d])
                                        for d in others]):
            c = [0] * grid.ndim
            for d, v in zip(others, rest):
                c[d] = v
            g = dist.new_group(sorted(members(c)), timeout=GROUP_TIMEOUT)
            if sorted(members(c)) == sorted(mine):
                group = g
    order = tuple(dist.get_group_rank(group, r) for r in mine)
    ids: list = [None] * p
    dist.all_gather_object(ids, _memory_id(), group=group)
    shards = Shards(mesh=mesh, axes=axes, p=p, index=shard_of(coord),
                    group=group, order=order,
                    memory_ids=tuple(tuple(ids[g]) for g in order))
    _RESOLVED[key] = shards
    return shards


def spawn_local(target, world_size: int, *, store_dir, backend: str = "gloo",
                args: tuple = (), timeout: float = 120.0) -> list:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` fresh
    processes of this host, each a rank of a process group over a
    ``FileStore`` in ``store_dir`` (created with :data:`GROUP_TIMEOUT`),
    and return the ranks' return values in rank order.

    ``target`` must be importable by name from a fresh interpreter (a
    module-level function). Return values travel pickled by value: a
    tensor sent through the queue as is would live in shared memory that
    the rank's exit can release before this process reads it. If a rank
    raises, dies, or the ranks are not
    all done ``timeout`` seconds after the start, every rank still running
    is killed and this raises: a rank that diverged can never hang the
    caller.
    """
    import os
    import queue
    import time
    import uuid

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(store_dir), f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, rank, world_size, store, backend,
                               args, results))
             for rank in range(world_size)]
    for proc in procs:
        proc.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(out)} of {world_size} ranks were not "
                    f"done after {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} "
                                       f"before returning")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return [out[r] for r in range(world_size)]


def _rank_main(target, rank, world_size, store, backend, args, results):
    import traceback

    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, world_size), rank=rank,
            world_size=world_size, timeout=GROUP_TIMEOUT)
        results.put((rank, True, pickle.dumps(target(rank, world_size,
                                                     *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def gather_shards(sh: Shards, x: torch.Tensor) -> torch.Tensor:
    """Every shard's ``x``, stacked in shard order: (p, *x.shape)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(len(sh.order))]
    dist.all_gather(parts, x, group=sh.group)
    return torch.stack([parts[g] for g in sh.order])


def gather_cat(sh: Shards, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every shard's ``x`` concatenated along ``dim`` in shard order (one
    all-gather; exact, so every rank holds the same bits)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(len(sh.order))]
    dist.all_gather(parts, x, group=sh.group)
    return torch.cat([parts[g] for g in sh.order], dim=dim)


def ordered_sum(sh: Shards, x: torch.Tensor) -> torch.Tensor:
    """Σ over the shards of ``x``, added in shard order — one all-gather and
    a left fold, so every rank gets the same bits whatever the backend."""
    parts = gather_shards(sh, x)
    acc = parts[0]
    for q in range(1, sh.p):
        acc = acc + parts[q]
    return acc


def owner_gather(sh: Shards, x: torch.Tensor) -> torch.Tensor:
    """The owner's ``x`` on every shard: ``x`` is real on one shard and zero
    on all others, so the all-reduce's sum is exact in any order."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=sh.group)
    return x


def shard_rows(x: torch.Tensor, mesh=None,
               data_axes: Sequence[str] = ("data",),
               fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of ``x`` (n, …): rows [i·n_loc, (i + 1)·n_loc) for
    shard i, the tail padded with ``fill`` up to n_loc = ⌈n/p⌉. A fresh
    contiguous tensor on ``x``'s device."""
    sh = resolve_mesh(mesh, data_axes)
    n = x.shape[0]
    n_loc = sh.n_loc(n)
    rows = x[min(sh.index * n_loc, n):min((sh.index + 1) * n_loc, n)]
    out = torch.full((n_loc,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[:rows.shape[0]] = rows
    return out


def shard_ground_set(V: torch.Tensor, mesh=None,
                     data_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """This rank's row shard of V, zero-padded to ⌈n/p⌉ rows."""
    return shard_rows(V, mesh, data_axes)


# ---------------------------------------------------------------------------
# Standalone evaluators: one collective per call
# ---------------------------------------------------------------------------


def _rbf_gamma(cfg: EvalConfig) -> Optional[float]:
    return dist_mod.RBF_GAMMA if cfg.distance == "rbf" else None


def _kernel_backend(cfg: EvalConfig):
    """The kernels' ops module where ``cfg`` asks for the cuda backend."""
    if cfg.backend != "cuda":
        return None
    if cfg.distance not in dist_mod.MXU_ELIGIBLE:
        raise ValueError(f"cuda backend supports "
                         f"{sorted(dist_mod.MXU_ELIGIBLE)}, got "
                         f"{cfg.distance!r}")
    from repro_torch.kernels import ops as kops

    return kops


def make_distributed_eval(mesh, cfg: EvalConfig,
                          data_axes: Sequence[str] = ("data",)):
    """Distributed L(S_j ∪ {e0}) evaluator.

    Returns ``fn(V_loc, data, lengths, d_e0_loc, n_total=None) -> (l,)``
    float32, where ``V_loc`` / ``d_e0_loc`` are this rank's row shards
    (:func:`shard_rows`; pad ``d_e0`` with 0, which makes pad rows inert)
    and the multiset is replicated. ``n_total`` is the normaliser: the real
    n, or by default p times the shard height, as the reference takes the
    global (padded) height. On the ``cuda`` backend each rank launches the
    exemplar-eval kernel (``cfg.mode``, ``cfg.kernel_variant``) on its rows
    with the global ``n_total``; the partials are added in shard order.
    """
    sh = resolve_mesh(mesh, data_axes)
    policy = resolve_policy(cfg.policy)
    pair = dist_mod.resolve_pairwise(cfg.distance)
    kops = _kernel_backend(cfg)

    def run(V_loc, data, lengths, d_e0_loc, n_total=None):
        n_global = sh.p * V_loc.shape[0] if n_total is None else n_total
        if kops is not None:
            return ordered_sum(sh, kops.exemplar_eval(
                V_loc, data, lengths, d_e0_loc, policy=policy, mode=cfg.mode,
                variant=cfg.kernel_variant if cfg.mode == "fused" else "loop",
                memory_budget_bytes=cfg.memory_budget_bytes,
                rbf_gamma=_rbf_gamma(cfg), n_total=n_global))
        l, k, d = data.shape
        D = pair(V_loc, data.reshape(l * k, d), policy).reshape(
            V_loc.shape[0], l, k)
        mask = torch.arange(k, device=D.device)[None, :] < lengths[:, None]
        D = torch.where(mask[None], D, torch.finfo(D.dtype).max)
        dmin = torch.minimum(torch.amin(D, dim=-1),
                             d_e0_loc[:, None].to(D.dtype))
        partial = torch.sum(dmin, dim=0).to(torch.float32)
        return ordered_sum(sh, partial) / n_global

    return run


def make_distributed_gains(mesh, cfg: EvalConfig,
                           data_axes: Sequence[str] = ("data",)):
    """Distributed marginal gains Δ(c_j | S) against a row-sharded
    min-cache: ``fn(V_loc, cands, cache_loc, n_total=None) -> (m,)``. Each
    shard's partials are normalised by the global n (default p times the
    shard height), so their ordered sum is the global gain. On the ``cuda``
    backend the partials are one launch of the gain kernel."""
    sh = resolve_mesh(mesh, data_axes)
    policy = resolve_policy(cfg.policy)
    pair = dist_mod.resolve_pairwise(cfg.distance)
    kops = _kernel_backend(cfg)

    def run(V_loc, cands, cache_loc, n_total=None):
        n_global = sh.p * V_loc.shape[0] if n_total is None else n_total
        if kops is not None:
            g = kops.marginal_gain(V_loc, cands, cache_loc, policy=policy,
                                   rbf_gamma=_rbf_gamma(cfg),
                                   n_total=n_global)
        else:
            g = gains_formula(V_loc, cands, cache_loc, pair, policy,
                              n_total=n_global)
        return ordered_sum(sh, g.to(torch.float32))

    return run


def make_distributed_cache_update(mesh, cfg: EvalConfig,
                                  data_axes: Sequence[str] = ("data",)):
    """Min-cache update m ← min(m, d(V, x)) on this rank's rows:
    ``fn(V_loc, x, cache_loc) -> cache_loc``. No collective."""
    resolve_mesh(mesh, data_axes)
    policy = resolve_policy(cfg.policy)
    pair = dist_mod.resolve_pairwise(cfg.distance)

    def run(V_loc, x, cache_loc):
        D = pair(V_loc, x[None, :], policy)[:, 0]
        return torch.minimum(cache_loc, D.to(cache_loc.dtype))

    return run


# ---------------------------------------------------------------------------
# Mesh-sharded selection: the engine's device_sharded and
# device_sharded_pool plans
# ---------------------------------------------------------------------------


def _kernel_ops(backend: str, fn: FnSpec):
    """The kernel template and ops module when the backend runs kernels."""
    tmpl = fx.kernel_template(fn)
    if backend != "cuda" or tmpl is None:
        return None, None
    from repro_torch.kernels import ops as kops

    return tmpl, kops


@contract(
    "distributed.selection_scan[sharded]",
    factory=True,
    host_syncs_per_round="celf",
    launches_per_round={"gain_eval": 1},
    collective_kinds=("allgather_", "allreduce_"),
    claim="a round makes no host sync (CELF: one allowed read per "
          "re-score); each scored batch is ONE all-gather of O(m) gain "
          "partials, each candidate block and the winner one owner gather "
          "of O(block·d) rows; nothing O(n·d) crosses the mesh")
@contract(
    "distributed.selection_scan[replicated]",
    factory=True,
    host_syncs_per_round="celf",
    launches_per_round={"gain_update_eval": 1, "gain_eval": 1},
    collective_kinds=("allgather_", "allreduce_"),
    reuse=("cache",),
    claim="a round makes no host sync (CELF: one allowed read per "
          "re-score) and ONE all-gather of the (m + 1) gain partials and "
          "stat sum per scored batch (graph cut: one more owner gather); "
          "the fused kernel ping-pongs two cache shards")
def make_selection_scan(
    mesh,
    data_axes: Sequence[str],
    *,
    fn: FnSpec = FnSpec(),
    kind: str,               # "dense" | "stochastic" | "lazy"
    k: int,
    top_b: int,
    n_total: int,            # global ground-set size (the gain normaliser)
    block_m: int,            # candidate block of the torch path / the take
    distance: str,
    policy: PrecisionPolicy,
    backend: str = "torch",  # "torch" | "cuda"
    rbf_gamma: Optional[float] = None,
    pool_plan: str = "replicated",  # "replicated" | "sharded"
):
    """Build one rank's k-round sharded selection.

    Returns ``run(V_loc, pool, seed_loc, aux_loc, cand_rounds, w0) -> (sel,
    traj, n_scored)``: ``V_loc`` / ``seed_loc`` / ``aux_loc`` are this
    rank's rows of V, of the cache seed and of the row auxiliary, padded
    with :func:`functions.pad_seed` / :func:`functions.pad_row_aux`;
    ``cand_rounds`` holds global candidate indices ((1, m) dense, (k, m)
    stochastic, (1, 0) lazy). The cache is ``(vec, aux)``: the vec
    row-shards with V, the scalar aux (graph cut's penalty) is replicated
    and advances by an :func:`owner_gather` of the winner's entry. Graph
    cut's index-addressed gain term is a per-shard partial (the owner adds
    the one real term), so it rides the gains collective.

    ``pool_plan="replicated"``: ``pool`` is the full candidate payload on
    every rank; each scored batch is one :func:`ordered_sum` of the (m,)
    gain partials and the shard's stat sum. ``pool_plan="sharded"``:
    ``pool`` is this rank's own rows (V's shard); candidate indices
    resolve through an owner gather per block of ``block_m`` columns, and
    the round's winner through one more. On the ``cuda`` backend the
    kernels score each rank's (n_loc, m) tile with the global ``n_total``:
    the fused kernel folds the winner in-tile on dense and stochastic
    rounds of a fused-eligible function with a replicated pool; CELF's
    re-scores, the sharded pool's blocks (with an explicit fold) and graph
    cut score through ``gain_eval``.
    """
    if pool_plan not in ("replicated", "sharded"):
        raise ValueError(f"unknown pool_plan {pool_plan!r}")
    sh = resolve_mesh(mesh, data_axes)
    pair = dist_mod.resolve_pairwise(distance)
    tmpl, kops = _kernel_ops(backend, fn)

    def psum(x):
        return ordered_sum(sh, x)

    def gather(x):
        return owner_gather(sh, x)

    def run(V_loc, pool, seed_loc, aux_loc, cand_rounds, w0):
        n_loc = V_loc.shape[0]
        dev = V_loc.device
        off = sh.index * n_loc
        seedf = seed_loc.to(torch.float32).clone()
        v0 = psum(torch.sum(fx.stat_rows(fn, seedf, aux_loc))) / n_total

        def local_stat(vec):
            return torch.sum(fx.stat_rows(fn, vec, aux_loc)) / n_total

        def value_of(cache):
            vec, aux = cache
            return fx.value_from_stat(fn, v0, psum(local_stat(vec)), aux,
                                      n_total)

        def fold(cache, w):
            vec, aux = cache
            row, gidx = w
            dw = pair(V_loc, row[None, :], policy)[:, 0]
            folded = fx.fold_vec_rows(fn, vec, dw.to(torch.float32))
            # aux advances from the PRE-fold vec; graph cut's owner gather
            # runs on every rank whatever the winner, then the gate applies
            new_aux = fx.fold_aux(fn, vec, aux, gidx, off, n_loc, psum=gather)
            ok = gidx >= 0
            return (torch.where(ok, folded, vec), torch.where(ok, new_aux, aux))

        def psum_gains_val(g_part, cache):
            """ONE collective per scored batch: the (m,) gain partials and
            the shard's stat sum in one payload."""
            vec, aux = cache
            out = psum(torch.cat([g_part.to(torch.float32),
                                  local_stat(vec)[None]]))
            return out[:-1], fx.value_from_stat(fn, v0, out[-1], aux, n_total)

        def score_part(vec, C):
            sc = fx.score_cache_rows(fn, vec, aux_loc)
            if kops is not None:
                return kops.marginal_gain(
                    V_loc, C, sc, policy=policy, rbf_gamma=rbf_gamma,
                    fold=tmpl[0], score_affine=tmpl[1], n_total=n_total)
            return _score_blocked(V_loc, C, sc, pair, policy, block_m,
                                  n_total=n_total, fn=fn, row_aux=aux_loc)

        def with_extra(g, vec, idx):
            extra = fx.gains_index_extra(fn, vec, idx, off, n_loc, n_total)
            return g if extra is None else g + extra

        cache0 = (seedf, torch.zeros((), dtype=torch.float32, device=dev))
        w0c = (w0.to(V_loc.dtype), torch.full((), -1, device=dev))

        if pool_plan == "sharded":
            n_loc_pool = pool.shape[0]
            off_pool = sh.index * n_loc_pool

            def take_rows(idxv):
                """Pool rows of global indices: the owner's rows against
                every other shard's zeros, one owner gather."""
                rel = idxv - off_pool
                own = (rel >= 0) & (rel < n_loc_pool)
                rows = pool[torch.clamp(rel, 0, n_loc_pool - 1)]
                return gather(torch.where(own[:, None], rows,
                                          torch.zeros_like(rows)))

            def take(j):
                return take_rows(j.reshape(1))[0], j

            def score_idx_val(cache, idx):
                # stream blocks of at most block_m columns: one gathered
                # block at a time, never more than the resident shard
                vec, _aux = cache
                bm = max(1, min(block_m, idx.shape[0]))
                g = torch.cat([score_part(vec, take_rows(idx[s:s + bm]))
                               for s in range(0, idx.shape[0], bm)])
                return psum_gains_val(with_extra(g, vec, idx), cache)

            def fold_score_val(cache, w_prev, cand_t):
                cache2 = fold(cache, w_prev)
                gains, val = score_idx_val(cache2, cand_t)
                return gains, cache2, val

            return drive_selection_scan(
                kind=kind, k=k, top_b=top_b, take=take, n_pool=n_total,
                cand_rounds=cand_rounds, cache0=cache0, w0=w0c, fold=fold,
                score_idx_val=score_idx_val, fold_score_val=fold_score_val,
                value_of=value_of)

        # the dense strategy scores one candidate row every round: its
        # payload is gathered once (the row object is kept)
        gathered = [None, None]

        def candidates(idx):
            if gathered[0] is not idx:
                gathered[:] = [idx, torch.index_select(pool, 0, idx)]
            return gathered[1]

        def score_idx_val(cache, idx):
            vec, _aux = cache
            g = score_part(vec, candidates(idx))
            return psum_gains_val(with_extra(g, vec, idx), cache)

        if kops is not None and fx.kernel_fused_ok(fn):
            # the fused kernel reads one cache buffer and writes the other
            bufs = (seedf.clone(), torch.empty_like(seedf))

            def fold_score_val(cache, w_prev, cand_t):
                vec, aux = cache
                row, gidx = w_prev
                out = bufs[1] if vec is bufs[0] else bufs[0]
                g_part, vec2 = kops.fused_gain_update(
                    V_loc, candidates(cand_t), vec, row, policy=policy,
                    rbf_gamma=rbf_gamma, fold=tmpl[0], score_affine=tmpl[1],
                    n_total=n_total, w_valid=(gidx >= 0).to(torch.float32),
                    cache_out=out)
                cache2 = (vec2, aux)  # fused-eligible functions carry no aux
                gains, val = psum_gains_val(g_part, cache2)
                return gains, cache2, val

            cache0 = (bufs[0], cache0[1])
        else:

            def fold_score_val(cache, w_prev, cand_t):
                cache2 = fold(cache, w_prev)
                gains, val = score_idx_val(cache2, cand_t)
                return gains, cache2, val

        return drive_selection_scan(
            kind=kind, k=k, top_b=top_b, pool=pool, cand_rounds=cand_rounds,
            cache0=cache0, w0=w0c, fold=fold, score_idx_val=score_idx_val,
            fold_score_val=fold_score_val, value_of=value_of)

    return run


def _placed_sharded(f, sh: Shards) -> dict:
    """This rank's padded rows of V, of the cache seed and of the row
    auxiliary, cached on ``f`` for the most recent mesh.

    V pads with zero rows; the seed and row_aux pad with the function's
    sentinels (:func:`functions.pad_seed` / ``pad_row_aux``), so pad rows
    add nothing to gains or stat sums: 0 for the min and additive caches,
    +inf dead-row markers for the max-cache functions (a zero V row is a
    real-looking point whose similarity to candidates is positive). V, the
    seed and the auxiliary never change, so repeat runs reuse the slices;
    delete ``f._sharded_placement_cache`` to release them. The replicated
    candidate pool needs no copy: it is ``f.V``.
    """
    placed = getattr(f, "_sharded_placement_cache", None)
    if placed is None or placed[0] is not sh:
        entry = {
            "V_sh": shard_rows(f.V, sh),
            "seed_sh": shard_rows(f.cache_seed.to(torch.float32), sh,
                                  fill=fx.pad_seed(f.spec)),
            "aux_sh": shard_rows(f.row_aux, sh, fill=fx.pad_row_aux(f.spec)),
        }
        placed = f._sharded_placement_cache = (sh, entry)
    return placed[1]


def run_sharded_selection(
    f,                       # SubmodularFunction
    cand_rounds: torch.Tensor,  # (k, m) global candidate indices
    w0: torch.Tensor,
    *,
    kind: str,
    k: int,
    top_b: int,
    m_widest: int,
    block_m: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    backend: str = "torch",
    rbf_gamma: Optional[float] = None,
    pool_plan: str = "replicated",
):
    """Slice this rank's rows and run the sharded selection.

    The torch path's gain tile is sized from the rank's own n/p rows (never
    the global n, which would under-fill every shard p×), the widest
    candidate round ``m_widest``, and the number of ranks whose tiles share
    one memory. Under the sharded pool the take-block width is also capped
    at n/p, so a gathered block never exceeds the resident shard. Returns
    ``(sel, traj, n_scored)`` device tensors, the same on every rank.
    """
    sh = resolve_mesh(mesh, data_axes)
    n = f.n
    n_loc = sh.n_loc(n)
    bm = block_m if block_m is not None else _device_block_m(
        n_loc, m_widest, mesh_tiles_per_memory(sh, device=f.device))
    if pool_plan == "sharded":
        bm = min(bm, max(8, n_loc))
    entry = _placed_sharded(f, sh)
    pool = f.V if pool_plan == "replicated" else entry["V_sh"]
    scan = make_selection_scan(
        sh, sh.axes, fn=f.spec, kind=kind, k=k, top_b=top_b, n_total=n,
        block_m=bm, distance=f.cfg.distance,
        policy=f.cfg.resolved_policy(), backend=backend, rbf_gamma=rbf_gamma,
        pool_plan=pool_plan)
    return scan(entry["V_sh"], pool, entry["seed_sh"], entry["aux_sh"],
                cand_rounds, w0)


# ---------------------------------------------------------------------------
# Batched × sharded: B tenants as (B, n/p) per rank
# ---------------------------------------------------------------------------


@contract(
    "distributed.selection_scan_batched[sharded]",
    factory=True,
    host_syncs_per_round="celf",
    launches_per_round={"gain_eval_batched": 1},
    collective_kinds=("allgather_", "allreduce_"),
    claim="B tenants' rounds make no host sync (CELF: one allowed read "
          "per re-score); each scored batch is ONE all-gather of O(B·m) "
          "and each candidate block ONE owner gather of O(B·block·d) — "
          "never one collective per tenant")
@contract(
    "distributed.selection_scan_batched[replicated]",
    factory=True,
    host_syncs_per_round="celf",
    launches_per_round={"gain_update_eval_batched": 1,
                        "gain_eval_batched": 1},
    collective_kinds=("allgather_", "allreduce_"),
    reuse=("cache",),
    claim="B tenants' rounds make no host sync (CELF: one allowed read "
          "per re-score) and ONE all-gather of (B, m + 1) per scored batch "
          "(graph cut: ONE owner gather of (B,)); the batched fused kernel "
          "ping-pongs two (B, n/p) cache shards")
def make_selection_scan_batched(
    mesh,
    data_axes: Sequence[str],
    *,
    fn: FnSpec = FnSpec(),
    kind: str,
    k: int,                  # shared round count (max per-request k)
    top_b: int,
    n_total: int,
    block_m: int,
    distance: str,
    policy: PrecisionPolicy,
    backend: str = "torch",
    rbf_gamma: Optional[float] = None,
    pool_plan: str = "replicated",
):
    """Build one rank's batched k-round sharded selection.

    The batched form of :func:`make_selection_scan`: B same-signature
    requests keep (B, n/p) state per rank. Returns ``run(V_loc, pool,
    seed_loc, aux_loc, cand_rounds, w0, k_eff) -> (sel (k, B), traj (k, B),
    n_scored (B,))`` with ``V_loc`` (B, n_loc, d), ``seed_loc`` /
    ``aux_loc`` (B, n_loc), ``cand_rounds`` (B, k, m), ``w0`` (B, d),
    ``k_eff`` (B,) (0 = an inert slot), and ``pool`` the (B, n, d) stacked
    payload (replicated) or ``V_loc`` itself (sharded).

    Each scored batch sends ALL B requests' (m,) gain partials and stat sums
    through ONE collective of (B, m + 1). A request's column of that
    payload is bit for bit the unbatched plan's (m + 1,) payload: its
    partials come from the grid-over-B kernels (each request bit for bit
    its own unbatched launch) or from a per-request torch reduction, and
    every per-request sum over n_loc is taken on that request's own row.
    So each request's selections, trajectory and evaluation count are bit
    for bit its unbatched sharded call. Batched CELF is
    :func:`engine.make_batched_lazy_step`, its values taken from the
    re-scores' collectives.
    """
    if pool_plan not in ("replicated", "sharded"):
        raise ValueError(f"unknown pool_plan {pool_plan!r}")
    sh = resolve_mesh(mesh, data_axes)
    pair = dist_mod.resolve_pairwise(distance)
    tmpl, kops = _kernel_ops(backend, fn)

    def psum(x):
        return ordered_sum(sh, x)

    def gather(x):
        return owner_gather(sh, x)

    def run(V_loc, pool, seed_loc, aux_loc, cand_rounds, w0, k_eff):
        B, n_loc, _d = V_loc.shape
        dev = V_loc.device
        off = sh.index * n_loc
        rows_b = torch.arange(B, device=dev)
        seedf = seed_loc.to(torch.float32).clone()

        def local_stats(vec):
            # each request's sum over its own row, as its unbatched run
            stat = fx.stat_rows(fn, vec, aux_loc)
            return torch.stack([torch.sum(stat[b]) for b in range(B)])

        v0 = psum(local_stats(seedf)) / n_total

        def value_of(cache):
            vec, aux = cache
            return fx.value_from_stat(fn, v0, psum(local_stats(vec) / n_total),
                                      aux, n_total)

        def fold(cache, w):
            vec, aux = cache
            row, gidx = w
            dw = torch.stack([pair(V_loc[b], row[b][None, :], policy)[:, 0]
                              for b in range(B)])
            folded = fx.fold_vec_rows(fn, vec, dw.to(torch.float32))
            new_aux = aux
            if fn.name == "graph_cut":
                # every tenant's owner entry in ONE gather of (B,)
                vw = gather(torch.stack([
                    fx.owner_entry(vec[b], gidx[b], off, n_loc)
                    for b in range(B)]))
                new_aux = fx.aux_from_entry(aux, vw)
            ok = gidx >= 0
            return (torch.where(ok[:, None], folded, vec),
                    torch.where(ok, new_aux, aux))

        def psum_gains_val(g_part, cache):
            """ONE collective per scored batch: (B, m) partials and the B
            stat sums in one (B, m + 1) payload."""
            vec, aux = cache
            out = psum(torch.cat([g_part.to(torch.float32),
                                  (local_stats(vec) / n_total)[:, None]],
                                 dim=1))
            return out[:, :-1], fx.value_from_stat(fn, v0, out[:, -1], aux,
                                                   n_total)

        def score_part(vec, C):
            sc = fx.score_cache_rows(fn, vec, aux_loc)
            if kops is not None:
                return kops.marginal_gain(
                    V_loc, C, sc, policy=policy, rbf_gamma=rbf_gamma,
                    fold=tmpl[0], score_affine=tmpl[1], n_total=n_total)
            return torch.stack([
                _score_blocked(V_loc[b], C[b], sc[b], pair, policy, block_m,
                               n_total=n_total, fn=fn, row_aux=aux_loc[b])
                for b in range(B)])

        def with_extra(g, vec, idx):
            if fn.name != "graph_cut":
                return g
            return g + torch.stack([
                fx.gains_index_extra(fn, vec[b], idx[b], off, n_loc, n_total)
                for b in range(B)])

        cache0 = (seedf, torch.zeros((B,), dtype=torch.float32, device=dev))
        w0c = (w0.to(V_loc.dtype),
               torch.full((B,), -1, dtype=torch.long, device=dev))

        if pool_plan == "sharded":
            n_loc_pool = pool.shape[1]
            off_pool = sh.index * n_loc_pool

            def take_rows(idxv):
                """(B, mb, d) pool rows of global indices, every request's
                in one owner gather."""
                rel = idxv - off_pool
                own = (rel >= 0) & (rel < n_loc_pool)
                rows = pool[rows_b[:, None], torch.clamp(rel, 0,
                                                         n_loc_pool - 1)]
                return gather(torch.where(own[:, :, None], rows,
                                          torch.zeros_like(rows)))

            def take(j):
                return take_rows(j[:, None])[:, 0], j

            def score_idx_val(cache, idx):
                vec, _aux = cache
                bm = max(1, min(block_m, idx.shape[1]))
                g = torch.cat([score_part(vec, take_rows(idx[:, s:s + bm]))
                               for s in range(0, idx.shape[1], bm)], dim=1)
                return psum_gains_val(with_extra(g, vec, idx), cache)

            def fold_score_val(cache, w_prev, cand_t, act):
                cache2 = fold(cache, w_prev)
                gains, val = score_idx_val(cache2, cand_t)
                return gains, _freeze_where(act, cache2, cache), val

            return drive_selection_scan_batched(
                kind=kind, k=k, top_b=top_b, k_eff=k_eff, take=take,
                n_pool=n_total, cand_rounds=cand_rounds, cache0=cache0,
                w0=w0c, fold=fold, score_idx_val=score_idx_val,
                fold_score_val=fold_score_val, value_of=value_of)

        gathered = [None, None]

        def candidates(idx):
            if gathered[0] is not idx:
                gathered[:] = [idx, pool[rows_b[:, None], idx]]
            return gathered[1]

        def score_idx_val(cache, idx):
            vec, _aux = cache
            g = score_part(vec, candidates(idx))
            return psum_gains_val(with_extra(g, vec, idx), cache)

        if kops is not None and fx.kernel_fused_ok(fn):
            # the fused kernel reads one cache buffer and writes the other
            # (the seed's copy is the first); a frozen request's fold gate
            # is 0, so its cache is copied
            bufs = (seedf, torch.empty_like(seedf))

            def fold_score_val(cache, w_prev, cand_t, act):
                vec, aux = cache
                row, gidx = w_prev
                out = bufs[1] if vec is bufs[0] else bufs[0]
                g_part, vec2 = kops.fused_gain_update(
                    V_loc, candidates(cand_t), vec, row, policy=policy,
                    rbf_gamma=rbf_gamma, fold=tmpl[0], score_affine=tmpl[1],
                    n_total=n_total,
                    w_valid=((gidx >= 0) & act).to(torch.float32),
                    cache_out=out)
                cache2 = (vec2, aux)
                gains, val = psum_gains_val(g_part, cache2)
                return gains, cache2, val
        else:

            def fold_score_val(cache, w_prev, cand_t, act):
                cache2 = fold(cache, w_prev)
                gains, val = score_idx_val(cache2, cand_t)
                return gains, _freeze_where(act, cache2, cache), val

        return drive_selection_scan_batched(
            kind=kind, k=k, top_b=top_b, k_eff=k_eff, pool=pool,
            cand_rounds=cand_rounds, cache0=cache0, w0=w0c, fold=fold,
            score_idx_val=score_idx_val, fold_score_val=fold_score_val,
            value_of=value_of)

    return run


def stage_sharded_batch(fs, *, mesh=None, data_axes: Sequence[str] = ("data",),
                        pool_plan: str = "replicated") -> dict:
    """Stack this rank's rows of a bucket of B same-signature requests.

    Each request's V / seed / aux rows are sliced and padded with the
    function's inert sentinels, as :func:`_placed_sharded` does, and
    stacked into (B, n/p, …) tensors on the requests' device. Nothing is
    cached on the functions: the seed must be fresh for every dispatch, and
    buckets change from call to call. The payload is single-use and
    carries the mesh and pool plan it was staged for.
    """
    sh = resolve_mesh(mesh, data_axes)
    f0 = fs[0]
    w0 = [f.e0 if f.e0 is not None else torch.zeros(
        (f.dim,), dtype=f0.V.dtype, device=f0.device) for f in fs]
    payload = {
        "shards": sh, "pool_plan": pool_plan,
        "V": torch.stack([shard_rows(f.V, sh) for f in fs]),
        "seed": torch.stack([
            shard_rows(f.cache_seed.to(torch.float32), sh,
                       fill=fx.pad_seed(f.spec)) for f in fs]),
        "aux": torch.stack([shard_rows(f.row_aux, sh,
                                       fill=fx.pad_row_aux(f.spec))
                            for f in fs]),
        "w0": torch.stack(w0).to(f0.V.dtype),
    }
    if pool_plan == "replicated":
        # UNPADDED (B, n, d): the replicated pool is candidate payload, and
        # lazy's bound seeding scores every pool row
        payload["pool"] = torch.stack([f.V for f in fs])
    return payload


def run_sharded_selection_batch(
    fs,                      # Sequence[SubmodularFunction]
    cand_rounds: torch.Tensor,  # (B, k, m) global candidate indices
    k_eff: torch.Tensor,        # (B,)
    *,
    kind: str,
    k: int,
    top_b: int,
    m_widest: int,
    block_m: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    backend: str = "torch",
    rbf_gamma: Optional[float] = None,
    pool_plan: str = "replicated",
    staged: Optional[dict] = None,
):
    """Stage this rank's (B, n/p) rows of a bucket and run the batched
    sharded selection. The torch path's gain tile is sized from B·n/p
    rows, divided by the ranks sharing one memory; under the sharded pool
    the take-block width is also capped at n/p. ``staged`` is a payload
    :func:`stage_sharded_batch` built for the same ``fs`` (restaged if its
    mesh or pool plan differ). Returns ``(sel (k, B), traj (k, B),
    n_scored (B,))`` device tensors, the same on every rank."""
    sh = resolve_mesh(mesh, data_axes)
    f0 = fs[0]
    n = f0.n
    n_loc = sh.n_loc(n)
    bm = block_m if block_m is not None else _device_block_m(
        n_loc, m_widest, mesh_tiles_per_memory(sh, device=f0.device),
        n_batch=len(fs))
    if pool_plan == "sharded":
        bm = min(bm, max(8, n_loc))
    if staged is None or staged.get("shards") is not sh \
            or staged.get("pool_plan") != pool_plan:
        staged = stage_sharded_batch(fs, mesh=sh, pool_plan=pool_plan)
    pool = staged["pool"] if pool_plan == "replicated" else staged["V"]
    scan = make_selection_scan_batched(
        sh, sh.axes, fn=f0.spec, kind=kind, k=k, top_b=top_b, n_total=n,
        block_m=bm, distance=f0.cfg.distance,
        policy=f0.cfg.resolved_policy(), backend=backend, rbf_gamma=rbf_gamma,
        pool_plan=pool_plan)
    return scan(staged["V"], pool, staged["seed"], staged["aux"], cand_rounds,
                staged["w0"], k_eff)


# ---------------------------------------------------------------------------
# GreeDi partition-then-merge (plan ``greedi``) — Mirzasoleiman et al.,
# "Distributed Submodular Maximization"
# ---------------------------------------------------------------------------


@contract(
    "distributed.greedi_scan",
    factory=True,
    launches_per_round={"gain_update_eval": 2, "gain_eval": 2},
    collective_kinds=("allgather_", "allreduce_"),
    reuse=("cache",),
    claim="no host sync; phase 1 is collective-free; a round adds p + 1 "
          "all-gathers of O(1) and O(p·k) (the p solutions' global values "
          "and the merge round's gains); the gathered solution rows are "
          "the largest operand, O(k·d) per rank, never O(n)")
def make_greedi_scan(
    mesh,
    data_axes: Sequence[str],
    *,
    fn: FnSpec = FnSpec(),
    k: int,
    n_total: int,
    block_m: int,
    distance: str,
    policy: PrecisionPolicy,
    backend: str = "torch",
    rbf_gamma: Optional[float] = None,
):
    """Build one rank's two-phase GreeDi selection.

    Returns ``run(V_loc, seed_loc, aux_loc, w0) -> (sel, traj, n_scored)``.
    Phase 1 is the single-device dense greedy on the rank's own partition,
    with no collective: local indices, gains normalised by the local
    (padded) n so the partition function is self-consistent, and the
    padding rows pre-marked as taken. Then one all-gather of each rank's k
    winners (rows and global indices) builds the p·k pool, each partition's
    own solution is valued globally (p·k folds against the sharded cache),
    and a merge greedy over the pool runs under the sharded-cache
    callbacks. The answer is the better of the merged solution and the best
    partition solution (ties keep the merged one). The trajectory is the
    global f(S_t); ``n_scored`` sums the partitions' scored candidates, the
    merge round's and the p·k folds.
    """
    sh = resolve_mesh(mesh, data_axes)
    pair = dist_mod.resolve_pairwise(distance)
    tmpl, kops = _kernel_ops(backend, fn)
    fused = kops is not None and fx.kernel_fused_ok(fn)
    p_total = sh.p

    def psum(x):
        return ordered_sum(sh, x)

    def gather(x):
        return owner_gather(sh, x)

    def run(V_loc, seed_loc, aux_loc, w0):
        n_loc, d = V_loc.shape
        dev = V_loc.device
        off = sh.index * n_loc
        seedf = seed_loc.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        w0c = (w0.to(V_loc.dtype), torch.full((), -1, device=dev))

        def score_local(vec, C, n_norm):
            sc = fx.score_cache_rows(fn, vec, aux_loc)
            if kops is not None:
                return kops.marginal_gain(
                    V_loc, C, sc, policy=policy, rbf_gamma=rbf_gamma,
                    fold=tmpl[0], score_affine=tmpl[1], n_total=n_norm)
            return _score_blocked(V_loc, C, sc, pair, policy, block_m,
                                  n_total=n_norm, fn=fn, row_aux=aux_loc)

        def fold_with(gather_aux):
            def fold(cache, w):
                vec, aux = cache
                row, idx = w
                dw = pair(V_loc, row[None, :], policy)[:, 0]
                folded = fx.fold_vec_rows(fn, vec, dw.to(torch.float32))
                new_aux = gather_aux(vec, aux, idx)
                ok = idx >= 0
                return (torch.where(ok, folded, vec),
                        torch.where(ok, new_aux, aux))
            return fold

        def fused_step(C_of, n_norm, value):
            """A dense round of a fused-eligible function: the winner fold
            rides in the fused kernel, which ping-pongs two buffers."""
            bufs = (seedf.clone(), torch.empty_like(seedf))

            def step(cache, w_prev, cand_t):
                vec, aux = cache
                row, idx = w_prev
                out = bufs[1] if vec is bufs[0] else bufs[0]
                g, vec2 = kops.fused_gain_update(
                    V_loc, C_of(cand_t), vec, row, policy=policy,
                    rbf_gamma=rbf_gamma, fold=tmpl[0], score_affine=tmpl[1],
                    n_total=n_norm, w_valid=(idx >= 0).to(torch.float32),
                    cache_out=out)
                return value(g, (vec2, aux))
            return step, (bufs[0], zero)

        # ---- phase 1: independent dense greedy over the local partition
        # (no collective; the phase-1 trajectory is local and discarded)
        v0_loc = torch.mean(fx.stat_rows(fn, seedf, aux_loc))

        def value_local(cache):
            vec, aux = cache
            return fx.value_from_stat(
                fn, v0_loc, torch.mean(fx.stat_rows(fn, vec, aux_loc)), aux,
                n_loc)

        fold_local = fold_with(
            lambda vec, aux, idx: fx.fold_aux(fn, vec, aux, idx, 0, n_loc))
        if fused:
            fold_score_local, cache1 = fused_step(
                lambda cand_t: V_loc[cand_t], n_loc,
                lambda g, cache2: (g, cache2, value_local(cache2)))
        else:
            cache1 = (seedf, zero)

            def fold_score_local(cache, w_prev, cand_t):
                cache2 = fold_local(cache, w_prev)
                vec2 = cache2[0]
                g = score_local(vec2, V_loc[cand_t], n_loc)
                extra = fx.gains_index_extra(fn, vec2, cand_t, 0, n_loc, n_loc)
                g = g if extra is None else g + extra
                return g, cache2, value_local(cache2)

        local_idx = torch.arange(n_loc, device=dev)
        sel1, _, nsc1 = drive_selection_scan(
            kind="dense", k=k, top_b=0, pool=V_loc,
            taken0=(local_idx + off) >= n_total,
            cand_rounds=local_idx[None, :], cache0=cache1, w0=w0c,
            fold=fold_local, fold_score_val=fold_score_local,
            value_of=value_local)

        # ---- one all-gather of the p·k partial solutions, in shard order
        rows_pk = gather_shards(sh, torch.index_select(V_loc, 0, sel1))
        idx_pk = gather_shards(sh, sel1 + off)
        merged_vec = rows_pk.reshape(p_total * k, d)
        merged_idx = idx_pk.reshape(p_total * k)
        nsc1_total = psum(nsc1)

        # ---- the global cache machinery of the solution values and the
        # merge greedy
        v0g = psum(torch.sum(fx.stat_rows(fn, seedf, aux_loc))) / n_total

        def local_stat(vec):
            return torch.sum(fx.stat_rows(fn, vec, aux_loc)) / n_total

        def value_global(cache):
            vec, aux = cache
            return fx.value_from_stat(fn, v0g, psum(local_stat(vec)), aux,
                                      n_total)

        fold_global = fold_with(
            lambda vec, aux, idx: fx.fold_aux(fn, vec, aux, idx, off, n_loc,
                                              psum=gather))

        def psum_gains_val(g_part, cache):
            vec, aux = cache
            out = psum(torch.cat([g_part.to(torch.float32),
                                  local_stat(vec)[None]]))
            return out[:-1], fx.value_from_stat(fn, v0g, out[-1], aux,
                                                n_total)

        # ---- each partition's solution valued GLOBALLY (best-of-both):
        # p·k folds, the same collectives on every rank
        cache0 = (seedf, zero)
        local_trajs = []
        for q in range(p_total):
            cache, vals = cache0, []
            for t in range(k):
                cache = fold_global(cache, (rows_pk[q, t], idx_pk[q, t]))
                vals.append(value_global(cache))
            local_trajs.append(torch.stack(vals))
        local_trajs = torch.stack(local_trajs)           # (p, k)
        best_q = torch.argmax(local_trajs[:, -1])
        # _at, not [best_q]: indexing with a 0-d tensor reads it on the host
        best_local_val = _at(local_trajs[:, -1], best_q)

        # ---- merge greedy over the gathered pool, cache sharded
        if fused:

            def merge_value(g, cache2):
                gains, val = psum_gains_val(g, cache2)
                return gains, cache2, val

            fold_score_merge, cache2_0 = fused_step(
                lambda cand_t: merged_vec[cand_t], n_total, merge_value)
        else:
            cache2_0 = cache0

            def fold_score_merge(cache, w_prev, cand_t):
                cache2 = fold_global(cache, w_prev)
                vec2 = cache2[0]
                g = score_local(vec2, merged_vec[cand_t], n_total)
                extra = fx.gains_index_extra(
                    fn, vec2, merged_idx[cand_t], off, n_loc, n_total)
                g = g if extra is None else g + extra
                gains, val = psum_gains_val(g, cache2)
                return gains, cache2, val

        sel2, traj2, nsc2 = drive_selection_scan(
            kind="dense", k=k, top_b=0,
            take=lambda j: (_at(merged_vec, j), _at(merged_idx, j)),
            n_pool=p_total * k,
            cand_rounds=torch.arange(p_total * k, device=dev)[None, :],
            cache0=cache2_0, w0=w0c, fold=fold_global,
            fold_score_val=fold_score_merge, value_of=value_global)

        # ---- best-of-both: the better of the merged greedy and the best
        # single-partition solution; ties keep the merged answer
        use_local = best_local_val > traj2[-1]
        sel_out = torch.where(use_local, _at(idx_pk, best_q),
                              merged_idx[sel2])
        traj_out = torch.where(use_local, _at(local_trajs, best_q), traj2)
        n_scored = nsc1_total + nsc2 + p_total * k
        return sel_out, traj_out, n_scored

    return run


def run_greedi_selection(
    f,                       # SubmodularFunction
    w0: torch.Tensor,
    *,
    k: int,
    block_m: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    backend: str = "torch",
    rbf_gamma: Optional[float] = None,
):
    """Slice this rank's rows and run GreeDi. Every partition must hold at
    least k real (non-padding) rows: each runs its own k-round greedy.
    Returns ``(sel, traj, n_scored)`` device tensors, the same on every
    rank."""
    sh = resolve_mesh(mesh, data_axes)
    n = f.n
    n_loc = sh.n_loc(n)
    tail_real = n - (sh.p - 1) * n_loc
    if tail_real < k:
        raise ValueError(
            f"greedi partitions V into {sh.p} shards of {n_loc} rows; the "
            f"last shard holds only {tail_real} real rows, fewer than k={k}"
            f" — its partition greedy would run out of candidates")
    bm = block_m if block_m is not None else _device_block_m(
        n_loc, n_loc, mesh_tiles_per_memory(sh, device=f.device))
    entry = _placed_sharded(f, sh)
    scan = make_greedi_scan(
        sh, sh.axes, fn=f.spec, k=k, n_total=n, block_m=bm,
        distance=f.cfg.distance, policy=f.cfg.resolved_policy(),
        backend=backend, rbf_gamma=rbf_gamma)
    return scan(entry["V_sh"], entry["seed_sh"], entry["aux_sh"], w0)


def distributed_greedy(mesh, V, k: int, cfg: EvalConfig = EvalConfig(),
                       data_axes: Sequence[str] = ("data",),
                       candidate_batch: Optional[int] = None,
                       device=None) -> tuple[list[int], float]:
    """Greedy with V row-sharded over the mesh, one collective per round:
    a thin wrapper over the ``device_sharded`` plan, run by every rank with
    the whole V (numpy or a tensor; numpy goes to ``device``).
    ``candidate_batch`` bounds the per-rank candidate tile of the torch
    path; the ``cuda`` backend launches the gain kernels on each rank's
    rows. Returns (indices, f value)."""
    from repro_torch.core.functions import ExemplarClustering
    from repro_torch.core.optimizers import greedy

    f = ExemplarClustering(V, cfg, device=device)
    res = greedy(f, k, mode="device_sharded", mesh=mesh, data_axes=data_axes,
                 block_m=candidate_batch)
    return res.indices, res.value
