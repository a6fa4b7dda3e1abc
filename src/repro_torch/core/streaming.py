"""The streaming sieve engine (the sieve family's execution plans).

The sieve family (SieveStreaming [4], SieveStreaming++ [19], Salsa [20])
keeps a *grid* of threshold sieves τ = (1+ε)^i and offers every arriving
stream element to all of them. This module keeps that grid on the device as
a **fixed-capacity sieve table** of ``S_max`` slots:

* Sieves are keyed by the **integer exponent** i of their threshold
  τ = (1+ε)^i, never by float equality of τ.
* Exponent i lives in slot ``i mod S_max``. The live window
  [i_lo, i_hi] = [⌈log m / log(1+ε)⌉, ⌊log(2km) / log(1+ε)⌋] has width
  ≤ log(2k)/log(1+ε) + 1 independent of the stream, so with
  ``S_max ≥ width + 2`` every live exponent owns a distinct slot.
* A grid "rebuild" is a **masked activation**: slots whose assigned exponent
  changed are reset (cache ← seed, size ← 0, members ← −1); slots whose
  exponent survives keep their state.
* Salsa's grid is grow-only, so its exponent span depends on the stream; its
  default capacity adds headroom, and when the span exceeds ``S_max`` the
  slot collision evicts the lowest (stalest) exponent — one capacity rule
  that every plan shares.

Function generality: the table rows carry whatever (n,)-vec cache the
objective's protocol defines; the element step reads gains through
:func:`~repro_torch.core.functions.sieve_gain_rows` (or the sieve kernel
under the function's min/max template), folds accepts through
:func:`~repro_torch.core.functions.sieve_fold_rows`, and values sieves
through ``stat_rows``/``value_from_stat``. Graph cut is not
:data:`~repro_torch.core.functions.SIEVE_ELIGIBLE`: its gain needs the
winner-indexed penalty, which a stream element's cache rows cannot carry.

Parity: :func:`_element_step` is the ONE definition of the per-element
transition, written as ``torch.where``s from end to end. The host mirror
calls it per element and reads each element's accept flag back (the
per-element round trip the device engine removes); the device engine calls
it for every element of a block and reads nothing back until the block's
offer ends. Both take distance rows from ``point_distances_block`` at one
(block_size, n) shape, so host and device see bitwise-identical inputs,
make identical accept decisions, select identical members, and report
identical evaluation counts.

Where the reference scans a block with ``jax.lax.scan`` and donates the
table carry, the engines here loop over the block's elements in Python with
no host read inside the loop, and update the (S_max, n) table in place.

The same step serves the batched multi-stream engine: every operation
broadcasts over a leading partition axis, and the only reductions over the
ground-set axis (:func:`_mean_rows`, and the batched sieve kernel) take each
partition at its standalone engine's shape, so a partition is bit for bit
its standalone engine.

The mesh-sharded plan (:func:`make_sharded_offer_scan`) column-shards the
(S_max, n) table, the seed, the row auxiliary and each element's distance
row over the data axes of a ``torch.distributed`` mesh: each rank holds
(S_max, n/p). It runs the identical :func:`_element_step`, with the step's
reductions over the ground set — the gains of the seed and the table, the
sieve values, ++'s lower bound — replaced by per-shard partials added in
shard order (:func:`repro_torch.core.distributed.ordered_sum`): one
collective per element, two for ++. Thresholds, sizes, members and the
evaluation counter stay replicated: every rank computes them from the same
bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core import functions as fx
from repro_torch.core.functions import FnSpec

VARIANTS = ("sieve", "pp", "salsa")
BACKENDS = ("torch", "cuda")

#: Slot-exponent value meaning "never assigned" — far below any reachable
#: grid exponent (f32 singleton values bound |i| ≲ 1000 for ε ≥ 1e-3).
_EXP_UNSET = -(1 << 30)

#: Byte alignment at which a partition's slice is reduced as its standalone
#: table is (a fresh allocation; ATen's vectorized reductions shift their
#: order with the operand's alignment).
_ALIGN = 128


class SieveSpec(NamedTuple):
    """Static configuration of a sieve table."""

    k: int
    eps: float
    s_max: int
    variant: str        # "sieve" | "pp" | "salsa"
    log1p_eps: float    # np.float32(log1p(eps)) — the ONE grid-log constant
    #: scoring backend for the element step's gains: "torch" runs the plain
    #: (S_max, n) protocol reduction; "cuda" runs the sieve kernel
    #: (:func:`repro_torch.kernels.ops.sieve_gains`) under the function's
    #: min/max template (its plain version on CPU tensors). Part of the spec
    #: (not the engine) so the host mirror and the device loop share ONE
    #: definition per backend.
    backend: str = "torch"
    #: the submodular objective the table rows cache — must be
    #: :data:`~repro_torch.core.functions.SIEVE_ELIGIBLE`.
    fn: FnSpec = FnSpec()


class SieveState(NamedTuple):
    """State of the fixed-capacity sieve table, on the engine's device.

    Inactive slots carry stale rows; every consumer masks with ``active``.
    ``members`` rows are stream ids in arrival order, -1 beyond ``sizes``.
    The batched engine stacks P of these along a leading axis.
    """

    caches: torch.Tensor    # (S_max, n) f32 per-sieve cache rows (fn semantics)
    slot_exp: torch.Tensor  # (S_max,) i32 threshold exponent i (τ = (1+ε)^i)
    active: torch.Tensor    # (S_max,) bool
    sizes: torch.Tensor     # (S_max,) i32 member counts
    members: torch.Tensor   # (S_max, k) i32 member slots
    m_seen: torch.Tensor    # () f32 max singleton gain seen
    lb: torch.Tensor        # () f32 best-value lower bound (pp only)
    evals: torch.Tensor     # () i32 engine-boundary evaluation count


def make_spec(k: int, eps: float, variant: str,
              s_max: Optional[int] = None,
              backend: str = "torch",
              fn: FnSpec = FnSpec()) -> SieveSpec:
    if variant not in VARIANTS:
        raise ValueError(f"unknown sieve variant {variant!r}; one of {VARIANTS}")
    if k < 1:
        raise ValueError(f"sieve streaming needs k >= 1, got k={k}")
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must lie in (0, 1), got {eps}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown sieve backend {backend!r}; 'torch' or 'cuda'")
    if fn.name not in fx.SIEVE_ELIGIBLE:
        raise ValueError(
            f"function {fn.name!r} is not sieve-streamable — threshold "
            f"sieves need monotone gains from the cache rows alone; "
            f"eligible: {sorted(fx.SIEVE_ELIGIBLE)}")
    if backend != "torch" and fx.kernel_template(fn) is None:
        # no kernel form (saturated coverage's capped gain): the step scores
        # through the torch protocol path, as the selection engine does
        backend = "torch"
    cap = s_max if s_max is not None else default_capacity(k, eps, variant)
    width = grid_width_bound(k, eps)
    if cap < width + 2:
        raise ValueError(
            f"s_max={cap} cannot hold the live threshold window "
            f"(width ≤ {width}, +2 slack required)")
    return SieveSpec(k, float(eps), int(cap), variant,
                     float(np.float32(np.log1p(np.float32(eps)))), backend,
                     fn)


def grid_width_bound(k: int, eps: float) -> int:
    """Max #live exponents in [⌈log m/L⌉, ⌊log 2km/L⌋]: ⌊log(2k)/L⌋ + 1."""
    return int(math.floor(math.log(2 * k) / math.log1p(eps))) + 1


def default_capacity(k: int, eps: float, variant: str) -> int:
    """Slot capacity: the live-window bound plus slack; Salsa's grow-only
    grid gets headroom for a 16x max-singleton drift before the capacity
    eviction rule starts firing."""
    cap = grid_width_bound(k, eps) + 2
    if variant == "salsa":
        cap += int(math.ceil(math.log(16.0) / math.log1p(eps)))
    return max(cap, 4)


def init_state(n: int, spec: SieveSpec, device, batch: Sequence[int] = ()
               ) -> SieveState:
    """Zeroed table (with a leading ``batch`` shape for the batched engine).
    Cache rows are dead until a slot's first claim resets them to the
    function's seed, so the init value never reaches a live gain."""
    S, k, b = spec.s_max, spec.k, tuple(batch)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SieveState(
        caches=torch.zeros((*b, S, n), **f32),
        slot_exp=torch.full((*b, S), _EXP_UNSET, **i32),
        active=torch.zeros((*b, S), dtype=torch.bool, device=device),
        sizes=torch.zeros((*b, S), **i32),
        members=torch.full((*b, S, k), -1, **i32),
        m_seen=torch.zeros(b, **f32),
        lb=torch.zeros(b, **f32),
        evals=torch.zeros(b, **i32),
    )


class StepConsts(NamedTuple):
    """Device constants of the element step. The divisors are tensors so
    that every division is a true fp32 division on every device (PyTorch's
    CUDA division by a host scalar multiplies by its reciprocal)."""

    L: torch.Tensor       # () f32 log1p(eps), exactly spec.log1p_eps
    k: torch.Tensor       # () f32 k
    slots: torch.Tensor   # (S_max,) i32 slot numbers
    ranks: torch.Tensor   # (k,) i32 member positions
    seed: torch.Tensor    # (n,) f32 the function's empty-set cache row
    row_aux: torch.Tensor  # (n,) f32 static per-row auxiliary (caps)
    v0: torch.Tensor      # () f32 empty-set baseline (mean of seed stats)


def step_consts(f, spec: SieveSpec) -> StepConsts:
    dev = f.device
    seed = f.cache_seed.to(torch.float32)
    aux = f.row_aux.to(torch.float32)
    return StepConsts(
        L=torch.tensor(spec.log1p_eps, dtype=torch.float32, device=dev),
        k=torch.tensor(float(spec.k), dtype=torch.float32, device=dev),
        slots=torch.arange(spec.s_max, dtype=torch.int32, device=dev),
        ranks=torch.arange(spec.k, dtype=torch.int32, device=dev),
        seed=seed, row_aux=aux,
        v0=torch.mean(fx.stat_rows(spec.fn, seed, aux)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


def _mean_rows(M: torch.Tensor) -> torch.Tensor:
    """Trailing-axis means of (rows, n), or of (P, rows, n) partition by
    partition: ATen picks a reduction's split and order from its operand's
    shape and alignment, so each partition is reduced at its standalone
    engine's shape, from an aligned base, and gets that engine's bits."""
    if M.ndim < 3:
        return torch.mean(M, dim=-1)
    return torch.stack([torch.mean(_aligned(M[p]), dim=-1)
                        for p in range(M.shape[0])])


def table_values(caches: torch.Tensor, c: StepConsts, fn: FnSpec,
                 mean_rows=_mean_rows) -> torch.Tensor:
    """Per-sieve f-values of (…, S_max, n) cache rows — shared by the
    element step and every engine's ``best``, so equal caches give
    bit-equal values. ``mean_rows`` is the row mean (the sharded engine's
    sums its shards' partials)."""
    return fx.value_from_stat(fn, c.v0,
                              mean_rows(fx.stat_rows(fn, caches, c.row_aux)))


def _element_step(spec: SieveSpec, c: StepConsts, state: SieveState, idx,
                  dvec, valid, *, mean_rows=_mean_rows, shard_sums=None):
    """The per-element sieve-table transition — ONE definition.

    ``idx`` (…,) i32 stream ids, ``dvec`` (…, n) f32 distance rows,
    ``valid`` (…,) bool, with … = () for one table and (P,) for the batched
    engine's P tables. ``valid=False`` makes the step a no-op. The table
    ``state.caches`` is updated IN PLACE (the reference donates it to its
    scan; here the claim reset and the fold write into the one (S_max, n)
    buffer instead of allocating a new table each step); the small fields
    are rebound. Returns ``(new_state, accepted_anywhere (…,))``. Makes no
    host read.

    The step's reductions over the ground-set axis are injectable, so the
    mesh-sharded engine runs this transition on (S_max, n/p) column shards.
    ``shard_sums(caches, dvec, c) -> (single, gains_pre, stats_pre)`` takes
    the step's first reductions in one collective: the gains of the seed
    and of the pre-rebuild table, and the table's stat-row means (None for
    Salsa, which reads no values). A claimed slot's cache is the seed, so
    its gain is ``single`` and its stat mean is ``c.v0``. ``mean_rows(M)``
    is the trailing-axis mean of ++'s post-fold values. Everything else is
    O(S_max) state.
    """
    k = spec.k
    fn = spec.fn
    caches, slot_exp, active, sizes, members, m_seen, lb, evals = state
    seed = c.seed

    # singleton gain Δ(e | ∅) — the grid anchor m = max singleton seen. The
    # cuda backend scores the seed and the table in ONE kernel launch up
    # front: output row 0 is the seed (the empty-set cache, whose gain IS
    # the singleton; the kernel reads it through its own pointer, so the
    # table is never copied to put it in front), rows 1: are the
    # pre-rebuild sieve caches. A slot the rebuild below claims is reset to
    # exactly the seed, so its post-rebuild gain is the singleton —
    # ``where(claim, single, ...)`` recovers the post-rebuild gains without
    # a second launch.
    use_kernel = spec.backend != "torch"
    stats_pre = None
    if shard_sums is not None:
        single, gains_pre, stats_pre = shard_sums(caches, dvec, c)
    elif use_kernel:
        from repro_torch.kernels import ops as kops

        fold, affine = fx.kernel_template(fn)
        gains_of = kops.sieve_gains_batched if caches.ndim == 3 \
            else kops.sieve_gains
        g_all = gains_of(caches, dvec, seed=seed, fold=fold,
                         score_affine=affine)
        single, gains_pre = g_all[..., 0], g_all[..., 1:]
    else:
        single = _mean_rows(
            fx.sieve_gain_rows(fn, seed[None, :], dvec, c.row_aux))[..., 0]
    new_max = valid & (single > m_seen)
    m_seen = torch.where(new_max, single, m_seen)

    # grid rebuild: SieveStreaming/Salsa rebuild only on a new max; ++
    # re-derives its window every element because LB moves after accepts.
    # fp32 throughout, in the reference's order: log, true division, ceil.
    if spec.variant == "pp":
        rebuild = valid & (m_seen > 0.0)
        lo = torch.maximum(lb, m_seen)
    else:
        rebuild = new_max
        lo = m_seen
    tiny = 1e-38  # log(0) guard; rebuild is False while m = 0
    i_lo = torch.ceil(torch.log(torch.clamp_min(lo, tiny)) / c.L
                      ).to(torch.int32)
    i_hi = torch.floor(torch.log(torch.clamp_min(2.0 * k * m_seen, tiny))
                       / c.L).to(torch.int32)

    # masked activation: exponent i lives in slot i mod S_max; a slot whose
    # assigned exponent changed is reset, one whose exponent survives keeps
    # its cache/members (the host rebuild's keep-and-add, shape-statically)
    i_lo1 = i_lo.unsqueeze(-1)
    wanted_exp = i_lo1 + torch.remainder(c.slots - i_lo1, spec.s_max)
    wanted = wanted_exp <= i_hi.unsqueeze(-1)
    rebuild1 = rebuild.unsqueeze(-1)
    claim = rebuild1 & wanted & ((slot_exp != wanted_exp) | ~active)
    if spec.variant == "sieve":
        active = torch.where(rebuild1, wanted, active)    # window replaces
    elif spec.variant == "salsa":
        active = active | (rebuild1 & wanted)             # grow-only
    else:  # pp: LB prune τ ≥ lo/(1+ε) ⇔ i ≥ i_lo − 1, then activation
        active = torch.where(rebuild1, active & (slot_exp >= i_lo1 - 1),
                             active)
        active = active | claim
    slot_exp = torch.where(claim, wanted_exp, slot_exp)
    torch.where(claim.unsqueeze(-1), seed, caches, out=caches)
    sizes = torch.where(claim, 0, sizes)
    members = torch.where(claim.unsqueeze(-1), -1, members)

    # offer to every sieve: marginal gain vs each (post-rebuild) cache, one
    # accept rule
    if use_kernel or shard_sums is not None:
        gains = torch.where(claim, single.unsqueeze(-1), gains_pre)
    else:
        gains = _mean_rows(fx.sieve_gain_rows(fn, caches, dvec, c.row_aux))
    taus = torch.exp(slot_exp.to(torch.float32) * c.L)
    if spec.variant == "salsa":
        # dense-threshold schedule: rate 1/2 for the first ⌈k/2⌉ members,
        # 1/(2e) after — (k+1)//2, so k=1 still gets the early rate
        rate = torch.where(sizes < (k + 1) // 2, 0.5, 1.0 / (2.0 * math.e))
        need = rate * taus / c.k
    else:
        if stats_pre is None:
            values = table_values(caches, c, fn)
        else:
            values = fx.value_from_stat(fn, c.v0,
                                        torch.where(claim, c.v0, stats_pre))
        need = (taus / 2.0 - values) / torch.clamp_min(k - sizes, 1)
    accept = valid.unsqueeze(-1) & active & (sizes < k) & (gains >= need)
    fx.sieve_fold_rows(fn, caches, dvec, accept, out=caches)
    members = torch.where(
        accept.unsqueeze(-1) & (c.ranks == sizes.unsqueeze(-1)),
        idx.unsqueeze(-1).unsqueeze(-1), members)
    sizes = sizes + accept.to(torch.int32)
    if spec.variant == "pp":
        vals_new = table_values(caches, c, fn, mean_rows)
        lb = torch.maximum(lb, torch.amax(
            torch.where(active, vals_new, -math.inf), dim=-1))

    # engine-boundary accounting: one engine call scores the element against
    # every live sieve (min. 1 — the singleton gain is always computed)
    n_active = torch.sum(active, dim=-1).to(torch.int32)
    evals = evals + torch.where(valid, torch.clamp_min(n_active, 1), 0)
    state = SieveState(caches, slot_exp, active, sizes, members, m_seen, lb,
                       evals)
    return state, torch.any(accept, dim=-1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class _EngineIO:
    """What every sieve engine shares: configuration checks, stream-id
    validation, host→device staging, the distance product, and the bound
    on blocks enqueued and unread.

    ``offer`` chunks the payload to ``block_size`` and pads ragged tails, so
    every plan runs the distance product at the one (block_size, n) shape —
    the bitwise-parity invariant is structural. Host payloads are staged in
    pinned memory and copied with ``non_blocking=True``.

    ``overlap=True`` (the default) reads nothing back until the end of
    ``offer``: the accept masks of all blocks are read in one copy after the
    last block is enqueued, and the evaluation counter is folded lazily at
    ``evaluations``. ``max_in_flight`` bounds how many blocks may be
    enqueued and unread: past it, ``offer`` waits on the oldest block's CUDA
    event. Every kernel runs on the calling thread's current stream, so
    this bounds the queue; it overlaps no copy with compute. ``overlap=False``
    reads each block's mask and folds its evaluations before the next.
    """

    _I32 = np.iinfo(np.int32)

    def __init__(self, f, spec: SieveSpec, block_size: int, overlap: bool,
                 max_in_flight: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.f = f
        self.spec = spec
        self.block_size = block_size
        self.overlap = overlap
        self.max_in_flight = max_in_flight
        self.device = f.device
        self._c = self._step_consts()

    def _step_consts(self) -> StepConsts:
        return step_consts(self.f, self.spec)

    def _validate_ids(self, idx) -> np.ndarray:
        """Stream ids live in the int32 member table; ids outside its range
        (the service's unbounded counter can exceed it on long-lived
        streams) must raise, not silently wrap into colliding member ids."""
        idx = np.atleast_1d(np.asarray(idx))
        if idx.size and (int(idx.max()) > self._I32.max
                         or int(idx.min()) < self._I32.min):
            raise OverflowError(
                f"stream ids must fit the int32 member table "
                f"([{self._I32.min}, {self._I32.max}]); got range "
                f"[{int(idx.min())}, {int(idx.max())}]")
        return idx.astype(np.int32)

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: through pinned memory with a
        non-blocking copy on a CUDA device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage_block(self, Xb, nb: int) -> torch.Tensor:
        """Pad one block to ``block_size`` rows on its way to the device."""
        B = self.block_size
        if isinstance(Xb, np.ndarray):
            Xp = np.zeros((B, Xb.shape[1]), np.float32)
            Xp[:nb] = Xb
            return self._stage(Xp)
        Xb = Xb.to(self.device)
        return torch.cat([Xb, Xb.new_zeros((B - nb, Xb.shape[1]))])

    def _distance_rows(self, X) -> torch.Tensor:
        # every plan consumes rows from the same product at the same shape —
        # host and device decisions see bitwise-identical distances
        return self.f.point_distances_block(X).to(torch.float32)

    def _enqueued(self, inflight: list) -> None:
        """Record the block just enqueued; past ``max_in_flight`` unread
        blocks, wait for the oldest (no wait off the card)."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        inflight.append(ev)
        if len(inflight) > self.max_in_flight:
            inflight.pop(0).synchronize()


class _SieveEngineBase(_EngineIO):
    """One sieve table; the plans differ only in :meth:`_consume`."""

    def __init__(self, f, spec: SieveSpec, block_size: int = 64,
                 overlap: bool = True, max_in_flight: int = 4):
        super().__init__(f, spec, block_size, overlap, max_in_flight)
        self._true = torch.ones((), dtype=torch.bool, device=self.device)
        self.state = self._initial_state()
        # device state counts in int32; folding into a Python int at drain
        # points keeps unbounded streams (the service's live-sensor case)
        # exact. Each element adds at most S_max evals, so int32 headroom
        # covers tens of millions of elements between drains.
        self._evals = 0

    def offer(self, idx, X) -> np.ndarray:
        """Offer elements ``X`` (numpy or a tensor, (len(idx), dim)) with
        stream ids ``idx``; returns their accept flags."""
        idx = self._validate_ids(idx)
        if isinstance(X, torch.Tensor):
            X = torch.atleast_2d(X)
        else:
            X = np.atleast_2d(np.asarray(X, np.float32))
        B = self.block_size
        masks: list = []          # per block: its accept mask
        inflight: list = []       # per unread block: its CUDA event
        for s in range(0, len(idx), B):
            ib = idx[s:s + B]
            nb = len(ib)
            dmat = self._distance_rows(self._stage_block(X[s:s + B], nb))
            acc = self._consume(self._stage(ib), dmat, nb)
            if self.overlap:
                masks.append(acc)
                self._enqueued(inflight)
            else:
                masks.append(_host(acc))
                self._fold_evals()
        if not masks:
            return np.zeros(0, bool)
        if self.overlap:
            return _host(torch.cat(masks))
        return np.concatenate(masks)

    def _initial_state(self) -> SieveState:
        return init_state(self.f.n, self.spec, self.device)

    def _values(self) -> torch.Tensor:
        return table_values(self.state.caches, self._c, self.spec.fn)

    def _consume(self, idxs: torch.Tensor, dmat: torch.Tensor, nb: int):
        """Advance the engine by the ``nb`` live elements of one padded
        block; returns their accept mask."""
        raise NotImplementedError

    def _fold_evals(self) -> None:
        """Drain the int32 evaluation counter into the exact Python count.
        A host read — per block only when ``overlap=False``."""
        e = int(self.state.evals)
        if e:
            self._evals += e
            self.state.evals.zero_()

    def evaluations(self) -> int:
        self._fold_evals()
        return self._evals

    def best(self) -> tuple[list[int], float]:
        """Members and value of the best live sieve ([], 0.0 when none)."""
        active = _host(self.state.active)
        if not active.any():
            return [], 0.0
        vals = np.where(active, _host(self._values()), -np.inf)
        b = int(np.argmax(vals))
        size = int(_host(self.state.sizes)[b])
        return [int(i) for i in _host(self.state.members)[b, :size]], \
            float(vals[b])

    def member_ids(self) -> list[int]:
        """Ids present in any live sieve's member table (service retention)."""
        st = self.state
        live = _host(st.active)[:, None] & (
            np.arange(self.spec.k)[None, :] < _host(st.sizes)[:, None])
        return sorted({int(i) for i in _host(st.members)[live]})


class HostSieveMirror(_SieveEngineBase):
    """The exact mirror: the identical :func:`_element_step`, one call per
    element, with its accept flag read back after each — the per-element
    host round trip the device engine removes, and the parity reference
    for it."""

    def _consume(self, idxs, dmat, nb) -> torch.Tensor:
        accepted = np.zeros(nb, bool)
        for b in range(nb):
            self.state, acc = _element_step(self.spec, self._c, self.state,
                                            idxs[b], dmat[b], self._true)
            accepted[b] = bool(acc)
        return torch.from_numpy(accepted)


class DeviceSieveEngine(_SieveEngineBase):
    """Device-resident sieve table: a block's elements run back to back
    with no host read between them (the reference's one scan dispatch per
    block). State never leaves the device between blocks beyond the accept
    masks and the evaluation-counter fold that ``offer`` reads.

    ``mesh`` column-shards the (S_max, n) table — and the cache seed, the
    row auxiliary and each element's distance row — over the mesh's
    ``data_axes`` (:func:`make_sharded_offer_scan`): each rank, running the
    same engine calls on the same stream, holds (S_max, n/p), and the full
    table never exists on any rank. The padded rows carry the function's
    pad sentinels, which add exactly 0 to every sum. ``offer`` and ``best``
    are collectives under a mesh; ``evaluations`` and ``member_ids`` read
    replicated state only."""

    def __init__(self, f, spec: SieveSpec, block_size: int = 64,
                 mesh=None, data_axes: Sequence[str] = ("data",),
                 overlap: bool = True, max_in_flight: int = 4):
        # mesh geometry first: the base constructor asks the hooks for the
        # step constants and the table, which must be born sharded
        self.mesh = mesh
        if mesh is None:
            self._offer_fn = _offer_loop(spec, f.device)
        else:
            from repro_torch.core import distributed

            self._shards = distributed.resolve_mesh(mesh, data_axes)
            self._placed = distributed._placed_sharded(f, self._shards)
            self._mean_rows = _sharded_mean_rows(self._shards, f.n, f.device)
            self._offer_fn = make_sharded_offer_scan(
                self._shards, spec=spec, n_total=f.n, device=f.device)
        super().__init__(f, spec, block_size, overlap=overlap,
                         max_in_flight=max_in_flight)

    def _step_consts(self) -> StepConsts:
        if self.mesh is None:
            return super()._step_consts()
        # this rank's columns of the seed and the auxiliary; the baseline
        # is the global mean of the seed's stat row
        seed, aux = self._placed["seed_sh"], self._placed["aux_sh"]
        return step_consts(self.f, self.spec)._replace(
            seed=seed, row_aux=aux,
            v0=self._mean_rows(fx.stat_rows(self.spec.fn, seed, aux)))

    def _initial_state(self) -> SieveState:
        if self.mesh is None:
            return super()._initial_state()
        return init_state(self._shards.n_loc(self.f.n), self.spec,
                          self.device)

    def _distance_rows(self, X) -> torch.Tensor:
        if self.mesh is None:
            return super()._distance_rows(X)
        # each rank's own columns of the (block_size, n) product: an entry
        # depends on its ground row alone, as in the unsharded product
        return fx._point_distances_block(
            self._placed["V_sh"], X, self.f.cfg.distance,
            self.f.cfg.resolved_policy()).to(torch.float32)

    def _values(self) -> torch.Tensor:
        if self.mesh is None:
            return super()._values()
        # the pad sentinels add exactly 0 to every stat sum, so only the
        # normaliser must be the real n, which the sharded mean divides by
        return table_values(self.state.caches, self._c, self.spec.fn,
                            self._mean_rows)

    def _consume(self, idxs, dmat, nb) -> torch.Tensor:
        self.state, acc = self._offer_fn(self.state, self._c, idxs, dmat, nb)
        return acc


@contract(
    "streaming.offer_scan",
    factory=True,
    launches_per_round={"sieve_gain_eval": 1},
    reuse=("caches",),
    claim="a stream block's elements run back to back with no host sync "
          "and no collective: one sieve kernel launch per element, the "
          "(S_max, n) table updated in place")
def _offer_loop(spec: SieveSpec, device, **hooks):
    """``offer(state, c, idxs, dmat, nb) -> (state, accepted (nb,))``: the
    element step over the ``nb`` live elements of a block, back to back,
    with no host read; ``hooks`` are the step's reductions over n."""
    true = torch.ones((), dtype=torch.bool, device=device)

    def offer(state, c, idxs, dmat, nb):
        accepted = []
        for b in range(nb):
            state, acc = _element_step(spec, c, state, idxs[b], dmat[b], true,
                                       **hooks)
            accepted.append(acc)
        return state, torch.stack(accepted)

    return offer


def _sharded_mean_rows(shards, n_total: int, device):
    """Row means of column-sharded rows: each shard's row sums, added in
    shard order, over the real n."""
    from repro_torch.core import distributed

    n_t = torch.tensor(float(n_total), dtype=torch.float32, device=device)

    def mean_rows(M):
        return distributed.ordered_sum(shards, torch.sum(M, dim=-1)) / n_t

    return mean_rows


@contract(
    "streaming.offer_scan[sharded]",
    factory=True,
    launches_per_round={"sieve_gain_eval": 1},
    collective_kinds=("allgather_",),
    reuse=("caches",),
    claim="no host sync inside a block; each element's gains and stat "
          "sums cross the mesh in ONE all-gather of O(S_max) floats (++: "
          "one more for its post-fold values) — never O(n); the (S_max, "
          "n/p) table shard is updated in place")
def make_sharded_offer_scan(mesh, data_axes: Sequence[str] = ("data",), *,
                            spec: SieveSpec, n_total: int, device):
    """Build the column-sharded engine's block consumer.

    Returns ``offer(state, c, idxs, dmat, nb) -> (state, accepted (nb,))``
    (:func:`_offer_loop`), with ``state.caches`` this rank's (S_max, n/p)
    columns, ``c`` the step constants over this rank's seed and row
    auxiliary (``v0`` the global baseline), and ``dmat`` this rank's
    columns of the block's distance rows. The step's reductions over n
    become shard partials added in shard order. An element's gains (the
    sieve kernel launched on this rank's columns with the global
    ``n_total`` on the ``cuda`` backend, row sums otherwise) and the
    table's stat-row sums travel in ONE collective of O(S_max) floats;
    ++ adds one more for the values after its fold.
    """
    from repro_torch.core import distributed

    shards = distributed.resolve_mesh(mesh, data_axes)
    fn = spec.fn
    n_t = torch.tensor(float(n_total), dtype=torch.float32, device=device)
    want_stats = spec.variant != "salsa"
    kernel = None
    if spec.backend != "torch":
        from repro_torch.kernels import ops as kops

        fold, affine = fx.kernel_template(fn)

        def kernel(caches, dvec, seed):
            return kops.sieve_gains(caches, dvec, seed=seed, n_total=n_total,
                                    fold=fold, score_affine=affine)

    def shard_sums(caches, dvec, c):
        if kernel is not None:
            parts = [kernel(caches, dvec, c.seed)]      # already over n
        else:
            parts = [torch.sum(fx.sieve_gain_rows(
                fn, rows, dvec, c.row_aux), dim=-1)
                for rows in (c.seed[None, :], caches)]
        r = caches.shape[0]
        if want_stats:
            parts.append(torch.sum(fx.stat_rows(fn, caches, c.row_aux),
                                   dim=-1))
        out = distributed.ordered_sum(shards, torch.cat(parts))
        gains = out[:r + 1] if kernel is not None else out[:r + 1] / n_t
        stats = out[r + 1:] / n_t if want_stats else None
        return gains[0], gains[1:], stats

    return _offer_loop(spec, device,
                       mean_rows=_sharded_mean_rows(shards, n_total, device),
                       shard_sums=shard_sums)


class BatchedSieveEngine(_EngineIO):
    """P independent stream partitions advanced together.

    The streaming analogue of ``run_selection_batch``: each partition owns a
    full fixed-capacity sieve table (a (P, …)-batched :class:`SieveState`),
    and one :func:`_element_step` per block row advances all of them — one
    launch of the batched sieve kernel scores all P tables on the ``cuda``
    backend. Every partition's members, values, accept masks and evaluation
    counts are bit for bit those of a standalone :class:`DeviceSieveEngine`
    fed the same sub-stream: the step is elementwise but for its reductions
    over n, which run per partition at the standalone shape (the kernel by
    construction, the means by :func:`_mean_rows`), and each partition's
    distance rows come from the standalone engine's (block_size, n) product.
    """

    def __init__(self, f, spec: SieveSpec, n_streams: int,
                 block_size: int = 64, overlap: bool = True,
                 max_in_flight: int = 4):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        super().__init__(f, spec, block_size, overlap, max_in_flight)
        self.n_streams = int(n_streams)
        self.states = init_state(f.n, spec, self.device,
                                 batch=(self.n_streams,))
        self._evals = np.zeros(self.n_streams, np.int64)

    def offer(self, idx_parts: Sequence, X_parts: Sequence
              ) -> list[np.ndarray]:
        """Offer per-partition element runs (ragged; empty allowed) and
        return per-partition accept masks. Partitions shorter than the
        longest run ride the shared blocks as ``valid=False`` padding."""
        P, B, d = self.n_streams, self.block_size, self.f.dim
        if len(idx_parts) != P or len(X_parts) != P:
            raise ValueError(
                f"expected {P} partition runs, got "
                f"{len(idx_parts)}/{len(X_parts)}")
        idxs = [self._validate_ids(i) for i in idx_parts]
        Xs = [np.asarray(x, np.float32).reshape(-1, d) for x in X_parts]
        for p, (i, x) in enumerate(zip(idxs, Xs)):
            if len(i) != len(x):
                raise ValueError(
                    f"partition {p}: {len(i)} ids vs {len(x)} vectors")
        n_rows = max((len(i) for i in idxs), default=0)
        handles: list = []
        inflight: list = []
        for s in range(0, n_rows, B):
            idxp = np.full((B, P), -1, np.int32)
            valid = np.zeros((B, P), bool)
            nbs = []
            rows = []
            for p in range(P):
                part = idxs[p][s:s + B]
                nb = len(part)
                nbs.append(nb)
                idxp[:nb, p] = part
                valid[:nb, p] = True
                # each partition's rows from the standalone engine's
                # (block_size, n) product: one product over all P·B rows
                # may sum in another order, as cuBLAS picks its algorithm
                # by shape (chip_smoke.py phase 3c measures both); an empty
                # partition's rows are never read
                rows.append(self._distance_rows(
                    self._stage_block(Xs[p][s:s + B], nb)) if nb else
                    torch.zeros((B, self.f.n), device=self.device))
            dmatb = torch.stack(rows, dim=1)           # (B, P, n)
            acc = self._consume(self._stage(idxp), dmatb, self._stage(valid),
                                max(nbs))
            if self.overlap:
                handles.append((acc, nbs))
                self._enqueued(inflight)
            else:
                handles.append((_host(acc), nbs))
                self._fold_evals()
        if self.overlap and handles:    # one read for every block's mask
            flat = _host(torch.cat([acc for acc, _ in handles]))
            ends = np.cumsum([0] + [len(acc) for acc, _ in handles])
            handles = [(flat[ends[j]:ends[j + 1]], nbs)
                       for j, (_, nbs) in enumerate(handles)]
        out: list[list] = [[] for _ in range(P)]
        for a, nbs in handles:             # a: (rows, P)
            for p, nb in enumerate(nbs):
                if nb:
                    out[p].append(a[:nb, p])
        return [np.concatenate(o) if o else np.zeros(0, bool) for o in out]

    def _consume(self, idxp, dmatb, valid, n_rows: int) -> torch.Tensor:
        self.states, acc = _offer_block_batched(self.spec, self._c,
                                                self.states, idxp, dmatb,
                                                valid, n_rows)
        return acc

    def _fold_evals(self) -> None:
        e = _host(self.states.evals)
        if e.any():
            self._evals += e.astype(np.int64)
            self.states.evals.zero_()

    def evaluations(self, p: Optional[int] = None) -> int:
        self._fold_evals()
        return int(self._evals.sum()) if p is None else int(self._evals[p])

    def best_all(self) -> list[tuple[list[int], float]]:
        """Per-partition (members, value) of each best live sieve."""
        active = _host(self.states.active)
        sizes = _host(self.states.sizes)
        members = _host(self.states.members)
        vals = np.where(active, _host(table_values(
            self.states.caches, self._c, self.spec.fn)), -np.inf)
        out = []
        for p in range(self.n_streams):
            if not active[p].any():
                out.append(([], 0.0))
                continue
            b = int(np.argmax(vals[p]))
            size = int(sizes[p, b])
            out.append(([int(i) for i in members[p, b, :size]],
                        float(vals[p][b])))
        return out

    def member_ids(self) -> list[int]:
        """Ids live in any partition's member tables (service retention)."""
        st = self.states
        live = _host(st.active)[:, :, None] & (
            np.arange(self.spec.k)[None, None, :]
            < _host(st.sizes)[:, :, None])
        return sorted({int(i) for i in _host(st.members)[live]})


@contract(
    "streaming.offer_scan_batched",
    launches_per_round={"sieve_gain_eval_batched": 1},
    reuse=("caches",),
    claim="P partitions advance through a block with no host sync: one "
          "launch of the batched sieve kernel per element row scores all P "
          "tables, which are updated in place")
def _offer_block_batched(spec: SieveSpec, c: StepConsts, states: SieveState,
                         idxp, dmatb, valid, n_rows: int):
    """The batched engine's block: ``n_rows`` element rows of P partitions
    (``idxp`` (B, P), ``dmatb`` (B, P, n), ``valid`` (B, P)), back to back
    with no host read. Returns ``(states, accepted (n_rows, P))``."""
    accepted = []
    for b in range(n_rows):
        states, acc = _element_step(spec, c, states, idxp[b], dmatb[b],
                                    valid[b])
        accepted.append(acc)
    return states, torch.stack(accepted)


def _resolve_backend(f, backend: Optional[str]) -> str:
    """``None`` inherits the function's backend: ``"cuda"`` runs the sieve
    kernel, every other evaluation backend the torch reduction."""
    if backend is None:
        return "cuda" if f.cfg.backend == "cuda" else "torch"
    return backend


def make_batched_sieve_engine(f, k: int, eps: float, n_streams: int,
                              variant: str = "sieve",
                              s_max: Optional[int] = None,
                              block_size: int = 64,
                              backend: Optional[str] = None,
                              overlap: bool = True,
                              max_in_flight: int = 4) -> BatchedSieveEngine:
    """Build the P-partition batched sieve engine (see
    :class:`BatchedSieveEngine`). ``backend=None`` inherits ``f.cfg.backend``
    as :func:`make_sieve_engine` does."""
    spec = make_spec(k, eps, variant, s_max,
                     backend=_resolve_backend(f, backend), fn=f.spec)
    return BatchedSieveEngine(f, spec, n_streams, block_size=block_size,
                              overlap=overlap, max_in_flight=max_in_flight)


def make_sieve_engine(f, k: int, eps: float, variant: str = "sieve",
                      mode: str = "device", s_max: Optional[int] = None,
                      block_size: int = 64,
                      backend: Optional[str] = None,
                      mesh=None,
                      data_axes: Sequence[str] = ("data",),
                      overlap: bool = True,
                      max_in_flight: int = 4) -> _SieveEngineBase:
    """Build a sieve engine under an execution plan (``host`` | ``device``).
    The engine streams whatever SIEVE_ELIGIBLE objective ``f`` carries
    (``f.spec``); ineligible functions raise at construction. Both plans
    take ``block_size``: it shapes the (padded) distance product, so host
    and device engines built with the same value compute the same rows.

    ``backend`` picks the element step's scoring path (``None`` inherits
    ``f.cfg.backend``): ``"cuda"`` runs the sieve kernel under the
    function's min/max template instead of the torch reduction — in BOTH
    plans, so parity stays structural. A function with no kernel template
    scores through torch.

    ``mesh`` (or ``mode="device_sharded"``, whose default is a 1-D mesh
    over the default process group) column-shards the sieve table over
    ``data_axes``: see :class:`DeviceSieveEngine`. Every rank builds the
    engine and feeds it the same stream. The host mirror is the
    per-element reference and takes no mesh.
    """
    spec = make_spec(k, eps, variant, s_max,
                     backend=_resolve_backend(f, backend), fn=f.spec)
    if mode == "host":
        if mesh is not None:
            raise ValueError(
                "the host mirror is the per-element reference; it does not "
                "take a mesh")
        return HostSieveMirror(f, spec, block_size=block_size,
                               overlap=overlap, max_in_flight=max_in_flight)
    if mode == "device_sharded":
        from repro_torch.core import distributed

        mesh = distributed.resolve_mesh(mesh, data_axes)
        mode = "device"
    if mode == "device":
        return DeviceSieveEngine(f, spec, block_size=block_size, mesh=mesh,
                                 data_axes=data_axes, overlap=overlap,
                                 max_in_flight=max_in_flight)
    raise ValueError(f"unknown streaming mode {mode!r}; 'host', 'device' "
                     f"or 'device_sharded'")
