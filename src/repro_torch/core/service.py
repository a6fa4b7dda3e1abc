"""Serving surfaces: streaming ingestion and batched selection requests.

* :class:`StreamIngestionService` — queue in, exemplars out, over the
  device-resident sieve engine (:mod:`repro_torch.core.streaming`).
* :class:`MultiStreamIngestionService` — P logical streams behind one
  batched sieve engine, with a two-tier merge that carries a certified
  bound.
* :class:`SelectionService` — many concurrent *selection* requests (each
  its own (V, k) problem), bucketed by signature and solved B-at-a-time
  through :func:`repro_torch.core.engine.run_selection_batch` — one batched
  dispatch per bucket, per-request demux, results identical to the
  unbatched engine.

The companion Industry 4.0 deployment (Honysz et al., 2021) runs the sieve
family against live sensor streams; the ingestion services are that serving
surface. Producers ``offer`` arbitrary vectors (not ground-set indices — the
ground set V is the fixed *evaluation* reference the submodular function
scores against); a single worker drains the queue in blocks and feeds the
engine; consumers ``snapshot`` the current best sieve at any point of the
stream. Flow control:

* **Offer batching** — the worker takes whatever is queued (up to
  ``block_size``) per engine offer, so a burst of producers amortizes to
  one block while a trickle still gets per-element latency. Block
  boundaries cannot change results: sieve decisions are per-element
  sequential regardless of blocking.
* **Backpressure** — a semaphore bounds pending elements at
  ``max_pending``; ``offer`` awaits when the engine falls behind.
* **Snapshot consistency** — engine access is serialized by a lock shared
  between the worker and ``snapshot``, so a snapshot always observes a
  block-aligned engine state (never a half-applied block).

The engines are synchronous PyTorch; their work runs in a thread
(``asyncio.to_thread``) so the event loop keeps accepting offers and
requests while the device works. Kernels launch on the calling thread's
current CUDA stream; no thread here picks another stream, so every
dispatch goes to the default stream, one after the other. Each selection
bucket's payload is built inline, just before its dispatch (overlapping it
with the previous dispatch needs a second stream, and is later work).
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.analysis.contracts import contract
from repro_torch.core.engine import OptResult
from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import FUNCTIONS, SubmodularFunction
from repro_torch.core.multiset import resolve_device
from repro_torch.core.streaming import make_batched_sieve_engine, make_sieve_engine


@dataclasses.dataclass
class SieveSnapshot:
    """Point-in-time view of the service's best sieve."""

    indices: list[int]      #: stream ids of the best sieve's members
    exemplars: np.ndarray   #: their vectors, (len(indices), dim)
    value: float            #: f-value of the best sieve
    n_offered: int          #: elements accepted into the queue so far
    n_ingested: int         #: elements the engine has consumed
    n_accepted: int         #: elements accepted by at least one sieve
    evaluations: int        #: engine-boundary evaluation count
    pending: int            #: elements still queued (backpressure depth)


class StreamIngestionService:
    """Async wrapper turning the sieve engine into a serving surface.

    Use as an async context manager::

        async with StreamIngestionService(f, k=8) as svc:
            for x in stream:
                await svc.offer(x)          # backpressure-aware
            snap = await svc.snapshot()     # current best exemplars

    The engine runs where ``f`` lives: a function built from numpy goes to
    ``"cuda"`` unless its caller named another device. Stream ids are
    assigned in ``offer`` order and are the ``indices`` the snapshot
    reports; the service retains accepted elements' vectors (pruned to the
    live member tables at snapshot time) so exemplars can be returned for
    elements that are not ground-set rows.

    ``mesh`` / ``mode="device_sharded"`` wrap the column-sharded engine
    (:class:`~repro_torch.core.streaming.DeviceSieveEngine`): every rank
    runs a service and offers the same elements in the same order. A
    snapshot is then a collective, so it first drains the queue: every rank
    takes it at the end of what it was offered.
    """

    def __init__(self, f: SubmodularFunction, k: int, eps: float = 0.1,
                 variant: str = "sieve", mode: str = "device",
                 block_size: int = 64, s_max: Optional[int] = None,
                 max_pending: int = 1024, mesh=None,
                 data_axes: Sequence[str] = ("data",), overlap: bool = True):
        self._engine = make_sieve_engine(f, k, eps, variant=variant,
                                         mode=mode, s_max=s_max,
                                         block_size=block_size, mesh=mesh,
                                         data_axes=data_axes, overlap=overlap)
        self._sharded = getattr(self._engine, "mesh", None) is not None
        self._dim = f.dim
        self._block = block_size
        self._max_pending = max_pending
        self._ids = itertools.count()
        self._vecs: dict[int, np.ndarray] = {}
        self._n_offered = 0
        self._n_ingested = 0
        self._n_accepted = 0
        self._queue: Optional[asyncio.Queue] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._lock: Optional[asyncio.Lock] = None
        self._task: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "StreamIngestionService":
        if self._task is not None:
            raise RuntimeError("service already started")
        # Backpressure lives in the semaphore, not the queue: ``offer``
        # suspends on acquire() BEFORE any state is touched, so a producer
        # cancelled mid-wait leaves no assigned id and no counter bump.
        self._queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(self._max_pending)
        self._lock = asyncio.Lock()
        self._task = asyncio.create_task(self._worker())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` ingests queued elements first."""
        if self._task is None:
            return
        try:
            if drain:
                await self.drain()
        finally:  # a failed worker must still be cancelled, not leaked
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    async def __aenter__(self) -> "StreamIngestionService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    def _check(self):
        if self._task is None:
            raise RuntimeError("service not started (use 'async with' or "
                               "await start())")
        if self._error is not None:
            raise RuntimeError("ingestion worker failed") from self._error

    # -- producer side -------------------------------------------------------

    async def offer(self, x) -> int:
        """Enqueue one element; awaits (backpressure) while ``max_pending``
        elements are queued. Returns the assigned stream id."""
        self._check()
        x = np.asarray(x, np.float32).reshape(self._dim)
        await self._sem.acquire()   # only suspension point — see start()
        i = next(self._ids)
        self._n_offered += 1
        self._queue.put_nowait((i, x))
        return i

    async def offer_batch(self, X) -> list[int]:
        return [await self.offer(x) for x in np.asarray(X, np.float32)]

    async def drain(self) -> None:
        """Wait until every queued element has been ingested."""
        self._check()
        await self._queue.join()
        self._check()

    # -- consumer side -------------------------------------------------------

    async def snapshot(self) -> SieveSnapshot:
        """Best sieve right now — members, vectors, value, flow counters.

        Valid while running and after ``stop`` (the engine state persists)."""
        if self._lock is None:
            raise RuntimeError("service was never started")
        if self._error is not None:
            raise RuntimeError("ingestion worker failed") from self._error
        if self._sharded and self._task is not None:
            await self.drain()
        async with self._lock:
            # Read, prune and gather in ONE thread hop while holding the
            # engine lock: the live-member set, the retention map and the
            # flow counters are all observed against the same block-aligned
            # engine state (pruning outside the lock could delete a vector
            # that a concurrent block just accepted).
            (members, value, evals, exemplars, offered, ingested,
             accepted) = await asyncio.to_thread(self._snapshot_sync)
        return SieveSnapshot(
            indices=members, exemplars=exemplars, value=value,
            n_offered=offered, n_ingested=ingested,
            n_accepted=accepted, evaluations=evals,
            pending=self._queue.qsize())

    def _snapshot_sync(self):
        """Consistent read of engine + retention state (runs in a thread,
        under the engine lock)."""
        members, value = self._engine.best()
        keep = set(self._engine.member_ids())
        self._vecs = {i: v for i, v in self._vecs.items() if i in keep}
        exemplars = (np.stack([self._vecs[i] for i in members])
                     if members else np.zeros((0, self._dim), np.float32))
        return (members, value, self._engine.evaluations(), exemplars,
                self._n_offered, self._n_ingested, self._n_accepted)

    # -- worker --------------------------------------------------------------

    async def _worker(self) -> None:
        while True:
            batch = [await self._queue.get()]
            while len(batch) < self._block:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                if self._error is None:  # after a failure: drain-only, so
                    async with self._lock:  # join() completes, _check raises
                        # ONE thread hop covers engine mutation AND the
                        # retention-map/counter writes: a cancelled
                        # to_thread await still runs its thread to the end,
                        # so the engine cannot hold accepted members whose
                        # vectors were never retained.
                        await asyncio.to_thread(self._ingest, batch)
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # surface on the next offer/drain
                self._error = e
            finally:
                for _ in batch:
                    self._queue.task_done()
                    self._sem.release()

    def _ingest(self, batch) -> None:
        """Synchronous block ingest: engine offer + retention, one atomic
        unit with respect to both the engine lock and task cancellation."""
        ids = np.fromiter((i for i, _ in batch), np.int64, len(batch))
        X = np.stack([x for _, x in batch])
        accepted = self._engine.offer(ids, X)
        for (i, x), acc in zip(batch, accepted):
            if acc:
                self._vecs[i] = x
                self._n_accepted += 1
        self._n_ingested += len(batch)


# ---------------------------------------------------------------------------
# Multi-stream ingestion: P partitions, one batched engine, two-tier merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiStreamSnapshot:
    """Point-in-time view across all stream partitions plus the merge tier.

    ``indices``/``exemplars``/``value`` describe the MERGED selection — the
    per-partition exemplar sets re-streamed through a second sieve
    (SieveStreaming composability: each partition's member set is a subset
    of the merge stream with ≤ k elements, so the merged sieve's
    (1/2−ε)·OPT guarantee over the union implies
    ``value ≥ (1/2−ε)·max_p stream_values[p]`` — the runtime certificate
    ``certified`` checks, with ``bound`` the certified floor).
    """

    indices: list[int]          #: merged best members (global stream ids)
    exemplars: np.ndarray       #: their vectors, (len(indices), dim)
    value: float                #: f-value of the merged best sieve
    stream_values: list[float]  #: per-partition best-sieve values
    stream_members: list[list[int]]  #: per-partition best-sieve members
    bound: float                #: (1/2−ε)·max_p stream_values[p]
    certified: bool             #: value ≥ bound (float32 tolerance)
    n_offered: int
    n_ingested: int
    n_accepted: int
    evaluations: int            #: partition-engine evals (merge excluded)
    pending: int


class MultiStreamIngestionService:
    """Many concurrent stream partitions behind ONE batched sieve engine.

    Producers ``offer(x, stream=p)`` into P independent logical streams
    (omitting ``stream`` round-robins by assigned id); a single worker
    drains the shared queue, groups elements by partition, and advances ALL
    partitions' sieve tables with one
    :class:`repro_torch.core.streaming.BatchedSieveEngine` step per block
    row. ``snapshot`` reports each partition's best sieve AND a two-tier
    merge: the per-partition exemplars re-streamed through a second sieve,
    with the certified ``(1/2−ε)``-composed bound (see
    :class:`MultiStreamSnapshot`).

    Concurrency discipline is :class:`StreamIngestionService`'s: semaphore
    backpressure with atomic id assignment, one thread hop per ingest
    (engine mutation + retention writes cancellation-atomic), snapshots
    reading engine + retention state under the lock. The engine runs where
    ``f`` lives.
    """

    def __init__(self, f: SubmodularFunction, k: int, n_streams: int,
                 eps: float = 0.1, variant: str = "sieve",
                 block_size: int = 32, s_max: Optional[int] = None,
                 max_pending: int = 4096, overlap: bool = True):
        self._engine = make_batched_sieve_engine(
            f, k, eps, n_streams, variant=variant, s_max=s_max,
            block_size=block_size, overlap=overlap)
        self._f = f
        self._k = k
        self._eps = float(eps)
        self._variant = variant
        self._dim = f.dim
        self._P = int(n_streams)
        self._block = block_size
        self._max_pending = max_pending
        self._ids = itertools.count()
        self._vecs: dict[int, np.ndarray] = {}
        self._n_offered = 0
        self._n_ingested = 0
        self._n_accepted = 0
        #: block size of the merge tier's single-stream sieve
        self._merge_block = 32
        self._queue: Optional[asyncio.Queue] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._lock: Optional[asyncio.Lock] = None
        self._task: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "MultiStreamIngestionService":
        if self._task is not None:
            raise RuntimeError("service already started")
        self._queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(self._max_pending)
        self._lock = asyncio.Lock()
        self._task = asyncio.create_task(self._worker())
        return self

    async def stop(self, drain: bool = True) -> None:
        if self._task is None:
            return
        try:
            if drain:
                await self.drain()
        finally:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    async def __aenter__(self) -> "MultiStreamIngestionService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    def _check(self):
        if self._task is None:
            raise RuntimeError("service not started (use 'async with' or "
                               "await start())")
        if self._error is not None:
            raise RuntimeError("ingestion worker failed") from self._error

    # -- producer side -------------------------------------------------------

    async def offer(self, x, stream: Optional[int] = None) -> int:
        """Enqueue one element into partition ``stream`` (default:
        round-robin by assigned id). Returns the global stream id."""
        self._check()
        x = np.asarray(x, np.float32).reshape(self._dim)
        if stream is not None and not 0 <= stream < self._P:
            raise ValueError(
                f"stream must lie in [0, {self._P}), got {stream}")
        await self._sem.acquire()   # only suspension point (see offer above)
        i = next(self._ids)
        self._n_offered += 1
        p = i % self._P if stream is None else int(stream)
        self._queue.put_nowait((p, i, x))
        return i

    async def drain(self) -> None:
        self._check()
        await self._queue.join()
        self._check()

    # -- consumer side -------------------------------------------------------

    async def snapshot(self) -> MultiStreamSnapshot:
        """Per-partition bests + the two-tier merged selection, consistent
        against one block-aligned engine state."""
        if self._lock is None:
            raise RuntimeError("service was never started")
        if self._error is not None:
            raise RuntimeError("ingestion worker failed") from self._error
        async with self._lock:
            snap = await asyncio.to_thread(self._snapshot_sync)
        snap.pending = self._queue.qsize()
        return snap

    def _snapshot_sync(self) -> MultiStreamSnapshot:
        bests = self._engine.best_all()
        keep = set(self._engine.member_ids())
        self._vecs = {i: v for i, v in self._vecs.items() if i in keep}
        evals = self._engine.evaluations()
        merged, value = self._merge(bests)
        exemplars = (np.stack([self._vecs[i] for i in merged])
                     if merged else np.zeros((0, self._dim), np.float32))
        peak = max((v for _, v in bests), default=0.0)
        bound = (0.5 - self._eps) * peak
        tol = 1e-5 * max(abs(value), abs(bound), 1e-30)
        return MultiStreamSnapshot(
            indices=merged, exemplars=exemplars, value=value,
            stream_values=[v for _, v in bests],
            stream_members=[m for m, _ in bests],
            bound=bound, certified=bool(value >= bound - tol),
            n_offered=self._n_offered, n_ingested=self._n_ingested,
            n_accepted=self._n_accepted, evaluations=evals, pending=0)

    def _merge(self, bests) -> tuple[list[int], float]:
        """Two-tier merge: stream the union of per-partition exemplars
        through a second sieve. Every partition's member set is ≤ k elements
        of the merge stream, so SieveStreaming's (1/2−ε)·OPT guarantee over
        the union certifies value ≥ (1/2−ε)·max_p value_p at runtime."""
        ids = [i for members, _ in bests for i in members]
        if not ids:
            return [], 0.0
        vecs = np.stack([self._vecs[i] for i in ids])
        eng = make_sieve_engine(
            self._f, self._k, self._eps, variant=self._variant,
            mode="device", block_size=self._merge_block, overlap=False)
        eng.offer(np.asarray(ids, np.int64), vecs)
        return eng.best()

    # -- worker --------------------------------------------------------------

    async def _worker(self) -> None:
        budget = self._P * self._block
        while True:
            batch = [await self._queue.get()]
            while len(batch) < budget:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                if self._error is None:
                    async with self._lock:
                        await asyncio.to_thread(self._ingest, batch)
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                self._error = e
            finally:
                for _ in batch:
                    self._queue.task_done()
                    self._sem.release()

    def _ingest(self, batch) -> None:
        """Group the drained batch by partition and advance ALL partitions
        with the batched engine. Runs in a thread under the lock —
        cancellation-atomic like the single-stream service's ingest."""
        parts: list[list] = [[] for _ in range(self._P)]
        for p, i, x in batch:
            parts[p].append((i, x))
        idxs = [np.asarray([i for i, _ in part], np.int64)
                for part in parts]
        Xs = [np.stack([x for _, x in part]) if part
              else np.zeros((0, self._dim), np.float32) for part in parts]
        masks = self._engine.offer(idxs, Xs)
        for p in range(self._P):
            for (i, x), acc in zip(parts[p], masks[p]):
                if acc:
                    self._vecs[i] = x
                    self._n_accepted += 1
        self._n_ingested += len(batch)


# ---------------------------------------------------------------------------
# Batched selection serving
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _stochastic_samples(n: int, k: int, eps: float, seed: int) -> np.ndarray:
    """Per-round candidate samples, bit-identical to
    :func:`repro_torch.core.optimizers.stochastic_greedy`'s draw so a served
    stochastic request returns exactly what the direct call would."""
    rng = np.random.default_rng(seed)
    m = min(n, int(math.ceil(n / k * math.log(1.0 / eps))))
    m_draw = min(n, m + k)
    return np.stack(
        [rng.choice(n, size=m_draw, replace=False) for _ in range(k)])


@dataclasses.dataclass
class _SelectionRequest:
    """One queued tenant request plus the future its result resolves."""

    X: np.ndarray           #: (n, d) ground set, float32
    k: int
    fn: str
    params: tuple           #: sorted (name, value) extra function kwargs
    kind: str               #: "dense" | "stochastic" | "lazy"
    seed: int               #: stochastic sampling seed (per request)
    eps: float              #: stochastic sampling rate
    top_b: int              #: lazy re-score width
    future: asyncio.Future = dataclasses.field(repr=False)

    def signature(self) -> tuple:
        """Bucket key — requests sharing it can ride one batched dispatch.

        Dense and lazy bucket by ``next_pow2(k)`` (the round count is padded
        up and ragged k is masked per request), so k=3 and k=4 tenants share
        a bucket. Stochastic buckets by EXACT (k, eps): the per-round sample
        width m depends on both. Seeds do NOT enter the key — samples are
        per-request payload, not signature.
        """
        n, d = self.X.shape
        if self.kind == "stochastic":
            k_sig: tuple = ("exact", self.k, self.eps)
        else:
            k_sig = ("pow2", _next_pow2(self.k))
        return (n, d, self.fn, self.params, self.kind, k_sig, self.top_b)


class SelectionService:
    """Multi-tenant selection front end: many concurrent (V, k) requests,
    one batched engine dispatch per signature bucket.

    Use as an async context manager::

        async with SelectionService(cfg, max_batch=64) as svc:
            results = await asyncio.gather(
                *[svc.submit(X_t, k=4) for X_t in tenants])

    Request lifecycle: ``submit`` validates and enqueues (awaiting while the
    bounded queue is full — backpressure), the worker drains whatever is
    queued, groups requests by signature (:meth:`_SelectionRequest.\
signature`), runs ONE :func:`repro_torch.core.engine.\
run_selection_batch` per bucket, at the bucket's own batch size, in a
    thread, and demuxes per-request
    :class:`~repro_torch.core.engine.OptResult` s back through the futures.
    Results are identical to per-request ``run_selection`` /
    ``stochastic_greedy`` calls — batching changes throughput, not output.

    Unlike the reference, the service does not pad a bucket's batch up to
    a power of two: the padding served the reference's jit cache, and here
    it would only add kernel work. Dense and lazy requests still pool k up
    to a power of two (the signature), which is what lets tenants with
    different k share a bucket.

    ``device`` is where the tenants' ground sets go: ``"cuda"`` unless the
    caller names another (with no GPU and no device this raises).

    ``plan`` / ``mesh`` / ``data_axes``: on ``"device_sharded"`` and
    ``"device_sharded_pool"`` each bucket is one batched dispatch across the
    mesh, (B, n/p) state per rank. Every rank runs a service and submits the
    same requests in the same order; the bucket the worker forms from what
    is queued must then be the same on every rank, which each dispatch
    checks with one small all-gather before it starts.
    """

    def __init__(self, cfg: Optional[EvalConfig] = None, *,
                 max_batch: int = 64, max_pending: int = 1024,
                 linger_s: float = 0.0, device=None, plan: str = "device",
                 mesh=None, data_axes: Sequence[str] = ("data",)):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if plan not in ("device", "device_sharded", "device_sharded_pool"):
            raise ValueError(
                f"unknown batched execution plan {plan!r}; the service "
                f"serves 'device', 'device_sharded' or 'device_sharded_pool'")
        self._plan = plan
        self._mesh = mesh
        self._data_axes = tuple(data_axes)
        self._cfg = cfg if cfg is not None else EvalConfig()
        self._max_batch = max_batch
        self._max_pending = max_pending
        self._linger_s = linger_s
        self._device = resolve_device(device)
        #: dispatches: batched engine calls issued; batched_requests:
        #: requests they carried (the amortization ratio is
        #: batched_requests / dispatches).
        self.stats = {"requests": 0, "dispatches": 0, "batched_requests": 0}
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "SelectionService":
        if self._task is not None:
            raise RuntimeError("service already started")
        self._queue = asyncio.Queue(self._max_pending)
        self._task = asyncio.create_task(self._worker())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` serves queued requests first."""
        if self._task is None:
            return
        try:
            if drain and self._error is None:
                await self._queue.join()
        finally:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None

    async def __aenter__(self) -> "SelectionService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    def _check(self):
        if self._task is None:
            raise RuntimeError("service not started (use 'async with' or "
                               "await start())")
        if self._error is not None:
            raise RuntimeError("selection worker failed") from self._error

    # -- producer side -------------------------------------------------------

    async def submit(self, X, k: int, *, fn: str = "exemplar",
                     kind: str = "dense", seed: int = 0, eps: float = 0.05,
                     top_b: int = 0, **params):
        """Submit one selection request; awaits until served.

        Returns the request's :class:`~repro_torch.core.engine.OptResult`.
        ``params`` are extra function-constructor kwargs (e.g. ``lam`` for
        graph_cut) and enter the bucket signature.
        """
        self._check()
        if kind not in ("dense", "stochastic", "lazy"):
            raise ValueError(f"unknown strategy kind {kind!r}")
        if fn not in FUNCTIONS:
            raise ValueError(f"unknown function {fn!r}; registered: "
                             f"{sorted(FUNCTIONS)}")
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be (n, d), got shape {X.shape}")
        if not 0 <= k <= X.shape[0]:
            raise ValueError(
                f"cannot select k={k} exemplars from n={X.shape[0]}")
        if k == 0:
            self.stats["requests"] += 1
            return OptResult([], 0.0, [], 0)
        req = _SelectionRequest(
            X=X, k=int(k), fn=fn, params=tuple(sorted(params.items())),
            kind=kind, seed=int(seed), eps=float(eps), top_b=int(top_b),
            future=asyncio.get_running_loop().create_future())
        await self._queue.put(req)      # backpressure point
        self.stats["requests"] += 1
        try:
            return await req.future
        finally:
            self._check()

    # -- worker --------------------------------------------------------------

    async def _worker(self) -> None:
        while True:
            batch = [await self._queue.get()]
            if self._linger_s > 0:      # let a burst accumulate
                await asyncio.sleep(self._linger_s)
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                buckets: dict[tuple, list[_SelectionRequest]] = {}
                for req in batch:
                    buckets.setdefault(req.signature(), []).append(req)
                for reqs in buckets.values():  # one dispatch at a time
                    for lo in range(0, len(reqs), self._max_batch):
                        await self._serve_bucket(
                            reqs[lo:lo + self._max_batch])
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # worker-level fault: fail fast
                self._error = e
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
            finally:
                for _ in batch:
                    self._queue.task_done()

    async def _serve_bucket(self, reqs: list[_SelectionRequest]) -> None:
        try:
            results = await asyncio.to_thread(self._run_bucket, reqs)
        except asyncio.CancelledError:
            raise
        except BaseException as e:      # bucket-level fault: this bucket's
            for req in reqs:            # tenants see it; others proceed
                if not req.future.done():
                    req.future.set_exception(e)
            return
        for req, res in zip(reqs, results):
            if not req.future.done():
                req.future.set_result(res)

    def _build_bucket(self, reqs: list[_SelectionRequest]):
        """Deterministic bucket assembly: one function per request, ragged
        ks, per-request stochastic samples, round count."""
        r0 = reqs[0]
        n = r0.X.shape[0]
        fs = [FUNCTIONS[r.fn](r.X, self._cfg, device=self._device,
                              **dict(r.params)) for r in reqs]
        ks = [r.k for r in reqs]
        cand = None
        if r0.kind == "stochastic":
            k_scan = r0.k                      # exact-k bucket
            cand = np.stack([_stochastic_samples(n, r.k, r.eps, r.seed)
                             for r in reqs])
        else:
            k_scan = _next_pow2(max(ks))       # ragged k, pooled rounds
        return fs, ks, cand, k_scan

    @contract(
        "service.bucket_dispatch",
        runtime_only=True,
        claim="every signature bucket rides ONE run_selection_batch "
              "dispatch (pow2-padded with inert k_eff = 0 slots); its rounds "
              "are engine.select_scan_batched's, audited there — this "
              "contract's own check is the service round trip (6 tenants in "
              "2 bursts cost 2 dispatches)")
    def _run_bucket(self, reqs: list[_SelectionRequest]):
        """Synchronous batched dispatch for one signature bucket (runs in a
        thread)."""
        from repro_torch.core import engine as eng

        r0 = reqs[0]
        fs, ks, cand, k_scan = self._build_bucket(reqs)
        if self._plan != "device":
            self._check_same_bucket(reqs)
        res = eng.run_selection_batch(
            fs, kind=r0.kind, k=k_scan, ks=ks, cand_rounds=cand,
            top_b=r0.top_b, plan=self._plan, mesh=self._mesh,
            data_axes=self._data_axes)
        self.stats["dispatches"] += 1
        self.stats["batched_requests"] += len(reqs)
        return res

    def _check_same_bucket(self, reqs: list[_SelectionRequest]) -> None:
        """Raise unless every rank of the mesh is about to dispatch the
        same bucket (signature, k and seed of each request, and a checksum
        of its ground set): a mismatch would pair one rank's collectives
        with another bucket's."""
        import torch.distributed as dist

        from repro_torch.core import distributed

        sh = distributed.resolve_mesh(self._mesh, self._data_axes)
        mine = [(r.signature(), r.k, r.seed,
                 float(np.sum(r.X, dtype=np.float64))) for r in reqs]
        every: list = [None] * sh.p
        dist.all_gather_object(every, mine, group=sh.group)
        if any(b != mine for b in every):
            raise RuntimeError(
                "the ranks formed different buckets; under a mesh plan every "
                "rank must submit the same requests in the same order")
