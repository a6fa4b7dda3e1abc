"""Serving surface: batched multi-tenant selection requests.

:class:`SelectionService` takes many concurrent *selection* requests (each
its own (V, k) problem), buckets them by signature and solves them
B-at-a-time through :func:`repro_torch.core.engine.run_selection_batch` —
one batched dispatch per bucket, per-request demux, results identical to
the unbatched engine. (The reference's streaming ingestion services come
with the streaming slice.)

The engine is synchronous PyTorch; dispatches run in a thread
(``asyncio.to_thread``) so the event loop keeps accepting requests while the
device works. Kernels launch on the calling thread's current CUDA stream;
no thread here picks another stream, so every dispatch goes to the default
stream, one bucket after the other. Each bucket's payload is built inline,
just before its dispatch (overlapping it with the previous dispatch needs
a second stream, and is later work).
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.engine import OptResult
from repro_torch.core.evaluator import EvalConfig
from repro_torch.core.functions import FUNCTIONS
from repro_torch.core.multiset import resolve_device


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
    """

    def __init__(self, cfg: Optional[EvalConfig] = None, *,
                 max_batch: int = 64, max_pending: int = 1024,
                 linger_s: float = 0.0, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
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

    def _run_bucket(self, reqs: list[_SelectionRequest]):
        """Synchronous batched dispatch for one signature bucket (runs in a
        thread)."""
        from repro_torch.core import engine as eng

        r0 = reqs[0]
        fs, ks, cand, k_scan = self._build_bucket(reqs)
        res = eng.run_selection_batch(
            fs, kind=r0.kind, k=k_scan, ks=ks, cand_rounds=cand,
            top_b=r0.top_b)
        self.stats["dispatches"] += 1
        self.stats["batched_requests"] += len(reqs)
        return res
