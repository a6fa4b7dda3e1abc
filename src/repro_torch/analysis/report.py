"""Case evaluation + machine-readable audit report.

:func:`evaluate_case` runs one :class:`~repro_torch.analysis.registry.\
AuditCase` at k = K, K + 1 and K + 2 under the census, takes the two
one-round differences, and compares them and the runs against the case's
:class:`~repro_torch.analysis.registry.Expect` and its contract — every
mismatch becomes a :class:`Violation`. The report collects per-case
results, runtime-check outcomes and lint findings into one
JSON-serializable dict (the CLI's ``--json`` payload).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any

import torch

from repro_torch.analysis import census as cz
from repro_torch.analysis.contracts import CONTRACTS
from repro_torch.analysis.registry import AuditCase


@dataclasses.dataclass
class Violation:
    check: str       #: which claim failed (syncs/launches/collectives/...)
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.detail}"


@dataclasses.dataclass
class CaseResult:
    label: str
    contract: str
    violations: list[Violation]
    metrics: dict[str, Any]

    @property
    def ok(self) -> bool:
        return not self.violations


def _plus(base: dict, per_it: dict, it: int) -> dict:
    out = Counter(base)
    for k, v in per_it.items():
        out[k] += v * it
    return {k: v for k, v in sorted(out.items()) if v}


def _state_of(args):
    from repro_torch.core.streaming import SieveState

    return next((a for a in args if isinstance(a, SieveState)), None)


def check_round(d: dict, case: AuditCase, contract,
                tag: str) -> list[Violation]:
    """The per-round claims on one difference of two runs' summaries."""
    e = case.expect
    v: list[Violation] = []
    it = d["iterations"]
    want_syncs = e.syncs + e.syncs_per_iteration * it
    if d["syncs"] != want_syncs:
        v.append(Violation(
            "syncs", f"{tag}: {d['syncs']} host syncs in a round (want "
            f"{want_syncs}{f' for {it} CELF iterations' if it else ''})"))
    allowed = contract.host_syncs_per_round != 0
    if d["syncs"] - (d["allowed_syncs"] if allowed else 0) > 0:
        v.append(Violation(
            "syncs", f"{tag}: {d['syncs'] - d['allowed_syncs']} host syncs "
            f"at a line not marked allow(host-sync)"
            if allowed else f"{tag}: the contract allows no host sync"))
    want = _plus(e.launches, e.launches_per_iteration, it)
    if d["calls"] != want:
        v.append(Violation(
            "launches", f"{tag}: kernel calls per round {d['calls']} "
            f"(want {want})"))
    batches = e.batches_per_round * (max(1, it) if it else 1)
    for kernel, n in d["calls"].items():
        budget = contract.launches_per_round.get(kernel, 0) * batches
        if n > budget:
            v.append(Violation(
                "launches", f"{tag}: {n} {kernel} calls in a round exceed "
                f"the contract's budget of {budget}"))
    want = _plus(e.collectives, e.collectives_per_iteration, it)
    if d["collectives"] != want:
        v.append(Violation(
            "collectives", f"{tag}: collectives per round "
            f"{d['collectives']} (want {want})"))
    if e.cache_allocs is not None and d["cache_buffers"] != e.cache_allocs:
        v.append(Violation(
            "reuse", f"{tag}: {d['cache_buffers']} new cache buffers per "
            f"round (want {e.cache_allocs}) — a fold allocating a fresh "
            f"cache every round"))
    return v


_UNIFORM_KEYS = ("ops", "syncs", "calls", "collectives", "allocs",
                 "cache_buffers", "staging")


def evaluate_case(case: AuditCase, *, card: bool = False) -> CaseResult:
    """Run the case at K, K + 1, K + 2 and compare. ``card``: the runs are
    on the card (sync debug mode, launches = calls, peak memory)."""
    e = case.expect
    contract = CONTRACTS[case.contract]
    v: list[Violation] = []
    runs, cens = [], []
    peak = None
    t0 = time.perf_counter()
    # gloo stages a CUDA tensor through the host, a sync by construction:
    # the mesh cases' own syncs are the census's count
    debug = card and e.syncs_total == 0 and not case.mesh
    for kk in (e.rounds, e.rounds + 1, e.rounds + 2):
        fn, args, kwargs = case.build(kk)
        if card and e.memory_bound is not None and kk == e.rounds:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out, c = cz.take_census(fn, *args, sync_debug=debug, **kwargs)
        if card and e.memory_bound is not None and kk == e.rounds:
            peak = torch.cuda.max_memory_allocated() - base
        if e.table_in_place:
            st = _state_of(args)
            if out[0].caches is not st.caches:
                v.append(Violation(
                    "reuse", f"k={kk}: the sieve table came out as a new "
                    f"tensor (not updated in place)"))
        runs.append(c.summary())
        cens.append(c)
    d1, d2 = cz.delta(runs[0], runs[1]), cz.delta(runs[1], runs[2])
    v += check_round(d1, case, contract, f"k={e.rounds}→{e.rounds + 1}")
    v += check_round(d2, case, contract, f"k={e.rounds + 1}→{e.rounds + 2}")
    r0, c0 = runs[0], cens[0]
    if contract.rounds_uniform and e.uniform:
        grew = [k for k in _UNIFORM_KEYS if d1[k] != d2[k]]
        if grew:
            v.append(Violation(
                "uniform", f"the round census changes with k in {grew}: "
                f"{ {k: (d1[k], d2[k]) for k in grew} }"))
    if e.syncs_total is not None and r0["syncs"] + r0["staging"] \
            != e.syncs_total:
        v.append(Violation(
            "syncs", f"the call makes {r0['syncs']} host syncs and "
            f"{r0['staging']} host-to-device copies (want "
            f"{e.syncs_total}): {c0.syncs[:3] + c0.staging[:3]}"))
    kinds = set(r0["collectives"])
    if not kinds <= set(contract.collective_kinds):
        v.append(Violation(
            "collectives", f"collective kinds {sorted(kinds)} outside the "
            f"contract's {list(contract.collective_kinds)}"))
    bound = e.max_collective_bytes
    if bound is not None and r0["max_collective_bytes"] > bound:
        v.append(Violation(
            "collectives", f"largest collective operand "
            f"{r0['max_collective_bytes']} B exceeds the bound {bound} B — "
            f"an O(n·d) payload is riding a collective"))
    if "cache" in contract.reuse and e.cache_allocs == 0 \
            and r0["fresh_cache_outs"]:
        v.append(Violation(
            "reuse", f"{r0['fresh_cache_outs']} fused calls were handed no "
            f"output buffer"))
    if contract.precision and e.widen_elems is not None:
        big = [w for c in cens for w in c.widens if w[2] >= e.widen_elems]
        for dt, shape, elems in big[:3]:
            v.append(Violation(
                "precision", f"{dt}{list(shape)} widened to fp32 ({elems} "
                f"elems ≥ {e.widen_elems}) outside a kernel — the payload "
                f"left half precision"))
        # the half payload reaches the distance product as a half matmul,
        # a kernel at the half policy, or half rows widened one block at a
        # time into an fp32 product (distances._dot: exact half products)
        if e.require_half and r0["half_matmuls"] + r0["half_kernel_calls"] \
                + r0["blocked_widens"] == 0:
            v.append(Violation(
                "precision", "no matmul or kernel consumed the half "
                "payload — the policy never reached the distance product"))
    if card:
        for r in runs:
            if r["calls"] != r["launches"]:
                v.append(Violation(
                    "launches", f"calls {r['calls']} != launches "
                    f"{r['launches']}: a plain version ran on the card"))
                break
        if runs[1]["rebuilds"] or runs[2]["rebuilds"]:
            v.append(Violation("rebuild", "a same-shape call loaded a "
                                          "kernel library"))
        if contract.memory and e.memory_bound is not None \
                and peak > e.memory_bound:
            v.append(Violation(
                "memory", f"peak {peak} B over the call exceeds the tile "
                f"bound {e.memory_bound} B"))
    elif r0["launches"]:
        v.append(Violation("launches", f"kernels launched off the card: "
                                       f"{r0['launches']}"))
    return CaseResult(
        label=case.label, contract=case.contract, violations=v,
        metrics={
            "syncs_per_round": d1["syncs"],
            "celf_iterations": [d1["iterations"], d2["iterations"]],
            "launches_per_round": d1["calls"],
            "collectives_per_round": d1["collectives"],
            "collective_total": r0["collective_total"],
            "max_collective_bytes": r0["max_collective_bytes"],
            "cache_allocs_per_round": d1["cache_buffers"],
            "allocs_per_round": d1["allocs"],
            "alloc_bytes_per_round": d1["alloc_bytes"],
            "syncs_call": r0["syncs"], "staging_call": r0["staging"],
            "widens": sum(len(c.widens) for c in cens),
            "half_matmuls": r0["half_matmuls"],
            "half_kernel_calls": r0["half_kernel_calls"],
            "blocked_widens": r0["blocked_widens"],
            "peak_bytes": peak, "memory_bound": e.memory_bound,
            "seconds": time.perf_counter() - t0,
        })


def failed_case(case: AuditCase, exc: BaseException) -> CaseResult:
    return CaseResult(label=case.label, contract=case.contract,
                      violations=[Violation("run",
                                            f"{type(exc).__name__}: {exc}")],
                      metrics={})


def build_report(case_results, runtime_results, lint_findings,
                 *, device: str, device_count: int) -> dict:
    """One JSON-serializable dict for --json."""
    failed = [c for c in case_results if not c.ok]
    rt_failed = [r for r in runtime_results if not r["ok"]]
    contracts = sorted({c.contract for c in case_results})
    return {
        "device": device,
        "device_count": device_count,
        "cases": [
            {"label": c.label, "contract": c.contract, "ok": c.ok,
             "violations": [str(x) for x in c.violations],
             "metrics": c.metrics}
            for c in case_results],
        "runtime": runtime_results,
        "lint": [dataclasses.asdict(f) for f in lint_findings],
        "summary": {
            "contracts": len(contracts),
            "cases": len(case_results),
            "cases_failed": len(failed),
            "runtime_checks": len(runtime_results),
            "runtime_failed": len(rt_failed),
            "lint_findings": len(lint_findings),
            "ok": not failed and not rt_failed and not lint_findings,
        },
    }


def contract_metrics(case_results) -> dict[str, dict]:
    """Per-contract aggregates: cases, the most syncs, kernel calls and
    collectives any case makes per round, the largest collective operand,
    the most new cache buffers per round, failures."""
    per: dict[str, dict] = {}
    for c in case_results:
        m = per.setdefault(c.contract, {
            "cases": 0, "syncs_per_round": 0, "launches_per_round": 0,
            "collectives_per_round": 0, "max_collective_bytes": 0,
            "cache_allocs_per_round": 0, "failed": 0})
        m["cases"] += 1
        m["failed"] += 0 if c.ok else 1
        if not c.metrics:
            continue
        mt = c.metrics
        m["syncs_per_round"] = max(m["syncs_per_round"],
                                   mt["syncs_per_round"])
        m["launches_per_round"] = max(m["launches_per_round"],
                                      sum(mt["launches_per_round"].values()))
        m["collectives_per_round"] = max(
            m["collectives_per_round"],
            sum(mt["collectives_per_round"].values()))
        m["max_collective_bytes"] = max(m["max_collective_bytes"],
                                        mt["max_collective_bytes"])
        m["cache_allocs_per_round"] = max(m["cache_allocs_per_round"],
                                          mt["cache_allocs_per_round"])
    return per
