"""CLI: prove the engine's per-round contracts at run time and lint the
tree.

    python -m repro_torch.analysis.audit [--json OUT] [--lint-only]
                                         [--audit-only] [--quick]
                                         [--filter SUBSTR]
                                         [--device cuda|cpu]

Exit status is non-zero on ANY violation: a case whose census breaks its
contract, a runtime check failure (a kernel rebuilt on a same-shape call,
a cache or sieve table not reused in place, ...), a lint finding, or a
registered contract with no audit coverage.

The cases run on ``--device`` (default ``cuda``, which must exist: with no
CUDA device the audit raises rather than fall back to the CPU). On the
card the ``cuda`` backend's cases launch the kernels, and the cases whose
rounds allow no sync also run under ``torch.cuda.set_sync_debug_mode
("error")``. The mesh cases run on the default process group; when there
is none, a one-rank gloo group over an in-memory store is started for the
run and torn down after it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load_contracts():
    """Import the core modules so their @contract decorators register."""
    from repro_torch.core import (distributed, engine, service,  # noqa: F401
                                  streaming)
    from repro_torch.analysis.contracts import CONTRACTS

    return CONTRACTS


def resolve_device(device: str):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the contract audit runs on the card by default and this "
            "machine has no CUDA device; pass --device cpu to audit on the "
            "CPU (the kernels' plain versions stand in for them)")
    return dev


def _ensure_group():
    """A one-rank gloo group when none exists; returns its teardown."""
    import torch.distributed as dist

    if dist.is_initialized():
        return lambda: None
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    return dist.destroy_process_group


def run_audit(device="cuda", quick: bool = False, case_filter: str = "",
              log=print):
    """Evaluate the grid on ``device`` under the default process group
    (:func:`_ensure_group` starts one). Returns ``(results, runtime
    results, uncovered contracts, seconds)``."""
    from repro_torch.analysis import report as rep
    from repro_torch.analysis.registry import build_cases, runtime_checks

    dev = resolve_device(device)
    contracts = _load_contracts()
    card = dev.type == "cuda"
    cases = build_cases(dev, quick=quick)
    if case_filter:
        cases = [c for c in cases if case_filter in c.label]
    results = []
    t0 = time.perf_counter()
    for case in cases:
        try:
            r = rep.evaluate_case(case, card=card)
        except Exception as e:  # a case that cannot even run is a failure
            r = rep.failed_case(case, e)
        results.append(r)
        if not r.ok:
            log(f"FAIL {r.label}")
            for v in r.violations:
                log(f"     {v}")
    elapsed = time.perf_counter() - t0

    covered = {c.contract for c in cases}
    rt_results = []
    if not case_filter:
        for check in runtime_checks(dev):
            try:
                ok, detail = check.run()
            except Exception as e:
                ok, detail = False, f"{type(e).__name__}: {e}"
            rt_results.append({"name": check.name, "ok": ok,
                               "detail": detail,
                               "contract": check.contract})
            covered.add(check.contract)
            if not ok:
                log(f"FAIL runtime {check.name}: {detail}")
    # a runtime-only contract (the service's) is covered by its check
    uncovered = [] if case_filter else sorted(set(contracts) - covered)
    return results, rt_results, uncovered, elapsed


def run_lint(log=print):
    from repro_torch.analysis.lint import lint_tree

    root = Path(__file__).resolve().parents[1]   # src/repro_torch
    findings = lint_tree(root)
    for f in findings:
        log(f"LINT {f}")
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="runtime contract audit + source lint")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="write the machine-readable report to OUT")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--audit-only", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="one case per contract and kind (smoke run)")
    ap.add_argument("--filter", default="",
                    help="only audit cases whose label contains SUBSTR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cases run (default: the card)")
    args = ap.parse_args(argv)

    import torch

    def err(msg):
        print(msg, file=sys.stderr)

    results, rt_results, uncovered, elapsed = [], [], [], 0.0
    findings = []
    if not args.lint_only:
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            err(f"audit: {e}")
            return 2
        teardown = _ensure_group()
        try:
            results, rt_results, uncovered, elapsed = run_audit(
                args.device, quick=args.quick, case_filter=args.filter,
                log=err)
        finally:
            teardown()
    if not args.audit_only:
        findings = run_lint(log=err)

    from repro_torch.analysis import report as rep

    payload = rep.build_report(
        results, rt_results, findings, device=args.device,
        device_count=torch.cuda.device_count() if args.device == "cuda"
        else 1)
    s = payload["summary"]
    s["uncovered_contracts"] = uncovered
    s["audit_seconds"] = round(elapsed, 2)
    s["contracts_registered"] = len(_load_contracts())
    full = not (args.lint_only or args.filter)
    s["contracts_covered"] = s["contracts_registered"] - len(uncovered) \
        if full else None
    payload["per_contract"] = rep.contract_metrics(results)
    if args.json:
        Path(args.json).write_text(json.dumps(payload, indent=2))
    ok = s["ok"] and not uncovered
    if full:
        print(f"contracts audited : {s['contracts_covered']} of "
              f"{s['contracts_registered']} ({s['contracts']} by cases, the "
              f"rest by runtime checks)")
    print(f"cases run         : {s['cases']} "
          f"({s['cases_failed']} failed, {elapsed:.1f}s)")
    print(f"runtime checks    : {s['runtime_checks']} "
          f"({s['runtime_failed']} failed)")
    print(f"lint findings     : {s['lint_findings']}")
    if uncovered:
        err(f"UNCOVERED contracts (registered, no audit case): {uncovered}")
    print("AUDIT " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
