#!/usr/bin/env python3
"""Time text-patched copies of the sieve kernel (``csrc/sieve_gain.cu``)
against the source as it stands, on one GPU.

    python3 tools/sieve_variants.py

Variants are built and loaded as ``tools/kernel_variants.py`` builds them
(its ``build`` and ``ptxas_report``), each in place of the package's
library, so the wrappers launch it unchanged. Per variant: registers and
spill bytes, the largest error against the plain version at the sieve
table's shape (relative to the largest gain), and device times from the
profiler over 50 launches (``chip_smoke.device_ms``), warm and with the L2
flushed before each launch (``chip_smoke.l2_flush``), at the streaming
path's shapes: the seed and 34 cache rows (the sieve table), the seed and
64 (salsa's), and 16 partitions of the first, n = 50 000. The base is timed
first and last. Results also go to ``chiprun_out/sieve_variants.json``.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def knob(name: str, old, new, kind: str = "int") -> tuple:
    """Set one compile-time constant of the source."""
    return (f"constexpr {kind} {name} = {old};",
            f"constexpr {kind} {name} = {new};")


T128 = knob("SIEVE_NT", 256, 128)
VARIANTS = {
    "base": [],
    "128 threads": [T128],
    "192 threads": [knob("SIEVE_NT", 256, 192)],
    "2 steps in flight": [knob("SIEVE_U", 4, 2)],
    "3 steps in flight": [knob("SIEVE_U", 4, 3)],
    "128 threads, 8 steps in flight": [T128, knob("SIEVE_U", 4, 8)],
    "span quantum 4 columns": [
        knob("SIEVE_QUANTUM", "SIEVE_STEP", "SIEVE_VEC")],
    # diagnostic: no loads, no adds (the launch, the trees and the barrier)
    "no loads": [("c0 < hi; c0 += SIEVE_U * SIEVE_STEP)",
                  "c0 < lo; c0 += SIEVE_U * SIEVE_STEP)")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sieve_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kernel_variants import build, ptxas_report
    from repro_torch.kernels import _build
    from repro_torch.kernels import marginal_gain as mg

    print(cs.card_line(), flush=True)
    nvcc = _build._nvcc()
    procs = {name: build(name, "sieve_gain", subs, nvcc, _build.CSRC,
                         _build.NVCC_FLAGS) for name, subs in VARIANTS.items()}
    libs, report = {}, {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _build.SIGNATURES["sieve_gain"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        report[name] = ptxas_report(log)

    N = 50_000
    flush = cs.l2_flush(torch.device("cuda"))
    shapes = {}
    for tag, lead, r in (("seed + (34, n)", (), 35), ("seed + (64, n)", (), 65),
                         ("seed + (16, 34, n)", (16,), 35)):
        T, d = cs.sieve_operands(lead, r, N, "min", seed=r)
        seed, T = T[(0,) * len(lead) + (0,)].clone(), T[..., 1:, :].contiguous()
        call = mg.sieve_gain_eval_batched if lead else mg.sieve_gain_eval
        shapes[tag] = (call, T, d, seed)
    ref = {tag: (mg.sieve_gain_eval_batched_plain if T.ndim == 3
                 else mg.sieve_gain_eval_plain)(T, d, n_total=N, seed=seed)
           for tag, (call, T, d, seed) in shapes.items()}
    for name in list(VARIANTS) + ["base"]:
        _build._LIBS["sieve_gain"] = libs[name]
        r = report[name]
        t = {}
        for tag, (call, T, d, seed) in shapes.items():
            def run(call=call, T=T, d=d, seed=seed):
                return call(T, d, n_total=N, seed=seed)
            got = run()
            torch.cuda.synchronize()
            r["err"] = max(r.get("err", 0.0), float(
                (got - ref[tag]).abs().max() / ref[tag].abs().max()))
            t[tag] = {"warm_us": cs.device_ms(run, 50) * 1e3,
                      "cold_us": cs.device_ms(run, 50, flush) * 1e3}
        r.setdefault("times", []).append(t)
        print(f"{name}: {json.dumps(r)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sieve_variants.json").write_text(json.dumps(
        {"card": cs.card_line(), "variants": report}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
