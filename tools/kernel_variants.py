#!/usr/bin/env python3
"""Time text-patched copies of the port's CUDA kernels against the sources
as they stand, on one GPU.

    python3 tools/kernel_variants.py [gain] [exemplar]

A variant is a list of (old, new) substitutions applied to copies of
``csrc/tile.cuh`` and one ``csrc/<source>.cu`` under
``build/variants/<name>/``. Every ``old`` must occur in the sources, so a
variant that no longer matches the code fails instead of timing the
unpatched kernel. Each copy is built with the package's own nvcc flags (all
in parallel) and loaded in place of the package's library, so the wrappers
launch it unchanged. Diagnostic variants drop work and compute wrong values
(their ``err`` column shows it); they bound what that work costs. Per
variant: registers and spill bytes from ptxas, the error against the plain
version on a slice, and CUDA-event times (median of 5 after 2 warm-ups) at
the paper's shapes (n = 50 000, d = 100; l = 5 000, k = 10), fp32. The base
is timed first and last. Results also go to
``chiprun_out/kernel_variants.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPB = ("constexpr int MAX_SPB = 8;", "constexpr int MAX_SPB = 1;")
VARIANTS = {
    "gain": ("marginal_gain", {
        "base": [],
        # diagnostics: drop the column loads / the row loads of the Gram loop
        "no column loads": [("load_cols<RC>(b, cb + ee * bcp, tx);",
                             "load_cols<RC>(b, cb, tx);")],
        "no row loads": [("load8(a, vr + ee * VS);", "load8(a, vr);")],
        "no shared loads": [("load_cols<RC>(b, cb + ee * bcp, tx);",
                             "load_cols<RC>(b, cb, tx);"),
                            ("load8(a, vr + ee * VS);", "load8(a, vr);")],
        "no epilogue": [(
            "const A d2 = dist_(vn[r], cn[q], acc[r][q], gamma);\n"
            "          colsum[q] += fold_max ? fmaxf(affine(alpha, beta, d2)"
            " - cr, 0.f) : relu_diff(cr, d2);",
            "colsum[q] += to_f(acc[r][q]);")],
        # designs
        "one segment a block": [SPB],
        "ptxas registers": [("__global__ void __maxnreg__(232)",
                             "__global__ void __launch_bounds__(NT)")],
    }),
    "exemplar": ("exemplar_eval", {
        "base": [],
        "no column loads": [
            ("load_cols<ERC>(b0, c0 + ee * BCP, tx);\n"
             "    load_cols<ERC>(b1, c1 + ee * BCP, tx);",
             "load_cols<ERC>(b0, c0, tx);\n    load_cols<ERC>(b1, c1, tx);")],
        "one segment a block": [SPB],
        "ptxas registers": [("__global__ void __maxnreg__(192)",
                             "__global__ void __launch_bounds__(NT)")],
    }),
}


def build(name: str, src: str, subs, nvcc: str, csrc: Path, flags):
    out = ROOT / "build" / "variants" / re.sub(r"\W+", "_", f"{src}_{name}")
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (csrc / f).read_text() for f in ("tile.cuh", f"{src}.cu")}
    for old, new in subs:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise SystemExit(f"variant {name!r}: {old[:60]!r} is not in the "
                             f"sources")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for f, t in texts.items():
        (out / f).write_text(t)
    lib = out / "lib.so"
    return subprocess.Popen([nvcc, *flags, "-o", str(lib), str(out / f"{src}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def ptxas_report(log: str) -> dict:
    regs, spill = [], 0
    fn = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        if "seg_sum" in fn:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill += int(m.group(1)) + int(m.group(2))
    return {"registers": [min(regs, default=0), max(regs, default=0)],
            "spill_bytes": spill}


def main(sets) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.evaluator import e0_distances
    from repro_torch.core.precision import FP32
    from repro_torch.data.synthetic import uniform_problem
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg

    print(cs.card_line(), flush=True)
    nvcc = _build._nvcc()
    procs = {}
    for s in sets:
        src, variants = VARIANTS[s]
        for name, subs in variants.items():
            procs[s, name] = build(name, src, subs, nvcc, _build.CSRC,
                                   _build.NVCC_FLAGS)
    libs, report = {}, {}
    for (s, name), (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{s} / {name}: build failed\n{log[-3000:]}")
        src = VARIANTS[s][0]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _build.SIGNATURES[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[s, name] = lib
        report[f"{s} / {name}"] = ptxas_report(log)

    dev = torch.device("cuda")
    N, L, K, D = 50_000, 5_000, 10, 100
    V = torch.as_tensor(uniform_problem(N, D, seed=0), device=dev)
    S = torch.as_tensor(uniform_problem(L * K, D, seed=1), device=dev
                        ).reshape(L, K, D)
    Sk = S.permute(1, 0, 2).contiguous()
    lengths = torch.full((L,), K, dtype=torch.int32, device=dev)
    d_e0 = e0_distances(V, None, "sqeuclidean", FP32).contiguous()
    kc = ops.kernel_config(K, D, FP32).k_chunk
    top, w = V[:256].contiguous(), V[5].contiguous()
    wv = torch.ones((), device=dev)
    kw = dict(n_total=N, policy=FP32)
    part = (Sk[:, :300].contiguous(), lengths[:300].contiguous())
    ref_g = mg.gain_eval_plain(V, top, d_e0, **kw)
    ref_f = ee.fused_eval_plain(V, *part, d_e0, layout="flat", **kw)

    def rel(got, ref):
        torch.cuda.synchronize()
        return float((got - ref).abs().max() / ref.abs().max())

    for s in sets:
        src, variants = VARIANTS[s]
        for name in list(variants) + ["base"]:
            _build._LIBS[src] = libs[s, name]
            r = report[f"{s} / {name}"]
            if src == "marginal_gain":
                r["err"] = rel(mg.gain_eval(V, top, d_e0, **kw), ref_g)
                t = {"gain_eval m=256": cs.cuda_ms(
                         lambda: mg.gain_eval(V, top, d_e0, **kw), 20),
                     "gain_eval m=50000": cs.cuda_ms(
                         lambda: mg.gain_eval(V, V, d_e0, **kw), 5),
                     "gain_update_eval m=50000": cs.cuda_ms(
                         lambda: mg.gain_update_eval(V, V, d_e0, w, wv, **kw),
                         5)}
            else:
                r["err"] = rel(ee.fused_eval(V, *part, d_e0, k_chunk=kc,
                                             layout="flat", **kw), ref_f)
                t = {"fused_eval l=5000": cs.cuda_ms(
                         lambda: ee.fused_eval(V, Sk, lengths, d_e0,
                                               k_chunk=kc, layout="flat",
                                               **kw), 5),
                     "two_pass_eval l=5000": cs.cuda_ms(
                         lambda: ee.two_pass_eval(V, S, lengths, d_e0,
                                                  k_chunk=kc, **kw), 5)}
            r.setdefault("ms", []).append(t)
            print(f"{s} / {name}: {json.dumps(r)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_variants.json").write_text(json.dumps(
        {"card": cs.card_line(), "variants": report}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main([a for a in sys.argv[1:]] or list(VARIANTS)))
