#!/usr/bin/env python3
"""Time text-patched copies of the port's CUDA kernels against the sources
as they stand, on one GPU.

    python3 tools/kernel_variants.py [gain] [exemplar] [gain_tc] [exemplar_tc]

A variant is a list of (old, new) substitutions applied to copies of
``csrc/tile.cuh``, ``csrc/tc_tile.cuh`` and one ``csrc/<source>.cu`` under
``build/variants/<name>/``. Every ``old`` must occur in the sources, so a
variant that no longer matches the code fails instead of timing the
unpatched kernel. Each copy is built with the package's own nvcc flags (all
in parallel) and loaded in place of the package's library, so the wrappers
launch it unchanged. Diagnostic variants drop work and compute wrong values
(their ``err`` column shows it); they bound what that work costs. Per
variant: registers and spill bytes from ptxas, the error against the plain
version on a slice, and CUDA-event times (median of 5 after 2 warm-ups) at
the paper's shapes (n = 50 000, d = 100; l = 5 000, k = 10; fp32 payloads,
as the main path passes them). The sets ``gain`` and ``exemplar`` patch the
SIMT tile and time their variants at fp32; ``gain_tc`` and ``exemplar_tc``
patch the tensor-core tile and time theirs at bf16 and fp16. Every set's
base is timed first and last, at fp32, bf16 and fp16. Results also go to
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

#: Policies every set's base is timed at.
POLICIES = ("fp32", "bf16", "fp16")
SPB = ("constexpr int MAX_SPB = 8;", "constexpr int MAX_SPB = 1;")
TC_GAIN_EPILOGUE = """    if (gamma >= 0.f) {
      if (fold_max)
        gain_cells<NW, true, true>(colsum, acc, cn_g, q, rn, cr, ok, gamma, alpha, beta);
      else
        gain_cells<NW, true, false>(colsum, acc, cn_g, q, rn, cr, ok, gamma, alpha, beta);
    } else {
      if (fold_max)
        gain_cells<NW, false, true>(colsum, acc, cn_g, q, rn, cr, ok, gamma, alpha, beta);
      else
        gain_cells<NW, false, false>(colsum, acc, cn_g, q, rn, cr, ok, gamma, alpha, beta);
    }"""
TC_GAIN_MMA = """    for (int kk = 0; kk < ks; ++kk)
      mma<P, NW>(acc, desc_sw128(vb, kk),"""
TC_EXEMPLAR_EPILOGUE = (
    "    exemplar_cells(mraw, acc, sm.cnorm + 16 * (g * kcap + s0), q, wn, k0 + s0, len, rn);")
TC_GAIN_BOUNDS1 = ("__global__ void __launch_bounds__(NT, 2)\ngain_tc_kernel",
                   "__global__ void __launch_bounds__(NT, 1)\ngain_tc_kernel")
#: (source, policies its variants are timed at, variants)
VARIANTS = {
    "gain": ("marginal_gain", ("fp32",), {
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
    "exemplar": ("exemplar_eval", ("fp32",), {
        "base": [],
        "no column loads": [
            ("load_cols<ERC>(b0, c0 + ee * BCP, tx);\n"
             "    load_cols<ERC>(b1, c1 + ee * BCP, tx);",
             "load_cols<ERC>(b0, c0, tx);\n    load_cols<ERC>(b1, c1, tx);")],
        "one segment a block": [SPB],
        "ptxas registers": [("__global__ void __maxnreg__(192)",
                             "__global__ void __launch_bounds__(NT)")],
    }),
    "gain_tc": ("marginal_gain", ("bf16", "fp16"), {
        "base": [],
        # diagnostics: drop the epilogue, the MMAs, the V staging
        "no epilogue": [(TC_GAIN_EPILOGUE, "colsum[0] += acc[0];")],
        "no products": [(TC_GAIN_MMA, TC_GAIN_MMA.replace("kk < ks", "kk < 0"))],
        "no V staging": [("    vs.issue(s + 2, pos);\n", ""),
                         ("  vs.begin(pos);\n", "")],
        "products and barriers only": [
            (TC_GAIN_EPILOGUE, "colsum[0] += acc[0];"),
            ("    vs.issue(s + 2, pos);\n", ""), ("  vs.begin(pos);\n", "")],
        # designs
        "one block an SM": [TC_GAIN_BOUNDS1],
        "64 candidates a warpgroup": [
            ("constexpr int TC_NW = 128;", "constexpr int TC_NW = 64;")],
    }),
    "exemplar_tc": ("exemplar_eval", ("bf16", "fp16"), {
        "base": [],
        "no epilogue": [(TC_EXEMPLAR_EPILOGUE,
                         "    mraw[0][0] = fminf(mraw[0][0], acc[0]);")],
        "no products": [("    mma<P, N>(acc, desc_sw128(vb, kk)",
                         "    if (0) mma<P, N>(acc, desc_sw128(vb, kk)")],
        "products and barriers only": [
            (TC_EXEMPLAR_EPILOGUE, "    mraw[0][0] = fminf(mraw[0][0], acc[0]);"),
            ("    vs.issue(s + 2, pos);\n", ""), ("  vs.begin(pos);\n", "")],
        "12 slot columns a pass": [("w = slot_cap(wn);", "w = TC_SLOTS;")],
        "two blocks an SM": [("__global__ void __launch_bounds__(NT, 1)\n"
                              "exemplar_tc_kernel",
                              "__global__ void __launch_bounds__(NT, 2)\n"
                              "exemplar_tc_kernel")],
        "no V staging": [("    vs.issue(s + 2, pos);\n", ""),
                         ("  vs.begin(pos);\n", "")],
    }),
}


def patched(name: str, src: str, subs, csrc: Path) -> dict:
    """The variant's copies of the sources, {file name: text}."""
    texts = {f: (csrc / f).read_text()
             for f in ("tile.cuh", "tc_tile.cuh", f"{src}.cu")}
    for old, new in subs:
        hits = [f for f, t in texts.items() if old in t]
        if not hits:
            raise SystemExit(f"variant {name!r}: {old[:60]!r} is not in the "
                             f"sources")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def build(name: str, src: str, texts: dict, nvcc: str, flags):
    out = ROOT / "build" / "variants" / re.sub(r"\W+", "_", f"{src}_{name}")
    out.mkdir(parents=True, exist_ok=True)
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
    from repro_torch.core.precision import resolve
    from repro_torch.data.synthetic import uniform_problem
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import exemplar_eval as ee
    from repro_torch.kernels import marginal_gain as mg

    print(cs.card_line(), flush=True)
    nvcc = _build._nvcc()
    # every variant's substitutions are checked before any build starts
    texts = {(s, name): patched(name, VARIANTS[s][0], subs, _build.CSRC)
             for s in sets for name, subs in VARIANTS[s][2].items()}
    procs = {(s, name): build(f"{s} {name}", VARIANTS[s][0], t, nvcc,
                              _build.NVCC_FLAGS)
             for (s, name), t in texts.items()}
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
    top, w = V[:256].contiguous(), V[5].contiguous()
    wv = torch.ones((), device=dev)
    part = (Sk[:, :300].contiguous(), lengths[:300].contiguous())

    def rel(got, ref):
        torch.cuda.synchronize()
        return float((got - ref).abs().max() / ref.abs().max())

    def run(src, pol):
        """(error on a slice, times) of the loaded library at one policy."""
        p = resolve(pol)
        d_e0 = e0_distances(V, None, "sqeuclidean", p).contiguous()
        kw = dict(n_total=N, policy=p)
        if src == "marginal_gain":
            err = rel(mg.gain_eval(V, top, d_e0, **kw),
                      mg.gain_eval_plain(V, top, d_e0, **kw))
            return err, {
                "gain_eval m=256": cs.cuda_ms(
                    lambda: mg.gain_eval(V, top, d_e0, **kw), 20),
                "gain_eval m=50000": cs.cuda_ms(
                    lambda: mg.gain_eval(V, V, d_e0, **kw), 5),
                "gain_update_eval m=50000": cs.cuda_ms(
                    lambda: mg.gain_update_eval(V, V, d_e0, w, wv, **kw), 5)}
        kc = ops.kernel_config(K, D, p).k_chunk
        err = rel(ee.fused_eval(V, *part, d_e0, k_chunk=kc, layout="flat",
                                **kw),
                  ee.fused_eval_plain(V, *part, d_e0, layout="flat", **kw))
        return err, {
            "fused_eval l=5000": cs.cuda_ms(
                lambda: ee.fused_eval(V, Sk, lengths, d_e0, k_chunk=kc,
                                      layout="flat", **kw), 5),
            "two_pass_eval l=5000": cs.cuda_ms(
                lambda: ee.two_pass_eval(V, S, lengths, d_e0, k_chunk=kc,
                                         **kw), 5)}

    for s in sets:
        src, policies, variants = VARIANTS[s]
        for name in list(variants) + ["base"]:
            _build._LIBS[src] = libs[s, name]
            r = report[f"{s} / {name}"]
            for pol in (POLICIES if name == "base" else policies):
                err, t = run(src, pol)
                r.setdefault("err", {})[pol] = err
                r.setdefault("ms", {}).setdefault(pol, []).append(t)
            print(f"{s} / {name}: {json.dumps(r)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_variants.json").write_text(json.dumps(
        {"card": cs.card_line(), "variants": report}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main([a for a in sys.argv[1:]] or list(VARIANTS)))
