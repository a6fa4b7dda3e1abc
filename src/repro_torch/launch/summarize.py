"""Summarize dry-run JSONs into the EXPERIMENTS.md roofline/dry-run tables
(the port of the JAX package's ``launch/summarize.py``: the same tables from
the same records; the port's records hold ``compile_s`` 0)."""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.roofline import model_flops


def load(outdir: str) -> list[dict]:
    recs = []
    for p in sorted(pathlib.Path(outdir).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def roofline_table(recs) -> str:
    """Single-pod roofline table (§Roofline), markdown."""
    rows = ["| arch | shape | compute_s | memory_s | collective_s | "
            "bottleneck | MODEL_FLOPS/HLO | peak GiB/dev | note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("multi_pod") or r.get("status") == "skipped":
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | "
                        f"— | — | {r.get('error','')[:60]} |")
            continue
        t = r["roofline"]
        # recompute useful ratio with current analytic params
        cfg = C.get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        mf = model_flops(cfg.approx_params(), r["tokens_per_step"],
                         r["kind"])
        ratio = mf / (t["device_flops"] * r["chips"]) if t["device_flops"] else 0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | "
            f"**{t['bottleneck']}** | {ratio:.3f} | "
            f"{fmt_bytes(r['memory']['peak_bytes_per_device'])} | |")
    for r in recs:
        if r.get("status") == "skipped" and not r.get("multi_pod"):
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped |"
                        f" — | — | {r['reason'][:60]} |")
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    """Both-mesh compile summary (§Dry-run)."""
    rows = ["| arch | shape | mesh | status | compile_s | peak GiB/dev | "
            "AR / AG / RS / A2A / CP (count) | coll GiB/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        mesh = "2×16×16" if r.get("multi_pod") else "16×16"
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | skipped | "
                        f"— | — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | ERROR | — |"
                        f" — | — | — |")
            continue
        c = r["collectives"]["counts"]
        cc = (f"{c['all-reduce']} / {c['all-gather']} / "
              f"{c['reduce-scatter']} / {c['all-to-all']} / "
              f"{c['collective-permute']}")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | ok | "
            f"{r['compile_s']:.0f} | "
            f"{fmt_bytes(r['memory']['peak_bytes_per_device'])} | {cc} | "
            f"{r['collectives']['total_bytes'] / 2**30:.2f} |")
    return "\n".join(rows)


def stats(recs) -> dict:
    ok = [r for r in recs if r.get("status") == "ok"]
    sk = [r for r in recs if r.get("status") == "skipped"]
    er = [r for r in recs if r.get("status") == "error"]
    return {"ok": len(ok), "skipped": len(sk), "error": len(er),
            "total": len(recs)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--mode", default="both",
                    choices=["roofline", "dryrun", "both", "stats"])
    args = ap.parse_args()
    recs = load(args.out)
    print(f"<!-- {stats(recs)} -->")
    if args.mode in ("dryrun", "both"):
        print("\n### Dry-run compile matrix\n")
        print(dryrun_table(recs))
    if args.mode in ("roofline", "both"):
        print("\n### Roofline (single-pod, full-depth meta run)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
