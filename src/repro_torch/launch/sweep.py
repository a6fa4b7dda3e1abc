"""Full dry-run sweep: every (arch × shape) × {single-pod, multi-pod}.

The port of the JAX package's ``launch/sweep.py``. Every cell's roofline
is its full-depth meta run's, which dispatches every layer (the
reference's single-pod cells extrapolate from shallow variants because
XLA counts a scanned layer once; the port's extrapolation is held equal
to the full-depth count in the tests, not run again here). Writes one
JSON per cell into --out; idempotent (--resume skips existing); exit 1
if any cell failed.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--archs a,b] [--resume]
"""
import argparse
import json
import pathlib

from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import run_cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--single-pod", action="store_true",
                    help="the 16 x 16 mesh only")
    args = ap.parse_args()
    archs = C.ARCH_IDS if args.archs == "all" else args.archs.split(",")
    shapes = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    meshes = (False,) if args.single_pod else (False, True)
    out = pathlib.Path(args.out)
    done = errors = 0
    # the mesh outermost: one fake group of 256, then one of 512 ranks
    for mp in meshes:
        for arch in archs:
            for sname in shapes:
                tag = "pod2x16x16" if mp else "pod16x16"
                path = out / f"{arch}__{sname}__{tag}.json"
                if args.resume and path.exists():
                    rec = json.loads(path.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        continue
                rec = run_cell(arch, sname, mp, args.out)
                done += 1
                errors += rec.get("status") == "error"
    print(f"[sweep] finished: {done} cells run, {errors} errors")
    raise SystemExit(1 if errors else 0)


if __name__ == "__main__":
    main()
