"""Run-only pre-flight across all cells — catches structural bugs fast.

The port of the JAX package's ``launch/preflight.py``: every supported
(arch × shape) cell's step runs once on meta tensors at both production
meshes (:func:`repro_torch.launch.dryrun.lower_cell`, on a fake group of
256 and then 512 ranks); exit 1 on any failure.

  PYTHONPATH=src python -m repro_torch.launch.preflight [--arch ID[,ID]]
      [--shape NAME[,NAME]] [--mesh both|single-pod|multi-pod]

(the filters split the run over processes: a cell's meta run is one
thread of Python, and xlstm's sLSTM loop makes its cells the longest).
"""
import argparse
import time
import traceback

from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES, cell_supported
from repro_torch.launch.dryrun import lower_cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="one arch, a comma-separated list, or all")
    ap.add_argument("--shape", default="all",
                    help="one shape, a comma-separated list, or all")
    ap.add_argument("--mesh", default="both",
                    choices=["both", "single-pod", "multi-pod"])
    args = ap.parse_args()
    archs = C.ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"both": (False, True), "single-pod": (False,),
              "multi-pod": (True,)}[args.mesh]
    n_bad = 0
    for mp in meshes:
        for arch in archs:
            cfg = C.get_config(arch)
            for sname in shapes:
                shape = SHAPES[sname]
                ok, reason = cell_supported(cfg, shape)
                if not ok:
                    if mp == meshes[0]:
                        print(f"SKIP {arch} × {sname}: {reason}")
                    continue
                t0 = time.time()
                try:
                    lower_cell(arch, shape, mp)
                    print(f"OK   {arch} × {sname} mp={mp} "
                          f"({time.time()-t0:.1f}s)", flush=True)
                except Exception as e:
                    n_bad += 1
                    print(f"FAIL {arch} × {sname} mp={mp}: "
                          f"{type(e).__name__}: {e}", flush=True)
                    traceback.print_exc(limit=8)
    print(f"preflight: {n_bad} failures")
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
