"""The readings that each limit of ``bench/limits/`` is set from, at a
cell's own size, from the root of a checkout:

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... [--seconds 2]

For each seed, one process reads the program (set-up, a window of
``--seconds``, the run's own check) and the control, one precision below
the configuration's (``LOWER``), judged by the same check; and, beside it,
the other lower readings of ``ALSO``. One JSON line a seed. The
benchmark's runs do not run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

#: The control of each policy, one precision below it: for fp32 (TF32 off)
#: the reference with its products' operands rounded to TF32, which the
#: program has no path for; for fp16 the program's own bf16 policy (8
#: significand bits against fp16's 11, the same tensor-core tile); for bf16
#: the reference at fp8 (e4m3).
LOWER = {"fp32": ("reference", "tf32"), "fp16": ("program", "bf16"),
         "bf16": ("reference", "fp8")}
#: Further lower readings, reported beside the control: the reference on
#: the bf16-rounded payload, and the program's fp16 path that accumulates
#: in fp16 (``fp16_strict``).
ALSO = {"fp16": (("reference", "bf16"), ("program", "fp16_strict"))}


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    from bench.record import RunRecord

    t0 = time.perf_counter()
    state = cell.driver.setup(cell.config, cell.traffic, seed, device)
    rec = RunRecord(cell.name, cell.config, cell.traffic, device)
    cell.driver.window(state, seconds, rec)
    program = cell.driver.check(state, rec)
    del state
    t1 = time.perf_counter()
    policy = cell.config["policy"]
    control = cell.driver.control(cell.config, cell.traffic, seed, device,
                                  LOWER[policy])
    also = {":".join(lower): cell.driver.control(cell.config, cell.traffic,
                                                 seed, device, lower)
            for lower in ALSO.get(policy, ())}
    return {"seed": seed, "program": program, "control": control,
            "also": also,
            "attempted": rec.units["attempted"],
            "failed": rec.units["failed"],
            "program_s": t1 - t0, "control_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    root = Path.cwd()
    sys.path[:] = [str(root / "src"), str(root)] + sys.path[1:]
    from bench import run

    cell = run.load_cell(root, args.workload, False)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
