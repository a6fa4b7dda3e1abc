"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration file and a traffic mix, ``bench/traffic/<traffic>.json``, which
names its driver, ``bench/drivers/<driver>.py``. The driver draws the inputs
from the seed, builds and warms up the program (set-up), drives it for the
window, and after the window judges what the program returned against the
plain reference (``bench/reference.py``), with the limits of
``bench/limits/<cell>.json``. Each metric is read by
``bench/metrics/<metric>.py``: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, from a profiled window.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared``: each number judged, with its limit).
The same numbers close standard error. With no CUDA device, with fewer than
the cell's chips, outside a checkout, if JAX or the JAX package was loaded,
or if a traced window recorded no device activity, the run prints no result
and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    limits: dict
    metrics: list


def load_module(path: Path):
    """The module in ``path``, found by its file name (which may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, trace: bool) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if _applies(m, name)]
    return Cell(name, w["chips"], json.loads((root / conf["file"]).read_text()),
                traffic, load_module(BENCH / "drivers"
                                     / f"{traffic['driver']}.py"),
                limits, metrics)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


#: What a reading records where the program gave no answer to judge.
NO_ANSWER = 1e300


def _number(x) -> float:
    return float(x) if x is not None and math.isfinite(x) else NO_ANSWER


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START):
    """One run of ``cell``: returns (result dict, exit code). The result is
    None where the run may print none."""
    import torch

    from bench import devtrace
    from bench.record import RunRecord
    from repro_torch.kernels import ops

    t_imported = time.perf_counter()
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    if device == "cuda":
        torch.cuda.init()
    t_device = time.perf_counter()
    rec = RunRecord(cell.name, cell.config, cell.traffic, kind)
    state = cell.driver.setup(cell.config, cell.traffic, seed, device)
    rec.setup_s = time.perf_counter() - t_start
    print(f"set-up: imports {t_imported - t_start:.3f} s, device "
          f"{t_device - t_imported:.3f} s, the driver's set-up "
          f"{rec.setup_s - (t_device - t_start):.3f} s", file=sys.stderr)
    launches0 = collections.Counter(ops.LAUNCHES)
    with devtrace.profiled(trace) as prof:
        with devtrace.span("window"):
            cell.driver.window(state, seconds, rec)
    rec.launches = collections.Counter(ops.LAUNCHES) - launches0
    if prof is not None:
        rec.device_trace = devtrace.summarize(prof)
        del prof
        t = rec.device_trace
        print(f"traced: busy {t['busy_s']:.6f} s of {t['window_s']:.6f} s; "
              f"device operations {sum(t['kernels'].values()):.6f} s, of "
              f"them launched in the program's calls {t['calls_s']:.6f} s "
              f"and with no launch in the trace {t['unlaunched_s']:.6f} s",
              file=sys.stderr)
        if device == "cuda" and not t["busy_s"] > 0:
            print("the profiler recorded no device activity in the window",
                  file=sys.stderr)
            return None, 5
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    t_check = time.perf_counter()
    readings = cell.driver.check(state, rec)
    del state
    print(f"the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    compared = {k: {"value": _number(readings.get(k)), "limit": v["limit"]}
                for k, v in cell.limits.items()}
    correct = (bool(compared) and rec.units["failed"] == 0
               and set(readings) == set(compared)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    metrics = {}
    for m in cell.metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": cell.chips if device == "cuda" else 1,
           "memory_peak_bytes": peak}
    if rec.device_trace is not None:
        dev["busy_s"] = rec.device_trace["busy_s"]
        dev["window_s"] = rec.device_trace["window_s"]
    if device == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": rec.units["attempted"],
              "failed": rec.units["failed"], "metrics": metrics,
              "device": dev}
    if rec.device_trace is not None:
        result["breakdown"] = rec.device_trace["breakdown"]
    result["compared"] = compared
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return None, 4
    return result, 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {root}: run from the root of a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    # the script's folder must not shadow top-level modules; the checkout's
    # root gives the package ``bench``, src/ the program
    sys.path[:] = [str(root / "src"), str(root)] + [
        x for x in sys.path[1:] if Path(x or ".").resolve() != BENCH]
    # every cache the program or torch keeps stays at a fixed place in the
    # checkout, so only a cell's first run there builds
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    cell = load_cell(root, args.workload, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, code = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return code
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
