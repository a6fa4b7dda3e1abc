"""The benchmark's files as data, its yardstick, and its reference, on the
CPU: ``python -m pytest bench/tests`` from the root of the repository."""
from __future__ import annotations

import ast
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import data, devtrace, reference, work  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"] and _line(c["source"])
        assert conf["policy"] in work.ITEMSIZE
    assert len({c["source"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(isinstance(v["limit"], float)
                              for v in limits.values())
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert _line(metric["layer"])
    assert set(metric) <= keys and set(metric) >= keys - {"workloads"}
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    src = (BENCH / "metrics" / f"{metric['name']}.py").read_text()
    assert "def read(run)" in src


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS \
        + [m["name"] for m in METRICS] \
        + [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")] \
        + [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)


def _cells_of(metric):
    return set(metric.get("workloads", CELLS))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        assert any(cell in _cells_of(m) for m in SPEC["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(cell in _cells_of(m) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_names_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    assert _cells_of(metric) <= _cells_of(e2e[metric["moves"]])


def test_a_layer_has_one_name():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


@pytest.mark.parametrize("case", [
    ("multiset", "fp32", 7.46e-3), ("multiset", "fp16", 0.506e-3),
    ("greedy", "fp32", 74.6e-3), ("greedy", "fp16", 5.06e-3)],
    ids=lambda c: f"{c[0]}-{c[1]}")
def test_work_bounds_at_the_papers_size(case):
    what, policy, expected = case
    w = work.multiset(50_000, 5_000, 10, 100, policy) if what == "multiset" \
        else work.greedy(50_000, 10, 100, policy)
    bound = work.bound_s(w, "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(expected, rel=2e-3)
    assert work.bound_s(w, "an unknown card") is None


def _brute_values(V, idx):
    """f(S_j) by the definitions, one point and one exemplar at a time."""
    X = V.to(torch.float64)
    L0 = sum(float(x @ x) for x in X) / len(X)
    out = []
    for row in idx.tolist():
        L = sum(min([float(x @ x)] + [float((x - X[s]) @ (x - X[s]))
                                      for s in row]) for x in X) / len(X)
        out.append(L0 - L)
    return out


def _brute_greedy(V, k):
    X = V.to(torch.float64)
    n = len(X)
    D = [[float((X[i] - X[j]) @ (X[i] - X[j])) for j in range(n)]
         for i in range(n)]
    cache = [float(x @ x) for x in X]
    L0 = sum(cache) / n
    picks, values = [], []
    for _ in range(k):
        gains = [-1.0 if c in picks else
                 sum(max(cache[i] - D[i][c], 0.0) for i in range(n)) / n
                 for c in range(n)]
        p = max(range(n), key=lambda c: gains[c])
        picks.append(p)
        cache = [min(cache[i], D[i][p]) for i in range(n)]
        values.append(L0 - sum(cache) / n)
    return picks, values


def _toy(seed, n=40, d=6):
    return data.blobs(n, d, 3, 0.2, data.generator("cpu", seed, 0))


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_values_match_brute_force(seed):
    V = _toy(seed)
    idx = data.k_subsets(40, 9, 4, data.generator("cpu", seed, 1))
    got = reference.multiset_values(V, idx, "fp32")
    assert got.tolist() == pytest.approx(_brute_values(V, idx), rel=1e-12)
    assert reference.multiset_gap(V, idx, got.tolist(), "fp32") < 1e-14


@pytest.mark.parametrize("seed", [3, 2**31 + 12])
def test_reference_greedy_matches_brute_force(seed):
    V = _toy(seed)
    picks, values = reference.greedy_select(V, 5, "fp32")
    bpicks, bvalues = _brute_greedy(V, 5)
    assert picks == bpicks
    assert values == pytest.approx(bvalues, rel=1e-12)
    assert reference.greedy_gap(V, picks, values, "fp32") < 1e-14


def test_reference_judges_a_wrong_pick_and_a_wrong_value():
    V = _toy(5)
    picks, values = reference.greedy_select(V, 4, "fp32")
    worse = picks[:2] + [p for p in range(40) if p not in picks][:1] \
        + picks[3:]
    assert reference.greedy_gap(V, worse, values, "fp32") > 1e-6
    shifted = values[:3] + [values[3] * (1 + 1e-5)]
    assert reference.greedy_gap(V, picks, shifted, "fp32") > 1e-6
    assert reference.greedy_gap(V, picks[:1] * 2, values[:2], "fp32") \
        == float("inf")


def test_k_subsets_are_distinct_and_repeat_from_the_seed():
    a = data.k_subsets(50_000, 500, 10, data.generator("cpu", 7, 1, 3))
    b = data.k_subsets(50_000, 500, 10, data.generator("cpu", 7, 1, 3))
    assert torch.equal(a, b)
    assert bool(torch.all(a[:, 1:] > a[:, :-1]))
    assert int(a.min()) >= 0 and int(a.max()) < 50_000


def test_seed_paths_differ():
    seeds = [data.seed_of(s, *p) for s, p in itertools.product(
        (0, 1, 2**31 + 5, -1), ((0,), (1, 0), (1, 1), (2, 0)))]
    assert len(set(seeds)) == len(seeds)


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH / "reference.py").read_text())
    mods = {a.name.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.Import) for a in node.names} | {
        node.module.split(".")[0] for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom) and node.module}
    assert mods <= {"__future__", "math", "torch"}, mods


def test_no_module_bench_runs_is_jax_or_the_jax_package():
    """A CPU run of every cell, in a process of its own: no module it loads
    has the top-level name jax, jaxlib, flax or repro (repro_torch is the
    program)."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from bench import run
for name in {CELLS!r}:
    for trace in (False, True):
        cell = run.load_cell(Path({str(ROOT)!r}), name, trace)
        cell.config = dict(cell.config, n=300)
        if "l" in cell.traffic:
            cell.traffic = dict(cell.traffic, l=16)
        res, code = run.run_cell(cell, 5, 0.2, trace, device="cpu")
        assert code == 0 and res is not None, (name, code)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded


def test_the_harness_refuses_to_run_outside_a_checkout(tmp_path):
    (tmp_path / "bench").symlink_to(BENCH)
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_harness_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


class _Event:
    def __init__(self, name, start, dur, cuda=False, corr=0):
        self._v = name, start, dur, cuda, corr

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] \
            else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        class R:
            def events(self):
                return events
        self.profiler = type("P", (), {"kineto_results": R()})()


def test_devtrace_counts_what_the_programs_calls_launched():
    """A device operation is the program's when the host call that
    launched it (same correlation id) lies inside a ``bench.call.`` span,
    whatever its name or when it ran; a draw launched outside is not."""
    ev = [_Event("bench.window", 0, 1000),
          _Event("bench.call.value_multi", 100, 200),
          _Event("cudaLaunchKernel", 150, 10, corr=7),
          _Event("bench.draw", 320, 50),
          _Event("cudaLaunchKernel", 330, 5, corr=8),
          _Event("cuLaunchKernel", 160, 5, corr=9),
          _Event("bench.call.value_multi", 400, 10, cuda=True),
          _Event("any_new_kernel_name", 200, 300, cuda=True, corr=7),
          _Event("draw_kernel", 340, 100, cuda=True, corr=8),
          _Event("Memcpy DtoH", 600, 50, cuda=True, corr=9),
          _Event("lost", 700, 20, cuda=True, corr=11)]
    t = devtrace.summarize(_Prof(ev))
    assert t["calls_s"] == pytest.approx(350e-9)
    assert t["unlaunched_s"] == pytest.approx(20e-9)
    assert t["busy_s"] == pytest.approx((500 - 200 + 50 + 20) * 1e-9)
    assert t["window_s"] == pytest.approx(1000e-9)
    assert "bench.call.value_multi" not in t["kernels"]
