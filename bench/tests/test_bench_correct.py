"""What decides ``correct``: a sound run passes, the control (one precision
below the configuration's: the program's own bf16 path for fp16, the
reference at TF32 in the program's place for fp32) fails, so do the
further lower readings beside it, and so does a run whose timed path is
broken underneath, once for each fault a cell can have. On the CPU the cells run at a small size, the
program's kernels as their plain versions; the tests marked ``cuda`` run
the cells themselves on the card."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import control, run  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
MULTISET = [c for c in CELLS if c.endswith(".multiset")]
SELECT = [c for c in CELLS if c.endswith(".greedy")]


def small(name: str, n: int = 600):
    cell = run.load_cell(ROOT, name, False)
    cell.config = dict(cell.config, n=n)
    if "l" in cell.traffic:
        cell.traffic = dict(cell.traffic, l=48)
    return cell


def cpu_run(name: str, seed: int = 2**31 + 99):
    res, code = run.run_cell(small(name), seed, 0.3, False, device="cpu")
    assert code == 0
    return res


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = cpu_run(name)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "compared"


def _lowers(name):
    policy = run.load_cell(ROOT, name, False).config["policy"]
    return [control.LOWER[policy], *control.ALSO.get(policy, ())]


@pytest.mark.parametrize("name,lower", [(c, lo) for c in CELLS
                                        for lo in _lowers(c)],
                         ids=lambda x: ":".join(x) if isinstance(x, tuple)
                         else x)
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_control_is_not_correct(name, lower, seed):
    cell = small(name)
    got = cell.driver.control(cell.config, cell.traffic, seed, "cpu", lower)
    assert any(got[k] > v["limit"] for k, v in cell.limits.items()), got


def test_the_half_control_is_the_programs_bf16_path():
    assert control.LOWER["fp16"] == ("program", "bf16")
    assert control.LOWER["fp32"] == ("reference", "tf32")


def _altered_value(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[len(out) // 2] *= 1 + 1e-3
        return out
    return broken


def _exemplar_half(fn):
    def broken(V, S, lengths, d_e0, **kwargs):
        h = V.shape[0] // 2
        kwargs.pop("n_total", None)
        return fn(V[:h], S, lengths, d_e0[:h], **kwargs)
    return broken


def _gains_half(fn):
    def broken(V, C, mincache, winner, **kwargs):
        _, new = fn(V, C, mincache, winner, **kwargs)
        h = V.shape[0] // 2
        kw = {k: v for k, v in kwargs.items() if k not in ("n_total",
                                                           "cache_out")}
        gains, _ = fn(V[:h], C, mincache[:h], winner, **kw)
        return gains, new
    return broken


def _state_unchanged(fn):
    """The fused step leaves its cache as it was: no winner folds in."""
    def broken(*args, **kwargs):
        kwargs["w_valid"] = torch.zeros_like(kwargs["w_valid"])
        return fn(*args, **kwargs)
    return broken


def _pick_altered(fn):
    def broken(*args, **kwargs):
        gains, new = fn(*args, **kwargs)
        gains = gains.clone()
        gains[torch.argmax(gains)] = -1.0
        return gains, new
    return broken


FAULTS = [(c, "exemplar_eval", f) for c in MULTISET
          for f in (_exemplar_half, _altered_value)] \
    + [(c, "fused_gain_update", f) for c in SELECT
       for f in (_gains_half, _state_unchanged, _pick_altered)]


@pytest.mark.parametrize("name,op,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(name, op, fault, monkeypatch):
    monkeypatch.setattr(ops, op, fault(getattr(ops, op)))
    res = cpu_run(name)
    assert not res["correct"], res["compared"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(card, name):
    cell = run.load_cell(ROOT, name, False)
    got = cell.driver.control(cell.config, cell.traffic, 2**31 + 21, "cuda",
                              control.LOWER[cell.config["policy"]])
    assert any(got[k] > v["limit"] for k, v in cell.limits.items()), got
