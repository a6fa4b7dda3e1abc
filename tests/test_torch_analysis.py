"""Negative fixtures for the port's contract auditor and lint.

Each checker must actually *detect* the defect class it exists for: one
deliberately bad fixture per claim (a host sync in a round, a round census
that grows with k, a second collective, an O(n·d) collective operand, one
collective per tenant, a fold that allocates a fresh cache every round, an
fp32 copy of a bf16 payload, a kernel rebuilt on a second call, a launch
over budget), asserted to be flagged — plus the green half: the small
accumulator widen, the lint's suppression comment, a clean loop body, the
port's tree lint-clean with exactly CELF's two allowed syncs, and no JAX
or reference import anywhere in the port or in ``chip_smoke.py``.

Everything runs on the CPU, where the kernel wrappers run their plain
versions (and still count ``CALLS``).
"""
import ast
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()
dist = pytest.importorskip("torch.distributed")

from repro_torch.analysis import census as cz  # noqa: E402
from repro_torch.analysis import registry as rg  # noqa: E402
from repro_torch.analysis.lint import (LOOP_BODIES,  # noqa: E402
                                       allowed_lines, lint_source,
                                       lint_tree, missing_loop_bodies)
from repro_torch.analysis.registry import AuditCase, Expect  # noqa: E402
from repro_torch.analysis.report import evaluate_case  # noqa: E402
from repro_torch.core import distributed as rdist  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
CPU = torch.device("cpu")


@pytest.fixture
def group():
    """A one-rank gloo group for the collective fixtures."""
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _toy(contract, body, **expect):
    """A case whose entry point runs ``body`` once per round."""
    def run(k):
        x = torch.zeros(8)
        for t in range(k):
            x = body(x, t)
        return x

    return AuditCase(contract=contract, label="toy",
                     build=lambda k: (run, (k,), {}),
                     expect=Expect(rounds=rg.K, **expect))


def _checks(result):
    return {v.check for v in result.violations}


def _case(label, **kw):
    cases = rg.build_cases(CPU, mesh=kw.pop("mesh", False))
    return next(c for c in cases if c.label == label)


# ---------------------------------------------------------------------------
# host syncs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sync", ["item", "mask_index", "tolist", "int",
                                  "nonzero"])
def test_host_sync_in_round_detected_by_census(sync):
    ops = {
        "item": lambda x: x.sum().item(),
        "mask_index": lambda x: x[x > 0],
        "tolist": lambda x: x.tolist(),
        "int": lambda x: int(x[0]),
        "nonzero": lambda x: torch.nonzero(x),
    }

    def body(x, t):
        ops[sync](x)
        return x + 1

    r = evaluate_case(_toy("engine.select_scan", body))
    assert "syncs" in _checks(r)
    assert r.metrics["syncs_per_round"] == 1


def test_host_sync_in_engine_round_detected(monkeypatch):
    """The real dense round with one ``bool(tensor)`` slipped in: the
    census sees one sync per round, at a line not allowed to sync."""
    real = eng.make_rounds_step

    def leaky(take, fold_score_val):
        step = real(take, fold_score_val)

        def step2(carry, cand_t):
            out = step(carry, cand_t)
            bool(out[1][1] > 0)     # the defect: a host read per round
            return out
        return step2

    case = _case("device.dense.exemplar.cuda.fp32")
    assert evaluate_case(case).ok
    monkeypatch.setattr(eng, "make_rounds_step", leaky)
    r = evaluate_case(case)
    assert "syncs" in _checks(r) and r.metrics["syncs_per_round"] == 1


def test_host_staging_detected():
    """``torch.tensor`` of a host value inside the call is a blocking copy
    to the card: the census counts it against the call's zero budget."""
    def run(k):
        x = torch.zeros(4)
        for _ in range(k):
            x = x + torch.tensor(1.0)
        return x

    case = AuditCase("engine.select_scan", "toy",
                     lambda k: (run, (k,), {}), Expect(rounds=rg.K))
    r = evaluate_case(case)
    assert "syncs" in _checks(r) and r.metrics["staging_call"] == rg.K


@pytest.mark.parametrize("src", [
    "def make():\n    def step(carry, x):\n        return carry.item()\n"
    "    return step\n",
    "def make():\n    def step(carry, x):\n        m = x[x > 0]\n"
    "        if torch.any(m > 0):\n            carry = carry + 1\n"
    "        return carry\n    return step\n",
    "def make():\n    def step(carry, x):\n        return bool(carry > 0)\n"
    "    return step\n",
    "def make():\n    def step(carry, x):\n        y = torch.max(x)\n"
    "        while y > 0:\n            y = y - 1\n        return y\n"
    "    return step\n",
])
def test_host_sync_detected_by_lint(src):
    rules = {f.rule for f in lint_source(src, loop_bodies=("make.step",))}
    assert "host-sync" in rules


def test_lint_allow_suppresses():
    src = ("def make():\n    def step(carry, x):\n"
           "        return carry.item()  # lint: allow(host-sync)\n"
           "    return step\n")
    assert not lint_source(src, loop_bodies=("make.step",))
    # the marker quoted in a string allows nothing
    src = ("def make():\n    def step(carry, x):\n"
           "        return carry.item(), '# lint: allow(host-sync)'\n"
           "    return step\n")
    assert lint_source(src, loop_bodies=("make.step",))


def test_clean_loop_body_not_flagged():
    src = ("import torch\n\ndef make(kind):\n"
           "    def step(carry, x, t: int):\n"
           "        if kind == 'dense' and t > 0 and carry is not None:\n"
           "            carry = torch.where(x > 0, carry + x, carry)\n"
           "        n = len(x) + x.shape[0]\n"
           "        return carry, n\n    return step\n")
    assert not lint_source(src, loop_bodies=("make.step",))


def test_np_in_loop_and_float_eq_detected():
    src = ("import numpy as np\n\ndef make():\n    def step(carry, x):\n"
           "        return np.sum(x)\n    return step\n\n"
           "def f(x):\n    return x == 1.5\n")
    rules = {f.rule for f in lint_source(src, loop_bodies=("make.step",))}
    assert rules == {"np-in-loop", "float-eq"}


def test_port_tree_is_lint_clean_with_only_celf_syncs_allowed():
    assert not lint_tree(PKG), "\n".join(map(str, lint_tree(PKG)))
    marked = [(p.relative_to(PKG).as_posix(), i)
              for p in sorted(PKG.rglob("*.py"))
              for i in allowed_lines(p.read_text(), "host-sync")]
    assert [p for p, _ in marked] == ["core/engine.py"] * 2
    src = (PKG / "core" / "engine.py").read_text().splitlines()
    assert "bool(fresh_best < torch.max(stale))" in src[marked[0][1] - 1]
    assert "bool(torch.any(active))" in src[marked[1][1] - 1]
    assert set(cz.allowed_sync_sites()) == {f"{p}:{i}" for p, i in marked}


def test_every_listed_loop_body_exists():
    assert not missing_loop_bodies(PKG)
    assert sum(len(v) for v in LOOP_BODIES.values()) == 9


def test_a_removed_loop_body_is_a_finding(tmp_path):
    (tmp_path / "core").mkdir()
    for rel in LOOP_BODIES:
        (tmp_path / rel).write_text("def unrelated():\n    return 1\n")
    findings = lint_tree(tmp_path)
    assert {f.rule for f in findings} == {"loop-body"}
    assert len(findings) == sum(len(v) for v in LOOP_BODIES.values())


# ---------------------------------------------------------------------------
# round census
# ---------------------------------------------------------------------------


def test_round_census_growing_with_k_detected():
    def body(x, t):
        for _ in range(t):          # the defect: round t does t more ops
            x = x + 1
        return x

    r = evaluate_case(_toy("engine.select_scan", body))
    assert "uniform" in _checks(r)


def test_uniform_round_census_passes():
    r = evaluate_case(_toy("engine.select_scan", lambda x, t: x * 2 + 1))
    assert r.ok, r.violations


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _shards():
    # resolved once per group, outside the measured call: resolving a mesh
    # reads its device grid on the host and gathers every rank's identity
    return rdist.resolve_mesh(None, ("data",))


def test_second_collective_per_round_detected(group):
    sh = _shards()

    def one(x, t):
        return rdist.ordered_sum(sh, x)

    def two(x, t):
        x = rdist.ordered_sum(sh, x)
        return x + rdist.ordered_sum(sh, x.max()[None])

    want = dict(collectives=Counter({"allgather_": 1}),
                max_collective_bytes=64)
    assert evaluate_case(_toy("distributed.selection_scan[replicated]", one,
                              **want)).ok
    r = evaluate_case(_toy("distributed.selection_scan[replicated]", two,
                           **want))
    assert "collectives" in _checks(r)
    assert r.metrics["collectives_per_round"] == {"allgather_": 2}


def test_oversized_collective_operand_detected(group):
    """An O(n·d) payload on a collective busts the O(m) byte bound."""
    V, sh = torch.ones(48, 8), _shards()

    def big(x, t):
        rdist.gather_shards(sh, V * x[0])
        return x + 1

    r = evaluate_case(_toy("distributed.selection_scan[replicated]", big,
                           collectives=Counter({"allgather_": 1}),
                           max_collective_bytes=(48 + 1) * 4))
    assert "collectives" in _checks(r)
    assert r.metrics["max_collective_bytes"] == 48 * 8 * 4


def test_per_tenant_collective_detected(group):
    """The batched budget is ONE collective per scored batch whatever B
    is; a per-tenant loop of collectives is B."""
    B, sh = 4, _shards()

    def stacked(x, t):
        return x + rdist.ordered_sum(sh, x.reshape(B, 2)).sum()

    def per_tenant(x, t):
        parts = [rdist.ordered_sum(sh, x.reshape(B, 2)[b])
                 for b in range(B)]
        return x + torch.stack(parts).sum()

    want = dict(collectives=Counter({"allgather_": 1}),
                max_collective_bytes=B * 2 * 4)
    name = "distributed.selection_scan_batched[replicated]"
    assert evaluate_case(_toy(name, stacked, **want)).ok
    r = evaluate_case(_toy(name, per_tenant, **want))
    assert r.metrics["collectives_per_round"] == {"allgather_": B}
    assert "collectives" in _checks(r)


def test_collective_in_collective_free_contract_detected(group):
    sh = _shards()

    def body(x, t):
        return rdist.owner_gather(sh, x)

    r = evaluate_case(_toy("engine.select_scan", body))
    assert "collectives" in _checks(r)


# ---------------------------------------------------------------------------
# in-place reuse
# ---------------------------------------------------------------------------


def test_fold_allocating_fresh_cache_detected(monkeypatch):
    """The fused round handed no output buffer allocates a fresh cache
    every round: the census holds every cache buffer it sees, so the
    allocator cannot hand the same address back and hide it."""
    from repro_torch.kernels import ops as kops

    real = kops.fused_gain_update

    def fresh(*a, cache_out=None, **kw):
        return real(*a, cache_out=None, **kw)

    case = _case("device.dense.exemplar.cuda.fp32")
    monkeypatch.setattr(kops, "fused_gain_update", fresh)
    r = evaluate_case(case)
    assert "reuse" in _checks(r)
    assert r.metrics["cache_allocs_per_round"] == 1


@pytest.mark.parametrize("label", [
    "batched[B=64].dense.exemplar.cuda.fp32",
    "batched[B=64].stochastic.facility_location.cuda.bf16",
])
def test_batched_fused_rounds_ping_pong(label):
    """Regression: the batched fused round wrote a fresh (B, n) cache
    every round and froze requests with one more; it now ping-pongs two
    buffers and gates a frozen request's fold off."""
    r = evaluate_case(_case(label))
    assert r.ok, r.violations
    assert r.metrics["cache_allocs_per_round"] == 0


def test_sieve_table_replaced_detected():
    from repro_torch.core import streaming as st

    case = _case("sieve_sieve.device.exemplar.cuda")

    def build(k):
        fn, args, kw = case.build(k)

        def copying(state, *rest):
            state = state._replace(caches=state.caches.clone())
            return fn(state, *rest)
        return copying, args, kw

    assert isinstance(case.build(rg.K)[1][0], st.SieveState)
    r = evaluate_case(AuditCase(case.contract, case.label, build,
                                case.expect))
    assert "reuse" in _checks(r)


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def test_fp32_copy_of_bf16_payload_detected():
    V = torch.randn(48, 8).to(torch.bfloat16)

    def leak(x, t):
        return x + V.to(torch.float32).sum()   # payload-sized widen

    r = evaluate_case(_toy("engine.select_scan", leak, widen_elems=112))
    assert "precision" in _checks(r)


def test_small_accumulator_widen_allowed():
    g = torch.randn(8).to(torch.bfloat16)
    V = torch.randn(48, 8).to(torch.bfloat16)

    def accum(x, t):
        return x + (V @ V.T).sum().float() + g.to(torch.float32)

    r = evaluate_case(_toy("engine.select_scan", accum, widen_elems=112,
                           require_half=True))
    assert r.ok, r.violations
    assert r.metrics["half_matmuls"] >= 1


def test_half_policy_that_never_reaches_the_product_detected():
    V = torch.randn(48, 8)

    def fp32_only(x, t):
        return x + (V @ V.T).sum()

    r = evaluate_case(_toy("engine.select_scan", fp32_only, widen_elems=112,
                           require_half=True))
    assert "precision" in _checks(r)


# ---------------------------------------------------------------------------
# kernels: rebuilds, budgets, CALLS
# ---------------------------------------------------------------------------


def test_kernel_rebuild_on_second_call_detected(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", dict(_build._LIBS))
    n = [0]

    def rebuilding():
        n[0] += 1
        _build._LIBS[f"marginal_gain-{n[0]}"] = object()

    ok, detail = rg._no_rebuild(rebuilding)
    assert not ok and "marginal_gain-2" in detail
    assert rg._no_rebuild(lambda: None)[0]


def test_launch_over_budget_detected():
    from repro_torch.core.precision import resolve
    from repro_torch.kernels import marginal_gain as mg

    V, C, cache = torch.randn(16, 4), torch.randn(5, 4), torch.ones(16)

    def twice(x, t):
        for _ in range(2):
            x = x + mg.gain_eval(V, C, cache, n_total=16,
                                 policy=resolve("fp32")).sum()
        return x

    r = evaluate_case(_toy("engine.select_scan", twice,
                           launches={"gain_eval": 2}))
    assert "launches" in _checks(r)
    assert any("budget" in v.detail for v in r.violations)


def test_calls_counted_on_the_plain_route():
    from repro_torch.core.precision import resolve
    from repro_torch.kernels import ops

    before = Counter(ops.CALLS)
    launches = Counter(ops.LAUNCHES)
    V, C, cache = torch.randn(16, 4), torch.randn(5, 4), torch.ones(16)
    ops.marginal_gain(V, C, cache, policy=resolve("fp32"))
    ops.fused_gain_update(V, C, cache, V[0], policy=resolve("fp32"))
    assert ops.CALLS - before == Counter({"gain_eval": 1,
                                         "gain_update_eval": 1})
    assert ops.LAUNCHES == launches     # no launch off the card


def test_census_sees_the_kernel_operands():
    """The census counts calls per kernel and keeps the cache buffers the
    kernels read and write, and leaves the plain versions' own ops out."""
    from repro_torch.core.precision import resolve
    from repro_torch.kernels import ops

    V, C, cache = torch.randn(16, 4), torch.randn(5, 4), torch.ones(16)
    out = torch.empty(16)
    _, c = cz.take_census(ops.fused_gain_update, V, C, cache, V[0],
                          policy=resolve("fp32"), cache_out=out)
    assert c.calls == Counter({"gain_update_eval": 1})
    assert len(c.cache_buffers) == 2 and c.fresh_cache_outs == 0
    assert "mm" not in c.ops            # the plain version's matmul


# ---------------------------------------------------------------------------
# the port imports no JAX and nothing of the reference
# ---------------------------------------------------------------------------


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
              *(ROOT / "examples").glob("*_torch.py")]))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"
