"""The port's contract audit, green on the CPU, and its parity with the
reference's registry.

* Every single-device and streaming case of the grid (but the 64-request
  buckets) runs under the census on the CPU (the ``cuda`` backend's kernels run their plain versions and
  still count ``CALLS``) and meets its contract; the CLI's quick run exits
  0 and covers all 11 contracts; with no CUDA device and no ``--device
  cpu`` it refuses.
* The port registers the reference's 11 contracts under the same names,
  its grid builds the reference's labels (backend part mapped), and for
  every mesh label the port's per-round collective count and byte bound
  are held against the reference registry's ``Expect`` (built without
  tracing). Where they differ, :data:`REASONS` says why, and every reason
  is used.

The mesh cases themselves run on two gloo ranks in
``tests/test_torch_audit_mesh.py``.
"""
import json

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch.analysis import audit  # noqa: E402
from repro_torch.analysis import registry as rg  # noqa: E402
from repro_torch.analysis.report import evaluate_case  # noqa: E402

CPU = torch.device("cpu")
#: the single-device and streaming cases; the 64-request buckets run in
#: the CLI's full grid (and two of them in tests/test_torch_analysis.py)
LOCAL = {c.label: c for c in rg.build_cases(CPU, mesh=False)
         if "[B=64]" not in c.label}
#: every case of the grid at p = 1 (the reference audits on one device)
GRID = {c.label: c for c in rg.build_cases(CPU, p=1, memory=True)}
MESH_LABELS = sorted(label for label, c in GRID.items() if c.mesh)


@pytest.mark.parametrize("label", sorted(LOCAL))
def test_single_device_and_streaming_case_green(label):
    r = evaluate_case(LOCAL[label])
    assert r.ok, "; ".join(map(str, r.violations))


def test_cli_quick_on_cpu_covers_every_contract(tmp_path, capsys):
    out = tmp_path / "audit.json"
    assert audit.main(["--device", "cpu", "--quick", "--json",
                       str(out)]) == 0
    rep = json.loads(out.read_text())
    s = rep["summary"]
    assert s["ok"] and s["contracts_registered"] == 11
    assert s["contracts_covered"] == 11 and not s["uncovered_contracts"]
    assert {r["name"] for r in rep["runtime"]} == {
        "retrace.device", "retrace.batched", "retrace.sharded",
        "retrace.sieve", "donation.live", "donation.sieve", "overlap.sieve",
        "service.bucket"}
    assert "AUDIT OK" in capsys.readouterr().out


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert audit.main(["--audit-only"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="--device cpu"):
        audit.run_audit("cuda")


# ---------------------------------------------------------------------------
# parity with the reference's registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    from repro.analysis import contracts as rc
    from repro.analysis.registry import build_cases
    from repro.core import distributed, engine, service, streaming  # noqa: F401

    return {"contracts": dict(rc.CONTRACTS),
            "cases": {c.label: c for c in build_cases()}}


def test_contract_names_match_reference(ref):
    from repro_torch.analysis.contracts import CONTRACTS

    audit._load_contracts()
    assert sorted(CONTRACTS) == sorted(ref["contracts"])
    assert len(CONTRACTS) == 11


def test_grid_builds_the_reference_labels(ref):
    assert len(GRID) == len(ref["cases"]) == 439
    assert {c.ref_label for c in GRID.values()} == set(ref["cases"])
    for c in GRID.values():
        assert c.contract == ref["cases"][c.ref_label].contract


#: Why the port's per-round collective count (``count``) or byte bound
#: (``bytes``) differs from the reference's, by (case family, kind or
#: plan, what). ``ordered_sum`` is one all-gather and a left fold in shard
#: order (the reference's psum), ``owner_gather`` one all-reduce of one
#: real row against zeros.
REASONS = {
    ("device_sharded_pool", "dense", "count"):
        "the reference counts its blocked-take psum once, statically, "
        "inside its lax.map; the port issues one owner gather per block of "
        "bm = 16 columns at run time: ⌈48/16⌉ = 3, so a dense round is one "
        "all-gather and 3 + 1 (the winner) owner gathers (+1 graph cut), "
        "against the reference's 1 + 1 + 1 (+1)",
    ("greedi", "dense", "count"):
        "the reference budgets no per-round body (its phase-1 scan is "
        "local-only and its other psums are counted per dispatch); a port "
        "round adds p + 1 all-gathers — the p partition solutions' global "
        "values gain one fold each, the merge greedy one round — and, for "
        "graph cut, p + 1 owner gathers",
    ("sieve_sieve.sharded", "jnp", "count"):
        "the port's element step sends the seed's and the table's gains "
        "and the table's stat sums in ONE all-gather on both backends; the "
        "reference's jnp step psums the singleton gain, the table gains and "
        "the values separately (3)",
    ("sieve_pp.sharded", "jnp", "count"):
        "as sieve, plus ++'s post-fold values: the port 1 + 1, the "
        "reference 3 + 1",
    ("sieve_salsa.sharded", "jnp", "count"):
        "Salsa reads no values: the port's one all-gather carries the seed "
        "and table gains, the reference's jnp step psums the singleton and "
        "the table gains separately (2)",
    ("sieve_sieve.sharded", "pallas_interpret", "count"):
        "the reference's kernel step psums the fused seed + table gains and "
        "then the values (2); the port's all-gather carries both (1)",
    ("sieve_pp.sharded", "pallas_interpret", "count"):
        "as sieve, plus ++'s post-fold values: the port 1 + 1, the "
        "reference 2 + 1",
    ("sieve.sharded", "*", "bytes"):
        "the port's one payload carries the S_max stat sums beside the "
        "1 + S_max gains: (1 + 2·S_max)·4 B (Salsa, which reads no values: "
        "(1 + S_max)·4 B, the reference's bound); still O(S_max), never "
        "O(n)",
}


def _port_count(c) -> int:
    """Collectives one round issues for one scored batch: a dense or
    stochastic round, or a CELF round with one re-score iteration."""
    e = c.expect
    return sum(e.collectives.values()) + \
        sum(e.collectives_per_iteration.values())


def _reason_key(c, what):
    head = c.label.split(".")[0]
    if head.startswith("sieve_"):
        plan = c.label.split(".")[1]
        if what == "bytes":
            return ("sieve." + plan, "*", what)
        return (f"{head}.{plan}", rg.REF_BACKEND[c.backend], what)
    return (head, c.kind, what)


def _differences(c, r):
    """[(reason key, port, reference)] where the two disagree."""
    out = []
    e, re_ = c.expect, r.expect
    ref_count = re_.body_psums if re_.body_psums is not None \
        else sum(re_.collectives.values()) if not c.mesh else None
    if _port_count(c) != ref_count:
        out.append((_reason_key(c, "count"), _port_count(c), ref_count))
    if e.max_collective_bytes != re_.max_collective_bytes:
        out.append((_reason_key(c, "bytes"), e.max_collective_bytes,
                    re_.max_collective_bytes))
    return out


@pytest.mark.parametrize("label", MESH_LABELS)
def test_mesh_collective_budget_vs_reference(ref, label):
    c = GRID[label]
    for key, mine, theirs in _differences(c, ref["cases"][c.ref_label]):
        assert key in REASONS, (
            f"{label}: port {key[2]} {mine} vs reference {theirs} has no "
            f"stated reason")


def test_single_device_cases_are_collective_free_in_both(ref):
    for c in GRID.values():
        if not c.mesh:
            r = ref["cases"][c.ref_label]
            assert not c.expect.collectives and not r.expect.collectives, \
                c.label


def test_every_reason_is_used(ref):
    used = {key for c in GRID.values() if c.mesh
            for key, _, _ in _differences(c, ref["cases"][c.ref_label])}
    assert used == set(REASONS)


@pytest.mark.parametrize("kind,batch", [("dense", 1), ("stochastic", 1),
                                        ("lazy", 1), ("dense", 4)])
def test_kernel_route_memory_bound_at_paper_size(kind, batch):
    """The card's paper-size cases hold their peak to ``kernel_bound``: it
    covers the kernel path's own partials workspace, gathered candidates
    and ping-pong caches, and a full (n, m) fp32 matrix breaks it."""
    import math

    from repro_torch.kernels._build import n_segments

    n, d = 50_000, 100
    m = math.ceil(n / 10 * math.log(10)) if kind == "stochastic" else n
    case = rg.paper_selection_case(
        kind, "fp32", torch.zeros((n, d)).numpy(), CPU, batch=batch)
    bound = case.expect.memory_bound
    held = batch * (n_segments(n) * m * 4 + m * d * 4 + 2 * n * 4)
    assert held < bound < batch * n * m * 4
    assert bound == rg.kernel_bound(n, m, d, 4, batch,
                                    fresh_candidates=kind == "stochastic")
