"""The mesh contracts on two gloo ranks (``spawn_local``, on the CPU).

One spawn of p = 2 ranks runs every mesh case of the audit grid at the
fp32 policy — ``device_sharded`` and ``device_sharded_pool``, unbatched and
batched (B = 1, 4), GreeDi, and the sharded sieve family — under the census
at k = K, K + 1 and K + 2 on every rank, and returns each case's result.
The parametrised tests then assert case by case that every rank met the
contract: the exact all-gathers and all-reduces per round (GreeDi: p + 1
per round at p = 2), each operand under its O(m), O(B·m) or O(S_max)
bound, no host sync but CELF's, and the same metrics on both ranks.

The ranks import this module: it imports no JAX.
"""
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch.analysis import registry as rg  # noqa: E402

P = 2
LABELS = sorted(c.label for c in rg.build_cases("cpu", p=P)
                if c.mesh and not c.label.endswith(".bf16"))


def _audit_rank(rank, world, labels):
    from repro_torch.analysis.report import evaluate_case

    cases = {c.label: c for c in rg.build_cases("cpu", p=world)}
    out = {}
    for label in labels:
        r = evaluate_case(cases[label])
        m = dict(r.metrics)
        m.pop("seconds", None)
        out[label] = ([str(v) for v in r.violations], m)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.core import distributed

    return distributed.spawn_local(
        _audit_rank, P, store_dir=tmp_path_factory.mktemp("audit_mesh"),
        args=(LABELS,), timeout=600)


@pytest.mark.parametrize("label", LABELS)
def test_mesh_case_green_on_two_ranks(ranks, label):
    for q, res in enumerate(ranks):
        violations, _ = res[label]
        assert not violations, f"rank {q}: {violations}"
    assert ranks[0][label][1] == ranks[1][label][1]


def test_greedi_collectives_grow_with_p(ranks):
    m = ranks[0]["greedi.dense.graph_cut.cuda.fp32"][1]
    assert m["collectives_per_round"] == {"allgather_": P + 1,
                                          "allreduce_": P + 1}


def test_batched_graph_cut_fold_is_one_owner_gather(ranks):
    """Regression: the batched mesh fold of graph cut issued one owner
    gather per tenant; now all B tenants' entries ride one."""
    m = ranks[0]["device_sharded.batched[B=4].dense.graph_cut.cuda.fp32"][1]
    assert m["collectives_per_round"] == {"allgather_": 1, "allreduce_": 1}
