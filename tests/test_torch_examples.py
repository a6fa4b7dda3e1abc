"""``examples/quickstart_torch.py`` against the reference's API, on the CPU.

The twin's ``run(device="cpu")`` goes through every step of
``examples/quickstart.py`` on the port (the ``cuda`` backend: the kernels'
plain versions on CPU tensors); the same steps run through the JAX
package's API. Selections and evaluation counts must be identical, values
within ``POLICY_TOLS`` of max(1, |reference|). The reference's last step,
``greedy(f, 8, mode="device_sharded")``, cannot run under jax 0.9.0
(ROADMAP C.1), so the twin's sharded line is held to the reference's device
plan. ``chip_smoke.py`` holds the twin's run on the card to constants of
the reference's figures (``QUICKSTART_FIGURES``); they must equal the
figures computed here afresh.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import quickstart_torch  # noqa: E402

#: tests/test_kernel_parity.py's per-policy bands, on max(1, |reference|).
POLICY_TOLS = {"fp32": 1e-5, "bf16": 5e-2, "fp16": 1e-2}
#: The stored constants against the figures computed afresh: the same
#: code on the same data, so only a change of either moves them.
CONSTANT_REL = 1e-6


def _figures(res) -> dict:
    return {"indices": [int(i) for i in res.indices],
            "value": float(res.value), "evaluations": int(res.evaluations)}


def reference_quickstart() -> dict:
    """The quickstart's steps through the JAX package's API, in the twin's
    format (without the sharded step, which the reference cannot run)."""
    import jax.numpy as jnp

    from repro.core import (EvalConfig, ExemplarClustering,
                            fit_exemplar_clustering, greedy, lazy_greedy)
    from repro.core.optimizers import OPTIMIZERS
    from repro.data.synthetic import blobs

    K = quickstart_torch.K
    X, true_labels = blobs(n=2000, dim=32, centers=8, seed=0)
    model = fit_exemplar_clustering(X, k=K, optimizer="greedy")
    labels = model.assign(X)
    purity = sum(np.bincount(true_labels[labels == c]).max()
                 for c in range(K)) / len(X)
    out = {"shape": list(X.shape), "true_clusters": len(set(true_labels)),
           "fit": dict(_figures(model.result),
                       cluster_sizes=np.bincount(labels).tolist(),
                       purity=float(purity))}
    f = ExemplarClustering(jnp.asarray(X))
    out["optimizers"] = {name: _figures(OPTIMIZERS[name](f, K))
                         for name in quickstart_torch.OPTIMIZER_NAMES}
    out["precision"] = {
        pol: _figures(fit_exemplar_clustering(
            X, k=K, cfg=EvalConfig(policy=pol)).result)
        for pol in quickstart_torch.POLICY_NAMES}
    out["greedy_host"] = _figures(greedy(f, K, mode="host"))
    out["greedy_device"] = _figures(greedy(f, K, mode="device"))
    out["lazy_host"] = _figures(lazy_greedy(f, K, mode="host"))
    out["lazy_device"] = _figures(lazy_greedy(f, K, mode="device"))
    return out


@pytest.fixture(scope="module")
def twin():
    return quickstart_torch.run("cpu")


@pytest.fixture(scope="module")
def reference():
    return reference_quickstart()


def _held(got, ref, policy="fp32"):
    assert got["indices"] == ref["indices"]
    assert got["evaluations"] == ref["evaluations"]
    assert abs(got["value"] - ref["value"]) <= POLICY_TOLS[policy] * max(
        1.0, abs(ref["value"]))


STEPS = (["fit"] + [f"optimizers/{n}" for n in quickstart_torch.OPTIMIZER_NAMES]
         + [f"precision/{p}" for p in quickstart_torch.POLICY_NAMES]
         + ["greedy_host", "greedy_device", "lazy_host", "lazy_device"])


def _step(figs, step):
    for key in step.split("/"):
        figs = figs[key]
    return figs


@pytest.mark.parametrize("step", STEPS)
def test_quickstart_step_matches_reference(twin, reference, step):
    policy = step.split("/")[1] if step.startswith("precision/") else "fp32"
    _held(_step(twin, step), _step(reference, step), policy)


def test_quickstart_clusters_match_reference(twin, reference):
    assert twin["shape"] == reference["shape"] == [2000, 32]
    assert twin["true_clusters"] == reference["true_clusters"] == 8
    assert twin["fit"]["cluster_sizes"] == reference["fit"]["cluster_sizes"]
    assert twin["fit"]["purity"] == reference["fit"]["purity"]
    assert twin["greedy_device"]["indices"] == twin["greedy_host"]["indices"]
    assert twin["lazy_device"]["indices"] == twin["lazy_host"]["indices"]


def test_quickstart_sharded_step_equals_reference_device_plan(twin, reference):
    """The one-rank gloo group's ``device_sharded`` greedy against the
    reference's device plan (its own sharded step fails, C.1)."""
    assert twin["sharded"]["devices"] == 1
    _held(twin["sharded"], reference["greedy_device"])
    assert not torch.distributed.is_initialized()


def test_chip_smoke_constants_are_the_reference_figures(reference):
    """``chip_smoke.py``'s ``QUICKSTART_FIGURES`` equal the reference's
    figures computed afresh: indices, evaluations, cluster sizes exactly,
    values within ``CONSTANT_REL``."""
    stored = chip_smoke.QUICKSTART_FIGURES
    assert sorted(stored) == sorted(set(reference) - {"shape",
                                                      "true_clusters"})
    for step in STEPS:
        got, want = _step(stored, step), _step(reference, step)
        assert sorted(got) == sorted(want)
        assert got["indices"] == want["indices"], step
        assert got["evaluations"] == want["evaluations"], step
        assert abs(got["value"] - want["value"]) <= CONSTANT_REL * max(
            1.0, abs(want["value"])), step
    assert stored["fit"]["cluster_sizes"] == reference["fit"]["cluster_sizes"]
    assert stored["fit"]["purity"] == reference["fit"]["purity"]


def test_twin_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart_torch.run("cuda")
