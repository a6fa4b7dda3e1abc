"""The PyTorch port's core modules against the JAX package, on the CPU.

Distances × policies, the packed multiset, ``EvalConfig`` validation, the
chunk planner, kernel configuration, state conversion, and the guards that
keep the port free of JAX: every input is built from a numpy seed and fed to
both packages.
"""
import ast
import dataclasses
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distances as jdist  # noqa: E402
from repro.core import evaluator as jev  # noqa: E402
from repro.core import multiset as jms  # noqa: E402
from repro.core.precision import resolve as jresolve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distances as tdist  # noqa: E402
from repro_torch.core import evaluator as tev  # noqa: E402
from repro_torch.core import multiset as tms  # noqa: E402
from repro_torch.core.precision import resolve as tresolve  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

#: Bands of the distance parity below, per policy, on max(1, |ref|): both
#: packages round the payload to the same compute dtype, so they differ only
#: in summation order (fp32/bf16/fp16 accumulate in fp32, eps 1.2e-7 × d
#: terms); fp16_strict also rounds the Gram product to fp16 (eps 9.8e-4).
DIST_BANDS = {"fp32": 1e-5, "bf16": 1e-5, "fp16": 1e-5, "fp16_strict": 2e-3}


def _band(got, ref, band):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    assert err <= band * max(1.0, float(np.max(np.abs(ref)))), err


@pytest.mark.parametrize("policy", sorted(DIST_BANDS))
@pytest.mark.parametrize("name", sorted(tdist.PAIRWISE))
def test_pairwise_distances_match_reference(name, policy):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(37, 13)).astype(np.float32)
    Y = rng.normal(size=(11, 13)).astype(np.float32)
    got = tdist.PAIRWISE[name](torch.from_numpy(X), torch.from_numpy(Y),
                               tresolve(policy))
    ref = jdist.PAIRWISE[name](jnp.asarray(X), jnp.asarray(Y),
                               jresolve(policy))
    assert got.dtype == tresolve(policy).accum_dtype
    _band(got.float().numpy(), np.asarray(ref, np.float32), DIST_BANDS[policy])


@pytest.mark.parametrize("name", sorted(tdist.POINT))
def test_point_distances_match_reference(name):
    rng = np.random.default_rng(6)
    x, y = rng.normal(size=(2, 9)).astype(np.float32)
    got = float(tdist.POINT[name](torch.from_numpy(x), torch.from_numpy(y)))
    ref = float(jdist.POINT[name](jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["bf16", "fp16"])
def test_sq_norms_of_half_payload_widen_only_the_accumulator(policy, monkeypatch):
    """A half payload is widened one row block at a time (the reference's
    precision.sq-norms-upcast rule), and the result matches the reference."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(50, 6)).astype(np.float32)
    pol = tresolve(policy)
    monkeypatch.setattr(tdist, "WIDEN_BLOCK_ROWS", 16)
    got = tdist.sq_norms(torch.from_numpy(X).to(pol.compute_dtype))
    ref = jdist.sq_norms(jnp.asarray(X).astype(jresolve(policy).compute_dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert jdist.MXU_ELIGIBLE == tdist.MXU_ELIGIBLE
    assert jdist.RBF_GAMMA == tdist.RBF_GAMMA


def test_policies_and_resolve_error_text():
    for name in ("fp32", "bf16", "fp16", "fp16_strict"):
        assert tresolve(name).itemsize == jresolve(name).itemsize
        assert tresolve(name).accum_dtype.itemsize == \
            jnp.dtype(jresolve(name).accum_dtype).itemsize
    with pytest.raises(ValueError) as te:
        tresolve("fp8")
    with pytest.raises(ValueError) as je:
        jresolve("fp8")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("base_len", [None, 2])
def test_pack_base_plus_candidates_matches_reference(base_len):
    rng = np.random.default_rng(8)
    base = rng.normal(size=(4, 5)).astype(np.float32)
    cands = rng.normal(size=(6, 5)).astype(np.float32)
    got = tms.pack_base_plus_candidates(torch.from_numpy(base),
                                        torch.from_numpy(cands), base_len)
    ref = jms.pack_base_plus_candidates(jnp.asarray(base), jnp.asarray(cands),
                                        base_len)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


def test_pack_sets_matches_reference():
    rng = np.random.default_rng(9)
    sets = [rng.normal(size=(kj, 7)).astype(np.float32) for kj in (3, 1, 5)]
    got = tms.pack_sets(sets, device="cpu")
    ref = jms.pack_sets(sets)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(got.mask().numpy(), np.asarray(ref.mask()))
    assert got.pad_fraction() == pytest.approx(ref.pad_fraction())
    assert got.nbytes() == ref.nbytes()
    assert got.slice_sets(1, 3).num_sets == 2
    with pytest.raises(ValueError):
        tms.pack_sets([], device="cpu")
    with pytest.raises(ValueError):
        tms.pack_sets([np.zeros((2, 3)), np.zeros((2, 4))], device="cpu")


@pytest.mark.parametrize("field,value", [
    ("distance", "hamming"), ("mode", "three_pass"), ("backend", "tpu"),
    ("kernel_variant", "wide"), ("policy", "fp8"),
    ("memory_budget_bytes", "lots")])
def test_eval_config_validation_matches_reference(field, value):
    with pytest.raises(ValueError):
        jev.EvalConfig(**{field: value})
    with pytest.raises(ValueError):
        tev.EvalConfig(**{field: value})


def test_eval_config_backends():
    assert tev.EvalConfig().backend == "torch"
    for be in ("torch", "naive", "cuda"):
        tev.EvalConfig(backend=be)
    for be in ("jnp", "pallas", "pallas_interpret"):
        with pytest.raises(ValueError):
            tev.EvalConfig(backend=be)


@pytest.mark.parametrize("mode", ["fused", "two_pass"])
@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp16_strict"])
def test_plan_chunks_matches_reference(mode, policy):
    for l, n, k, d in ((100, 1000, 10, 64), (5000, 50_000, 10, 100),
                       (7, 33, 3, 5)):
        assert tev.bytes_per_set(n, k, d, tresolve(policy), mode) == \
            jev.bytes_per_set(n, k, d, jresolve(policy), mode)
        for budget in (None, 10**6, 10**8, 10**10):
            try:
                ref = jev.plan_chunks(l, n, k, d, jresolve(policy), mode,
                                      budget)
            except jev.ChunkingError:
                with pytest.raises(tev.ChunkingError):
                    tev.plan_chunks(l, n, k, d, tresolve(policy), mode,
                                    budget)
                continue
            assert tev.plan_chunks(l, n, k, d, tresolve(policy), mode,
                                   budget) == ref


def test_chunking_error_and_cpu_probe():
    with pytest.raises(tev.ChunkingError, match="lower floating-point"):
        tev.plan_chunks(10, 10_000, 10, 64, tresolve("fp32"), "fused", 100)
    assert tev.free_memory_bytes("cpu") is None
    with pytest.raises(ValueError):
        tev.resolve_memory_budget("plenty")


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp16_strict"])
def test_kernel_config_fits_hopper_shared_memory(policy):
    """The paper's sweep (k ∈ [10, 500], d up to 1024) always gets a k
    chunk that fits the 227 KB budget; the whole S tile of the paper's
    shape (k=10, d=100) stays resident."""
    pol = tresolve(policy)
    for k in (10, 45, 500):
        for d in (100, 129, 1024):
            cfg = tops.kernel_config(k, d, pol)
            assert 1 <= cfg.k_chunk <= k
            assert cfg.smem_bytes == tops.smem_bytes(cfg.k_chunk, d, pol)
            assert cfg.smem_bytes <= tops.SMEM_BUDGET
            if cfg.k_chunk < k:
                assert tops.smem_bytes(cfg.k_chunk + 1, d, pol) > tops.SMEM_BUDGET
    assert tops.kernel_config(10, 100, pol).k_chunk == 10
    # (set tiles, blocks along n: 196 segments, 8 a block) at the paper's
    # shape
    assert tops.kernel_config(10, 100, pol).grid(5000, 50_000) == (157, 25)
    with pytest.raises(ValueError, match="too wide"):
        tops.kernel_config(10, 1 << 16, pol)


# ---------------------------------------------------------------------------
# Launch geometry of the gain and exemplar-eval kernels (csrc/tile.cuh)
# ---------------------------------------------------------------------------

H100_SMS = 132
SM_SHARED_BYTES = 233472   # 228 KB of shared memory per SM


def _header_constants() -> dict:
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    text = "".join((csrc / f).read_text() for f in
                   ("tile.cuh", "exemplar_eval.cu"))
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}


def test_geometry_mirrors_the_cuda_header():
    """ops' mirrors of the compiled tile shape match csrc/ (a drift would
    make kernel_config size shared memory for another kernel)."""
    c = _header_constants()
    assert tops.BLOCK_N == c["TY"] * c["RN"] == 128
    assert tops.CHUNK_D == c["DC"] == c["TX"]
    assert tops.SEG == c["SEG"] and tops.SEG % tops.BLOCK_N == 0
    assert tops.SMEM_BUDGET == c["SMEM_LIMIT"]
    assert tops.BLOCK_L == c["TX"] * c["ERC"]
    assert tops.GAIN_BLOCK_M == (c["TX"] * 8, c["TX"] * 2)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 513, 4099, 50_000])
def test_segments_cover_n_exactly(n):
    """The fixed split of n: contiguous SEG-row segments covering [0, n)
    once, their count a function of n alone (the reduction order of every
    column rests on it)."""
    import inspect

    segs = tops.segments(n)
    assert list(inspect.signature(tops.segments).parameters) == ["n"]
    assert len(segs) == tops.n_segments(n) == max(1, -(-n // tops.SEG))
    assert segs[0][0] == 0 and segs[-1][1] == n
    for (a, b), (c, _) in zip(segs, segs[1:]):
        assert b == c and b - a == tops.SEG
    assert all(0 <= b - a <= tops.SEG for a, b in segs)
    assert sum(b - a for a, b in segs) == n


def test_launch_geometry_at_the_paper_shape():
    """The sizing rules SEG was chosen by (n = 50 000, d = 100, fp32):
    CELF's m = 256 re-score puts at least two blocks on each of the H100's
    132 SMs (one segment a block), and SEG is the largest multiple of the
    row tile that does; wide launches walk 8 segments a block; fused_eval's
    grid (one block per SM: its k slots stay resident) leaves under 5 % of
    its last wave idle."""
    fp32 = tresolve("fp32")
    n, d = 50_000, 100
    assert tops.n_segments(n) == 196
    gx, gy, gz = tops.gain_grid(n, 256, d, fp32)
    assert (gx, gy, gz) == (2, 196, 1)
    assert gx * gy * gz >= 2 * H100_SMS
    coarser = -(-n // (tops.SEG + tops.BLOCK_N))
    assert gx * coarser < 2 * H100_SMS
    assert tops.gain_grid(n, n, d, fp32) == (391, 25, 1)
    assert tops.gain_grid(8192, 8192, d, fp32, batch=64,
                          update=True) == (64, 4, 64)
    cfg = tops.kernel_config(10, d, fp32)
    assert cfg.k_chunk == 10
    assert 2 * cfg.smem_bytes > SM_SHARED_BYTES   # one block per SM
    gx, gy = cfg.grid(5000, n)
    assert (gx, gy) == (157, 25)
    slots = -(-gx * gy // H100_SMS) * H100_SMS
    assert 1 - gx * gy / slots < 0.05


@pytest.mark.parametrize("col_blocks,n_segs,spb", [
    (1, 1, 1), (2, 196, 1), (6, 196, 1), (157, 196, 8), (391, 196, 8),
    (4096, 32, 8), (64, 32, 2), (40, 32, 1)])
def test_segments_per_block_keep_narrow_launches_wide(col_blocks, n_segs,
                                                      spb):
    """A block walks up to 8 segments, fewer where that would launch under
    MIN_BLOCKS blocks; every block still starts on a segment boundary and
    the blocks cover every segment once."""
    got = tops.segs_per_block(col_blocks, n_segs)
    assert got == spb
    blocks = -(-n_segs // got)
    assert (blocks - 1) * got < n_segs <= blocks * got


@pytest.mark.parametrize("policy", ["fp32", "bf16", "fp16", "fp16_strict"])
def test_gain_block_width_fits_shared_memory(policy):
    """128 candidates a block where they fit, else 32; either way the
    block's shared memory fits the budget up to d = 1 024."""
    pol = tresolve(policy)
    for update in (False, True):
        assert tops.gain_block_cols(100, pol, update) == 128
        for d in (1, 45, 100, 129, 400, 1024):
            bc = tops.gain_block_cols(d, pol, update)
            assert tops.smem_bytes(1, d, pol, bc, update) <= tops.SMEM_BUDGET
            if bc == 32:
                assert tops.smem_bytes(1, d, pol, 128, update) > \
                    tops.SMEM_BUDGET


def test_convert_config_and_state():
    jcfg = jev.EvalConfig(distance="rbf", policy=jresolve("bf16"),
                          backend="pallas_interpret", mode="two_pass",
                          kernel_variant="loop", memory_budget_bytes=123,
                          n_block=64)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert cfg == tev.EvalConfig(distance="rbf", policy="bf16",
                                 backend="cuda", mode="two_pass",
                                 kernel_variant="loop",
                                 memory_budget_bytes=123, n_block=64)
    assert convert.config_from_fields(
        dataclasses.asdict(jev.EvalConfig())).backend == "torch"
    vec, aux = convert.cache_from_arrays(np.arange(4), 2.5, device="cpu")
    assert vec.dtype == torch.float32 and float(aux) == 2.5
    pk = convert.packed_from_arrays(np.zeros((2, 3, 4), np.float32),
                                    np.array([1, 3]), device="cpu")
    assert pk.lengths.dtype == torch.int32 and pk.k_max == 3


def test_numpy_entry_points_need_a_device_without_cuda():
    """With no GPU, an entry point that takes numpy raises unless the
    caller asks for the CPU — no silent move."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs go to it")
    from repro_torch.core import ExemplarClustering

    V = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExemplarClustering(V)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tms.pack_sets([V])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.cache_from_arrays(np.zeros(4))
    assert ExemplarClustering(V, device="cpu").V.device == CPU


def _imports(tree: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_in_a_fresh_process():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len([k for k in sys.modules if k.startswith("repro_torch")]))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 15


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_lm_torch.py",
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for path in files:
        bad = [m for m in _imports(ast.parse(path.read_text())) if _foreign(m)]
        assert not bad, (path, bad)


@pytest.mark.parametrize("name", ["exemplar", "facility_location",
                                  "graph_cut", "saturated_coverage"])
def test_protocol_helpers_match_reference(name):
    """Every FnSpec-dispatched helper of the cache protocol, per objective."""
    from repro.core import functions as jfx
    from repro_torch.core import functions as tfx

    rng = np.random.default_rng(31)
    n, m = 23, 7
    vec, dw, row_aux = (rng.uniform(0.0, 3.0, size=n).astype(np.float32)
                        for _ in range(3))
    D = rng.uniform(0.0, 3.0, size=(n, m)).astype(np.float32)
    if name in ("facility_location", "graph_cut"):
        row_aux[[3, 9]] = np.inf  # dead rows
    idx = np.array([0, 4, 22, 9], np.int64)
    tspec, jspec = tfx.FnSpec(name, lam=0.3, sat=0.5), jfx.FnSpec(name, lam=0.3,
                                                                 sat=0.5)
    t = torch.from_numpy
    j = jnp.asarray
    assert tfx.kernel_template(tspec) == jfx.kernel_template(jspec)
    assert tfx.kernel_fused_ok(tspec) == jfx.kernel_fused_ok(jspec)
    sc_t = tfx.score_cache_rows(tspec, t(vec), t(row_aux))
    sc_j = jfx.score_cache_rows(jspec, j(vec), j(row_aux))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_allclose(
        tfx.gains_rows(tspec, sc_t, t(D), t(row_aux)).numpy(),
        np.asarray(jfx.gains_rows(jspec, sc_j, j(D), j(row_aux))), rtol=1e-6)
    np.testing.assert_allclose(
        tfx.fold_vec_rows(tspec, t(vec), t(dw)).numpy(),
        np.asarray(jfx.fold_vec_rows(jspec, j(vec), j(dw))), rtol=1e-6)
    np.testing.assert_allclose(
        tfx.stat_rows(tspec, t(vec), t(row_aux)).numpy(),
        np.asarray(jfx.stat_rows(jspec, j(vec), j(row_aux))), rtol=1e-6)
    aux_t = tfx.fold_aux(tspec, t(vec), torch.tensor(0.5), torch.tensor(4),
                         0, n)
    aux_j = jfx.fold_aux(jspec, j(vec), jnp.float32(0.5), 4, 0, n)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    np.testing.assert_allclose(
        float(tfx.value_from_stat(tspec, 2.0, torch.tensor(0.7), aux_t, n)),
        float(jfx.value_from_stat(jspec, 2.0, jnp.float32(0.7), aux_j, n)),
        rtol=1e-6)
    ex_t = tfx.gains_index_extra(tspec, t(vec), t(idx), 0, n, n)
    ex_j = jfx.gains_index_extra(jspec, j(vec), j(idx), 0, n, n)
    assert (ex_t is None) == (ex_j is None)
    if ex_t is not None:
        np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=1e-6)
    pair_t = tdist.resolve_pairwise("rbf")
    pair_j = jdist.resolve_pairwise("rbf")
    X = rng.normal(size=(n, 5)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        tfx.gains_formula_spec(tspec, t(X), t(X[:m]), sc_t, t(row_aux),
                               pair_t, tresolve("fp32"), n_total=2 * n).numpy(),
        np.asarray(jfx.gains_formula_spec(jspec, j(X), j(X[:m]), sc_j,
                                          j(row_aux), pair_j,
                                          jresolve("fp32"), n_total=2 * n)),
        rtol=1e-5, atol=1e-6)
