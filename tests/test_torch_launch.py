"""The production dry run (``repro_torch.launch``, ``configs/shapes.py``)
against the JAX package's ``launch/`` on the CPU.

In-process, against the reference's own functions: ``SHAPES`` and
``cell_supported`` for every arch × shape; ``input_specs`` leaf by leaf
(shape and dtype) for every supported cell at full width; the depth
extrapolation's counts, variants and solve; ``model_flops``;
``roofline_terms`` with the reference's module constants set to the H100
figures (monkeypatched); ``summarize``'s tables byte for byte on the same
synthetic records; the collective kinds' table.

In a subprocess of the reference with 512 host devices (as
``run_with_devices``; nothing compiles): every supported cell's argument
bytes per device at 16 × 16 and 2 × 16 × 16, leaf by leaf —
``NamedSharding.shard_shape`` × itemsize over ``jax.eval_shape`` of its
state with ``tree_shardings`` — held equal to the port's
``argument_leaf_bytes``.

Every test on a fake process group runs in a subprocess of the port with
its own timeout (a group in this process would leak into the other tests
of the xdist worker); three run side by side, each from the module's
start: a group of 4 ranks (a wrong world size raises, collectives of
known size mapped to their result bytes, an unknown c10d op raises, and
each family's reduced config: the depth extrapolation equal to the
full-depth run on a (2, 2) mesh), a group of 1 rank (each family's
reduced config at a tiny shape: the FLOPs, bytes accessed, ops and peak
of a meta run equal to the same step's on real CPU tensors, through the
placed path on a (1, 1) mesh), and the production groups of 256 and 512
ranks (the mesh shapes, and one full-width ``run_cell``).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import shapes as TSH  # noqa: E402
from repro_torch.distributed.sharding import MeshRules  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import extrapolate as TX  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import summarize as TSUM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s) for a in TC.ARCH_IDS for s, sh in TSH.SHAPES.items()
         if TSH.cell_supported(TC.get_config(a), sh)[0]]
#: one reduced config per family (gemma3: the local/global layers)
FAMILIES = ("qwen3-0.6b", "gemma3-1b", "granite-moe-3b-a800m",
            "pixtral-12b", "whisper-small", "xlstm-1.3b", "hymba-1.5b")
TINY = {"train": TSH.Shape("tiny_train", 32, 4, "train"),
        "prefill": TSH.Shape("tiny_prefill", 32, 4, "prefill"),
        "decode": TSH.Shape("tiny_decode", 32, 4, "decode")}
EXTRAPOLATED = ("train", "decode")
#: the extrapolation's rtol against the full-depth run
EXTRAPOLATION_RTOL = 1e-9
SUBPROCESS_TIMEOUT = 420
H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12, "ICI_BW": 50e9}


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    env.update(extra or {})
    return env


class _Run:
    """One subprocess, started now, run in a thread; :meth:`result` waits
    for it and raises with its output if it failed."""

    def __init__(self, args, env, timeout=SUBPROCESS_TIMEOUT, out=None):
        self.out, self.error, self.path = None, None, out

        def run():
            try:
                proc = subprocess.run(args, capture_output=True, text=True,
                                      timeout=timeout, env=env, cwd=ROOT)
                if proc.returncode != 0:
                    raise AssertionError(
                        f"subprocess failed\nSTDOUT:\n{proc.stdout[-3000:]}"
                        f"\nSTDERR:\n{proc.stderr[-3000:]}")
                self.out = proc.stdout
            except BaseException as e:      # raised on the test's thread
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        if self.path is not None:
            return json.loads(Path(self.path).read_text())
        return self.out


# ---------------------------------------------------------------------------
# the subprocesses
# ---------------------------------------------------------------------------

_REF_CODE = """
import json, math
import jax
from repro import configs as C
from repro.configs.shapes import SHAPES, cell_supported, input_specs
from repro.distributed.sharding import MeshRules
from repro.launch.dryrun import _cfg_for_cell, abstract_state
from repro.launch.mesh import make_production_mesh
from repro.train import step as St


def key(path):
    out = ""
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out += "/" + str(k.key)
        elif isinstance(k, jax.tree_util.SequenceKey):
            out += f"[{k.idx}]"
        else:
            raise TypeError(k)
    return out


def leaf_bytes(prefix, tree, shardings, out):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree.leaves(shardings)
    assert len(flat) == len(shs), (len(flat), len(shs))
    for (path, x), sh in zip(flat, shs):
        out[(prefix + key(path)).lstrip("/")] = (
            math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize)


res, states = {}, {}
for mp, tag in ((False, "pod16x16"), (True, "pod2x16x16")):
    mesh = make_production_mesh(multi_pod=mp)
    rules = MeshRules.for_mesh(mesh)
    res[tag + "|mesh"] = dict(mesh.shape)
    for arch in C.ARCH_IDS:
        for sname, shape in SHAPES.items():
            if not cell_supported(C.get_config(arch), shape)[0]:
                continue
            cfg = _cfg_for_cell(arch, shape)
            train = shape.kind == "train"
            if (cfg, train) not in states:
                states[cfg, train] = abstract_state(cfg, with_opt=train)
            st, dims = states[cfg, train]
            out = {}
            if train:
                leaf_bytes("", st, St.tree_shardings(
                    rules, st, St.state_dims(dims)), out)
            else:
                leaf_bytes("params", st,
                           St.tree_shardings(rules, st, dims), out)
            specs = input_specs(cfg, shape)
            if shape.kind == "decode":
                bdims = {"tokens": (("batch",), (None,)),
                         "caches": St.cache_dims_tree(cfg, specs["caches"],
                                                      rules),
                         "pos": ()}
            else:
                bdims = St.batch_dims(cfg, specs)
            leaf_bytes("batch", specs,
                       St.tree_shardings(rules, specs, bdims), out)
            res[f"{tag}|{arch}|{sname}"] = out
print("ARGS " + json.dumps(res))
"""


def _worker_run(part: str, tmp: Path) -> _Run:
    out = tmp / f"{part}.json"
    code = ("import sys, torch; torch.set_num_threads(int(sys.argv[3])); "
            "import test_torch_launch as t; t._port_worker(sys.argv[1], "
            "sys.argv[2])")
    return _Run([sys.executable, "-c", code, part, str(out),
                 str(torch.get_num_threads())], _env(), out=out)


def _port_worker(part: str, out: str) -> None:
    """One of the port's fake-group subprocesses; writes its results as
    JSON to ``out``."""
    res = {"group4": _group4, "group1": _group1,
           "production": _production}[part](Path(out).parent)
    Path(out).write_text(json.dumps(res))


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _group4(tmp: Path) -> dict:
    from repro_torch.launch import mesh as TMESH

    res = {"no_group": _raised(TMESH.make_production_mesh)}
    TD.ensure_fake_group(4)
    res["wrong_single_pod"] = _raised(TMESH.make_production_mesh)
    res["wrong_multi_pod"] = _raised(
        lambda: TMESH.make_production_mesh(multi_pod=True))
    res["wrong_shape"] = _raised(
        lambda: TMESH.make_mesh((2, 3), ("data", "model")))
    mesh = TMESH.make_mesh((2, 2), ("data", "model"))
    res["device_type"] = mesh.device_type
    res["collectives"], res["broadcast"] = _hand_made_collectives(mesh)
    res["extrapolation"] = {}
    for arch in FAMILIES:
        cfg = TC.get_reduced_config(arch)
        for kind in EXTRAPOLATED:
            xc = TD.extrapolated_costs(arch, TINY[kind], mesh=mesh, cfg=cfg)
            run, _ = TD.lower_cell(arch, TINY[kind], False, cfg=cfg,
                                   mesh=mesh)
            res["extrapolation"][f"{arch}|{kind}"] = {
                "extrapolated": [xc["flops"], xc["bytes"],
                                 xc["collective_bytes"]],
                "full_depth": [run["flops"], run["bytes accessed"],
                               run["collectives"]["total_bytes"]],
                "variants": len(xc["variant_counts"])}
    return res


def _hand_made_collectives(mesh):
    """Collectives of known size on meta tensors under the census, on the
    (2, 2) mesh's data group (2 ranks) and the world (4 ranks)."""
    import torch.distributed as dist

    from repro_torch.analysis.census import take_census

    g = mesh.get_group("data")

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def run():
        x = meta(3, 5)                                  # 60 B
        dist.all_gather([meta(3, 5) for _ in range(2)], x, group=g)
        dist.all_gather([meta(3, 5) for _ in range(4)], x)
        dist.all_gather_into_tensor(meta(6, 5), x, group=g)
        dist.all_to_all_single(meta(4, 5), meta(4, 5), group=g)
        dist.all_reduce(meta(6, dtype=torch.bfloat16), group=g)
        dist.reduce_scatter_tensor(meta(4, 2), meta(8, 2), group=g)

    _, c = take_census(run)
    got = TR.collective_bytes(c.collective_results)
    _, c2 = take_census(lambda: dist.broadcast(meta(6), src=0, group=g))
    return got, [c2.collective_results,
                 _raised(lambda: TR.collective_bytes(c2.collective_results))]


def _real_args(cfg, shape, rules):
    """The cell's step arguments on real CPU tensors (seeded), as
    :func:`TD.cell_args` makes them on meta."""
    from repro_torch.train import step as TS

    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        state = TS.init_train_state(cfg, 0, "cpu", rules=rules)
    else:
        state = TM.init_model(cfg, 0, "cpu")
    batch = {}
    for k, t in TSH.input_specs(cfg, shape, device="cpu").items():
        if k == "caches":
            B, S = shape.global_batch, shape.seq_len
            batch[k] = TM.zero_caches(cfg, B, S, "cpu", rules=rules)
        elif k == "pos":
            batch[k] = shape.seq_len - 1
        elif t.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                     generator=gen, dtype=torch.int32)
        else:
            batch[k] = torch.randn(t.shape, generator=gen, dtype=t.dtype)
    return state, batch


COUNTS = ("flops", "bytes accessed", "aten_ops", "temp_bytes")


def _group1(tmp: Path) -> dict:
    from repro_torch.launch import mesh as TMESH

    TD.ensure_fake_group(1)
    rules = MeshRules.for_mesh(TMESH.make_mesh((1, 1), ("data", "model")))
    TD.resolve_shards(rules)
    res = {}
    for arch in FAMILIES:
        cfg = TC.get_reduced_config(arch)
        for kind, shape in TINY.items():
            step = TD.cell_step(cfg, shape, rules)
            meta = TD.measure(step, *TD.cell_args(cfg, shape, rules))
            real = TD.measure(step, *_real_args(cfg, shape, rules))
            res[f"{arch}|{kind}"] = {
                side: [r[k] for k in COUNTS] + [r["collectives"]]
                for side, r in (("meta", meta), ("real", real))}
    return res


def _held_bytes(rules) -> dict:
    """Every arch's placed ``train_4k`` state on ``rules``' mesh: its
    bytes on this rank leaf by leaf against ``argument_leaf_bytes``' (the
    reference's layout), and whether :func:`TD.check_held_state` passes;
    then a planted fault (one leaf left whole) that the check must name."""
    sh = TSH.SHAPES["train_4k"]
    out = {}
    for arch in TC.ARCH_IDS:
        cfg = TD._cfg_for_cell(arch, sh)
        state = TD.abstract_state(cfg, True, rules)
        want = {k: n for k, n in TD.argument_leaf_bytes(cfg, sh, rules)
                .items() if not k.startswith("batch")}
        got = TD.held_leaf_bytes(state)
        out[arch] = {"bad": {k: [got.get(k), want.get(k)]
                             for k in set(got) | set(want)
                             if got.get(k) != want.get(k)},
                     "leaves": len(want),
                     "check": _raised(lambda: TD.check_held_state(
                         cfg, sh, rules, state))}
    cfg = TD._cfg_for_cell("qwen3-0.6b", sh)
    state = TD.abstract_state(cfg, True, rules)
    whole = TM.abstract_model(cfg).get_parameter("embed.w")
    state["params"].get_parameter("embed.w").data = whole.data
    out["planted"] = _raised(lambda: TD.check_held_state(cfg, sh, rules,
                                                         state))
    return out


def _production(tmp: Path) -> dict:
    res = {}
    for mp in (False, True):
        m = TD.production_mesh(mp)
        res[f"mesh|{mp}"] = dict(zip(m.mesh_dim_names,
                                     (int(s) for s in m.mesh.shape)))
        rules = MeshRules.for_mesh(m)
        TD.resolve_shards(rules)
        res[f"held|{mp}"] = _held_bytes(rules)
        if not mp:
            rec = TD.run_cell("qwen3-0.6b", "train_4k", False,
                              str(tmp / "records"))
            res["record"] = {k: v for k, v in rec.items()
                             if k != "traceback"}
            res["records"] = [p.name for p in (tmp / "records").iterdir()]
    return res


_RUNS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The reference's subprocess and the port's three, started with the
    module's first test and waited for at its end."""
    tmp = tmp_path_factory.mktemp("launch")
    _RUNS["reference"] = _Run(
        [sys.executable, "-c", _REF_CODE],
        _env({"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
              "JAX_PLATFORMS": "cpu"}))
    for part in ("group4", "group1", "production"):
        _RUNS[part] = _worker_run(part, tmp)
    yield _RUNS
    for r in _RUNS.values():
        r.thread.join()


def _reference_args() -> dict:
    out = _RUNS["reference"].result()
    line = next(ln for ln in out.splitlines() if ln.startswith("ARGS "))
    return json.loads(line[len("ARGS "):])


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_shapes_and_cell_supported_match_reference(arch):
    from repro import configs as RC
    from repro.configs import shapes as RSH

    assert list(TSH.SHAPES) == list(RSH.SHAPES)
    for name, shape in TSH.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            RSH.SHAPES[name])
        assert TSH.cell_supported(TC.get_config(arch), shape) == \
            RSH.cell_supported(RC.get_config(arch), RSH.SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every leaf's path, shape and dtype, at full width."""
    import jax

    from repro import configs as RC
    from repro.configs import shapes as RSH

    # the reference's ``launch.dryrun._cfg_for_cell`` (that module sets
    # XLA_FLAGS when imported, so it is not imported here)
    ref = RC.get_config(arch)
    if ref.family == "encdec":
        ref = dataclasses.replace(
            ref, max_seq_len=max(TSH.SHAPES[shape].seq_len, 2048))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(
                RSH.input_specs(ref, RSH.SHAPES[shape]))[0]}
    specs = TSH.input_specs(TD._cfg_for_cell(arch, TSH.SHAPES[shape]),
                            TSH.SHAPES[shape])
    got = {}
    for path, t in TM.tree_leaves(specs):
        assert t.device.type == "meta", path
        key = "".join(f"['{k}']" if not k.startswith("[") else k
                      for k in path.replace("[", "/[").split("/") if k)
        got[key] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert got == want


# ---------------------------------------------------------------------------
# depth extrapolation, roofline, summary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_layer_kinds_and_depth_variants_match_reference(arch):
    from repro import configs as RC
    from repro.launch import extrapolate as RX

    cfg, ref = TC.get_config(arch), RC.get_config(arch)
    assert TX.layer_kind_counts(cfg) == RX.layer_kind_counts(ref)
    got, want = TX.depth_variants(cfg), RX.depth_variants(ref)
    assert [c for _, c in got] == [c for _, c in want]
    assert [dataclasses.asdict(v) for v, _ in got] == \
        [dataclasses.asdict(v) for v, _ in want]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_and_extrapolate_matches_reference(seed):
    from repro.launch import extrapolate as RX

    rng = np.random.default_rng(seed)
    kinds = ["a", "b", "c"][:1 + seed]
    counts = [{k: int(rng.integers(0, 4)) for k in kinds}
              for _ in range(len(kinds) + 2)]
    values = [float(v) for v in rng.uniform(1e9, 1e12, len(counts))]
    real = {k: int(rng.integers(10, 60)) for k in kinds}
    got = TX.solve_and_extrapolate(counts, values, real)
    want = RX.solve_and_extrapolate(counts, values, real)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_and_roofline_terms_match_reference(kind, monkeypatch):
    from repro.launch import roofline as RR

    for k, v in H100.items():
        monkeypatch.setattr(RR, k, v)
    sxm = TR.PEAKS[TR.DEFAULT]
    assert (sxm["half"], sxm["bw"], TR.NET_BW) == \
        (H100["PEAK_FLOPS"], H100["HBM_BW"], H100["ICI_BW"])
    assert TR.model_flops(596_049_920, 1_048_576, kind) == \
        RR.model_flops(596_049_920, 1_048_576, kind)
    rng = np.random.default_rng(len(kind))
    for _ in range(5):
        cost = {"flops": float(rng.uniform(1e12, 1e15)),
                "bytes accessed": float(rng.uniform(1e10, 1e13))}
        coll = int(rng.uniform(1e8, 1e12))
        assert TR.roofline_terms(cost, coll) == RR.roofline_terms(cost, coll)


def _records() -> list:
    """Synthetic records of the dry run's schema: ok, error and skipped
    cells at both meshes."""
    rng = np.random.default_rng(7)
    recs = []
    for arch in ("qwen3-0.6b", "gemma3-1b", "xlstm-1.3b"):
        for shape, kind in (("train_4k", "train"), ("decode_32k", "decode")):
            for mp in (False, True):
                chips = 512 if mp else 256
                coll = {op: int(rng.integers(0, 2**33))
                        for op in TR._COLL_OPS}
                counts = {op: int(rng.integers(0, 900))
                          for op in TR._COLL_OPS}
                terms = TR.roofline_terms(
                    {"flops": float(rng.uniform(1e12, 1e15)),
                     "bytes accessed": float(rng.uniform(1e10, 1e13))},
                    sum(coll.values()))
                recs.append({
                    "arch": arch, "shape": shape, "kind": kind,
                    "multi_pod": mp, "chips": chips, "status": "ok",
                    "compile_s": float(rng.uniform(0, 100)),
                    "memory": {"peak_bytes_per_device":
                               int(rng.integers(1, 2**37))},
                    "collectives": {"bytes": coll, "counts": counts,
                                    "total_bytes": sum(coll.values())},
                    "roofline": terms,
                    "tokens_per_step": 1_048_576 if kind == "train" else 128})
    recs.append({"arch": "qwen3-32b", "shape": "prefill_32k",
                 "multi_pod": False, "status": "error",
                 "error": "RuntimeError: " + "x" * 90})
    recs.append({"arch": "qwen3-32b", "shape": "prefill_32k",
                 "multi_pod": True, "status": "error", "error": "E"})
    for mp in (False, True):
        recs.append({"arch": "qwen3-32b", "shape": "long_500k",
                     "multi_pod": mp, "status": "skipped",
                     "reason": "pure full-attention arch: long_500k skipped "
                               "(task rule)"})
    return recs


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_memory_floor_on_one_device(arch):
    """On a (1, 1) mesh the floor is its formula worked by hand: AdamW
    reads and writes params (the gradients' size), master, m, v and the
    step once; the weights are read three times; each layer's input
    (B × S × d_model) is written and read once; the tokens and labels
    (int32) are read once."""
    cfg, sh = TC.get_config(arch), TSH.Shape("p", 512, 8, "train")
    model = TM.abstract_model(cfg)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    state = params + 3 * 4 * n + 4
    acts = cfg.num_layers * 8 * 512 * cfg.d_model * 2
    want = 2 * state + 3 * params + 2 * acts + 2 * 8 * 512 * 4
    assert TD.memory_floor_bytes(cfg, sh, MeshRules.for_mesh(
        {"data": 1, "model": 1})) == want


@pytest.mark.parametrize("table", ["roofline_table", "dryrun_table",
                                   "stats"])
def test_summarize_tables_match_reference(table, tmp_path):
    from repro.launch import summarize as RSUM

    recs = _records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    assert TSUM.load(str(tmp_path)) == RSUM.load(str(tmp_path))
    loaded = TSUM.load(str(tmp_path))
    assert getattr(TSUM, table)(loaded) == getattr(RSUM, table)(loaded)


# ---------------------------------------------------------------------------
# argument bytes per device against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_match_reference(mesh, arch, shape):
    want = _reference_args()[f"{mesh}|{arch}|{shape}"]
    sh = TSH.SHAPES[shape]
    got = TD.argument_leaf_bytes(TD._cfg_for_cell(arch, sh), sh,
                                 MeshRules.for_mesh(MESHES[mesh]))
    assert sorted(got) == sorted(want), (set(got) ^ set(want))
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, f"leaves of other bytes (port, reference): {bad}"
    assert TD.argument_bytes(TD._cfg_for_cell(arch, sh), sh,
                             MeshRules.for_mesh(MESHES[mesh])) == \
        sum(want.values())


# ---------------------------------------------------------------------------
# the fake groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    """The shapes of ``test_multipod_mesh_shapes`` (and the reference's
    mesh in its subprocess)."""
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert _RUNS["production"].result()[f"mesh|{multi_pod}"] == want
    tag = "pod2x16x16" if multi_pod else "pod16x16"
    assert _reference_args()[f"{tag}|mesh"] == want


@pytest.mark.parametrize("case", ["no_group", "wrong_single_pod",
                                  "wrong_multi_pod", "wrong_shape"])
def test_wrong_world_size_raises(case):
    got = _RUNS["group4"].result()[case]
    if case == "no_group":
        assert got.startswith("RuntimeError") and \
            "init_process_group" in got, got
        return
    ranks = {"wrong_single_pod": "256", "wrong_multi_pod": "512",
             "wrong_shape": "6"}[case]
    assert got.startswith("ValueError"), got
    assert f"has {ranks} ranks" in got and "the process group 4" in got, got


@pytest.mark.parametrize("backend,want", [("nccl", "cuda"),
                                          ("gloo", "cpu"), ("fake", "cpu")])
def test_mesh_device_type_follows_the_backend(backend, want, monkeypatch):
    """``make_mesh`` builds its mesh on the group's devices: CUDA for NCCL
    ranks, the CPU for gloo and the fake group (whose (2, 2) mesh in its
    subprocess is a CPU mesh)."""
    from repro_torch.core import distributed as TDIST

    monkeypatch.setattr(TDIST.dist, "get_backend", lambda *a: backend)
    assert TDIST.mesh_device_type() == want
    assert _RUNS["group4"].result()["device_type"] == "cpu"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_placed_state_bytes_equal_argument_bytes(arch, multi_pod):
    """A placed ``train_4k`` state holds, leaf by leaf, the bytes of the
    reference's layout on rank 0 of the production mesh, so the records'
    peak (held arguments + the step's live storage) rests on the
    reference's argument bytes; ``check_held_state`` passes."""
    r = _RUNS["production"].result()[f"held|{multi_pod}"][arch]
    assert not r["bad"], f"leaves of other bytes (held, reference): " \
        f"{r['bad']}"
    assert r["leaves"] > 0 and r["check"] == "no error", r["check"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_misplaced_state_is_named(multi_pod):
    """A leaf left whole on a rank fails the held-bytes check, which names
    it."""
    got = _RUNS["production"].result()[f"held|{multi_pod}"]["planted"]
    assert got.startswith("ValueError") and "params/embed/w" in got, got


def test_collective_result_bytes_of_hand_made_collectives():
    """Result bytes: an all-gather p × its input (2 and 4 ranks, list and
    tensor forms), an all-to-all its output, an all-reduce its tensor, a
    reduce-scatter input / p."""
    got = _RUNS["group4"].result()["collectives"]
    assert got["bytes"] == {"all-reduce": 12, "all-gather": 120 + 240 + 120,
                            "reduce-scatter": 32, "all-to-all": 80,
                            "collective-permute": 0}
    assert got["counts"] == {"all-reduce": 1, "all-gather": 3,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 0}
    assert got["total_bytes"] == 12 + 480 + 32 + 80


def test_unknown_c10d_op_raises():
    records, err = _RUNS["group4"].result()["broadcast"]
    assert records == [["broadcast_", 24]]
    assert err.startswith("ValueError") and "broadcast_" in err, err
    with pytest.raises(ValueError, match="barrier"):
        TR.collective_bytes([("allgather_", 8), ("barrier", 4)])


@pytest.mark.parametrize("kind", EXTRAPOLATED)
@pytest.mark.parametrize("arch", FAMILIES)
def test_extrapolation_equals_full_depth(arch, kind):
    """The depth extrapolation from 2–3 shallow variants is the full-depth
    run's count: FLOPs, bytes accessed and collective bytes."""
    r = _RUNS["group4"].result()["extrapolation"][f"{arch}|{kind}"]
    assert r["variants"] >= 2
    for got, want in zip(r["extrapolated"], r["full_depth"]):
        assert got == pytest.approx(want, rel=EXTRAPOLATION_RTOL)
    assert r["full_depth"][0] > 0


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counts_equal_real_cpu_counts(arch, kind):
    """A meta run's FLOPs, bytes accessed, op count, peak of live storage
    and collectives are the same step's on real CPU tensors."""
    r = _RUNS["group1"].result()[f"{arch}|{kind}"]
    assert r["meta"] == r["real"], dict(zip(COUNTS + ("collectives",),
                                            zip(r["meta"], r["real"])))
    assert r["meta"][0] > 0 and r["meta"][1] > 0


def test_full_width_run_cell_writes_an_ok_record():
    """qwen3-0.6b × train_4k on the 16 × 16 mesh, at full width: a record
    of the reference's schema that ``summarize`` tabulates, its argument
    bytes the reference's."""
    res = _RUNS["production"].result()
    rec = res["record"]
    assert rec["status"] == "ok", rec.get("error")
    assert res["records"] == ["qwen3-0.6b__train_4k__pod16x16.json"]
    for k in ("memory", "cost", "collectives", "roofline",
              "model_flops_global", "useful_flops_ratio", "tokens_per_step",
              "lower_s", "compile_s"):
        assert k in rec, k
    assert rec["chips"] == 256 and rec["compile_s"] == 0
    assert rec["tokens_per_step"] == 256 * 4096
    want = _reference_args()["pod16x16|qwen3-0.6b|train_4k"]
    assert rec["memory"]["argument_bytes"] == sum(want.values())
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == \
        mem["held_argument_bytes"] + mem["temp_bytes"]
    assert rec["cost"]["flops"] > rec["model_flops_global"] / 256
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["host_syncs"] == 0
    t = rec["roofline"]
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    # the function's floor: under the eager traffic, from its own count
    sh = TSH.SHAPES["train_4k"]
    assert t["memory_floor_bytes"] == TD.memory_floor_bytes(
        TD._cfg_for_cell("qwen3-0.6b", sh), sh, MeshRules.for_mesh(
            MESHES["pod16x16"]))
    assert 0 < t["memory_floor_s"] < t["memory_s"]
    assert t["floor_bound_s"] == max(t["compute_s"], t["memory_floor_s"],
                                     t["collective_s"]) <= t["bound_s"]
    row = TSUM.roofline_table([rec]).splitlines()[2]
    assert row.startswith("| qwen3-0.6b | train_4k |"), row
    assert math.isfinite(rec["useful_flops_ratio"])
