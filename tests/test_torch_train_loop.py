"""The port's training loop around the step: checkpointing
(``repro_torch.train.checkpoint``, twins of ``tests/test_checkpoint.py``
but the mesh one), crash and resume, checkpoints crossing between the
port and the JAX package in both directions, the straggler monitor,
SIGTERM, and curated training that learns.

Tolerances: the port's own crash-resume bit for bit (the reference's
``test_crash_resume_equivalence``); a checkpoint restored bit for bit in
either package, bf16 leaves included; two steps after a cross-package
resume within 1e-5 of each leaf's max |value| of the other package's two
steps (``REL``, the train-step parity band of ``test_torch_lm_train.py``).
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

from repro import configs as ref_configs
from repro.data.pipeline import token_batches as ref_token_batches
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.checkpoint import config_hash as ref_config_hash
from repro.train.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import train as ref_train
from repro_torch import configs
from repro_torch.convert import lm_train_state_to_arrays
from repro_torch.data.pipeline import CurationConfig, token_batches
from repro_torch.models.model import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager, config_hash
from repro_torch.train.monitor import StepMonitor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainConfig, train

REL = 1e-5


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "b": torch.zeros((8,), dtype=torch.bfloat16)},
        "opt": {"m": torch.ones((8, 8)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _flat(tree):
    from repro_torch.train.checkpoint import _flatten_with_names
    return _flatten_with_names(tree)


def test_save_restore_bitwise(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    st = _state()
    st["params"]["b"] += 1.5
    cm.save(3, st, cfg_hash="abc")
    restored, manifest = cm.restore(_state(seed=1), cfg_hash="abc")
    assert manifest["step"] == 3
    assert manifest["dtypes"]["params/b"] == "bfloat16"
    for (na, a), (nb, b) in zip(_flat(st), _flat(restored)):
        assert na == nb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_async_save(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=True)
    st = _state()
    cm.save(1, st)
    st["params"]["w"].zero_()     # the snapshot was taken at save()
    cm.wait()
    assert cm.latest_step() == 1
    restored, _ = cm.restore(_state(seed=1))
    assert torch.equal(restored["params"]["w"], _state()["params"]["w"])


def test_latest_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False, keep_last=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _state())
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_incomplete_write_ignored(tmp_path):
    """A crash mid-write (tmp dir, no rename) must be invisible to restore."""
    cm = CheckpointManager(tmp_path, async_write=False)
    cm.save(5, _state())
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_8").mkdir()
    assert cm.latest_step() == 5
    cm.clean_incomplete()
    assert not (tmp_path / "step_9.tmp").exists()


def test_config_hash_mismatch_rejected(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    cm.save(1, _state(), cfg_hash="abc")
    with pytest.raises(ValueError, match="hash"):
        cm.restore(_state(), cfg_hash="different")


def test_restore_missing_leaf_rejected(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    cm.save(1, _state())
    bigger = {**_state(), "extra": torch.zeros((2,))}
    with pytest.raises(KeyError):
        cm.restore(bigger)


def test_checkpoint_format_crosses_packages(tmp_path):
    """The same tree written by each package restores bit for bit in the
    other, bf16 leaf included (the port reads its uint16 bits with no
    ``ml_dtypes``)."""
    st = _state(seed=2)
    st["params"]["b"] += torch.linspace(-3, 3, 8).to(torch.bfloat16)
    jst = jax.tree.map(lambda t: jnp.asarray(
        t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
        else jnp.asarray(t.numpy()), st)
    CheckpointManager(tmp_path / "port", async_write=False).save(1, st)
    RefCheckpointManager(tmp_path / "ref", async_write=False).save(1, jst)
    from_port, _ = RefCheckpointManager(tmp_path / "port").restore(jst)
    from_ref, _ = CheckpointManager(tmp_path / "ref").restore(_state())
    for (n, a), (_, b) in zip(_flat(st), _flat(from_ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for (n, a), (_, b) in zip(_flat(st), tree_leaves(
            jax.tree.map(np.asarray, from_port))):
        assert str(b.dtype) == str(a.dtype).replace("torch.", ""), n
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert (config_hash((configs.get_reduced_config("qwen3-0.6b"),
                         OptimizerConfig()))
            == ref_config_hash((ref_configs.get_reduced_config("qwen3-0.6b"),
                                RefOptimizerConfig())))


def test_train_state_roundtrip_bf16(tmp_path):
    """A bf16 model's train state: saved and restored bit for bit (params
    bf16, master and moments fp32, step int32)."""
    from repro_torch.train.step import init_train_state

    cfg = configs.replace(configs.get_reduced_config("hymba-1.5b"),
                          dtype="bfloat16")
    st = init_train_state(cfg, 3, device="cpu")
    st["opt"]["step"].fill_(5)
    cm = CheckpointManager(tmp_path, async_write=False)
    cm.save(5, st)
    back, _ = cm.restore(init_train_state(cfg, 4, device="cpu"))
    a, b = lm_train_state_to_arrays(st), lm_train_state_to_arrays(back)
    for (n, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=n)
    assert back["params"].embed["w"].dtype == torch.bfloat16
    assert all(p.requires_grad for p in back["params"].parameters())


def _opt():
    return dict(warmup_steps=2, total_steps=8, lr=1e-3)


def test_crash_resume_equivalence(tmp_path):
    """Interrupted-and-resumed training == uninterrupted (bitwise)."""
    cfg = configs.get_reduced_config("qwen3-0.6b")
    opt = OptimizerConfig(**_opt())

    def batches():
        return token_batches(cfg.vocab_size, 2, 16, steps=8, seed=5,
                             device="cpu")

    s_full, _ = train(cfg, TrainConfig(steps=8, ckpt_every=100,
                                       log_every=100), opt, batches(),
                      device="cpu")
    d = str(tmp_path / "ck")
    train(cfg, TrainConfig(steps=4, ckpt_every=4, ckpt_dir=d,
                           log_every=100), opt, batches(), device="cpu")
    it = batches()
    for _ in range(4):  # data pipeline replay: skip consumed batches
        next(it)
    s_res, _ = train(cfg, TrainConfig(steps=8, ckpt_every=4, ckpt_dir=d,
                                      resume="auto", log_every=100), opt, it,
                     device="cpu")
    a, b = lm_train_state_to_arrays(s_full), lm_train_state_to_arrays(s_res)
    for (n, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=n)


def _close_trees(got, want, what):
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (p, g), (_, w) in zip(gl, wl):
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= REL * scale, f"{what} {p}: {err:.3e} > {REL} x {scale}"


def _ref_batches(cfg, skip=0):
    it = ref_token_batches(cfg.vocab_size, 2, 16, steps=4, seed=5)
    for _ in range(skip):
        next(it)
    return it


def _port_batches(cfg, skip=0):
    it = token_batches(cfg.vocab_size, 2, 16, steps=4, seed=5, device="cpu")
    for _ in range(skip):
        next(it)
    return it


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(tmp_path, writer):
    """Two steps checkpointed by one package, two more in the other after
    ``resume="auto"``: equal to the writer's own four steps within REL."""
    jcfg = ref_configs.get_reduced_config("qwen3-0.6b")
    tcfg = configs.get_reduced_config("qwen3-0.6b")
    d = tmp_path / "ck"
    if writer == "reference":
        run, other = ref_train, train
        args = (jcfg, RefTrainConfig, RefOptimizerConfig(**_opt()),
                _ref_batches)
        other_args = (tcfg, TrainConfig, OptimizerConfig(**_opt()),
                      _port_batches)
        kw, other_kw = {}, {"device": "cpu"}
    else:
        run, other = train, ref_train
        args = (tcfg, TrainConfig, OptimizerConfig(**_opt()), _port_batches)
        other_args = (jcfg, RefTrainConfig, RefOptimizerConfig(**_opt()),
                      _ref_batches)
        kw, other_kw = {"device": "cpu"}, {}
    cfg, TC, opt, batches = args
    straight, _ = run(cfg, TC(steps=4, ckpt_every=100, log_every=100), opt,
                      batches(cfg), **kw)
    run(cfg, TC(steps=2, ckpt_every=2, ckpt_dir=str(d), log_every=100), opt,
        batches(cfg), **kw)
    ocfg, OTC, oopt, obatches = other_args
    resumed, _ = other(ocfg, OTC(steps=4, ckpt_every=100, ckpt_dir=str(d),
                                 resume="auto", log_every=100), oopt,
                       obatches(ocfg, skip=2), **other_kw)

    def arrays(s):
        if isinstance(s["params"], torch.nn.Module):
            return lm_train_state_to_arrays(s)
        return jax.tree.map(np.asarray, s)

    _close_trees(arrays(resumed), arrays(straight), f"written by {writer}")
    assert int(arrays(resumed)["opt"]["step"]) == 4


def test_straggler_monitor_flags_outliers():
    mon = StepMonitor(k_sigma=3.0, min_samples=4)
    for i in range(20):
        mon.observe(i, 1.0 + 0.01 * (i % 3))
    ev = mon.observe(20, 5.0)  # injected straggler
    assert ev is not None and ev.step == 20
    assert mon.straggler_fraction > 0
    assert mon.mean < 1.5


def test_sigterm_checkpoints_then_exits(tmp_path):
    """SIGTERM during step 2: the loop saves step 2 and stops there."""
    cfg = configs.get_reduced_config("qwen3-0.6b")
    d = str(tmp_path / "ck")

    def on_metrics(step, m):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    state, hist = train(cfg, TrainConfig(steps=6, ckpt_every=100,
                                         ckpt_dir=d, log_every=1),
                        OptimizerConfig(**_opt()),
                        _port_batches(cfg), on_metrics=on_metrics,
                        device="cpu")
    assert [h["step"] for h in hist] == [1, 2]
    assert CheckpointManager(d).all_steps() == [2]
    assert int(state["opt"]["step"]) == 2
    assert signal.getsignal(signal.SIGTERM) is not None


def _mesh_train_rank(rank, world, d):
    """One gloo rank of a (1, 2) mesh: ``train(mesh=)`` resumed from the
    single-device checkpoint in ``d`` to step 4; the whole state."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.train.step import gather_train_state

    torch.set_num_threads(1)
    cfg = configs.get_reduced_config("qwen3-0.6b")
    mesh = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
    state, hist = train(cfg, TrainConfig(steps=4, ckpt_every=100,
                                         ckpt_dir=d, resume="auto",
                                         log_every=1),
                        OptimizerConfig(**_opt()), _port_batches(cfg, skip=2),
                        mesh=mesh, device="cpu")
    return ([h["loss"] for h in hist],
            lm_train_state_to_arrays(gather_train_state(state)))


def test_train_on_a_mesh_resumes_a_single_device_checkpoint(tmp_path):
    """``train(mesh=)`` on two gloo ranks, resumed from a checkpoint that
    ``train`` wrote on one device after two steps: its steps 3 and 4
    within REL of the single-device run's, on every rank the same."""
    from repro_torch.core.distributed import spawn_local

    cfg = configs.get_reduced_config("qwen3-0.6b")
    opt = OptimizerConfig(**_opt())
    straight, hist = train(cfg, TrainConfig(steps=4, ckpt_every=100,
                                            log_every=1), opt,
                           _port_batches(cfg), device="cpu")
    d = str(tmp_path / "ck")
    train(cfg, TrainConfig(steps=2, ckpt_every=2, ckpt_dir=d, log_every=100),
          opt, _port_batches(cfg), device="cpu")
    ranks = spawn_local(_mesh_train_rank, 2, store_dir=tmp_path, args=(d,),
                        timeout=300)
    (losses, state), (losses1, _) = ranks
    assert losses == losses1
    for got, want in zip(losses, [h["loss"] for h in hist][2:]):
        assert abs(got - want) <= REL * abs(want)
    _close_trees(state, lm_train_state_to_arrays(straight), "mesh")
    assert int(state["opt"]["step"]) == 4


def test_curated_training_runs_and_learns():
    """The full integration (the reference's ``test_system.py`` case):
    LM training consuming exemplar-curated batches."""
    cfg = configs.get_reduced_config("qwen3-0.6b")
    batches = token_batches(cfg.vocab_size, 4, 32, steps=20,
                            curation=CurationConfig(window=16, select=4),
                            seed=11, device="cpu")
    _, hist = train(cfg, TrainConfig(steps=20, log_every=5),
                    OptimizerConfig(lr=3e-3, warmup_steps=3, total_steps=20),
                    batches, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    """No silent fallback: with no CUDA device, the default device raises
    (the tests name the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, TrainConfig(steps=1), OptimizerConfig(), [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(token_batches(cfg.vocab_size, 2, 8, steps=1))


def test_example_end_to_end_on_cpu(tmp_path):
    """``examples/train_lm_curated_torch.py --device cpu``: raw and curated
    runs, each checkpointed, and the comparison line."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "examples" / "train_lm_curated_torch.py"),
         "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "== raw ==" in out and "== curated ==" in out
    assert "final loss — raw:" in out
    for label in ("raw", "curated"):
        assert CheckpointManager(tmp_path / label).all_steps() == [2, 4]
