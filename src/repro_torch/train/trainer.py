"""Training loop: checkpoint/resume, straggler monitor, SIGTERM safety.

The port of the JAX package's ``train/trainer.py``. Deliberately
host-driven and restart-oriented: every ``ckpt_every`` steps the full state
is snapshotted (async); on start, ``resume="auto"`` picks up the latest
complete checkpoint, written by this package or by the reference (the two
share the format, see :mod:`repro_torch.train.checkpoint`). Each step ends
in one ``torch.cuda.synchronize`` (the reference's ``block_until_ready``);
metrics are read to the host only at ``log_every`` steps. Training on the
LM mesh (``mesh=``) is a later slice, ROADMAP A.9.3b.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Iterable, Optional

import torch

from repro_torch.core.multiset import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import step as St
from repro_torch.train.checkpoint import CheckpointManager, config_hash
from repro_torch.train.monitor import StepMonitor
from repro_torch.train.optimizer import OptimizerConfig


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    resume: str = "never"  # never | auto
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    opt_cfg: OptimizerConfig,
    batches: Iterable[dict],
    mesh=None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    device=None,
):
    """Run the loop on ``device`` (``"cuda"`` unless named); returns
    (final state, history list)."""
    if mesh is not None:
        raise NotImplementedError("training on a mesh is the LM mesh's "
                                  "training half (ROADMAP A.9.3b), which the "
                                  "port does not have yet; the mesh serves "
                                  "(make_prefill_step / make_serve_step with "
                                  "rules=); pass mesh=None")
    dev = resolve_device(device)
    state = St.init_train_state(cfg, tcfg.seed, dev)
    chash = config_hash((cfg, opt_cfg))

    ckpt = None
    start_step = 0
    if tcfg.ckpt_dir:
        ckpt = CheckpointManager(tcfg.ckpt_dir)
        ckpt.clean_incomplete()
        if tcfg.resume == "auto" and ckpt.latest_step() is not None:
            state, manifest = ckpt.restore(state, device=dev, cfg_hash=chash)
            start_step = manifest["step"]

    step_fn = St.make_train_step(cfg, opt_cfg,
                                 microbatches=tcfg.microbatches)

    stop = {"now": False}

    def _sigterm(sig, frame):  # checkpoint-then-exit on preemption
        stop["now"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)

    monitor = StepMonitor()
    history = []
    it = iter(batches)
    step = start_step
    try:
        while step < tcfg.steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            monitor.start()
            state, metrics = step_fn(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            monitor.stop(step)
            step += 1
            if step % tcfg.log_every == 0 or step == tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_time_s"] = monitor.mean
                history.append({"step": step, **m})
                if on_metrics:
                    on_metrics(step, m)
            if ckpt and (step % tcfg.ckpt_every == 0 or stop["now"]
                         or step == tcfg.steps):
                ckpt.save(step, state, cfg_hash=chash,
                          extra={"stragglers": len(monitor.events)})
            if stop["now"]:
                break
    finally:
        signal.signal(signal.SIGTERM, old)
        if ckpt:
            ckpt.wait()
    return state, history
