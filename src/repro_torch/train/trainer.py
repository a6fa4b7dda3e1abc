"""Training loop: checkpoint/resume, straggler monitor, SIGTERM safety.

The port of the JAX package's ``train/trainer.py``. Deliberately
host-driven and restart-oriented: every ``ckpt_every`` steps the full state
is snapshotted (async); on start, ``resume="auto"`` picks up the latest
complete checkpoint, written by this package or by the reference (the two
share the format, see :mod:`repro_torch.train.checkpoint`). Each step ends
in one ``torch.cuda.synchronize`` (the reference's ``block_until_ready``);
metrics are read to the host only at ``log_every`` steps.

``mesh=`` (a ``DeviceMesh`` with named dims ``("data", "model")``, or
with ``"pod"`` before them) trains on the LM mesh: every rank of the mesh
calls ``train`` with the same batches, draws the same whole model from the
seed and keeps its blocks of the params, master and moments
(``train.step.init_train_state(rules=)``), and runs the mesh's train step.
A resume restores the latest checkpoint onto the current mesh, whatever
mesh (or single device) saved it — the elastic restore; saves gather the
blocks and rank 0 writes. The ranks agree on a SIGTERM before they stop,
so all of them save the same step.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.multiset import resolve_device
from repro_torch.distributed.sharding import MeshRules
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
    (final state, history list). With ``mesh``, every rank of it runs the
    loop on its blocks; the returned state is this rank's blocks
    (``train.step.gather_train_state`` makes it whole)."""
    dev = resolve_device(device)
    rules = None if mesh is None else _mesh_rules(mesh, dev)
    state = St.init_train_state(cfg, tcfg.seed, dev, rules=rules)
    chash = config_hash((cfg, opt_cfg))

    ckpt = None
    start_step = 0
    if tcfg.ckpt_dir:
        ckpt = CheckpointManager(tcfg.ckpt_dir)
        if rules is None or _leader(rules):
            ckpt.clean_incomplete()
        if rules is not None:    # no rank reads before the clean-up
            dist.barrier(group=_world(rules).group)
        if tcfg.resume == "auto" and ckpt.latest_step() is not None:
            state, manifest = ckpt.restore(state, device=dev, cfg_hash=chash,
                                           shardings=rules)
            start_step = manifest["step"]

    step_fn = St.make_train_step(cfg, opt_cfg,
                                 microbatches=tcfg.microbatches, rules=rules)

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
            if rules is not None:
                stop["now"] = _any_rank(rules, stop["now"], dev)
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


def _world(rules):
    return rules.shards(tuple(rules.shape))


def _leader(rules) -> bool:
    return not any(int(c) for c in rules.mesh.get_coordinate())


def _mesh_rules(mesh, dev: torch.device) -> MeshRules:
    """The rules of the mesh the loop trains on; raises where its backend
    cannot run the step on ``dev`` (NCCL reduces CUDA tensors only)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("train(mesh=) runs on a torch.distributed process "
                           "group: call init_process_group on every rank "
                           "first")
    rules = MeshRules.for_mesh(mesh)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL mesh trains on cuda, not on {dev}")
    return rules


def _any_rank(rules, flag: bool, dev: torch.device) -> bool:
    """True on every rank when any rank's ``flag`` is (one all-reduce MAX:
    the ranks stop at the same step)."""
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_world(rules).group)
    return bool(t.item())
