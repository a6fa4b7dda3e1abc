"""Fault-tolerant checkpointing: atomic and async, in the JAX package's format.

Protocol (crash-safe by construction):
  1. all state leaves are copied to host and written to
     ``<dir>/step_<N>.tmp/state.npz``;
  2. a ``manifest.json`` (step, leaf paths, dtypes, config hash, wall time)
     is written *inside* the tmp dir and fsync'd;
  3. the tmp dir is atomically renamed to ``step_<N>/``.

A restart only ever sees fully-renamed directories — a crash mid-write leaves
a ``.tmp`` dir that ``latest_step`` ignores and ``clean_incomplete`` removes.

The port of the JAX package's ``train/checkpoint.py``, on its format: the
npz entries are named by the leaves' paths in the reference's tree
(``params/groups/g0_attn/attn/wq``, ``opt/master/embed/w``, ``opt/step``),
a group's layers stacked ``(count, …)``, and bfloat16 leaves stored as
their uint16 bits beside a dtype table in the manifest. So a checkpoint
written by either package restores into the other. The port's train state
(``train.step.init_train_state``) goes to and from that tree through
``convert.lm_train_state_tree`` and ``convert.lm_train_state_from_arrays``;
any other nested dict of tensors is saved leaf by leaf. Restore places the
leaves on a ``device``.

On a mesh (a train state placed by ``train.step``: each rank its blocks)
every rank calls :meth:`CheckpointManager.save`; the blocks are gathered
into whole leaves, rank 0 writes them in the same format, and the other
ranks wait for it. So a checkpoint saved on one mesh is the same file as
one saved on one device, and :meth:`CheckpointManager.restore`'s
``shardings=`` places it on any mesh (the elastic path): a train state's
leaves cut to this rank's blocks by the rules of the current mesh, any
other tree's leaves as ``DTensor``s by the placements given.

Async mode runs step 1–3 on a worker thread so the train loop never blocks
on I/O (overlap of checkpoint writes with compute).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import queue
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.models.model import DecoderLM

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_train_state(state) -> bool:
    return isinstance(state, dict) and isinstance(state.get("params"),
                                                  DecoderLM)


def _map_with_names(fn, tree, path: tuple = ()):
    """``fn(name, leaf)`` over nested dicts, lists and tuples, ``name`` in
    the reference's form: keys joined by ``/``, sequence items as
    ``[i]``."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _flatten_with_names(tree) -> list:
    """``(name, leaf)`` pairs, dict keys sorted (``jax.tree`` order)."""
    out = []

    def visit(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                visit(tree[k], path + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                visit(v, path + (f"[{i}]",))
        else:
            out.append(("/".join(path), tree))

    visit(tree, ())
    return out


def _train_state_names(state) -> list:
    """The reference's leaf names of a port train state (no copy)."""
    model, opt = state["params"], state["opt"]
    parts = [("params", model.named_parameters())] + [
        (f"opt/{k}", opt[k].items()) for k in ("master", "m", "v")]
    names = ["opt/step"]
    for prefix, named in parts:
        names += [f"{prefix}/{'/'.join(p)}"
                  for p in convert.lm_ref_leaves(named)]
    return sorted(names)


def _host(x) -> torch.Tensor:
    """A host copy (never the live tensor: the optimizer updates in
    place while an async save is pending)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.as_tensor(np.asarray(x))


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, dtype name): bfloat16 as its uint16 bits, as the reference
    stores ``ml_dtypes.bfloat16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def config_hash(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, async_write: bool = True,
                 keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_write = async_write
        self._q: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._errors: list[str] = []
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state, extra: Optional[dict] = None,
             cfg_hash: str = ""):
        """Snapshot state (device→host copy happens here, synchronously, so
        the caller may overwrite the tensors immediately after). A placed
        train state: every rank calls it, rank 0 writes the gathered
        leaves before it returns, and the other ranks return once it
        has."""
        placed = _is_train_state(state) and \
            state["params"].placement is not None
        if placed:
            from repro_torch.train.step import gather_train_state

            rules = state["params"].placement.rules
            lead = int(rules.mesh.mesh.flatten()[0])
            state = gather_train_state(state, dst=lead)
            if state is None:          # not the writer: wait for it
                dist.barrier(group=rules.shards(tuple(rules.shape)).group)
                return
        tree = (convert.lm_train_state_tree(state) if _is_train_state(state)
                else _map_with_names(lambda n, x: _host(x), state))
        host = [(n,) + _to_numpy(t) for n, t in _flatten_with_names(tree)]
        job = (step, host, extra or {}, cfg_hash)
        if placed:
            self._write(job)
            dist.barrier(group=rules.shards(tuple(rules.shape)).group)
        elif self.async_write:
            self._q.put(job)
        else:
            self._write(job)

    def wait(self):
        if self.async_write:
            self._q.join()
        if self._errors:
            raise IOError("; ".join(self._errors))

    def _drain(self):
        while True:
            job = self._q.get()
            try:
                self._write(job)
            except Exception as e:  # surfaced on wait()
                self._errors.append(f"step {job[0]}: {e}")
            finally:
                self._q.task_done()

    def _write(self, job):
        step, host, extra, cfg_hash = job
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "state.npz", **{n: a for n, a, _ in host})
        manifest = {
            "step": step,
            "leaves": [n for n, _, _ in host],
            "dtypes": {n: dt for n, _, dt in host},
            "config_hash": cfg_hash,
            "time": time.time(),
            "extra": extra,
            "shards": None,  # reserved: per-host sharded saves
            "complete": True,
        }
        mpath = tmp / "manifest.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def clean_incomplete(self):
        for p in self.dir.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_state, step: Optional[int] = None, device=None,
                cfg_hash: Optional[str] = None, shardings=None):
        """Restore into the structure of ``target_state``: a port train
        state (rebuilt by ``convert.lm_train_state_from_arrays`` for the
        target's config) or a nested dict of tensors. Each leaf takes the
        target leaf's dtype, on ``device`` (None: the target leaf's).
        Returns ``(state, manifest)``; the target is left as it was.

        ``shardings`` places the leaves on a mesh, whatever mesh saved
        them: for a train state, the current mesh's ``MeshRules`` (each
        rank gets its blocks, ``train.step.place_train_state``); for
        another tree, a tree of the same keys whose leaves are
        ``(DeviceMesh, placements)`` pairs (each leaf a ``DTensor`` of this
        rank's block)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if cfg_hash and manifest["config_hash"] and \
                manifest["config_hash"] != cfg_hash:
            raise ValueError(
                f"checkpoint config hash {manifest['config_hash']} != "
                f"current {cfg_hash}")
        data = np.load(d / "state.npz")
        train = _is_train_state(target_state)
        names = (_train_state_names(target_state) if train
                 else [n for n, _ in _flatten_with_names(target_state)])
        missing = [n for n in names if n not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        saved_dtypes = manifest.get("dtypes", {})

        def read(name):
            return _from_numpy(data[name], saved_dtypes.get(name))

        if train:
            model = target_state["params"]
            tree: dict = {}
            for name in names:
                convert.put_path(tree, tuple(name.split("/")), read(name))
            dev = device if device is not None else model.embed["w"].device
            if shardings is None:
                return (convert.lm_train_state_from_arrays(model.cfg, tree,
                                                           dev), manifest)
            from repro_torch.train.step import place_train_state

            whole = convert.lm_train_state_from_arrays(model.cfg, tree, "cpu")
            return place_train_state(whole, shardings, device=dev), manifest

        def leaf(name, ref):
            ref = _host(ref) if not isinstance(ref, torch.Tensor) else ref
            t = read(name).to(device=ref.device if device is None
                              else device, dtype=ref.dtype)
            return t if shardings is None else _dtensor(
                t, _at(shardings, name))

        return _map_with_names(leaf, target_state), manifest


def _at(tree, name: str):
    """The leaf of ``tree`` at a checkpoint name (``params/w``, ``[i]``
    for a sequence's item)."""
    for part in name.split("/"):
        if part.startswith("["):
            for i in part.strip("[]").split("]["):
                tree = tree[int(i)]
        else:
            tree = tree[part]
    return tree


def _dtensor(t: torch.Tensor, sharding):
    """This rank's block of the whole ``t`` under ``(mesh, placements)``
    (a ``Shard(i)`` on mesh dim j cuts dim i into the dim's size, the
    major mesh dim first), as a ``DTensor``."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, placements = sharding
    coord = mesh.get_coordinate()
    block = t
    for j, pl in enumerate(placements):
        if isinstance(pl, Shard):
            size = mesh.size(j)
            if block.shape[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does "
                                 f"not split into {size}")
            block = block.chunk(size, pl.dim)[int(coord[j])]
    return DTensor.from_local(block.contiguous(), mesh, list(placements),
                              run_check=False)
