"""Logical-axis sharding rules with divisibility fallback, over a
``torch.distributed`` ``DeviceMesh``.

The port of the JAX package's ``distributed/sharding.py``. Every tensor of
the LM stack annotates its dims with *logical* names (``"batch"``,
``"tp"``, ``"fsdp"``, …): parameter specs carry them as
:attr:`repro_torch.models.model.Leaf.dims`, the caches and batches get
them from the tables of :mod:`repro_torch.train.step`. A
:class:`MeshRules` maps those names to the mesh's named dims and drops or
relocates the ones that do not divide (gemma3's one KV head cannot be
split over a model axis, so ``"tp"`` falls through to the next dim that
asks for it and divides).

Dim spec format: each tensor dim is a tuple of logical names tried in
priority rounds; round p tries every dim's p-th alternative. ``None``
skips a round, so ``(None, "tp")`` means "take the model axis only if no
earlier dim claimed it" — the fallback mechanism.

:meth:`MeshRules.spec` returns what the reference's ``PartitionSpec``
holds, as a tuple: per dim a mesh dim name, a tuple of names (major
first), or None. :meth:`MeshRules.placements` gives the same split as
one ``Shard(i)`` / ``Replicate()`` per mesh dim, and :meth:`MeshRules.local`
cuts this rank's block out of a full tensor.

The reference's ``constraint`` and ``shard_activation`` have no
counterpart here. They annotate a global array so that GSPMD can place
it; in the port each rank holds its own block already (the serve path
slices its batch rows and allocates its cache block, and the two
collective regions, expert-parallel MoE and the sequence-sharded decode,
exchange what they need explicitly), so there is nothing left to
annotate.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional, Sequence

import torch

# A dim spec: tuple of (logical name | None) tried in priority rounds.
DimSpec = Sequence[Optional[str]]

#: The mesh dims a batch is split over, major first.
DATA_AXES = ("pod", "data")


def _mesh_shape(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` with named dims (or of a
    mapping of sizes, for rules with no process group)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if not names:
        raise ValueError("the LM mesh needs a DeviceMesh with named dims "
                         "(mesh_dim_names)")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def default_logical_rules(mesh) -> dict[str, tuple[str, ...]]:
    """Map logical names → mesh dims, for any of our meshes (a
    ``DeviceMesh`` or a mapping of dim sizes)."""
    axes = set(_mesh_shape(mesh))
    dp = tuple(a for a in DATA_AXES if a in axes)
    tp = ("model",) if "model" in axes else ()
    return {
        "batch": dp,          # activations' batch dim
        "fsdp": dp,           # parameter / optimizer-state sharding (ZeRO-3)
        "pod": ("pod",) if "pod" in axes else (),
        "data": ("data",) if "data" in axes else (),
        "tp": tp,             # tensor parallel (heads / mlp / vocab / experts)
        "sp": ("data",) if "data" in axes else (),  # sequence/context parallel
        "expert": tp,         # expert parallel shares the model axis
    }


@dataclasses.dataclass(eq=False)
class MeshRules:
    """The rule system on one mesh. ``mesh`` is the ``DeviceMesh`` (None
    for rules over dim sizes alone, which place nothing); ``shape`` maps
    each mesh dim to its size, in the mesh's order."""

    mesh: object
    logical: dict
    shape: dict

    @classmethod
    def for_mesh(cls, mesh) -> "MeshRules":
        """Rules on a ``DeviceMesh`` with named dims, or — for the tables
        alone, with no process group — on a mapping ``{dim: size}``."""
        shape = _mesh_shape(mesh)
        return cls(None if isinstance(mesh, Mapping) else mesh,
                   default_logical_rules(shape), shape)

    def _axis_size(self, phys: tuple[str, ...]) -> int:
        return math.prod(self.shape[a] for a in phys)

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.shape)

    def spec(self, shape: Sequence[int], dims: Sequence[DimSpec]) -> tuple:
        """The priority-round fallback: per dim a mesh dim name, a tuple of
        names, or None."""
        if len(shape) != len(dims):
            raise ValueError(f"shape {shape} vs dims {dims} length mismatch")
        out: list = [None] * len(shape)
        used: set[str] = set()
        rounds = max((len(d) for d in dims), default=0)
        for p in range(rounds):
            for i, alts in enumerate(dims):
                if out[i] is not None or p >= len(alts) or alts[p] is None:
                    continue
                phys = self.logical.get(alts[p], ())
                phys = tuple(a for a in phys if a in self.shape)
                if not phys or any(a in used for a in phys):
                    continue
                if shape[i] % self._axis_size(phys) != 0:
                    continue
                out[i] = phys if len(phys) > 1 else phys[0]
                used.update(phys)
        return tuple(out)

    def placements(self, shape: Sequence[int],
                   dims: Sequence[DimSpec]) -> list:
        """:meth:`spec` as ``DTensor`` placements: ``Shard(i)`` on each
        mesh dim that splits tensor dim i, ``Replicate()`` on the others.
        A tensor dim split over several mesh dims needs them in the mesh's
        order (major first), as ``DTensor`` splits."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.shape)
        out = [Replicate() for _ in names]
        for i, phys in enumerate(self.spec(shape, dims)):
            phys = _axes(phys)
            if [names.index(a) for a in phys] != sorted(names.index(a)
                                                        for a in phys):
                raise ValueError(f"dim {i} is split over {phys}, not in the "
                                 f"mesh's order {tuple(names)}")
            for a in phys:
                out[names.index(a)] = Shard(i)
        return out

    def coordinate(self, phys) -> int:
        """This rank's index along the mesh dims ``phys`` (row-major, the
        first major), as :func:`repro_torch.core.distributed.resolve_mesh`
        numbers its shards."""
        if self.mesh is None:
            raise ValueError("these rules were built from sizes alone and "
                             "place nothing: build them on a DeviceMesh")
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        names = list(self.shape)
        idx = 0
        for a in _axes(phys):
            idx = idx * self.shape[a] + int(coord[names.index(a)])
        return idx

    def local(self, x: torch.Tensor, dims: Sequence[DimSpec]) -> torch.Tensor:
        """This rank's block of the full tensor ``x`` (a view)."""
        for i, phys in enumerate(self.spec(tuple(x.shape), dims)):
            if phys is None:
                continue
            n = self._axis_size(_axes(phys))
            size = x.shape[i] // n
            x = x.narrow(i, self.coordinate(phys) * size, size)
        return x

    def local_shape(self, shape: Sequence[int],
                    dims: Sequence[DimSpec]) -> tuple:
        """The shape of one rank's block."""
        return tuple(s if phys is None else s // self._axis_size(_axes(phys))
                     for s, phys in zip(shape, self.spec(shape, dims)))

    def shards(self, axes: Sequence[str]):
        """The resolved mesh over ``axes`` (a collective on its first use:
        every rank asks for the same axes in the same order)."""
        from repro_torch.core.distributed import resolve_mesh

        if self.mesh is None:
            raise ValueError("these rules were built from sizes alone and "
                             "have no process group")
        return resolve_mesh(self.mesh, tuple(axes))


def _axes(phys) -> tuple:
    if phys is None:
        return ()
    return phys if isinstance(phys, tuple) else (phys,)


class NoRules:
    """Identity stand-in for single-device runs: no mesh, nothing placed
    (``forward`` and the steps treat it as no rules)."""

    def spec(self, shape, dims):
        return ()


def on_mesh(rules) -> bool:
    """True for rules that place tensors on a ``DeviceMesh``."""
    return isinstance(rules, MeshRules) and rules.mesh is not None
