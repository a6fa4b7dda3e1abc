"""A model whose parameters are this rank's blocks on the LM mesh.

Training on a mesh keeps each parameter (and its master and moments) as
this rank's block of the leaf, placed by the leaf's dim spec
(:attr:`~repro_torch.models.model.Leaf.dims` through
:meth:`~repro_torch.distributed.sharding.MeshRules.spec`): ``"fsdp"`` dims
split over the data axes (ZeRO-3), ``"tp"`` / ``"expert"`` dims over the
model axis. :class:`PlacedWeights` records each parameter's spec, and
:class:`PlacedTree` reads a layer's parameters through it as the layer
functions read a ``ParamTree``: ``p["wq"]`` is the leaf gathered whole
(:func:`~repro_torch.distributed.parallel.use_leaf`, whose backward adds
the gradient over the ranks that computed it and cuts it back to this
rank's block), ``p.block("wq")`` the leaf gathered over the data axes
but for this rank's model-axis block, which a tensor-parallel product
multiplies by.

A view is made inside the layer's function, so under remat the gathers
run again in the recompute and no gathered leaf outlives its layer.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from repro_torch.distributed.parallel import use_leaf
from repro_torch.distributed.sharding import _axes


def leaf_split(spec) -> tuple:
    """(the dim split over data axes, the dim split over the model axis),
    each None where the spec splits none."""
    d = m = None
    for i, phys in enumerate(spec):
        ax = _axes(phys)
        if "model" in ax:
            m = i
        elif ax:
            d = i
    return d, m


@dataclasses.dataclass(eq=False)
class PlacedWeights:
    """The placement of a model's parameters on ``rules``' mesh:
    ``specs`` maps each parameter name to its leaf's spec; ``data`` and
    ``model`` are the data axes' and the model axis's shards (None where
    the axis is one rank)."""

    rules: object
    specs: dict
    data: object
    model: object

    def __deepcopy__(self, memo):
        return self          # the mesh and its process groups are shared

    def split(self, name: str) -> tuple:
        return leaf_split(self.specs[name])

    def whole(self, t, name: str, partial: bool = False):
        d, m = self.split(name)
        return use_leaf(t, self.data, d, self.model, m, partial)

    def block(self, t, name: str):
        d, m = self.split(name)
        if m is None:
            raise ValueError(f"{name} is not split over the model axis")
        return use_leaf(t, self.data, d, None, None, False)

    def view(self, tree, prefix: str) -> "PlacedTree":
        return PlacedTree(tree, self, prefix, False, {})


class PlacedTree:
    """A (sub)tree of a placed model's parameters, read through its
    placement; leaves are gathered once per view (a loop that reads a
    leaf every step, as the sLSTM's, gathers it once). ``partial``: the
    reads are inside a tensor-parallel region (their gradients add over
    the model axis)."""

    __slots__ = ("tree", "plan", "prefix", "partial", "cache")

    def __init__(self, tree, plan: PlacedWeights, prefix: str,
                 partial: bool, cache: dict):
        self.tree, self.plan, self.prefix = tree, plan, prefix
        self.partial, self.cache = partial, cache

    def _name(self, k: str) -> str:
        return f"{self.prefix}.{k}" if self.prefix else k

    def __getitem__(self, k):
        v = getattr(self.tree, k)
        name = self._name(k)
        if isinstance(v, nn.Module):
            return PlacedTree(v, self.plan, name, self.partial, self.cache)
        key = (name, self.partial)
        if key not in self.cache:
            self.cache[key] = self.plan.whole(v, name, self.partial)
        return self.cache[key]

    def __contains__(self, k) -> bool:
        return k in self.tree._parameters or k in self.tree._modules

    def partitioned(self) -> "PlacedTree":
        """This tree read inside a tensor-parallel region."""
        return PlacedTree(self.tree, self.plan, self.prefix, True, self.cache)

    def block(self, k: str):
        """Leaf ``k`` whole over the data axes, this rank's block along the
        model axis."""
        name = self._name(k)
        key = (name, "block")
        if key not in self.cache:
            self.cache[key] = self.plan.block(getattr(self.tree, k), name)
        return self.cache[key]

    def model_dim(self, k: str):
        """The dim of leaf ``k`` split over the model axis (None: not
        split, or the model axis is one rank)."""
        if self.plan.model is None:
            return None
        return self.plan.split(self._name(k))[1]
