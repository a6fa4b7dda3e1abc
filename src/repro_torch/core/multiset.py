"""Packed representation of a *multiset of evaluation sets* (paper §IV-B-2).

The paper packs ``S_multi = {S_1 … S_l}`` into one dense device buffer so that
(a) the host→device copy is a single large transaction and (b) on-device
access is coalesced. Sets of unequal size leave blank fields; here that is
zero-padding plus a validity mask, in a dense row-major ``(l, k_max, d)``
block (the CUDA kernels read it through strides, so the k-major layout of the
flat kernel variant is a transpose of this block, not another format).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """Where an entry point that takes numpy puts its tensors: ``"cuda"``
    unless the caller names a device. No silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class PackedMultiset:
    """Dense ``(l, k_max, d)`` payload + per-set lengths.

    Attributes:
      data: ``(l, k_max, d)`` tensor; rows past ``lengths[j]`` are padding.
      lengths: ``(l,)`` int32 number of valid vectors per set.
    """

    data: torch.Tensor
    lengths: torch.Tensor

    @property
    def num_sets(self) -> int:
        return self.data.shape[0]

    @property
    def k_max(self) -> int:
        return self.data.shape[1]

    @property
    def dim(self) -> int:
        return self.data.shape[2]

    def mask(self) -> torch.Tensor:
        """(l, k_max) bool — True where a slot holds a real vector."""
        ar = torch.arange(self.k_max, device=self.lengths.device)
        return ar[None, :] < self.lengths[:, None]

    def pad_fraction(self) -> float:
        """Fraction of allocated slots that are blank (paper's unused fields)."""
        total = self.num_sets * self.k_max
        used = int(self.lengths.sum().item())
        return 1.0 - used / max(total, 1)

    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() \
            + self.lengths.numel() * 4

    def slice_sets(self, start: int, stop: int) -> "PackedMultiset":
        """Chunking support: a view of sets [start, stop) (paper §IV-B-3)."""
        return PackedMultiset(self.data[start:stop], self.lengths[start:stop])


def pack_sets(sets: Sequence[np.ndarray], dtype=torch.float32,
              device=None) -> PackedMultiset:
    """Pack a list of ``(k_j, d)`` arrays into a PackedMultiset on ``device``
    (``"cuda"`` unless the caller passes another device)."""
    if not sets:
        raise ValueError("cannot pack an empty multiset")
    dims = {s.shape[-1] for s in sets}
    if len(dims) != 1:
        raise ValueError(f"inconsistent dims across sets: {dims}")
    d = dims.pop()
    lengths = np.array([s.shape[0] for s in sets], dtype=np.int32)
    k_max = int(lengths.max())
    l = len(sets)
    buf = np.zeros((l, k_max, d), dtype=np.float32)
    for j, s in enumerate(sets):
        buf[j, : s.shape[0]] = np.asarray(s, dtype=np.float32)
    dev = resolve_device(device)
    return PackedMultiset(torch.from_numpy(buf).to(dev, dtype),
                          torch.from_numpy(lengths).to(dev))


def pack_base_plus_candidates(
    base: torch.Tensor, candidates: torch.Tensor,
    base_len: Optional[int] = None,
) -> PackedMultiset:
    """Greedy-step multiset: ``S_j = S ∪ {c_j}``.

    Returns a PackedMultiset with ``data[j] = concat(S, c_j)`` on the
    candidates' device — Greedy's equal-size sets make the dense layout free
    of blank fields.

    Args:
      base: ``(k, d)`` current set (k may be 0).
      candidates: ``(m, d)``.
      base_len: valid prefix length of ``base`` if it is itself padded.
    """
    m = candidates.shape[0]
    k = base.shape[0]
    blen = k if base_len is None else base_len
    tiled = base[None].expand(m, k, base.shape[-1]).to(candidates.dtype)
    data = torch.cat([tiled, candidates[:, None, :]], dim=1)
    lengths = torch.full((m,), blen + 1, dtype=torch.int32,
                         device=candidates.device)
    # Move each candidate into the first padding slot when base is padded:
    # slot order is irrelevant to min-reduction, so leaving the candidate at
    # position k with mask length blen+1 would be wrong only if blen < k.
    if base_len is not None and base_len < k:
        data = data.clone()
        data[:, blen, :] = candidates
        data = data[:, : blen + 1, :]
    return PackedMultiset(data, lengths)
