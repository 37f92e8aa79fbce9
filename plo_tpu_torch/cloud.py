"""Fixed-capacity masked point sets (the port of plo_tpu/cloud.py).

A cloud is a padded struct of tensors with a validity mask; "deleting" a
point clears its mask bit, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point set, capacity P (plo_tpu.cloud.PointCloud)."""

    xyz: torch.Tensor        # [P, 3] f32
    normal: torch.Tensor     # [P, 3] f32 (0 where unknown)
    intensity: torch.Tensor  # [P]    f32
    curvature: torch.Tensor  # [P]    f32
    eigvals: torch.Tensor    # [P, 3] f32, descending
    valid: torch.Tensor      # [P]    bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def gather(self, idx: torch.Tensor, idx_valid: torch.Tensor) -> "PointCloud":
        """Select rows `idx` (with validity) into a new padded cloud."""
        idx = idx.clamp(0, self.capacity - 1)
        return PointCloud(
            xyz=self.xyz[idx], normal=self.normal[idx],
            intensity=self.intensity[idx], curvature=self.curvature[idx],
            eigvals=self.eigvals[idx], valid=self.valid[idx] & idx_valid)

    def slice(self, n: int) -> "PointCloud":
        """The first n rows."""
        return PointCloud(**{f.name: getattr(self, f.name)[:n]
                             for f in dataclasses.fields(self)})

    def concat(self, other: "PointCloud") -> "PointCloud":
        return PointCloud(**{f.name: torch.cat([getattr(self, f.name),
                                                getattr(other, f.name)])
                             for f in dataclasses.fields(self)})
