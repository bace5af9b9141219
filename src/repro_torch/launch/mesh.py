"""Meshes of the LM substrate (the reference's ``launch/mesh.py``).

``make_production_mesh`` is the reference's axis layout, one pod of 16x16
or two of them, as an abstract shape that the sharding rules and the
dry-run fit specs against: nothing builds 256 or 512 ranks. ``make_mesh``
(``engine.mesh``'s, where every use of ``torch.distributed`` lives)
builds a real ``DeviceMesh`` over the ranks of the process group.

``HW`` holds the card's constants. The reference's v5e constants are TPU
facts and are not the port's; its ``CHIPS_PER_POD`` (256 v5e chips to a
pod) has no use in the port and is left out.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.engine.mesh import make_mesh
from repro_torch.obs.compiled import HBM_BYTES_PER_S, PEAK_OPS_PER_S

__all__ = ["make_production_mesh", "make_mesh", "HW", "AbstractMesh"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


class HW:
    """The card's constants, for the dry-run's fits-per-card check."""

    # NVIDIA H100 80GB HBM3, 700 W
    PEAK_FLOPS_BF16 = PEAK_OPS_PER_S["bf16"]
    # NVIDIA H100 80GB HBM3, 700 W
    HBM_BW = HBM_BYTES_PER_S
    # NVIDIA H100 80GB HBM3, 700 W: NVLink, bytes/s per direction
    NVLINK_BW = 450e9
    # NVIDIA H100 80GB HBM3, 700 W
    HBM_BYTES = 80e9
