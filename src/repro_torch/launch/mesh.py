"""Device meshes: a grid of ``torch.device`` slots with named axes.

The counterpart of the reference's ``jax.sharding.Mesh`` constructors. A
mesh is a numpy array of devices shaped like the grid, plus one name per
axis; the pipeline executors place a stage group on each slot of one axis
(``runtime/pipeline_exec.py``). Building one is a FUNCTION, so importing
this module never touches the card.

``make_mesh`` takes the first ``prod(shape)`` visible cards, or an explicit
device list, which may name one device more than once: a mesh of four
slots that are all ``cuda:0`` runs a four-group pipeline on one card.
Without enough cards it raises; it never falls back to the CPU, which a
caller names explicitly (``cpu_mesh``, or ``devices=[torch.device("cpu")]
* n``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray        # object array of torch.device, the grid
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def slots(self, axis: str) -> tuple:
        """The devices along ``axis`` (every other axis at index 0)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return tuple(self.devices[tuple(index)])


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    """A mesh from the first ``prod(shape)`` visible CUDA devices, or from
    ``devices`` (torch devices or names, repeats allowed)."""
    shape = tuple(int(n) for n in shape)
    ndev = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < ndev:
            raise RuntimeError(f"mesh {shape} needs {ndev} CUDA devices, "
                               f"have {have}; pass devices= to place its "
                               "slots explicitly")
        devices = [torch.device("cuda", i) for i in range(ndev)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) < ndev:
        raise ValueError(f"mesh {shape} needs {ndev} devices, given "
                         f"{len(devices)}")
    grid = np.empty(ndev, dtype=object)
    grid[:] = devices[:ndev]
    return Mesh(grid.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production grid: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model"); raises with fewer cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def cpu_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh on the CPU."""
    return make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("cpu")])
