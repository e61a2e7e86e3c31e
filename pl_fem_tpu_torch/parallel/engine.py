"""The design split of a sweep over a set of devices.

Port of pl_fem_tpu/parallel/engine.py. The designs of a sweep are
independent, so the one parallel axis is the design axis: each device
(or slice of one) filters a contiguous range of the designs with the
same kernels, and nothing crosses devices on the hot path except the
per-pass gate, reduced once over all designs. The JAX package lays the
axis over a 1-D ``jax.sharding.Mesh`` through ``shard_map``; here the
mesh is an ordered tuple of ``torch.device`` and the split is written
out in ``ops/kernels.solve_lowest_sweep(mesh=)``.

``TrueVectorialMaxwellSolver.solve_sweep(..., mesh=design_mesh())``
splits a sweep; the dataset engine asks for the mesh itself when more
than one CUDA device is visible (``DatasetGenerator._device_mesh``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class DesignMesh(NamedTuple):
    """A 1-D 'designs' axis: the devices the design ranges go to, in
    order. A device may repeat: its slices then share it."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def ranges(self, B: int) -> List[Tuple[torch.device, int, int]]:
        """``(device, start, stop)`` of each slice's contiguous range of
        ``B`` designs; ``B`` must divide over the mesh (the solver pads)."""
        if B % self.size:
            raise ValueError(f"sweep width {B} not divisible by the "
                             f"{self.size}-slice design mesh")
        b = B // self.size
        return [(d, i * b, (i + 1) * b) for i, d in enumerate(self.devices)]


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare "cuda" is the current CUDA device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def design_mesh(devices: Sequence = None) -> DesignMesh:
    """The 'designs' axis over ``devices`` (names or ``torch.device``s,
    repeats allowed: ``["cpu"] * 3``, ``["cuda:0"] * 2``), by default
    over every visible CUDA device. Raises where none is visible, and on
    a mix of device types."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("design_mesh: no CUDA device is visible; "
                               "name the devices to split over")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError("design_mesh: no devices given")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"design_mesh: devices of more than one type: "
                         f"{[str(d) for d in devs]}")
    return DesignMesh(devs)


__all__ = ["DesignMesh", "design_mesh"]
