"""Device meshes of the port (``repro.launch.mesh``).

A :class:`Mesh` is a grid of process ranks with named axes: the axis
names, an ordered ``shape`` dict and a numpy grid of ranks.  Building one
touches no process group, so the sharding rules run on a 16x16 or
2x16x16 mesh in one process.  Collectives go through
:meth:`Mesh.device_mesh`, a ``torch.distributed.device_mesh.DeviceMesh``
over the same grid, built at first use once a default process group of
at least the mesh's size is up; an axis of size 1 needs no group.  Ranks
of the group outside the grid (``elastic_mesh`` leaves the remainder
out) take part in building it and then hold no coordinates.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


class AxisGroup(NamedTuple):
    """The process group along one mesh axis that holds this rank."""
    group: Any                # a torch.distributed ProcessGroup
    size: int
    rank: int                 # this rank's coordinate along the axis
    order: tuple[int, ...]    # each member's coordinate, in group-rank order


class Mesh:
    """``devices``: an integer array of ranks, one dimension per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._dm = None
        self._grid_group = None
        self._orders: dict[str, list[int]] = {}
        self._axis_groups: dict[str, AxisGroup] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> dict[str, int]:
        """The axis coordinates of ``rank`` in the grid."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh once")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def owns(self) -> bool:
        """Whether this process's rank is in the grid."""
        if self.size == 1:
            return True
        import torch.distributed as dist
        return bool((self.devices == dist.get_rank()).any())

    def own_coords(self) -> dict[str, int]:
        """This process's coordinates: its rank in the default group, or
        the one rank of a one-rank mesh without a group."""
        if self.size == 1:
            return self.coords(int(self.devices.reshape(-1)[0]))
        import torch.distributed as dist
        return self.coords(dist.get_rank())

    def device_mesh(self):
        """The ``DeviceMesh`` over this grid (built once, on the default
        group's device: ``cuda`` under nccl, ``cpu`` under gloo).  Every
        rank of the default group calls it, those outside the grid too;
        in a larger world it also makes a group of the grid's ranks (for
        :meth:`barrier`)."""
        if self._dm is None:
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            world = dist.get_world_size()
            if int(self.devices.max()) >= world or len(np.unique(self.devices)) != self.size:
                raise ValueError(f"a mesh of ranks {sorted(self.devices.reshape(-1))} "
                                 f"in a world of {world}")
            self._dm = DeviceMesh(device_type, torch.as_tensor(self.devices),
                                  mesh_dim_names=self.axis_names)
            if world > self.size:
                self._grid_group = dist.new_group(sorted(int(r) for r in
                                                         self.devices.reshape(-1)))
        return self._dm

    def barrier(self) -> None:
        """Wait for every rank of the grid (nothing at one rank)."""
        if self.size == 1:
            return
        import torch.distributed as dist
        self.device_mesh()
        dist.barrier(group=self._grid_group)

    def group(self, axis: str):
        """The process group along ``axis`` that holds this rank."""
        return self.device_mesh().get_group(axis)

    def group_order(self, axis: str) -> list[int]:
        """For each member of this rank's ``axis`` group, in group-rank
        order, its coordinate along ``axis``."""
        if axis not in self._orders:
            import torch.distributed as dist
            g = self.group(axis)
            self._orders[axis] = [
                self.coords(dist.get_global_rank(g, i))[axis]
                for i in range(dist.get_world_size(g))]
        return self._orders[axis]

    def axis_group(self, axis: str) -> AxisGroup:
        """This rank's group along ``axis`` with its coordinates."""
        if axis not in self._axis_groups:
            self._axis_groups[axis] = AxisGroup(
                self.group(axis), self.shape[axis], self.own_coords()[axis],
                tuple(self.group_order(axis)))
        return self._axis_groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.

    ``pod`` is pure data parallelism, ``data`` is DP+FSDP, ``model`` is
    TP/EP (the reference's axes and shapes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def make_smoke_mesh() -> Mesh:
    """One-rank mesh with the same axis names (CPU tests)."""
    return Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
