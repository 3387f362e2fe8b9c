"""Shard mesh and its collectives (torch port of
gaussian_splat_ipu_tpu/parallel/mesh.py, with the collectives that
shard_map gives the reference's parallel/distributed.py).

A `Mesh` is D shards with named axes: a 1-D ("shard",) mesh, whose one axis
shards gaussians for projection and framebuffer tile rows for
rasterization, or a 2-D ("view", "shard") mesh that also splits a batch of
camera views between groups of shards. Each shard has a torch.device.
`make_mesh` and `make_mesh_2d` place the shards round-robin over the
visible devices of the kind the caller asks for: CUDA unless the caller
asks for the CPU. Shards may share a device: 4 shards on one H100 all sit
on cuda:0, 8 shards on the CPU all on the CPU. That is the counterpart of
the forced host device count (XLA_FLAGS
--xla_force_host_platform_device_count=8) that the reference's tests run
its mesh on, and it runs the sharded programs, exchange included, exactly
as D devices would, with every shard's work on one stream.

One process holds every shard (the reference's single controller): a
sharded tensor is one tensor whose leading dimension is the D shards'
contiguous slices in shard order, on the mesh's first device, and a shard
body takes its slice with `shard_slices` (a view, or a copy to the shard's
device when it has its own). The collectives are differentiable tensor
operations between the shards' tensors, given as lists in shard order: on
one device they are index, reshape and cat operations, across devices
`.to(device)` peer copies. The autograd transpose of each is the
reference's: all_to_all's is the inverse all_to_all, all_gather's the
reduce-scatter, so gradients land on the owning shard's slice.
parallel/distributed.py calls only these. The backend with one shard per
process (parallel/multihost.py) gives the same collectives, and an
all_to_all whose parts are sized from the demands it reads back to the
host; this one's buckets are fixed, so nothing reads back and a sharded
program captures as one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)

# The model-parallel axis: shards gaussians at projection and framebuffer
# tile rows at rasterization (same shards, two roles).
SHARD_AXIS = "shard"
# The data-parallel axis: shards a batch of camera views (training).
VIEW_AXIS = "view"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards over named axes. devices: one per shard, in row-major order
    over axis_names (the shard axis fastest)."""

    devices: tuple
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        n = 1
        for s in self.axis_sizes:
            n *= s
        if len(self.axis_names) != len(self.axis_sizes) \
                or len(self.devices) != n or n < 1:
            raise ValueError(f"mesh of {len(self.devices)} devices over axes "
                             f"{self.axis_names} of sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Where the mesh's sharded tensors live: its first device."""
        return self.devices[0]

    @property
    def spans_devices(self) -> bool:
        """True when the shards are on more than one device."""
        return len(set(self.devices)) > 1

    def group(self, index: int = 0, axis: str = SHARD_AXIS) -> "ShardGroup":
        """The shards along `axis` at position `index` of the other axis (a
        view group of a 2-D mesh; the whole mesh of a 1-D one)."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh {self.axis_names}")
        d = self.shape[axis]
        if len(self.axis_names) == 1:
            return ShardGroup(self.devices)
        if self.axis_names.index(axis) != len(self.axis_names) - 1:
            raise ValueError("the shard axis must be the mesh's last")
        return ShardGroup(self.devices[index * d:(index + 1) * d])


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """The D shards of one shard axis, all held by this process, and their
    collectives over lists of per-shard tensors in shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """The shard indices this process holds: all of them."""
        return range(len(self.devices))

    @property
    def same_device(self) -> bool:
        return len(set(self.devices)) == 1

    def local_rows(self, n: int) -> int:
        """Rows of one shard of a sharded tensor of n rows."""
        if n % len(self.devices):
            raise ValueError(f"{n} gaussians do not split over "
                             f"{len(self.devices)} shards: shard the model "
                             "first (parallel.mesh.shard_model)")
        return n // len(self.devices)

    def shard_slices(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The local shards' slices of a sharded tensor (leading dimension
        D * n), each on its shard's device."""
        n = self.local_rows(x.shape[0])
        return [s.to(dev) for s, dev in zip(x.split(n), self.devices)]

    def all_to_all(self, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """sends[i]: (D * cap, F), bucket j of shard i in rows
        [j * cap, (j + 1) * cap). Shard j receives every shard's bucket j,
        in shard order: (D * cap, F)."""
        d = len(self.devices)
        if self.same_device:
            x = torch.stack(list(sends))              # (D_src, D*cap, F)
            x = x.reshape(d, d, -1, *x.shape[2:]).transpose(0, 1)
            return list(x.reshape(d, -1, *x.shape[3:]).unbind(0))
        return [torch.cat([s.chunk(d)[j].to(dev) for s in sends])
                for j, dev in enumerate(self.devices)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard receives the concatenation of all shards' xs."""
        if self.same_device:
            whole = torch.cat(list(xs))
            return [whole] * len(self.devices)
        return [torch.cat([x.to(dev) for x in xs]) for dev in self.devices]

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over shards, on the first shard's device."""
        dev = self.devices[0]
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(dev)
        return total

    def gather(self, xs: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
        """The concatenation of every shard's xs, on `device` (the
        sharded outputs: image rows, tile counts, the visibility mask)."""
        return torch.cat([x.to(device) for x in xs])


def _devices(kind: str) -> List[torch.device]:
    """The visible devices of a kind: every CUDA device, or the CPU."""
    dev = torch.device(kind)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"device {kind!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {kind!r}: no CUDA device is available")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def visible_device_count(device: str = "cuda") -> int:
    """How many devices of this kind a mesh can place shards on."""
    return len(_devices(device))


def make_mesh(num_shards: int | None = None, axis: str = SHARD_AXIS,
              device: str = "cuda") -> Mesh:
    """A 1-D mesh of num_shards shards (default: one per visible device of
    the kind), round-robin over the visible devices."""
    devs = _devices(device)
    n = len(devs) if num_shards is None else num_shards
    if n < 1:
        raise ValueError(f"a mesh of {n} shards")
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)), (axis,), (n,))


def make_mesh_2d(num_views: int, num_shards: int | None = None,
                 view_axis: str = VIEW_AXIS, shard_axis: str = SHARD_AXIS,
                 device: str = "cuda") -> Mesh:
    """(view, shard) mesh: view groups on the outer axis, each num_shards
    shards (default: the visible devices split over the groups)."""
    devs = _devices(device)
    if num_shards is None:
        num_shards = max(len(devs) // num_views, 1)
    n = num_views * num_shards
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)),
                (view_axis, shard_axis), (num_views, num_shards))


def shard_model(model: GaussianModel, mesh: Mesh,
                axis: str = SHARD_AXIS) -> GaussianModel:
    """The model with N padded to a multiple of the axis size
    (GaussianModel.pad_to: padding is culled), on the mesh's device: shard
    j's slice is rows [j * N / D, (j + 1) * N / D). Parameters require
    grad as the input's do."""
    d = mesh.shape[axis]
    n = model.num_gaussians
    padded = model.pad_to(-(-n // d) * d)
    if padded is model and model.device == mesh.device:
        return model
    return GaussianModel(*(getattr(padded, k).detach().to(mesh.device)
                           for k in FIELDS),
                         requires_grad=model.means.requires_grad)
