"""Multi-process runs: one shard per process over torch.distributed (torch
port of gaussian_splat_ipu_tpu/parallel/multihost.py).

The reference bootstraps jax.distributed and runs the same shard_map
program over every process's devices. The port's counterpart is a process
group, one process per shard, and a `ProcessMesh` whose shard group
(`ProcessShardGroup`) gives parallel/distributed.py its collectives over
that group: the shard body is the one the in-process mesh runs
(parallel/mesh.py), and each process holds only its own shard. Launch one
process per shard with the reference's environment contract:

    GSPLAT_COORDINATOR    host:port of process 0 (its TCP store)
    GSPLAT_NUM_PROCESSES  the process count
    GSPLAT_PROCESS_ID     this process's rank

`initialize()` picks NCCL when each process can have a GPU of its own and
gloo otherwise, which also lets processes share one GPU (two processes on
cuda:0). gloo has no all_to_all or all_gather for CUDA tensors, so with
gloo a CUDA tensor's collective is staged through pinned host memory,
explicitly (`_Host`), both ways and under autograd.

On the process mesh the model passed to render_sharded is this process's
slice (`load_scene_sharded` reads only it from the file). The image is
gathered on every process, which then computes the same loss: the
gather's backward therefore keeps this process's rows of the cotangent
instead of summing every process's copy (`_GatherReplicated`), so a
gradient is not counted once per process. Collectives cannot be captured
by a CUDA graph on one device: programs over a process mesh run eagerly
(RenderEngine.register(eager=)). So the exchange may read the host's
copy of a value once a forward, and does: the ranks' per-destination row
demands (`ProcessShardGroup.demand_matrix`), which size the all_to_all's
parts exactly (`ProcessShardGroup.all_to_all`), where the in-process mesh
sends fixed, mostly padded buckets so as to stay capturable
(parallel/distributed.py).

Training state on a process mesh (app/train.py): each process holds its
rows of every slot-indexed tensor (parameters, Adam moments, density
statistics; `local_model`, `keep_state`). `gather_state` all-gathers them
for a checkpoint, and `densify_and_prune` runs the density event on the
gathered buffer on every process, with the same key, keeping each
process's rows: the event's ranking and allocation are global.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn  # noqa: F401  (dist.nn.functional)

from gaussian_splat_ipu_tpu_torch.models.gaussians import (FIELDS,
                                                          GaussianModel)
from gaussian_splat_ipu_tpu_torch.parallel.mesh import SHARD_AXIS
from gaussian_splat_ipu_tpu_torch.train import adam, densify, trainer

log = logging.getLogger("gsplat")


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> bool:
    """Join the process group from the arguments or the GSPLAT_*
    environment. Returns True when a multi-process group is up, False
    without a coordinator (a single process). Idempotent."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("GSPLAT_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(
        os.environ.get("GSPLAT_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("GSPLAT_PROCESS_ID", "0"))
    own_gpus = (torch.device(device).type == "cuda"
                and torch.cuda.is_available()
                and torch.cuda.device_count() >= num_processes)
    backend = "nccl" if own_gpus else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    log.info("process %d of %d (%s)", process_id, num_processes, backend)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes files and logs."""
    return process_index() == 0


def local_shard_bounds(n: int) -> tuple:
    """[lo, hi) of the gaussian axis this process owns (an even split
    rounded up, the last process's share cut at n)."""
    per = -(-n // process_count())
    lo = min(process_index() * per, n)
    return lo, min(lo + per, n)


def process_device(device: str = "cuda") -> torch.device:
    """This process's device: the CPU, its own GPU under NCCL (rank modulo
    the visible GPUs), or the first GPU, shared, under gloo."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", process_index()
                            % torch.cuda.device_count())
    return torch.device("cuda", 0)


class _Host(torch.autograd.Function):
    """A CUDA tensor copied into pinned host memory for a gloo collective;
    the gradient goes back to the device."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.device)


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    return _Host.apply(x) if _staged(x) else x


class _AllGather(torch.autograd.Function):
    """All ranks' x, concatenated on every rank; backward sums every
    rank's cotangent of this rank's rows (the all_gather exchange: each
    rank bins its own strip from the gathered splats)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows]


class _AllToAll(torch.autograd.Function):
    """Rows [sum(send[:j]), sum(send[:j + 1])) of x to rank j; the parts
    received, concatenated in rank order. The backward is the inverse
    exchange with the same sizes."""

    @staticmethod
    def forward(ctx, x, send_sizes, recv_sizes):
        ctx.sizes = send_sizes, recv_sizes
        out = x.new_empty((sum(recv_sizes),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), recv_sizes, send_sizes)
        return out

    @staticmethod
    def backward(ctx, g):
        send_sizes, recv_sizes = ctx.sizes
        return _AllToAll.apply(g, recv_sizes, send_sizes), None, None


class _GatherReplicated(torch.autograd.Function):
    """All ranks' x, concatenated on every rank; backward keeps this
    rank's rows of the cotangent, which every rank holds whole because the
    computation downstream of the gather is replicated."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows]


@dataclasses.dataclass(frozen=True)
class ProcessShardGroup:
    """The shard group of a process mesh: world-size shards, one per
    process; this process holds shard `rank` on `device`. Collectives as
    mesh.ShardGroup's, over lists of the local shard's tensors (one)."""

    device: torch.device
    size: int
    rank: int

    @property
    def local(self) -> range:
        return range(self.rank, self.rank + 1)

    @property
    def devices(self) -> tuple:
        return (self.device,) * self.size

    def local_rows(self, n: int) -> int:
        """Rows of one shard of a model whose local slice has n rows."""
        return n

    def shard_slices(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The local shard: x is this process's slice already."""
        return [x.to(self.device)]

    def demand_matrix(self, demand: torch.Tensor) -> List[List[int]]:
        """Every rank's (D,) per-destination row demand, as a (D, D) list
        on the host, row i rank i's: one all_gather of D counts, then one
        read back to the host, which waits for this process's stream."""
        wire = demand.cpu() if _staged(demand) else demand
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire)
        return torch.stack(parts).tolist()

    def all_to_all(self, sends: Sequence[torch.Tensor],
                   send_sizes: Sequence[int],
                   recv_sizes: Sequence[int]) -> List[torch.Tensor]:
        """The local shard's rows [sum(send_sizes[:j]), ... + send_sizes[j])
        to rank j; received, recv_sizes[i] rows from rank i in rank order.
        Differentiable: the backward sends the cotangents back."""
        (send,) = sends
        recv = _AllToAll.apply(_to_wire(send), list(send_sizes),
                               list(recv_sizes))
        return [recv.to(send.device)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        return [_AllGather.apply(_to_wire(x)).to(x.device)]

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over processes of integer counters (no gradient)."""
        (x,) = xs
        wire = x.detach().cpu() if _staged(x) else x.detach().clone()
        dist.all_reduce(wire)
        return wire.to(x.device)

    def gather(self, xs: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
        (x,) = xs
        return gather_rows(x).to(device)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's x concatenated in process order, on x's device, on
    every process: a collective that all processes call. Differentiable
    (_GatherReplicated); with gloo a CUDA tensor is staged through pinned
    host memory."""
    if x.dtype == torch.bool:
        return gather_rows(x.to(torch.uint8)).to(torch.bool)
    return _GatherReplicated.apply(_to_wire(x)).to(x.device)


def keep_rows(x: torch.Tensor) -> torch.Tensor:
    """A copy of this process's rows of a whole tensor whose leading
    dimension splits evenly over the processes (shard order)."""
    n, p = x.shape[0], process_count()
    if n % p:
        raise ValueError(f"{n} rows do not split over {p} processes")
    lo = process_index() * (n // p)
    return x[lo:lo + n // p].clone()


def local_model(model: GaussianModel) -> GaussianModel:
    """This process's shard of a whole model, laid out as
    parallel.mesh.shard_model lays a model over a mesh of one shard per
    process: padded to a multiple of the process count (culled padding),
    this process's contiguous run of rows. Parameters require grad as the
    input's do."""
    p = process_count()
    padded = model.pad_to(-(-model.num_gaussians // p) * p)
    return GaussianModel(*(keep_rows(getattr(padded, k).detach())
                           for k in FIELDS),
                         requires_grad=model.means.requires_grad)


def _slots(state: trainer.TrainState, dstate=None) -> list:
    """Every slot-indexed tensor of (state, dstate), in a fixed order: the
    five parameters, each label's Adam moments, then grad_sum, vis_count
    and alive."""
    ts = [getattr(state.params, k) for k in FIELDS]
    for label in adam.LABELS:
        st = state.opt_state.adam[label]
        ts += [st.mu, st.nu]
    if dstate is not None:
        ts += [dstate.grad_sum, dstate.vis_count, dstate.alive]
    return ts


def _with_slots(state: trainer.TrainState, dstate, ts: list):
    """(state, dstate) with its slot-indexed tensors replaced by ts (in
    _slots order); the counts, the step and the key are kept."""
    it = iter(ts)
    params = GaussianModel(*(next(it).detach() for _ in FIELDS),
                           requires_grad=True)
    moments = {label: trainer.AdamState(state.opt_state.adam[label].count,
                                        next(it), next(it))
               for label in adam.LABELS}
    new = trainer.TrainState(
        params, trainer.OptState(moments, state.opt_state.means_lr_count),
        state.step)
    if dstate is None:
        return new, None
    return new, densify.DensifyState(next(it), next(it), next(it),
                                     dstate.key)


@torch.no_grad()
def gather_state(state: trainer.TrainState, dstate=None):
    """The whole (state, dstate) on every process, each slot-indexed
    tensor all-gathered from the processes' slices: a collective that all
    processes call. The counts, the step and the key are the same on
    every process already."""
    return _with_slots(state, dstate,
                       [gather_rows(t) for t in _slots(state, dstate)])


def keep_state(state: trainer.TrainState, dstate=None):
    """This process's rows of a whole (state, dstate) (keep_rows of every
    slot-indexed tensor)."""
    return _with_slots(state, dstate,
                       [keep_rows(t.detach()) for t in _slots(state, dstate)])


def densify_and_prune(state: trainer.TrainState,
                      dstate: densify.DensifyState,
                      cfg: densify.DensifyConfig = densify.DensifyConfig(),
                      counts=None):
    """One density event on a process mesh, where each process holds a
    slice of the slot buffer: every slot-indexed tensor is all-gathered,
    densify.densify_and_prune runs on the whole buffer on every process
    with the same key (so the same split noise), and this process's rows
    are written back into its tensors in place (a registered program
    keeps training them). The whole buffer's counts go into `counts` when
    given. Returns (state, dstate with the advanced key). The opacity
    reset is elementwise and needs no gather."""
    whole, wd = gather_state(state, dstate)
    whole, wd = densify.densify_and_prune(whole, wd, cfg, counts)
    with torch.no_grad():
        for mine, w in zip(_slots(state, dstate), _slots(whole, wd)):
            mine.copy_(keep_rows(w))
    return state, dstate._replace(key=wd.key)


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A 1-D mesh of one shard per process (parallel/mesh.Mesh's
    interface for the shard body)."""

    group_: ProcessShardGroup
    axis_names: tuple = (SHARD_AXIS,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.group_.size}

    @property
    def device(self) -> torch.device:
        return self.group_.device

    def group(self, index: int = 0, axis: str = SHARD_AXIS):
        return self.group_


def make_process_mesh(device: str = "cuda") -> ProcessMesh:
    """The mesh of the initialised process group, this process's shard on
    process_device(device)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize() first")
    return ProcessMesh(ProcessShardGroup(process_device(device),
                                         dist.get_world_size(),
                                         dist.get_rank()))


def _all_boxes(box: np.ndarray, device) -> np.ndarray:
    """Every process's (2, 3) f32 box, (P, 2, 3)."""
    t = torch.tensor(box, dtype=torch.float32)
    if dist.get_backend() == "nccl":
        t = t.to(device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def load_scene_sharded(path: str, mesh, center: bool = True,
                       flip_z: bool = True, sh_degree: int = 0):
    """Load this process's shard of a scene, reading only its rows.

    The vertex count comes from the header (a .splat's from its size); the
    count is padded to a multiple of the mesh size and each process takes
    an equal run of rows. The world centre must be global, so the raw
    boxes of all processes are exchanged before assembly; the scene's
    bounds are the union of the processes' assembled boxes. The returned
    Scene holds this process's slice, padded (GaussianModel.pad_to) to the
    common length, and the file's row count in num_rows. One process:
    load_scene and shard_model."""
    from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_lib
    from gaussian_splat_ipu_tpu_torch.parallel import mesh as mesh_lib

    ext = path.rsplit(".", 1)[-1].lower()
    if ext not in ("ply", "splat") or process_count() == 1:
        scene = scene_lib.load_scene(path, center, flip_z, sh_degree,
                                     device=mesh.device)
        scene.num_rows = scene.num_gaussians
        if isinstance(mesh, mesh_lib.Mesh):
            scene.model = mesh_lib.shard_model(scene.model, mesh)
        else:
            # Other formats have no row index: parse the whole file.
            scene.model = local_model(scene.model)
        return scene
    if ext == "splat":
        from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
        n = splat_io.count_records(path)
    else:
        n = ply_io.count_vertices(path)
    per_proc = -(-n // process_count())
    lo = min(process_index() * per_proc, n)
    hi = min(lo + per_proc, n)
    fields = ply_io.load_points(path, row_range=(lo, hi))
    raw = fields["means"].astype(np.float32)
    empty = np.stack([np.full(3, np.inf, np.float32),
                      np.full(3, -np.inf, np.float32)])
    box = np.stack([raw.min(0), raw.max(0)]) if len(raw) else empty
    boxes = _all_boxes(box, mesh.device)
    center_point = ((boxes[:, 0].min(0) + boxes[:, 1].max(0)) * 0.5
                    if center else None)
    scene = scene_lib.assemble_scene(fields, center, flip_z, sh_degree,
                                     center_point=center_point,
                                     device=mesh.device)
    post = (np.stack([scene.bb_min, scene.bb_max]).astype(np.float32)
            if hi > lo else empty)
    boxes = _all_boxes(post, mesh.device)
    scene.bb_min, scene.bb_max = boxes[:, 0].min(0), boxes[:, 1].max(0)
    scene.model = scene.model.pad_to(per_proc)
    scene.num_rows = n
    return scene


def export_ply_sharded(path: str, model: GaussianModel) -> None:
    """Write the processes' slices as one standard 3DGS PLY, each process
    writing only its rows: the header is a function of the columns and
    the total count, so every process knows its byte offset; the primary
    writes the header, a barrier, then positional writes, a barrier. The
    path must be on a file system all processes share. One process: the
    plain export (io/scene.write_ply)."""
    from gaussian_splat_ipu_tpu_torch.io import ply as ply_io
    from gaussian_splat_ipu_tpu_torch.io import scene as scene_lib

    if process_count() == 1:
        scene_lib.write_ply(path, model)
        return
    rows = model.num_gaussians
    counts = torch.tensor([rows], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        counts = counts.to(model.device)
    parts = [torch.empty_like(counts) for _ in range(process_count())]
    dist.all_gather(parts, counts)
    sizes = [int(p) for p in parts]
    lo = sum(sizes[:process_index()])
    local = GaussianModel(*(getattr(model, k).detach() for k in FIELDS))
    rec = ply_io.pack_records(scene_lib.gaussian_columns(local))
    header = ply_io.ply_header(list(rec.dtype.names), sum(sizes))
    if is_primary():
        with open(path, "wb") as f:
            f.write(header)
    dist.barrier()
    with open(path, "r+b") as f:
        f.seek(len(header) + lo * rec.itemsize)
        f.write(rec.tobytes())
    dist.barrier()
