"""Data parallelism over ranks (port of decompdiff_tpu/parallel/mesh.py).

The JAX package shards the complex batch over a one-axis 'dp' device mesh
and replicates the parameters; XLA derives the gradient all-reduce from
the shardings. Here each rank is a process (`torchrun --standalone
--nproc_per_node W`, one per GPU) and the collectives are written out:

  * batch_sharding (leading axis over 'dp') is `shard_batch`: every
    [B, ...] field of a ComplexBatch or FullProtein sliced to this rank's
    contiguous rows [r*B/W, (r+1)*B/W). The padding (Np, Nl, A) is the
    collated global batch's, so each rank's kernels see the unsharded
    shapes with B/W rows.
  * replicated_sharding (P()) is a tensor kept whole on every rank: the
    parameters and Adam moments (`broadcast_` from rank 0 at the start),
    the Lt buffers (updated from all-gathered rows) and the generator
    (every rank draws the same global numbers, `draw_rows`).
  * The psum over 'dp' is `all_reduce_mean` (one flat bucket, summed,
    divided by W); the gathers of the sharded outputs are
    `all_gather_rows` (rank order, so the rows are the global batch's).

Data parallelism only, for the JAX module's reasons: the denoiser has ~5M
parameters and a complex is a few hundred kNN-sparse atoms, so splitting
a model or a complex across devices would put every gather on the
interconnect for nothing; sampling is parallel across molecules.

Backend rule: NCCL when every rank has a GPU of its own; gloo on the CPU,
and gloo when ranks share a GPU (NCCL refuses two ranks on one device).
Under gloo the collectives run on host copies. A process started without
torchrun's environment is a world of one and starts no process group.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from decompdiff_tpu_torch.device import DeviceLike, resolve_device

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the data-parallel world. `group` is the
    default process group, None in a world of one started without
    torchrun. `comm` accumulates, per collective, its calls, seconds and
    bytes (comm_seconds, comm_since); on a GPU the seconds are read from
    CUDA events around each collective, kept in `pending` until then, so
    that timing never stalls the host."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]
    group: Any = None
    reason: str = 'one process'
    comm: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    pending: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def rows(self, global_rows: int) -> slice:
        """This rank's contiguous block of a leading axis of global_rows."""
        if global_rows % self.world_size:
            raise ValueError(f'{global_rows} rows do not divide over '
                             f'{self.world_size} ranks')
        n = global_rows // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def describe(self) -> str:
        return (f'rank {self.rank} of {self.world_size} on {self.device}, '
                f'backend {self.backend} ({self.reason})')


def choose_backend(device: torch.device, local_world_size: int,
                   gpu_count: int) -> tuple:
    """(backend, reason): the rule in the module docstring."""
    if device.type != 'cuda':
        return 'gloo', 'CPU ranks'
    if local_world_size > gpu_count:
        return 'gloo', (f'{local_world_size} ranks share {gpu_count} '
                        'GPU(s); NCCL refuses two ranks on one device')
    return 'nccl', 'a GPU per rank'


def make_mesh(*, device: DeviceLike = None,
              init_method: Optional[str] = None) -> Mesh:
    """The data-parallel world of this process, from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; MASTER_ADDR and
    MASTER_PORT unless `init_method` names another rendezvous, such as a
    file:// store). `device` is the entry points' --device: CUDA unless
    given (each rank takes GPU LOCAL_RANK mod the GPUs visible, set as the
    current device before anything is allocated), or 'cpu'. Without
    torchrun's environment: a world of one, no process group. The world
    size is the launcher's (JAX's make_mesh(n_devices) has no counterpart:
    the ranks are processes that already exist)."""
    env = os.environ
    if 'RANK' not in env or 'WORLD_SIZE' not in env:
        return Mesh(0, 1, 0, resolve_device(device), None)
    rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
    local_rank = int(env.get('LOCAL_RANK', rank))
    local_world = int(env.get('LOCAL_WORLD_SIZE', world))
    dev = resolve_device(device)
    gpus = torch.cuda.device_count() if dev.type == 'cuda' else 0
    if dev.type == 'cuda':
        dev = torch.device('cuda', local_rank % gpus)
        torch.cuda.set_device(dev)
    backend, reason = choose_backend(dev, local_world, gpus)
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            rank=rank, world_size=world)
    return Mesh(rank, world, local_rank, dev, backend, dist.group.WORLD,
                reason)


def destroy_mesh(mesh: Mesh) -> None:
    """Ends the process group a mesh started (entry points call it in a
    `finally`, so that a failing rank leaves the group and the others'
    collectives fail rather than wait)."""
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of every tensor field of a ComplexBatch or
    FullProtein (all of them [B, ...]); the batch itself in a world of
    one."""
    if mesh is None or mesh.world_size == 1:
        return batch
    first = getattr(batch, dataclasses.fields(batch)[0].name)
    rows = mesh.rows(first.shape[0])
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rows]
        for f in dataclasses.fields(batch)
        if getattr(batch, f.name) is not None})


def take_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global tensor (e.g. injected draws)."""
    if mesh is None or mesh.world_size == 1:
        return x
    return x[mesh.rows(x.shape[0])]


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              mesh: Optional[Mesh]) -> torch.Tensor:
    """`draw(shape)` as a world of one draws it for the whole batch: at the
    global leading size (shape[0] rows a rank, so every rank advances its
    generator alike), then this rank's rows."""
    shape = tuple(shape)
    if mesh is None or mesh.world_size == 1:
        return draw(shape)
    n = shape[0]
    full = draw((n * mesh.world_size,) + shape[1:])
    return full[mesh.rank * n:(mesh.rank + 1) * n]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    return mesh.device if mesh.backend == 'nccl' else torch.device('cpu')


class _timed:
    """Adds a collective's calls, bytes and time to mesh.comm[kind]. On a
    GPU the time is that between two CUDA events on the current stream
    around the collective (so the kernels queued before it do not count),
    read when the comm records are (_settle); on the CPU, wall time."""

    def __init__(self, mesh: Mesh, kind: str, nbytes: int):
        self.mesh, self.kind, self.nbytes = mesh, kind, nbytes
        self.cuda = mesh.device.type == 'cuda'

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        rec = _record(self.mesh, self.kind)
        rec['calls'] += 1
        rec['bytes'] += self.nbytes
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.mesh.pending.append((self.kind, self.start, end))
        else:
            rec['seconds'] += time.perf_counter() - self.t0


def _record(mesh: Mesh, kind: str) -> Dict[str, float]:
    return mesh.comm.setdefault(kind, {'calls': 0, 'seconds': 0.0,
                                       'bytes': 0})


def _settle(mesh: Mesh) -> None:
    """Adds the pending collectives' event times to mesh.comm (waiting for
    the last of them, which a step's closing synchronize has passed)."""
    for kind, start, end in mesh.pending:
        end.synchronize()
        _record(mesh, kind)['seconds'] += start.elapsed_time(end) / 1e3
    mesh.pending.clear()


def comm_seconds(mesh: Mesh) -> float:
    """The seconds of every collective so far."""
    _settle(mesh)
    return sum(rec['seconds'] for rec in mesh.comm.values())


def comm_since(mesh: Mesh, before: Dict[str, Dict[str, float]]) -> dict:
    """mesh.comm less `before`, an earlier comm_since(mesh, {}) (which is
    a copy of mesh.comm): the collectives of one run."""
    _settle(mesh)
    return {kind: {k: v - before.get(kind, {}).get(k, 0)
                   for k, v in rec.items()}
            for kind, rec in mesh.comm.items()
            if rec['calls'] != before.get(kind, {}).get('calls', 0)}


def all_reduce_mean(tensors: Dict[str, torch.Tensor],
                    mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The mean over ranks of each tensor (same keys, shapes and dtypes):
    one flat float32 bucket, summed by the backend, divided by W. In a
    world of one without a process group, the tensors themselves."""
    if mesh is None or not mesh.distributed:
        return dict(tensors)
    names = list(tensors)
    flat = torch.cat([tensors[n].detach().reshape(-1).float()
                      for n in names])
    with _timed(mesh, 'all_reduce', flat.numel() * 4):
        bucket = flat.to(_comm_device(mesh))
        dist.all_reduce(bucket)
        flat = bucket.to(mesh.device)
    flat = flat / mesh.world_size
    out, i = {}, 0
    for n in names:
        t = tensors[n]
        out[n] = flat[i:i + t.numel()].view(t.shape).to(t.dtype)
        i += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order: the global
    rows of a sharded result. In a world of one, x."""
    if mesh is None or not mesh.distributed:
        return x
    part = x.detach().contiguous().to(_comm_device(mesh))
    parts = [torch.empty_like(part) for _ in range(mesh.world_size)]
    with _timed(mesh, 'all_gather', part.numel() * part.element_size()):
        dist.all_gather(parts, part)
    return torch.cat(parts, dim).to(x.device)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Overwrites every tensor with rank `src`'s, in place (one bucket per
    dtype): the replicated state after creating or resuming it."""
    if not mesh.distributed:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = torch.cat([t.reshape(-1).to(_comm_device(mesh))
                          for t in group])
        with _timed(mesh, 'broadcast', flat.numel() * flat.element_size()):
            dist.broadcast(flat, src)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Rank `src`'s picklable obj, on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's picklable obj, in rank order, on every rank."""
    if not mesh.distributed:
        return [obj]
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh: Mesh) -> None:
    if not mesh.distributed:
        return
    if mesh.backend == 'nccl':
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
