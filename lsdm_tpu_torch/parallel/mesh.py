"""A (data, model) mesh of processes on ``torch.distributed``.

Counterpart of ``lsdm_tpu/parallel/mesh.py``.  JAX lays its devices out as
``Mesh(("data", "model"))`` and lets XLA's SPMD partitioner keep every
array's global meaning; here each rank is one process with one device, and
the same global meaning is kept by hand:

  * rank ``r`` sits at ``(r // model, r % model)``; a process group spans
    each data-axis line (the ranks of one model index, which hold different
    scenes) and each model-axis line (the ranks of one data index, which
    hold the same scenes), besides the mesh's ranks as a whole;
  * parameters are replicated (:func:`replicated` broadcasts them from the
    mesh's first rank);
  * a batch is split on axis 0 over the data axis (:func:`batch_sharding`,
    :func:`shard_batch`): the ranks of one data index hold one slice;
  * the flattened (B * max_objs) cloud axis of the object backbone is split
    over both axes: a rank takes its model index's part of its data slice's
    clouds, and :func:`cloud_shard_map` runs a per-cloud function there and
    gathers the results over the model axis, with autograd.  JAX names
    that split ``obj_sharding`` and counts its shards with
    ``shard_count``; here it is always the whole mesh, so the
    :class:`Mesh` stands for it and ``mesh.size`` counts them.

Collectives with autograd (:func:`all_reduce_sum`, :func:`gather_clouds`)
are written here as the adjoints of their forwards: the backward of a sum
over ranks is the same sum of the gradients, and that of a gather is each
rank's part of the gradients summed over the ranks.  So the per-rank
backward of ``sum over ranks of loss_r`` is that sum's exact gradient, and
each parameter's gradient is the sum of its ranks' gradients
(``train/trainer.py``).

``initialize_distributed`` reads torchrun's environment; :func:`spawn` starts
the ranks of one machine itself, as ``run/train_sdm.py --mesh`` does.
JAX's ``stacked_batch_sharding`` belongs to ``--steps_per_dispatch``, which
the port does not have (ROADMAP.md, "Not ported").
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the process group over which train-mode BatchNorms take their statistics
# (models/pointnet2.py:bn_train); None: the tensor they are given
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "lsdm_batch_stats_group", default=None)

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer fails


def initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group torchrun describes (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment); a no-op for a
    single process or when the group exists.  Returns whether a group of
    more than one process is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks; this process's place in it and the
    groups of its lines."""

    shape: Tuple[int, int]
    ranks: Tuple[int, ...]  # the global ranks, row-major over (data, model)
    rank: int  # this process's global rank
    group: Any  # every rank of the mesh
    data_group: Any  # this rank's data-axis line: one model index
    model_group: Any  # this rank's model-axis line: one data index

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def data_index(self) -> int:
        return self.index // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.index % self.shape[1]

    @property
    def is_first(self) -> bool:
        return self.index == 0


def make_mesh(shape: Optional[Sequence[int]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ranks ``ranks`` (default: the whole world) as a (data, model)
    grid of ``shape`` (default: all on the data axis).  Every process of
    the world calls it, members or not, since creating a process group is
    collective; a non-member gets a :class:`Mesh` with ``member`` false."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = tuple(range(world) if ranks is None else ranks)
    if shape is None:
        shape = (len(ranks), 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != len(ranks):
        raise ValueError(f"mesh shape {shape} != {len(ranks)} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if not dist.is_initialized():
        return Mesh(shape, ranks, rank, None, None, None)
    D, M = shape
    group = dist.new_group(list(ranks)) if len(ranks) < world else dist.group.WORLD
    data_group = model_group = None
    for m in range(M):  # every process creates every group, in one order
        g = dist.new_group([ranks[d * M + m] for d in range(D)])
        if rank in ranks and ranks.index(rank) % M == m:
            data_group = g
    for d in range(D):
        g = dist.new_group([ranks[d * M + m] for m in range(M)])
        if rank in ranks and ranks.index(rank) // M == d:
            model_group = g
    return Mesh(shape, ranks, rank, group, data_group, model_group)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank, so that every rank starts from the same bits."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, mesh.ranks[0], group=mesh.group)
    return module


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's slice of axis 0 of a global batch of ``batch`` items:
    the data axis splits it, the model axis does not."""
    D = mesh.shape[0]
    if batch % D:
        raise ValueError(f"batch {batch} does not split over {D} data ranks")
    n = batch // D
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def shard_batch(mesh: Mesh, tree):
    """This rank's slice (:func:`batch_sharding`) of every array of a tuple,
    list or dict of arrays (torch tensors or numpy arrays)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, a) for a in tree)
    return tree[batch_sharding(mesh, tree.shape[0])]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable: its
    gradient is the sum of the ranks' gradients of the sum."""
    if _size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated on axis 0, no gradient."""
    if _size(group) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return grad[i * ctx.n:(i + 1) * ctx.n], None


def gather_clouds(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated on axis 0 in rank order,
    differentiable (each rank's part of the gradient, summed over the
    ranks)."""
    if _size(group) == 1:
        return t
    return _GatherParts.apply(t, group)


def _part(a, mesh: Mesh):
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return type(a)(_part(x, mesh) for x in a)
    n, parts = a.shape[0], mesh.shape[1]
    if n % parts:
        raise ValueError(f"{n} clouds do not split into {parts} parts")
    k = n // parts
    return a[mesh.model_index * k:(mesh.model_index + 1) * k]


def cloud_shard_map(fn: Callable[..., torch.Tensor], mesh: Mesh,
                    *arrays) -> torch.Tensor:
    """``fn`` over this rank's part of the clouds, the flattened
    (B * max_objs) cloud axis split over both mesh axes (JAX's
    ``obj_sharding``): ``arrays`` (tensors, or lists of tensors, with this
    rank's data slice of the clouds on axis 0, or None) are cut into
    ``model`` parts, ``fn`` runs on this rank's part (the kernels per
    shard, as JAX's ``cloud_shard_map`` runs them under ``shard_map``), and
    the parts of the model-axis line are gathered back, with autograd.
    ``fn`` must not mix clouds."""
    if mesh.shape[1] == 1:
        return fn(*arrays)
    out = fn(*(_part(a, mesh) for a in arrays))
    return gather_clouds(out, mesh.model_group)


@contextlib.contextmanager
def batch_stats_over(group):
    """Train-mode BatchNorms in the block take their statistics over the
    ranks of ``group`` (``models/pointnet2.py:bn_train``), as flax's do
    over every shard of a sharded axis."""
    token = _STATS_GROUP.set(group if _size(group) > 1 else None)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def batch_stats_group():
    """The group set by :func:`batch_stats_over`, or None."""
    return _STATS_GROUP.get()


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """What a forward on this rank's slice of a global batch needs in order
    to compute the global batch's function (``models/sdm.py``).  The SDM
    mixes scenes across the batch axis in two places (its head-major mask
    tiling and its ``(N, -1, B, O)`` scramble), and its train-mode
    BatchNorms take the whole batch's statistics.  ``split_clouds``: the
    object clouds are split over the model axis as well (JAX's
    cloud split, the train step); without it each rank runs all of
    its data slice's clouds (sampling)."""

    mesh: Mesh
    split_clouds: bool = True

    def global_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """The global (B, O) object mask, float, from this rank's rows."""
        return all_gather(mask.float(), self.mesh.data_group)

    def offset(self, local_batch: int) -> int:
        """The global index of this rank's first scene."""
        return self.mesh.data_index * local_batch


# --- processes -------------------------------------------------------------

def backend_for(device_type: str, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo (ranks on the
    CPU, or ranks that share cards: gloo's CUDA all-reduce, broadcast and
    all-gather stage through the host)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int, world: int) -> torch.device:
    """The device of ``rank``: card ``rank % device_count`` on ``cuda``
    (made current); on the CPU the ranks share the cores."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("rank_device: no CUDA device")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return torch.device(device_type)


def _rank_entry(rank: int, world: int, init_method: str, backend: str,
                out_dir: Optional[str], fn: Callable, args: tuple) -> None:
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    try:
        result = fn(rank, *args)
        if out_dir is not None:
            torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


class RankRun:
    """Ranks started by :func:`start_ranks`; :meth:`wait` joins them."""

    def __init__(self, ctx, tmp: tempfile.TemporaryDirectory, world: int,
                 results: bool, timeout: float):
        self.ctx, self.tmp, self.world = ctx, tmp, world
        self.results, self.end = results, time.monotonic() + timeout

    def kill(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self.ctx.processes:
            p.join(10)
        self.tmp.cleanup()

    def wait(self) -> Optional[List[Any]]:
        """Each rank's return value (None without ``results``).  A rank that
        fails, or ranks that outlast the timeout, end every rank and
        raise."""
        try:
            # join returns when a rank ends (False while others run) and
            # raises when one failed
            while not self.ctx.join(timeout=max(self.end - time.monotonic(), 0.01)):
                if time.monotonic() > self.end:
                    raise TimeoutError(f"{self.world} ranks still running at "
                                       "their timeout")
            if not self.results:
                return None
            return [torch.load(os.path.join(self.tmp.name, f"rank{r}.pt"),
                               weights_only=False) for r in range(self.world)]
        finally:
            self.kill()


def start_ranks(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
                timeout: float = 600.0, results: bool = True) -> RankRun:
    """Start ``fn(rank, *args)`` in ``world`` new processes (the ``spawn``
    start method) joined in one process group of ``backend`` over a file
    rendezvous in a temporary directory; each rank's return value is saved
    with ``torch.save`` for :meth:`RankRun.wait` (tensors come back on
    their device) when ``results``.  The caller may work while they run."""
    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory(prefix="lsdm_ranks_")
    init = "file://" + os.path.join(tmp.name, "rendezvous")
    out_dir = tmp.name if results else None
    try:
        ctx = mp.start_processes(
            _rank_entry, args=(world, init, backend, out_dir, fn, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
    except BaseException:
        tmp.cleanup()
        raise
    return RankRun(ctx, tmp, world, results, timeout)


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 600.0, results: bool = True) -> Optional[List[Any]]:
    """:func:`start_ranks`, then wait for them."""
    return start_ranks(fn, world, args, backend, timeout, results).wait()

def sharded_config(cfg):
    """``cfg`` as a model under an object sharding runs it: ``ball_impl``
    ``"fused"`` and ``"sg"`` become ``"auto"`` (the selection kernels per
    shard), as JAX's ``models/sdm.py:141-143`` resolves them there."""
    if cfg.ball_impl in ("fused", "sg"):
        return dataclasses.replace(cfg, ball_impl="auto")
    return cfg
