"""Device mesh and data parallelism over torch.distributed.

Counterpart of `swarm_ode_tpu/parallel/mesh.py`. JAX's mesh is one process
driving every device, with the collectives placed by XLA under jit. Here
each device is driven by a process of its own (a rank; NCCL between cards,
gloo between CPU processes), which keeps every card's launches on a host
thread of their own, and the collectives are written out: `replicate`
broadcasts from rank 0, `shard_batch` keeps this rank's rows, and
`all_reduce_sum` / `all_gather` combine what the ranks computed. JAX's
`replicated(mesh)` and `batch_sharded(mesh)` return placement objects
(`NamedSharding`) that have no torch counterpart: their behaviour lives in
`replicate` and `shard_batch`.

A mesh of one rank needs no process group: every collective is then the
identity and nothing is communicated, so code written for the mesh runs on
one device exactly as it does without it.

    torchrun --nproc_per_node=N -m swarm_ode_tpu_torch.train.train_gde ...

starts N ranks that `make_mesh` joins from torchrun's environment; tests
and the multi-device dry run start gloo ranks on the CPU with `launch`.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from swarm_ode_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of ranks: the axes' names and sizes
    (`shape`, as jax's `Mesh.shape`), this rank's coordinate on each axis,
    its device, and one process group per axis over the ranks along that
    axis (None where the axis holds this rank alone)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Optional[object]]
    rank: int = 0

    @property
    def size(self) -> int:
        """The number of ranks (devices) in the mesh."""
        return math.prod(self.shape.values())


def make_mesh(axes: Sequence[str] = ("dp",), shape: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
    """A mesh over every rank of the default process group (by default 1-D
    data parallel: all ranks on the first axis). With no group it is a
    mesh of one rank on `device`; under torchrun (RANK, WORLD_SIZE and
    LOCAL_RANK set) with no group up, it first initialises one (NCCL for
    the card, gloo for the CPU). A rank asked for "cuda" takes the card
    cuda:LOCAL_RANK. Every rank of the group must call this, with the same
    axes and shape: each axis's groups are created collectively."""
    axes = tuple(axes)
    dev = torch.device(device)
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not hold the "
                         f"{world} rank(s) of the process group")
    if dev.type == "cuda" and world > 1:
        torch.cuda.set_device(dev)
    ranks = np.arange(world).reshape(shape)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    groups = {}
    for i, axis in enumerate(axes):
        groups[axis] = None
        if shape[i] == 1:
            continue
        if shape[i] == world:
            groups[axis] = dist.group.WORLD
            continue
        # The ranks that differ only in this axis's coordinate, one group
        # each; every rank creates all of them, in one order.
        for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
            g = dist.new_group(line.tolist())
            if rank in line:
                groups[axis] = g
    return Mesh(axes, dict(zip(axes, shape)), coords, dev, groups, rank)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as a collective can carry it (gloo has no bool)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def replicate(mesh: Mesh, tree):
    """Every rank's tensors of `tree` set to rank 0's (a broadcast, in
    place); returns the tree. The identity on a mesh of one rank."""
    if mesh.size == 1:
        return tree
    for t in tree_leaves(tree):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(_wire(buf), src=0)
        if buf is not t:
            t.copy_(buf)
    return tree


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """This rank's contiguous share of the leading axis of every tensor of
    `tree`: rank r of n along `axis` keeps rows [r B/n, (r+1) B/n), the rows
    that JAX's device r holds under PartitionSpec(axis). Raises ValueError
    if B does not divide over the axis."""
    n, r = mesh.shape[axis], mesh.coords[axis]
    if n == 1:
        return tree

    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not divide over "
                             f"{axis}={n}")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return tree_map(one, tree)


def pad_to_multiple(tree, multiple: int):
    """Zero rows appended to the leading axis of every tensor of `tree` up to
    a multiple of `multiple` (so that the batch divides over the ranks);
    returns (padded tree, valid mask (B',) bool)."""
    first = tree_leaves(tree)[0]
    B = first.shape[0]
    pad = (-B) % multiple
    mask = torch.ones(B + pad, dtype=torch.bool, device=first.device)
    if pad == 0:
        return tree, mask
    mask[B:] = False
    padded = tree_map(lambda x: torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]), tree)
    return padded, mask


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor],
                   axis: str = "dp") -> List[torch.Tensor]:
    """The sum over the ranks along `axis` of each tensor (one dtype), as
    new tensors; one collective carries them all. On an axis of one rank,
    the tensors themselves."""
    group = mesh.groups[axis]
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather(mesh: Mesh, tree, axis: str = "dp", dim: int = 0):
    """Every tensor of `tree` concatenated along `dim` over the ranks along
    `axis`, in their order: shard_batch's inverse. On an axis of one rank,
    the tree itself."""
    group, n = mesh.groups[axis], mesh.shape[axis]
    if group is None:
        return tree

    def one(x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather([_wire(p) for p in parts], _wire(x), group=group)
        return torch.cat(parts, dim=dim)

    return tree_map(one, tree)


class _GatherShards(torch.autograd.Function):
    """all_gather whose backward hands each rank its own slice of the
    gradient: right where the ranks along the axis run the same computation
    on the gathered tensor (so each holds the whole gradient already)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        n, r = ctx.mesh.shape[ctx.axis], ctx.mesh.coords[ctx.axis]
        return grad.chunk(n, ctx.dim)[r], None, None, None


def gather_shards(mesh: Mesh, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """`all_gather` of this rank's shard of a tensor, differentiable, for a
    computation that every rank along `axis` runs alike (tensor-parallel
    storage of replicated work, JAX's PartitionSpec(axis) on a parameter):
    the gradient of the shard is its slice of the whole one, with no sum
    over the ranks. (torch.distributed.nn.functional.all_gather sums them,
    and its gloo backward fails on a group that is not the world's.)"""
    if mesh.groups[axis] is None:
        return x
    return _GatherShards.apply(x, mesh, axis, dim)


# A launched run's limit, and a collective's within it.
LAUNCH_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 600.0, 300.0


def _rank_main(rank: int, n_ranks: int, backend: str, tmp: str, threads: int) -> None:
    torch.set_num_threads(threads)
    fn, args = torch.load(os.path.join(tmp, "job.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank,
                            world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, backend: str = "gloo", args=()) -> list:
    """Run fn(*args) on `n_ranks` new processes, one rank each of a process
    group joined through a file store in a temporary directory (no TCP
    port), and return the ranks' results in rank order. fn must be
    importable by name (a module-level function, or a functools.partial of
    one); each rank imports fn's module, and its result travels back
    through torch.save. A rank that fails, or a run longer than
    LAUNCH_TIMEOUT_S, stops every rank and raises RuntimeError with the
    failed ranks' tracebacks."""
    ctx = multiprocessing.get_context("spawn")
    threads = max(1, (os.cpu_count() or 1) // n_ranks)
    with tempfile.TemporaryDirectory(prefix="swarm_mesh_") as tmp:
        # The job goes through a file: a start() that pipes a large one to
        # its process waits for that process to read it, one rank at a time.
        torch.save((fn, args), os.path.join(tmp, "job.pt"))
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, backend, tmp, threads))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or any(p.is_alive() for p in procs):
                why = (f"ranks {failed} failed" if failed
                       else f"timed out after {LAUNCH_TIMEOUT_S} s")
                errors = [os.path.join(tmp, f"error_{r}.txt") for r in range(n_ranks)]
                detail = "".join(f"rank {r}: " + open(e).read()
                                 for r, e in enumerate(errors) if os.path.exists(e))
                name = getattr(getattr(fn, "func", fn), "__name__", "fn")
                raise RuntimeError(f"launch({name}, {n_ranks}): {why}\n{detail}")
            return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                    for r in range(n_ranks)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
