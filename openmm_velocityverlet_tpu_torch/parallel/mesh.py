"""Multi-device execution over ``torch.distributed`` (counterpart of
``openmm_velocityverlet_tpu/parallel/mesh.py``).

The JAX package shards the atom axis of the step carry over a
``jax.sharding.Mesh`` and lets the XLA partitioner insert the collectives;
eager PyTorch has no partitioner, so here every rank (one process, one
device) holds the whole ``State`` and runs the O(N) integration on every
atom, and only the work that scales with pairs is split: each rank runs
kernel B2 over its ``n_tiles / size`` row tiles and one ``all_reduce`` a
force evaluation sums the rows, the column reaction and the pair energies
(``ops/pair_tri.banded_sweep_sharded``).  The counterparts: ``Mesh`` is
the process group with its rank, size, device and backend on the axis
``"atoms"``; ``make_mesh`` joins (or starts) the default group;
``carry_shardings`` gives the JAX layout rule, per-atom leaves on
``"atoms"`` and the rest replicated; ``shard_carry`` places a State on the
rank's device and broadcasts it from rank 0, which is what placing a carry
on the mesh means when the layout is replicated; ``sharded_step`` is the
step callable ``Context`` runs on a mesh.  Only ``all_reduce`` and
``broadcast`` are used: NCCL and gloo both carry them for CUDA tensors, so
two ranks can share one card under gloo.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..system import State, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group the step is split over."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "atoms"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self):
        """Wait for every rank (an all_reduce of one element)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(size=None, device=None, backend=None, init_method=None,
              rank=None) -> Mesh:
    """The mesh of this process.  Joins the default process group when one
    is initialized; otherwise starts it from ``init_method`` (e.g. a
    ``file://`` store) or from the torchrun environment (``RANK``,
    ``WORLD_SIZE`` and ``env://``), with ``rank`` and ``size`` defaulting
    to that environment.  ``device`` defaults to ``cuda:$LOCAL_RANK``
    (``device="cpu"`` for a host run); ``backend`` to "nccl" for a CUDA
    device and "gloo" for the CPU.  A named backend is never replaced:
    if it cannot start, or the running group has another, this raises."""
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', rank))}"
    device = resolve_device(device)
    if backend is None and not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if size is None:
            size = int(env.get("WORLD_SIZE", 1))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=int(size))
    running = dist.get_backend()
    if backend is not None and running != backend:
        raise ValueError(f"make_mesh: backend {backend!r} asked for, but the "
                         f"process group runs {running!r}")
    world = dist.get_world_size()
    if size is not None and int(size) != world:
        raise ValueError(f"make_mesh: size {size} asked for, but the process "
                         f"group has {world} ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=world,
                device=device, backend=running)


def carry_shardings(state, mesh: Mesh, n_atoms=None):
    """The JAX layout rule on a State: a State-shaped tree holding
    ``mesh.axis_name`` for each per-atom tensor (leading dimension above
    the mesh size and equal to ``n_atoms``, or when ``n_atoms`` is None a
    multiple of the mesh size) and None for everything replicated (the NH
    chains, box, generator and scalars).  The port replicates every leaf;
    the rule names which ones the row split of the pair sweep covers."""
    def spec(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return None
        lead = x.shape[0]
        if lead > mesh.size and (lead == n_atoms if n_atoms is not None
                                 else lead % mesh.size == 0):
            return mesh.axis_name
        return None
    return dataclasses.replace(state, **{
        f.name: spec(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def shard_carry(state: State, mesh: Mesh) -> State:
    """``state`` on the rank's device with rank 0's values on every rank:
    its tensors and host scalars in one float64 broadcast (exact for the
    float32 tensors and for step counts below 2^53), its generator's state
    in a second."""
    dev = mesh.device
    names = [f.name for f in dataclasses.fields(State)
             if f.name != "generator"]
    vals = [getattr(state, k) for k in names]
    flat = mesh.broadcast(torch.cat([
        torch.as_tensor(v, dtype=torch.float64, device=dev).reshape(-1)
        for v in vals]))
    out, at = {}, 0
    for k, v in zip(names, vals):
        if isinstance(v, torch.Tensor):
            out[k] = flat[at:at + v.numel()].reshape(v.shape).to(v.dtype)
            at += v.numel()
        else:
            out[k] = type(v)(flat[at].item())
            at += 1
    if state.generator.device.type != dev.type:
        raise ValueError("shard_carry: the state's generator is on "
                         f"{state.generator.device}, the mesh on {dev}")
    gen = torch.Generator(device=dev)
    gen.set_state(mesh.broadcast(state.generator.get_state().to(dev)).cpu())
    return State(generator=gen, **out)


def sharded_step(step_fn, mesh: Mesh):
    """The step callable of ``Context`` on a mesh: runs ``step_fn(cache)``,
    whose pair sweep is split over the ranks, and returns its coverage
    flag as a host bool.  The flag rides in the sweep's all_reduce, so it
    is the same on every rank and the ranks' segment loops (rebuild or
    not) stay in step without a collective of their own."""
    def step(cache) -> bool:
        return bool(step_fn(cache))
    return step


def writes_files() -> bool:
    """False on a rank other than 0 of an initialized default process
    group: there the reporters write to the null device and checkpoints
    are left to rank 0."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def launched_mesh(n: int, device=None) -> Mesh:
    """The mesh of a driver's ``--mesh N``: the N ranks that
    ``torchrun --nproc-per-node N`` started (a world of one needs no
    launcher).  Raises ValueError when the launch has another number of
    ranks."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != int(n):
        raise ValueError(
            f"--mesh {n} needs {n} ranks, this launch has {world}: run it "
            f"as torchrun --nproc-per-node {n} -m <driver> --mesh {n} ...")
    return make_mesh(size=int(n), device=device)
