"""Process meshes and the launcher of the port's sharded engines
(counterpart of ``quantum_computations_tpu/parallel/mesh.py``).

JAX's devices live in one process and a ``jax.sharding.Mesh`` names them.
Here each device belongs to a process: one rank of a ``torch.distributed``
world. A :class:`Mesh` names the ranks, shaped as the JAX mesh shapes its
devices (``mesh.devices.shape`` is ``(2,)*k`` or ``(D,)``), and carries the
process group on which the engines issue their collectives explicitly,
through the mesh's methods. A mesh built with no initialised process group
is a world of one: rank 0, one rank, and no collective is ever called.

:func:`launch`, which JAX does not need, starts a world of processes and
runs a function on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["Mesh", "data_mesh", "launch", "qubit_mesh"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_TIMEOUT = datetime.timedelta(minutes=30)  # of each collective of a launched world


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks of a ``torch.distributed`` world shaped as a JAX mesh.

    devices: the ranks (global rank ids), shaped ``(2,)*k`` or ``(D,)``;
    axis_names: one name per axis; device: this rank's ``torch.device``;
    group: the process group (None: a world of one, no collectives);
    rank: this process's index in ``devices.reshape(-1)``.

    The collective methods take and return tensors on ``device`` and are
    called by every rank of the mesh in the same order.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]
    device: torch.device
    group: object = None
    rank: int = 0

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _global(self, r: int) -> int:
        return int(self.devices.reshape(-1)[r])

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise sum (or ``op="max"``) of ``t`` over the ranks."""
        if self.group is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along dim 0, in
        rank order, on every rank."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (same shape and dtype)."""
        if self.group is None:
            return t
        out = t.contiguous().clone()
        dist.broadcast(out, src=self._global(src), group=self.group)
        return out

    def exchange(self, send: torch.Tensor, partner: int) -> torch.Tensor:
        """Send ``send`` to rank ``partner`` and return what it sent here.

        One ``all_to_all_single`` over the whole mesh with zero split sizes
        for every rank but the partner, so every pair of a pairing (the
        tiled pair ``all_to_all`` of the JAX engine) exchanges at once."""
        send = send.contiguous().reshape(-1)
        recv = torch.empty_like(send)
        splits = [0] * self.size
        splits[partner] = send.numel()
        dist.all_to_all_single(recv, send, splits, splits, group=self.group)
        return recv

    def max_int(self, value: int) -> int:
        """The largest of the ranks' host integers ``value``."""
        if self.group is None:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, "max").item())

    def gather_rows(self, t: torch.Tensor, counts: list[int]) -> torch.Tensor:
        """The ranks' row blocks (rank r holds ``counts[r]`` rows along dim
        0) concatenated in rank order, on every rank: each block is padded
        to the largest count for the gather."""
        if self.group is None:
            return t
        most = max(counts)
        if t.shape[0] < most:
            t = torch.cat([t, t.new_zeros((most - t.shape[0],) + t.shape[1:])])
        parts = self.all_gather(t).split(most)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: ``cuda:(rank % cards)`` unless ``device`` names
    the CPU or a card. Raises when a card is asked for and none exists."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _build(ranks: np.ndarray, axis_names: tuple[str, ...], device):
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    members = [int(r) for r in ranks.reshape(-1)]
    if len(set(members)) != len(members) or not all(0 <= r < world for r in members):
        raise ValueError(f"ranks {members} are not distinct ranks of a world of {world}")
    if not dist.is_initialized():
        return Mesh(ranks, axis_names, _rank_device(device, 0))
    if members == list(range(world)):
        group = dist.group.WORLD
    else:
        group = dist.new_group(members)  # every rank of the world calls it
        if me not in members:
            return None
    return Mesh(ranks, axis_names, _rank_device(device, me), group,
                members.index(me))


def _world_ranks(ranks) -> list[int]:
    if ranks is not None:
        return [int(r) for r in ranks]
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def qubit_mesh(n_axes: int | None = None, ranks=None, *, device=None) -> Mesh:
    """Mesh of shape (2,)*k with axis names 'q0'..'q{k-1}': one binary mesh
    axis per sharded qubit of the DV state vector.

    Uses every rank of the world by default (the count must cover 2^k);
    ``ranks`` picks others, and then every rank of the world must call it
    (a rank outside them gets None). ``device``: ``"cpu"``, or the default
    ``cuda`` (``cuda:(rank % cards)``)."""
    ranks = _world_ranks(ranks)
    if n_axes is None:
        n_axes = int(np.log2(len(ranks)))
    n = 2 ** n_axes
    if n > len(ranks):
        raise ValueError(f"Need {n} ranks for {n_axes} sharded qubit axes, "
                         f"have {len(ranks)}.")
    return _build(np.array(ranks[:n]).reshape((2,) * n_axes),
                  tuple(f"q{i}" for i in range(n_axes)), device)


def data_mesh(ranks=None, name: str = "data", *, device=None) -> Mesh:
    """1-D mesh over every rank of the world (or ``ranks``) for batched
    trajectory sweeps."""
    return _build(np.array(_world_ranks(ranks)), (name,), device)


def _rank_main(rank: int, world: int, backend: str, device: str,
               store_path: str, result_path: str, fn, args):
    """One rank of :func:`launch`: join the world, run ``fn(mesh, *args)``
    and, on rank 0, write its result for the parent."""
    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=_TIMEOUT)
    result = fn(data_mesh(device=device), *args)
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def launch(fn, world_size: int, *args, device=None):
    """Run ``fn(mesh, *args)`` on every rank of a new world of
    ``world_size`` processes and return rank 0's result.

    ``mesh`` is :func:`data_mesh` over the world. The ranks are spawned
    with ``torch.multiprocessing`` and meet through a ``FileStore`` in a
    temporary directory (no TCP port). ``device``: ``"cpu"``, or the
    default ``cuda`` (rank r on ``cuda:(r % cards)``; raises without a
    card). The backend is NCCL when every rank has a card of its own, else
    gloo (NCCL refuses two ranks on one card). ``fn`` and ``args`` are
    pickled, so ``fn`` must be importable by name; the result is pickled
    back. If any rank raises or dies, the others are stopped and this
    raises with the failing rank's traceback."""
    dev = resolve_device(device)
    own_card = dev.type == "cuda" and world_size <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    with tempfile.TemporaryDirectory(prefix="qct_launch_") as tmp:
        result_path = os.path.join(tmp, "result.pkl")
        torch.multiprocessing.start_processes(
            _rank_main, args=(world_size, backend, dev.type,
                              os.path.join(tmp, "store"), result_path, fn, args),
            nprocs=world_size, join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)  # written by rank 0 of this world
