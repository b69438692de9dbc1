"""A device mesh, and the two collectives the multi-device code uses (the
port's counterpart of `jax.sharding.Mesh` with `jax.lax.ppermute` and
`jax.lax.psum` inside `shard_map`).

JAX's `shard_map` is single-controller SPMD: one Python process runs one
program per mesh device. The port keeps that form. A `Mesh` is an array of
`torch.device`s with named axes; a sharded function loops over the shards,
each shard's tensors on its device, and a collective is a function over
the list of the shards' tensors (one axis of the mesh, in its order):

- `ppermute(blocks, perm)`: shard dst receives shard src's block, copied to
  dst's device (`.to(device, non_blocking=True)`: a peer copy between two
  cards, nothing on one card);
- `psum(blocks)`: every shard receives the sum of all blocks, each moved to
  the receiving shard's device and added in shard order; with `scatter_dim`
  each shard keeps only its own equal slice along that dimension (a
  reduce-scatter, as the node-sharded vspace tick needs).

One process may hold every shard (the default: a card may be listed
several times, as chip_smoke.py drives it on one H100, and the same code
with distinct cards does real peer copies). Or the mesh spans the
processes of a `torch.distributed` group (common/dist.py), as
`jax.distributed` joins hosts into one global mesh: every entry of the
global devices array has an owner rank, a process's `local` shards are
the ones it owns, and `Mesh.ppermute` / `Mesh.psum` take this process's
blocks in global shard order and return its results. Blocks that cross a
process boundary go through the group (on gloo as host tensors, complex
ones as `torch.view_as_real`); the sum is still taken in global shard
order, from a gather of the pieces each receiver needs, never by the
backend's all_reduce, so a spanning result is bit for bit the one-process
mesh's at the same shard layout. Nothing falls back to the CPU: a mesh
holds exactly the devices it is given (`Mesh.cuda(n)` takes n distinct
cards or raises).
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """devices: an object array of `torch.device` of any rank (or anything
    np.array turns into one), one name per axis. owners (the same shape,
    default all 0) gives each entry's rank in `group`, a
    torch.distributed process group; with group None one process holds
    every shard."""

    def __init__(self, devices, axis_names: tuple[str, ...], owners=None,
                 group=None):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(given[idx])
        if arr.ndim != len(axis_names) or len(set(axis_names)) != arr.ndim:
            raise ValueError(f"Mesh: {arr.ndim}-d devices need as many distinct "
                             f"axis names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("Mesh: no devices")
        if (owners is None) != (group is None):
            raise ValueError("Mesh: owners and group go together")
        own = np.zeros(arr.shape, np.int64) if owners is None else \
            np.asarray(owners, dtype=np.int64).reshape(arr.shape)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.owners = own
        self.group = group
        self.rank = 0 if group is None else torch.distributed.get_rank(group)

    @classmethod
    def cuda(cls, n: int, axis_names: tuple[str, ...] = ("t",)) -> Mesh:
        """A 1-d mesh of the first n visible cards, each once; raises if
        fewer are visible (to put several shards on one card, list it
        several times yourself)."""
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not 1 <= n <= have:
            raise RuntimeError(f"Mesh.cuda({n}): {have} CUDA device(s) visible")
        return cls(np.array([torch.device("cuda", i) for i in range(n)],
                            dtype=object), axis_names)

    @classmethod
    def over_group(cls, local_devices, axis_name: str = "t",
                   group=None) -> Mesh:
        """A 1-d mesh spanning every process of `group` (default: the
        default group): each process lists the devices of its own shards,
        and the global order is the ranks' order. Collective: every rank
        calls it."""
        import torch.distributed as dist

        group = dist.group.WORLD if group is None else group
        per_rank = [None] * dist.get_world_size(group)
        dist.all_gather_object(per_rank, [str(torch.device(d))
                                          for d in local_devices], group=group)
        devs = np.array([torch.device(d) for ds in per_rank for d in ds],
                        dtype=object)
        owners = [r for r, ds in enumerate(per_rank) for _ in ds]
        return cls(devs, (axis_name,), owners, group)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _along(self, arr, axis: str, index) -> list:
        k = self.axis_names.index(axis)
        rest = (index,) if isinstance(index, (int, np.integer)) else tuple(index)
        if len(rest) != self.devices.ndim - 1:
            raise ValueError(f"along {axis!r}: {len(rest)} indices for "
                             f"{self.devices.ndim - 1} other axes")
        sel = list(rest)
        sel.insert(k, slice(None))
        return list(arr[tuple(sel)])

    def devices_along(self, axis: str, index=()) -> list[torch.device]:
        """The devices along `axis`, in order, at `index` on the other axes
        (an int or a tuple, in the mesh's axis order; () on a 1-d mesh)."""
        return self._along(self.devices, axis, index)

    def owners_along(self, axis: str, index=()) -> list[int]:
        """The owner rank of each shard along `axis` at `index`."""
        return [int(r) for r in self._along(self.owners, axis, index)]

    def local_along(self, axis: str, index=()) -> list[int]:
        """The positions along `axis` (at `index`) of the shards this
        process owns, in order."""
        return [i for i, r in enumerate(self.owners_along(axis, index))
                if r == self.rank]

    def ppermute(self, blocks: list[torch.Tensor], perm, axis: str,
                 index=()) -> list[torch.Tensor]:
        """`ppermute` over `axis` (at `index`): blocks and the result are
        this process's shards' (every shard's on a one-process mesh), perm
        lists (src, dst) global positions along the axis."""
        return _ppermute(blocks, perm, self.owners_along(axis, index),
                         self.rank, self.group)

    def psum(self, blocks: list[torch.Tensor], axis: str, index=(),
             scatter_dim: int | None = None) -> list[torch.Tensor]:
        """`psum` over `axis` (at `index`) of this process's shards' blocks
        (every shard's on a one-process mesh), summed in global shard
        order."""
        return _psum(blocks, self.owners_along(axis, index), self.rank,
                     self.group, scatter_dim)


def ppermute(blocks: list[torch.Tensor], perm) -> list[torch.Tensor]:
    """jax.lax.ppermute over one mesh axis of one process: perm lists (src,
    dst) shard pairs; shard dst receives blocks[src] on blocks[dst]'s
    device, a shard no pair names receives zeros. A block copied within one
    device is the same tensor (read it only)."""
    return _ppermute(blocks, perm, [0] * len(blocks), 0, None)


def psum(blocks: list[torch.Tensor], scatter_dim: int | None = None
         ) -> list[torch.Tensor]:
    """jax.lax.psum over one mesh axis of one process: shard i receives the
    sum of every block, each moved to blocks[i]'s device, added in shard
    order. With `scatter_dim`, shard i keeps only the i-th of n equal
    slices of the sum along that dimension (a reduce-scatter: only that
    slice is moved)."""
    return _psum(blocks, [0] * len(blocks), 0, None, scatter_dim)


def _piece(block: torch.Tensor, i: int, n: int, scatter_dim: int | None):
    """What shard i of n needs of `block` for a psum: all of it, or its
    slice along scatter_dim."""
    if scatter_dim is None:
        return block
    if block.shape[scatter_dim] % n:
        raise ValueError(f"psum: dim {scatter_dim} of {tuple(block.shape)} "
                         f"is not a multiple of {n} shards")
    return block.chunk(n, scatter_dim)[i]


class _Wire:
    """Blocks on their way through a process group: complex as real pairs,
    on the host for gloo (its send / recv take host tensors only), on the
    card for nccl. Every send and receive of one collective is posted in
    the same global order in every process, then all are waited on. On a
    one-process mesh (group None) nothing crosses, and none is posted."""

    def __init__(self, group):
        self.group = group
        self.ops, self.recvs = [], []

    def _op(self, kind: str, t: torch.Tensor, peer: int, tag: int) -> None:
        import torch.distributed as dist

        self.ops.append(dist.P2POp(getattr(dist, kind), t,
                                   dist.get_global_rank(self.group, peer),
                                   self.group, tag))

    def _host(self) -> bool:
        import torch.distributed as dist

        return dist.get_backend(self.group) == "gloo"

    def send(self, t: torch.Tensor, to: int, tag: int) -> None:
        w = torch.view_as_real(t) if t.is_complex() else t
        self._op("isend", (w.cpu() if self._host() else w).contiguous(), to, tag)

    def recv(self, like: torch.Tensor, frm: int, tag: int) -> int:
        """Post a receive of a tensor shaped and typed as `like`; returns
        its handle for `got` after `run`."""
        w = torch.view_as_real(like) if like.is_complex() else like
        buf = torch.empty(w.shape, dtype=w.dtype,
                          device="cpu" if self._host() else like.device)
        self._op("irecv", buf, frm, tag)
        self.recvs.append((buf, like))
        return len(self.recvs) - 1

    def run(self) -> None:
        if self.ops:
            import torch.distributed as dist

            for req in dist.batch_isend_irecv(self.ops):
                req.wait()

    def got(self, handle: int) -> torch.Tensor:
        buf, like = self.recvs[handle]
        t = torch.view_as_complex(buf) if like.is_complex() else buf
        return t.to(like.device)


def _local(owners: list[int], rank: int, blocks: list) -> dict[int, int]:
    """Global shard position -> index in this process's blocks."""
    mine = [i for i, r in enumerate(owners) if r == rank]
    if len(blocks) != len(mine):
        raise ValueError(f"rank {rank} owns {len(mine)} shards of {owners}, "
                         f"given {len(blocks)} blocks")
    return {g: k for k, g in enumerate(mine)}


def _ppermute(blocks, perm, owners, rank, group):
    """ppermute of this process's blocks; owners[i] is global shard i's
    rank. A pair within this process is a copy, one across processes a
    send and a receive."""
    pos = _local(owners, rank, blocks)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a shard receives twice in {perm}")
    n = len(owners)
    out = [torch.zeros_like(b) for b in blocks]
    wire, into = _Wire(group), {}
    for src, dst in perm:
        tag = src * n + dst
        if owners[src] == rank and owners[dst] == rank:
            out[pos[dst]] = blocks[pos[src]].to(blocks[pos[dst]].device,
                                                non_blocking=True)
        elif owners[src] == rank:
            wire.send(blocks[pos[src]], owners[dst], tag)
        elif owners[dst] == rank:
            into[pos[dst]] = wire.recv(blocks[pos[dst]], owners[src], tag)
    wire.run()
    for k, h in into.items():
        out[k] = wire.got(h)
    return out


def _psum(blocks, owners, rank, group, scatter_dim):
    """psum of this process's blocks: each receiver gathers the pieces it
    needs from the shards of other processes (a process sends a piece once
    to each other process that needs it), then adds every shard's piece,
    moved to its device, in global shard order."""
    pos = _local(owners, rank, blocks)
    n = len(owners)

    # piece j -> receiver i (scatter), or j -> every receiver of a process
    def key(j, i):
        return (j, i) if scatter_dim is not None else (j, owners[i])
    wire, handles = _Wire(group), {}
    for j in range(n):
        for i in range(n):
            kj = key(j, i)
            if kj in handles or owners[j] == owners[i]:
                continue
            tag = kj[0] * n + kj[1]
            if owners[j] == rank:
                wire.send(_piece(blocks[pos[j]], i, n, scatter_dim),
                          owners[i], tag)
                handles[kj] = None
            elif owners[i] == rank:
                handles[kj] = wire.recv(
                    _piece(blocks[pos[i]], i, n, scatter_dim), owners[j], tag)
    wire.run()
    out = []
    for i, k in sorted(pos.items()):
        mine, acc = blocks[k], None
        for j in range(n):
            if owners[j] == rank:
                b = _piece(blocks[pos[j]], i, n, scatter_dim)
            else:
                b = wire.got(handles[key(j, i)])
            b = b.to(mine.device, non_blocking=True)
            acc = b.clone() if acc is None else acc + b
        out.append(acc)
    return out
