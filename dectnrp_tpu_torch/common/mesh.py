"""A device mesh in one process, and the two collectives the multi-device
code uses (the port's counterpart of `jax.sharding.Mesh` with
`jax.lax.ppermute` and `jax.lax.psum` inside `shard_map`).

JAX's `shard_map` is single-controller SPMD: one Python process runs one
program per mesh device. The port keeps that form. A `Mesh` is an array of
`torch.device`s with named axes; a sharded function loops over the shards,
each shard's tensors on its device, and a collective is a plain function
over the list of the shards' tensors (one axis of the mesh, in its order):

- `ppermute(blocks, perm)`: shard dst receives shard src's block, copied to
  dst's device (`.to(device, non_blocking=True)`: a peer copy between two
  cards, nothing on one card);
- `psum(blocks)`: every shard receives the sum of all blocks, each moved to
  the receiving shard's device and added in shard order; with `scatter_dim`
  each shard keeps only its own equal slice along that dimension (a
  reduce-scatter, as the node-sharded vspace tick needs).

No process group: one process holds every shard, so a card may be listed
several times (several shards on one card, as chip_smoke.py drives it on
one H100), and the same code with distinct cards does real peer copies.
Nothing falls back to the CPU: a mesh holds exactly the devices it is given
(`Mesh.cuda(n)` takes n distinct cards or raises).
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """devices: an object array of `torch.device` of any rank (or anything
    np.array turns into one), one name per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(given[idx])
        if arr.ndim != len(axis_names) or len(set(axis_names)) != arr.ndim:
            raise ValueError(f"Mesh: {arr.ndim}-d devices need as many distinct "
                             f"axis names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("Mesh: no devices")
        self.devices = arr
        self.axis_names = tuple(axis_names)

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

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axis: str, index=()) -> list[torch.device]:
        """The devices along `axis`, in order, at `index` on the other axes
        (an int or a tuple, in the mesh's axis order; () on a 1-d mesh)."""
        k = self.axis_names.index(axis)
        rest = (index,) if isinstance(index, (int, np.integer)) else tuple(index)
        if len(rest) != self.devices.ndim - 1:
            raise ValueError(f"devices_along({axis!r}): {len(rest)} indices for "
                             f"{self.devices.ndim - 1} other axes")
        sel = list(rest)
        sel.insert(k, slice(None))
        return list(self.devices[tuple(sel)])


def ppermute(blocks: list[torch.Tensor], perm) -> list[torch.Tensor]:
    """jax.lax.ppermute over one mesh axis: perm lists (src, dst) shard
    pairs; shard dst receives blocks[src] on blocks[dst]'s device, a shard
    no pair names receives zeros. A block copied within one device is the
    same tensor (read it only)."""
    out = [torch.zeros_like(b) for b in blocks]
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a shard receives twice in {perm}")
    for src, dst in perm:
        out[dst] = blocks[src].to(blocks[dst].device, non_blocking=True)
    return out


def psum(blocks: list[torch.Tensor], scatter_dim: int | None = None
         ) -> list[torch.Tensor]:
    """jax.lax.psum over one mesh axis: shard i receives the sum of every
    block, each moved to blocks[i]'s device, added in shard order. With
    `scatter_dim`, shard i keeps only the i-th of n equal slices of the sum
    along that dimension (a reduce-scatter: only that slice is moved)."""
    n = len(blocks)
    out = []
    for i, mine in enumerate(blocks):
        acc = None
        for b in blocks:
            if scatter_dim is not None:
                if b.shape[scatter_dim] % n:
                    raise ValueError(f"psum: dim {scatter_dim} of {tuple(b.shape)} "
                                     f"is not a multiple of {n} shards")
                b = b.chunk(n, scatter_dim)[i]
            b = b.to(mine.device, non_blocking=True)
            acc = b.clone() if acc is None else acc + b
        out.append(acc)
    return out
