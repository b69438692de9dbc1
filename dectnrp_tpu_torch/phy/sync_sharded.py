"""Time-axis sharded sync (port of dectnrp_tpu/phy/sync_sharded.py).

The reference parallelizes the STF search by time-interleaving chunks of
the RX ring across sync worker threads with an overlap region of 4 STF
lengths (lib/src/phy/worker_pool.cpp:249-324, sync_param.hpp:77), with a
unique-sync-time filter against double detections in the overlap. Here the
IQ stream is cut into contiguous chunks along one axis of a device mesh
(common/mesh.py): each shard takes c_loc chunks, receives the next shard's
first `overlap` samples as its halo (`ppermute`; the last shard's wraps to
shard 0), and searches its c_loc windows of chunk + overlap samples in ONE
`Sync` call on its device (one detection-kernel launch a shard, at
B = c_loc). Double detections in the overlap are resolved on the host by
the same unique-time rule (`dedup_reports`, a copy of the JAX function).
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.mesh import Mesh, ppermute
from ..sections.part3.transmission_packet_structure import get_N_samples_STF
from .sync import Sync, SyncParams, build_sync


def _windows(ext: torch.Tensor, n_win: int, chunk: int, overlap: int) -> torch.Tensor:
    """ext [R, n_win * chunk + overlap] -> contiguous windows [n_win, R,
    chunk + overlap], window c starting at c * chunk."""
    assert ext.shape[-1] == n_win * chunk + overlap
    return ext.unfold(-1, chunk + overlap, chunk).transpose(0, 1).contiguous()


def _own(rep: dict, first: int, c_loc: int, chunk: int, overlap: int,
         n_chunks: int) -> dict:
    """A window report of chunks first .. first + c_loc - 1 -> the sharded
    report: a detection belongs to its chunk only if it starts inside it
    (the overlap re-finds packets owned by the next chunk), and on the
    stream's last chunk, whose halo wraps to the stream's head, only if its
    correlation support stays clear of the wrapped samples."""
    t_fine = rep["t_fine"]
    base = (first + torch.arange(c_loc, dtype=torch.int64,
                                 device=t_fine.device)) * chunk
    own = t_fine < chunk
    is_last = base + chunk >= n_chunks * chunk
    own = own & (~is_last | (t_fine <= chunk - overlap))
    return {
        "detected": rep["detected"] & own,
        "t_global": (base + t_fine).to(torch.int32),
        "cfo": rep["cfo"],
        "n_eff_tx": rep["n_eff_tx"],
        "metric": rep["metric"],
        "rms": rep["rms"],
    }


class SyncSharded(torch.nn.Module):
    """f(iq [R, n_chunks * chunk]) -> report dict of [n_chunks] tensors
    (detected, t_global int32, cfo, n_eff_tx, metric, rms), gathered in
    chunk order on the first device along `axis`.

    The stream's time axis is cut into n_chunks contiguous chunks shared
    out over `axis` (n_chunks % mesh.shape[axis] == 0); on a mesh of more
    axes the shards along `axis` at index 0 of the others compute it (JAX
    replicates the same work there). Each shard's `Sync` is built once a
    device.
    """

    def __init__(self, u: int, b: int, chunk: int, n_chunks: int, mesh: Mesh,
                 axis: str = "t", n_rx: int = 1,
                 params: SyncParams = SyncParams()):
        super().__init__()
        n_dev = mesh.shape[axis]
        assert n_chunks % n_dev == 0
        self.c_loc = n_chunks // n_dev
        self.overlap = 4 * get_N_samples_STF(u, b)
        assert self.overlap < chunk, "chunk must exceed the overlap region"
        self.chunk, self.n_chunks, self.n_dev = chunk, n_chunks, n_dev
        self.devices = mesh.devices_along(
            axis, (0,) * (len(mesh.axis_names) - 1))
        self.perm = [((i + 1) % n_dev, i) for i in range(n_dev)]  # receive from next
        # one Sync a distinct device, each placed there (not submodules: a
        # .to() of the whole must not move them off their shards)
        self.syncs = {d: build_sync(u, b, chunk + self.overlap, params=params,
                                    device=d) for d in dict.fromkeys(self.devices)}

    def forward(self, iq: torch.Tensor) -> dict:
        c_loc, chunk, ov = self.c_loc, self.chunk, self.overlap
        span = c_loc * chunk
        if iq.dim() != 2 or iq.shape[-1] != self.n_chunks * chunk:
            raise ValueError(f"sync_sharded: iq must be [R, {self.n_chunks * chunk}]"
                             f", got {tuple(iq.shape)}")
        # each shard's contiguous slice of the stream, on its device (on a
        # device listed twice, a view: read only)
        xs = [iq[:, i * span:(i + 1) * span].to(d, non_blocking=True)
              for i, d in enumerate(self.devices)]
        halos = ppermute([x[:, :ov] for x in xs], self.perm)
        reps = []
        for i, (x, halo, d) in enumerate(zip(xs, halos, self.devices)):
            ext = torch.cat([x, halo], -1)                        # a fresh tensor
            rep = self.syncs[d](_windows(ext, c_loc, chunk, ov))  # [c_loc]
            reps.append(_own(rep, i * c_loc, c_loc, chunk, ov, self.n_chunks))
        d0 = self.devices[0]
        return {k: torch.cat([r[k].to(d0) for r in reps]) for k in reps[0]}


def build_sync_sharded(u: int, b: int, chunk: int, n_chunks: int, mesh: Mesh,
                       axis: str = "t", n_rx: int = 1,
                       params: SyncParams = SyncParams()) -> SyncSharded:
    """The sharded STF search over `mesh` (dectnrp_tpu/phy/sync_sharded.py:27)."""
    return SyncSharded(u, b, chunk, n_chunks, mesh, axis, n_rx, params)


def sync_dense(sync: Sync, iq: torch.Tensor, chunk: int, n_chunks: int,
               overlap: int) -> dict:
    """The sharded search's serial oracle: all n_chunks windows (the last
    one's overlap wrapped to the stream's head, as the sharded halo) through
    `sync` in ONE call on iq's device, masked as the shards mask them."""
    ext = torch.cat([iq, iq[:, :overlap]], -1)
    rep = sync(_windows(ext, n_chunks, chunk, overlap))
    return _own(rep, 0, n_chunks, chunk, overlap, n_chunks)


def dedup_reports(rep: dict, u: int, b: int) -> list[dict]:
    """Host-side unique-sync-time filter over gathered chunk reports
    (reference baton_t::is_sync_time_unique, worker_pool.cpp:299-324); rep
    holds host arrays (numpy, or CPU tensors). A copy of the JAX function,
    code for code."""
    stf = get_N_samples_STF(u, b)
    det = np.asarray(rep["detected"])
    t = np.asarray(rep["t_global"])
    out, last = [], None
    for i in np.argsort(t):
        if not det[i]:
            continue
        if last is not None and abs(int(t[i]) - last) < stf:
            continue
        last = int(t[i])
        out.append({k: np.asarray(v)[i].item() for k, v in rep.items()})
    return out
