"""Time-axis sharded sync (port of dectnrp_tpu/phy/sync_sharded.py).

The reference parallelizes the STF search by time-interleaving chunks of
the RX ring across sync worker threads with an overlap region of 4 STF
lengths (lib/src/phy/worker_pool.cpp:249-324, sync_param.hpp:77), with a
unique-sync-time filter against double detections in the overlap. Here the
IQ stream is cut into contiguous chunks along one axis of a device mesh
(common/mesh.py, in one process or spanning several): each shard takes
c_loc chunks, receives the next shard's first `overlap` samples as its
halo (`ppermute`: a process's last shard's comes from the next process's
first; the last shard's wraps to shard 0), and searches its c_loc
windows of chunk + overlap samples in ONE `Sync` call on its device (one
detection-kernel launch a shard, at B = c_loc). Double detections in the
overlap are resolved on the host by the same unique-time rule
(`dedup_reports`, a copy of the JAX function).
"""
from __future__ import annotations

import numpy as np
import torch

from ..common.mesh import Mesh
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
    """f(iq [R, n * c_loc * chunk]) -> report dict of [n * c_loc] tensors
    (detected, t_global int32, cfo, n_eff_tx, metric, rms), gathered in
    chunk order on the first device of this process's shards.

    The stream's time axis is cut into n_chunks contiguous chunks shared
    out over `axis` (n_chunks % mesh.shape[axis] == 0); on a mesh of more
    axes the shards along `axis` at index 0 of the others compute it (JAX
    replicates the same work there). On a one-process mesh iq is the whole
    stream and n every shard; on a process-spanning mesh (its shards along
    `axis` contiguous in each process) iq is this process's contiguous
    span, n its shards, and a shard's halo may come from the next process
    (`gather_report` collects the reports on one rank). Each shard's `Sync`
    is built once a device.
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
        self.mesh, self.axis = mesh, axis
        self.at = (0,) * (len(mesh.axis_names) - 1)
        self.devices = mesh.devices_along(axis, self.at)
        self.local = mesh.local_along(axis, self.at)
        if not self.local or self.local != list(
                range(self.local[0], self.local[-1] + 1)):
            raise ValueError(f"sync_sharded: rank {mesh.rank} must own a "
                             f"contiguous run of the shards, owns {self.local}")
        self.perm = [((i + 1) % n_dev, i) for i in range(n_dev)]  # receive from next
        # one Sync a distinct device, each placed there (not submodules: a
        # .to() of the whole must not move them off their shards)
        self.syncs = {d: build_sync(u, b, chunk + self.overlap, params=params,
                                    device=d)
                      for d in dict.fromkeys(self.devices[i] for i in self.local)}

    def forward(self, iq: torch.Tensor) -> dict:
        c_loc, chunk, ov = self.c_loc, self.chunk, self.overlap
        span = c_loc * chunk
        if iq.dim() != 2 or iq.shape[-1] != len(self.local) * span:
            raise ValueError(f"sync_sharded: iq must be [R, {len(self.local) * span}]"
                             f", got {tuple(iq.shape)}")
        devs = [self.devices[i] for i in self.local]
        # each shard's contiguous slice of the stream, on its device (on a
        # device listed twice, a view: read only)
        xs = [iq[:, k * span:(k + 1) * span].to(d, non_blocking=True)
              for k, d in enumerate(devs)]
        halos = self.mesh.ppermute([x[:, :ov] for x in xs], self.perm,
                                   self.axis, self.at)
        reps = []
        for i, x, halo, d in zip(self.local, xs, halos, devs):
            ext = torch.cat([x, halo], -1)                        # a fresh tensor
            rep = self.syncs[d](_windows(ext, c_loc, chunk, ov))  # [c_loc]
            reps.append(_own(rep, i * c_loc, c_loc, chunk, ov, self.n_chunks))
        d0 = devs[0]
        return {k: torch.cat([r[k].to(d0) for r in reps]) for k in reps[0]}

    def gather_report(self, rep: dict, dst: int = 0) -> dict | None:
        """Every process's report (forward's) in chunk order, as CPU
        tensors, on rank dst and None on the others; on a one-process mesh
        the report itself, on the CPU. Collective on a spanning mesh."""
        mine = {k: v.cpu() for k, v in rep.items()}
        group = self.mesh.group
        if group is None:
            return mine
        import torch.distributed as dist

        got = [None] * dist.get_world_size(group) if self.mesh.rank == dst else None
        dist.gather_object((self.local[0], mine), got,
                           dst=dist.get_global_rank(group, dst), group=group)
        if got is None:
            return None
        got.sort(key=lambda first_rep: first_rep[0])
        return {k: torch.cat([r[k] for _, r in got]) for k in mine}


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


def report_mismatch(got: dict, want: dict, cfo_rtol: float = 0.0) -> list[str]:
    """The fields in which two chunk reports differ: each bit for bit,
    but cfo within cfo_rtol relative where it is not 0 (on the CPU
    torch.angle takes a vectorized atan2 on full vector lanes and a scalar
    one on the rest, which differ in the last bit between batch sizes; on
    the card the sharded and dense searches are bit for bit)."""
    bad = [k for k in want if k not in got or got[k].shape != want[k].shape
           or got[k].dtype != want[k].dtype]
    for k in want:
        if k in bad:
            continue
        a, b = got[k].cpu(), want[k].cpu()
        same = (torch.allclose(a, b, rtol=cfo_rtol, atol=0.0)
                if k == "cfo" and cfo_rtol else torch.equal(a, b))
        if not same:
            bad.append(k)
    return bad


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
