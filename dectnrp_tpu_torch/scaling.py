"""Mesh scaling of the sharded paths (port of tools/run_scaling.py).

    python -m dectnrp_tpu_torch.scaling                       # on the card
    python -m dectnrp_tpu_torch.scaling --device cpu --n-devs 1 2 --iters 1

Two sharded paths over one process's mesh (common/mesh.py): the card
listed n times, or n distinct cards where `Mesh.cuda(n)` has them (each
row records how many distinct devices it ran on):

(a) the time-sharded sync (phy/sync_sharded.py) at u = b = 1, chunk 8,192:
    strong scaling over one 32-chunk stream at n = 1, 2, 4, 8 shards;
    weak scaling at 4 chunks a shard, beside the same stream searched on
    one shard (the control); and the halo's structural overhead;
(b) the node-sharded vspace tick at N = 8 nodes, A = 1, spp 4,096 with
    per-edge gains, beside the tick on one shard (the control).

Inputs are drawn from numpy default_rng(0) in the JAX tool's order. Before
a row is timed, its sharded output is held to the dense output (the sync
report bit for bit to `sync_dense`, on the CPU cfo within 1e-6 relative,
`report_mismatch`; the tick within 1e-5 to `apply_tick` on the same draws)
and a mismatch raises; each row records the kernel launches of that held
sharded call (`launches`: not those of the dense oracle, the warm-up or the
timed calls). Times are `benchtime.synced_ms`: host wall clock closed by a
synchronisation of the mesh's devices. The rows carry the JAX tool's keys.
Its `real_chip_projection` and `tpu_single_chip` (TPU link speeds and a
TPU anchor) are left out: the record keeps the structural fractions and
this device's own times, beside its name and power limit. One JSON line
is printed; `--out` also writes it to a file (never SCALING_r0*.json, the
JAX package's records).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .common.benchtime import synced_ms
from .common.mesh import Mesh
from .kernels import LAUNCH_KEYS, launch_counts
from .phy.sync_sharded import build_sync_sharded, report_mismatch, sync_dense
from .sections.part3.transmission_packet_structure import get_N_samples_STF
from .simulation.vspace import apply_tick, draw_tick_sharded, tick_sharded

N_DEVS = (1, 2, 4, 8)
U, B, CHUNK, N_CHUNKS, WEAK_CHUNKS = 1, 1, 8192, 32, 4
VS_N, VS_A, VS_SPP, VS_NV, VS_TOL = 8, 1, 4096, 1e-6, 1e-5


def mesh_of(device: str, n: int, axis: str) -> Mesh:
    """n shards of one process on `device`: n distinct cards where there
    are as many, else the card (or the CPU) listed n times."""
    if device == "cuda" and torch.cuda.device_count() >= n:
        return Mesh.cuda(n, (axis,))
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    return Mesh(np.array([dev] * n, dtype=object), (axis,))


def _distinct(mesh: Mesh) -> int:
    return len(set(mesh.devices.flat))


def _launches(f, *args):
    """(f(*args), the kernel launches it made)."""
    c0 = launch_counts()
    out = f(*args)
    c1 = launch_counts()
    return out, {k: c1[k] - c0[k] for k in LAUNCH_KEYS}


def held_sync(sh, iq: torch.Tensor, label: str) -> dict:
    """Raise unless the sharded report equals the dense search's; returns
    the sharded call's kernel launches."""
    d0 = sh.devices[0]
    dense = sync_dense(sh.syncs[d0], iq.to(d0), sh.chunk, sh.n_chunks, sh.overlap)
    got, launches = _launches(sh, iq)
    bad = report_mismatch(got, dense, 0.0 if d0.type == "cuda" else 1e-6)
    if bad:
        raise RuntimeError(f"scaling {label}: sharded report differs from the "
                           f"dense search in {bad}")
    return launches


def held_tick(mesh: Mesh, tx, gain, label: str) -> dict:
    """Raise unless the sharded tick is the dense one on the same draws
    within VS_TOL; returns the sharded tick's kernel launches."""
    dev = mesh.devices.flat[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = draw_tick_sharded(gen, mesh, VS_N, VS_A, VS_SPP)
    got, launches = _launches(lambda: tick_sharded(mesh, tx, gain, VS_NV,
                                                   draws=draws))
    got = torch.cat([g.to(dev) for g in got])
    want = apply_tick(tx.to(dev), gain.to(dev), None,
                      {"noise": torch.cat([d.to(dev) for d in draws])}, "awgn",
                      1_728_000.0, VS_NV)
    err = (got - want).abs().max().item()
    if not err <= VS_TOL:
        raise RuntimeError(f"scaling {label}: sharded tick vs dense max |err| "
                           f"{err} (limit {VS_TOL})")
    return launches


def run(device: str = "cuda", n_devs=N_DEVS, iters: int = 5) -> dict:
    """Every row at each shard count in n_devs; raises on a mismatch."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaling: no CUDA device (use --device cpu)")
    if device == "cuda":
        from .kernels import card_name
        card = card_name()
    else:
        card = "cpu"
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(0)

    def stream(T):
        return torch.from_numpy((rng.standard_normal((1, T))
                                 + 1j * rng.standard_normal((1, T))
                                 ).astype(np.complex64)).to(dev)

    def ms(mesh, f, *args):
        return synced_ms(f, args, iters=iters, warmup=1,
                         devices=set(mesh.devices.flat))

    res = {"device": card, "host_cores": os.cpu_count(),
           "note": "one process's mesh; each row's sharded output held to "
                   "the dense output before it is timed (benchtime.synced_ms)"}
    overlap = 4 * get_N_samples_STF(U, B)
    T = N_CHUNKS * CHUNK
    iq = stream(T)
    strong = []
    for n in n_devs:
        mesh = mesh_of(device, n, "t")
        f = build_sync_sharded(U, B, CHUNK, N_CHUNKS, mesh)
        launches = held_sync(f, iq, f"sync strong {n}")
        t = ms(mesh, f, iq)
        strong.append({"n_dev": n, "distinct_devices": _distinct(mesh),
                       "launches": launches,
                       "ms_per_stream": t, "samples_per_s": T / (t / 1e3),
                       "chunks_per_dev": N_CHUNKS // n})
    res["sync_sharded_strong"] = strong

    weak = []
    mesh1 = mesh_of(device, 1, "t")
    for n in n_devs:
        nc = WEAK_CHUNKS * n
        Tw = nc * CHUNK
        iqw = stream(Tw)
        mesh = mesh_of(device, n, "t")
        f = build_sync_sharded(U, B, CHUNK, nc, mesh)
        launches = held_sync(f, iqw, f"sync weak {n}")
        t = ms(mesh, f, iqw)
        t_ctl = ms(mesh1, build_sync_sharded(U, B, CHUNK, nc, mesh1), iqw)
        weak.append({"n_dev": n, "distinct_devices": _distinct(mesh),
                     "launches": launches,
                     "total_chunks": nc, "ms_per_stream": t,
                     "ms_per_chunk_per_dev": t / WEAK_CHUNKS,
                     "control_unsharded_1dev_ms": t_ctl,
                     "sharded_over_control": t / t_ctl,
                     "samples_per_s": Tw / (t / 1e3)})
    res["sync_sharded_weak"] = weak
    c_loc = N_CHUNKS // 8
    res["sync_halo_overhead"] = {
        "overlap_samples": overlap, "chunk_samples": CHUNK,
        "window_redundancy": overlap / CHUNK,
        "ici_halo_fraction_8dev": overlap / (c_loc * CHUNK),
        "comment": "each chunk's search window re-reads overlap/chunk = "
                   f"{overlap / CHUNK:.1%} extra samples (compute redundancy); "
                   "the ppermute moves only `overlap` samples a shard "
                   f"boundary = {overlap / (c_loc * CHUNK):.2%} of a shard's "
                   "samples at 8 shards (a peer copy between cards, a view "
                   "on one card; the key keeps the JAX record's name)"}

    gain = torch.from_numpy(rng.uniform(0.05, 1.0, (VS_N, VS_N)).astype(np.float32)
                            ).to(dev)
    tx = torch.from_numpy((rng.standard_normal((VS_N, VS_A, VS_SPP))
                           + 1j * rng.standard_normal((VS_N, VS_A, VS_SPP))
                           ).astype(np.complex64)).to(dev)

    def tick_ms(mesh):
        g = torch.Generator(device=dev).manual_seed(0)
        draws = draw_tick_sharded(g, mesh, VS_N, VS_A, VS_SPP)
        return ms(mesh, lambda: tick_sharded(mesh, tx, gain, VS_NV,
                                             draws=draws))
    mesh1n = mesh_of(device, 1, "node")
    held_tick(mesh1n, tx, gain, "vspace control")
    t_ctl = tick_ms(mesh1n)
    vs = []
    for n in n_devs:
        mesh = mesh_of(device, n, "node")
        launches = held_tick(mesh, tx, gain, f"vspace {n}")
        t = tick_ms(mesh)
        vs.append({"n_dev": n, "distinct_devices": _distinct(mesh),
                   "launches": launches,
                   "ms_per_tick": t, "control_unsharded_1dev_ms": t_ctl,
                   "sharded_over_control": t / t_ctl,
                   "nodes_per_dev": VS_N // n})
    res["vspace_sharded"] = vs
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n-devs", type=int, nargs="+", default=list(N_DEVS))
    ap.add_argument("--iters", type=int, default=5,
                    help="calls each time averages over")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    res = run(a.device, a.n_devs, a.iters)
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
