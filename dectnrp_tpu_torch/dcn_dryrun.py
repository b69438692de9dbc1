"""The multi-process dry run (port of tools/run_dcn_dryrun.py).

    python -m dectnrp_tpu_torch.dcn_dryrun                  # on the card(s)
    python -m dectnrp_tpu_torch.dcn_dryrun --device cpu

`--n-proc` processes (2) are spawned and joined by torch.distributed
(common/dist.py: a FileStore, no fixed port, the backend named by
`--backend`: default nccl where every process owns a distinct card, gloo
otherwise) into process-spanning meshes (`Mesh.over_group`), as the JAX
tool joins two processes with `jax.distributed.initialize`. Each process
holds its own shards; what crosses the process boundary goes through the
group. Three parts, each a function of its inputs and draws:

(a) `ether`: the node-sharded vspace tick (`vspace.tick_sharded`) over
    n_proc x `--local` (2) shards, N = 4 nodes, A = 1, spp 2,048, per-edge
    gains and TX drawn from default_rng(0) as the JAX tool draws them
    (:58-63), noise_var 1e-6; its reduce-scatter psum crosses processes.
    Gates: every shard within 0.02 of the host superposition
    einsum("ji,jas->ias") (the JAX tool's gate), and bit for bit the
    one-process tick over as many shards on the same draws.
(b) `channels`: four independent channels, one a shard: psdef (1, 1, 0, 2,
    0, 2, 6144) at 15 dB, each shard encodes with build_tx, adds its noise
    (an argument of `channel_step`) and decodes with build_rx; the count of
    TBs decoded is a psum over the group. Gate: 4 of 4 in every process.
(c) `sync`: the process-spanning time-sharded sync at the flagship's
    numerology (the slice's full-width case): u = 1, b = 16, a stream
    [1, 2,097,152] of 64 chunks of 32,768 with 4 flagship packets (1, 16,
    1, 4, 0, 4) at 15 dB (mid-shard, straddling a chunk boundary,
    straddling the process boundary, in the last shard), over n_proc x 4
    shards (windows [8, 1, 39,936] a shard at 2 processes). Gates (rank 0,
    on the report gathered there): bit for bit the one-process search over
    as many shards and the dense search (`sync_dense`; on the CPU cfo
    within 1e-6 relative, `report_mismatch`), and every packet found
    within +-2 samples.

Each child's report carries its kernel launches a part (`launch_counts`;
the reference runs beside the parts are not counted). The parent prints
one JSON line (per-process reports, `ok`, the backend, the card) and writes
it to `--out` when given; it never writes results/dcn/, the JAX package's
records. Exits 1 if a gate fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .common import dist
from .common.benchtime import synced_ms
from .common.mesh import Mesh
from .kernels import LAUNCH_KEYS, launch_counts
from .multichip import NID, make_stream
from .phy.rx import build_rx
from .phy.sync_sharded import (build_sync_sharded, dedup_reports,
                               report_mismatch, sync_dense)
from .phy.tx import build_tx
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .simulation.channels import draw_noise
from .simulation.vspace import draw_tick_sharded, tick_sharded

N_PROC, LOCAL = 2, 2
ETHER_A, ETHER_SPP, ETHER_NV, ETHER_TOL = 1, 2048, 1e-6, 0.02
PSDEF_CHAN = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
NOISE_VAR = float(np.float32(10.0 ** (-15.0 / 10.0)))       # 15 dB
#: (c): shards a process, u, b, chunk, chunks, psdef, packets as (chunk,
#: sample in it): mid-shard, across the chunk boundary 9 -> 10, across the
#: process boundary (chunk 32 at 2 processes x 4 shards), in the last shard
SYNC_LOCAL, SYNC_U, SYNC_B, SYNC_CHUNK, SYNC_CHUNKS = 4, 1, 16, 32768, 64
PSDEF_SYNC = PacketSizesDef(1, 16, 1, 4, 0, 4, 6144)
SYNC_OFFSETS = ((3, 4000), (10, -1000), (32, -900), (60, 5000))
#: seeds of the torch noise of (a), (b), (c) and of (c)'s numpy bits
SEEDS = (0, 3, 11, 12)
TIMED = 5                      # calls a timing averages over


def _since(c0: dict) -> dict:
    c1 = launch_counts()
    return {k: c1[k] - c0[k] for k in LAUNCH_KEYS}


def ether_inputs(n_nodes: int):
    """(gain [N, N] float32, tx [N, A, spp] complex64, rng): default_rng(0)
    drawn in the JAX tool's order; rng goes on to (b)'s bits."""
    rng = np.random.default_rng(0)
    gain = rng.uniform(0.5, 1.0, (n_nodes, n_nodes)).astype(np.float32)
    tx = (rng.standard_normal((n_nodes, ETHER_A, ETHER_SPP))
          + 1j * rng.standard_normal((n_nodes, ETHER_A, ETHER_SPP))
          ).astype(np.complex64)
    return gain, tx, rng


def channel_bits(rng, n_chan: int):
    """(b)'s PLCF [n, 40] and TB [n, N_TB_bits] uint8 bits, in the JAX
    tool's order after (a)'s draws."""
    n_tb = get_packet_sizes(PSDEF_CHAN).N_TB_bits
    plcf = rng.integers(0, 2, (n_chan, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (n_chan, n_tb)).astype(np.uint8)
    return plcf, tb


def channel_step(tx, rx, plcf, tb, noise, noise_var: float = NOISE_VAR):
    """(b)'s step on one shard's channels: plcf uint8 [B, 40], tb [B,
    N_TB_bits], noise unit-variance complex64 shaped as the TX IQ ->
    (TX IQ, build_rx's output on IQ + sqrt(noise_var) noise)."""
    flags = torch.zeros((plcf.shape[0],), dtype=torch.bool, device=plcf.device)
    iq = tx(plcf, tb, flags, flags)
    return iq, rx(iq + noise_var ** 0.5 * noise, noise_var)


def part_ether(dev, local: int) -> tuple[dict, np.random.Generator]:
    """(a) in this process: the spanning tick against the host
    superposition and the one-process tick on the same draws."""
    mesh = Mesh.over_group([dev] * local, "node")
    n = len(mesh.devices)
    gain, tx, rng = ether_inputs(n)
    own = mesh.local_along("node")
    gen = torch.Generator(device=dev).manual_seed(SEEDS[0])
    draws = draw_tick_sharded(gen, mesh, n, ETHER_A, ETHER_SPP)
    c0 = launch_counts()
    got = tick_sharded(mesh, torch.from_numpy(tx[own]), gain, ETHER_NV,
                       draws=draws)
    launches = _since(c0)
    want = np.einsum("ji,jas->ias", gain, tx)
    err = max(float(np.abs(g.cpu().numpy() - want[i:i + 1]).max())
              for g, i in zip(got, own))
    one = Mesh(np.array([dev] * n, dtype=object), ("node",))
    gen.manual_seed(SEEDS[0])
    ref = tick_sharded(one, torch.from_numpy(tx), gain, ETHER_NV,
                       draws=draw_tick_sharded(gen, one, n, ETHER_A, ETHER_SPP))
    same = all(torch.equal(g, ref[i]) for g, i in zip(got, own))
    return {"global_shards": n, "local_shards": len(own), "ether_max_err": err,
            "ether_equal_one_process": same, "launches": launches}, rng


def part_channels(dev, local: int, rng) -> dict:
    """(b) in this process: its shards' channels, the OK count summed over
    the group."""
    mesh = Mesh.over_group([dev] * local, "node")
    n = len(mesh.devices)
    plcf, tb = channel_bits(rng, n)
    tx = build_tx(PSDEF_CHAN, NID, 1, device=dev)
    rx = build_rx(PSDEF_CHAN, NID, 1, device=dev)
    ps = get_packet_sizes(PSDEF_CHAN)
    gen = torch.Generator(device=dev).manual_seed(SEEDS[1])
    noise = draw_noise(gen, (n, ps.tm_mode.N_TX, ps.N_samples_packet), dev)
    torch.distributed.barrier()
    c0 = launch_counts()
    t0 = time.perf_counter()
    oks = []
    for i in mesh.local_along("node"):
        rows = slice(i, i + 1)
        _, out = channel_step(tx, rx, torch.from_numpy(plcf[rows]).to(dev),
                              torch.from_numpy(tb[rows]).to(dev), noise[rows])
        oks.append(out["tb_ok"].to(torch.int64).sum().reshape(1))
    total = mesh.psum(oks, "node")                 # crosses the processes
    counts = sorted({int(t.item()) for t in total})
    secs = time.perf_counter() - t0
    return {"channels_decoded_ok": counts[0] if len(counts) == 1 else counts,
            "channels_total": n, "chan_step_s": secs,
            "launches": _since(c0)}


def sync_stream(dev):
    """(c)'s stream [1, SYNC_CHUNKS * SYNC_CHUNK] on dev and its packets'
    offsets: bits from numpy seed SEEDS[3], noise from a torch.Generator
    seeded SEEDS[2] on dev (the same in every process on one kind of
    device)."""
    offs = [c * SYNC_CHUNK + s for c, s in SYNC_OFFSETS]
    T = SYNC_CHUNKS * SYNC_CHUNK
    rng = np.random.default_rng(SEEDS[3])
    plcf = rng.integers(0, 2, (len(offs), 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (len(offs), get_packet_sizes(PSDEF_SYNC).N_TB_bits)
                      ).astype(np.uint8)
    gen = torch.Generator(device=dev).manual_seed(SEEDS[2])
    return make_stream(plcf, tb, offs, T, draw_noise(gen, (1, T), dev),
                       PSDEF_SYNC), offs


def part_sync(dev) -> dict:
    """(c) in this process: the spanning search of its span, the reports
    gathered to rank 0 and held there to the one-process and dense
    searches; each process's host ms a call, and on rank 0 those of the
    one-process and dense calls."""
    stream, offs = sync_stream(dev)
    mesh = Mesh.over_group([dev] * SYNC_LOCAL, "t")
    sh = build_sync_sharded(SYNC_U, SYNC_B, SYNC_CHUNK, SYNC_CHUNKS, mesh)
    span = sh.c_loc * SYNC_CHUNK
    mine = stream[:, sh.local[0] * span:(sh.local[-1] + 1) * span]
    torch.distributed.barrier()
    c0 = launch_counts()
    rep = sh(mine)
    launches = _since(c0)
    full = sh.gather_report(rep)
    rec = {"shards": len(mesh.devices), "local_shards": len(sh.local),
           "window": [sh.c_loc, 1, SYNC_CHUNK + sh.overlap],
           "stream": list(stream.shape), "launches": launches,
           "spanning_ms": synced_ms(lambda: sh(mine), iters=TIMED, warmup=1)}
    if full is not None:
        one = build_sync_sharded(SYNC_U, SYNC_B, SYNC_CHUNK, SYNC_CHUNKS, Mesh(
            np.array([dev] * len(mesh.devices), dtype=object), ("t",)))
        dense = sync_dense(one.syncs[dev], stream, SYNC_CHUNK, SYNC_CHUNKS,
                           one.overlap)
        found = sorted(h["t_global"] for h in dedup_reports(full, SYNC_U, SYNC_B))
        det = full["detected"]
        rec |= {
            "offsets": sorted(offs), "found": found,
            "found_ok": len(found) == len(offs) and all(
                abs(f - o) <= 2 for f, o in zip(found, sorted(offs))),
            "detected_chunks": int(det.sum()),
            "mismatch_one_process": report_mismatch(full, one(stream)),
            "mismatch_dense": report_mismatch(
                full, dense, 0.0 if dev.type == "cuda" else 1e-6),
            "cfo_max_abs_err_dense": float(
                (full["cfo"] - dense["cfo"].cpu()).abs().max()),
            "one_process_ms": synced_ms(lambda: one(stream), iters=TIMED,
                                        warmup=1),
            "dense_ms": synced_ms(lambda: sync_dense(
                one.syncs[dev], stream, SYNC_CHUNK, SYNC_CHUNKS, one.overlap),
                iters=TIMED, warmup=1)}
    torch.distributed.barrier()
    return rec


def child(rank: int, world: int, device: torch.device, local: int) -> dict:
    """One process of the dry run, as common/dist.spawn runs it (the
    device selected, the group joined): (a), (b), (c)."""
    ether, rng = part_ether(device, local)
    chan = part_channels(device, local, rng)
    sync = part_sync(device)
    return {"device": str(device), "ether": ether, "channels": chan,
            "sync": sync}


def gates(rec: dict) -> dict:
    """Each gate of the run's records (run's output), by name."""
    reps = rec["reports"]
    s0 = reps[0]["sync"]
    return {
        "ether_within_tol": all(r["ether"]["ether_max_err"] < ETHER_TOL
                                for r in reps),
        "ether_equal_one_process": all(r["ether"]["ether_equal_one_process"]
                                       for r in reps),
        "channels_all_decoded": all(
            r["channels"]["channels_decoded_ok"] == r["channels"]["channels_total"]
            for r in reps),
        "sync_found": s0["found_ok"],
        "sync_equal_one_process": not s0["mismatch_one_process"],
        "sync_equal_dense": not s0["mismatch_dense"]}


def run(device: str = "cuda", backend: str | None = None, n_proc: int = N_PROC,
        local: int = LOCAL, timeout_s: float = 600.0) -> dict:
    """Spawn the n_proc processes over `device` (cuda: process r on card r
    where there are n_proc cards, else every process on card 0) and
    collect their reports. backend None: nccl where every process owns a
    distinct card, else gloo."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dcn_dryrun: no CUDA device (use --device cpu)")
        from . import kernels

        kernels.load()          # built once here; the children load it
        card = kernels.card_name()
        n_cards = torch.cuda.device_count()
        devs = [torch.device("cuda", r if n_cards >= n_proc else 0)
                for r in range(n_proc)]
    elif device == "cpu":
        card, devs = "cpu", [torch.device("cpu")] * n_proc
    else:
        raise ValueError(f"dcn_dryrun: device {device!r} (cuda or cpu)")
    distinct = len(set(devs))
    if backend is None:
        backend = "nccl" if device == "cuda" and distinct == n_proc else "gloo"
    reports = dist.spawn(child, n_proc, backend, devs, args=(local,),
                         timeout_s=timeout_s)
    rec = {"n_processes": n_proc, "local_shards_per_process": local,
           "sync_shards_per_process": SYNC_LOCAL, "backend": backend,
           "device": device, "card": card, "distinct_devices": distinct,
           "reports": reports}
    rec["gates"] = gates(rec)
    rec["ok"] = all(rec["gates"].values())
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl where every process owns a distinct "
                         "card, else gloo")
    ap.add_argument("--n-proc", type=int, default=N_PROC)
    ap.add_argument("--local", type=int, default=LOCAL,
                    help="shards a process in (a) and (b)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    rec = run(a.device, a.backend, a.n_proc, a.local)
    line = json.dumps(rec)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
