"""The multi-device dry run over a mesh of devices (port of
`__graft_entry__.py::dryrun_multichip`).

    python -m dectnrp_tpu_torch.multichip --n-devices 8 --repeat-card
    python -m dectnrp_tpu_torch.multichip --device cpu --n-devices 4

Two phases, each a function that takes its inputs and draws and returns
its records:

1. `cross_node_loopback`: a vspace-style TDM loopback across nodes. The
   mesh is ("node", "dp"): n_node nodes (4 when the device count allows,
   else 2, else 1), each node's batch of B = 2 n_dp packets sharded over
   "dp". Each shard builds its packets (psdef (1, 1, 0, 2, 1, 1, 6144):
   N_TX = 2, Alamouti), puts them in its node's slot of an n_node-slot TDM
   frame, runs them through the 2-tap delay line of every directed edge
   (`edge_channels`, numpy from a seed, the same in both packages), and the
   ether is a reduce-scatter `psum` over "node" within each dp column; the
   node adds AWGN at 15 dB and decodes the OTHER node's slot.
2. `sharded_sync_decode`: one continuous stream chunked over every device
   on a "t" axis, searched by `build_sync_sharded` (halos), deduplicated
   (`dedup_reports`), and every packet found decoded by `build_rx_stream`.

`dryrun_multichip(devices)` makes both phases' inputs (numpy from fixed
seeds, noise from `torch.Generator`s) and runs them. It stays in one
process, which holds every shard (common/mesh.py; a device may be listed
several times): phase 1 reads every node's decisions on the host. The
process-spanning form of the same collectives, over torch.distributed, is
dcn_dryrun.py's (the port of tools/run_dcn_dryrun.py).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .common.mesh import Mesh, psum
from .phy.rx import build_rx
from .phy.sync import build_rx_stream
from .phy.sync_sharded import build_sync_sharded, dedup_reports
from .phy.tx import build_tx
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .simulation.channels import draw_noise

NID = 0x12345678
#: phase 1: N_eff_TX = 2 transmit diversity (tm 1), so the cross-node link
#: is a real spatial one
PSDEF_NODES = PacketSizesDef(1, 1, 0, 2, 1, 1, 6144)
#: phase 2: SISO stream packets
PSDEF_STREAM = PacketSizesDef(1, 1, 0, 1, 0, 1, 6144)
TAP_DELAY = 3                     # samples of excess delay on the second tap
CHUNK = 2048                      # phase 2's sync chunk
NOISE_VAR = float(np.float32(10.0 ** (-15.0 / 10.0)))   # 15 dB
#: the noise generators' seeds, phase 1 and phase 2 (the JAX dry run's keys
#: PRNGKey(7) and PRNGKey(11))
NOISE_SEEDS = (7, 11)


def node_split(n_devices: int) -> tuple[int, int]:
    """(n_node, n_dp): 4 nodes when the device count allows, else 2, else 1."""
    n_node = 4 if n_devices % 4 == 0 else 2 if n_devices % 2 == 0 else 1
    return n_node, n_devices // n_node


def edge_channels(n_node: int, n_tx: int) -> np.ndarray:
    """H complex64 [N (tx node j), N (rx node i), A, 2 taps]: node j's TX
    antenna a reaches node i through H[j, i, a, tap], tap 1 TAP_DELAY
    samples late and 0.4 as strong (`__graft_entry__.py:99-105`)."""
    crng = np.random.default_rng(1)
    mag0 = crng.uniform(0.8, 1.0, (n_node, n_node, n_tx))
    ph = crng.uniform(0, 2 * np.pi, (2, n_node, n_node, n_tx))
    H = np.stack([mag0 * np.exp(1j * ph[0]),
                  0.4 * mag0 * np.exp(1j * ph[1])], axis=-1)
    return H.astype(np.complex64)


def _per_device(build, devices):
    """{device: build(device)} once a distinct device."""
    return {d: build(d) for d in dict.fromkeys(devices)}


def draw_loopback_noise(generator: torch.Generator, mesh2d: Mesh, B: int
                        ) -> list[torch.Tensor]:
    """Phase 1's noise: one unit-variance complex64 block [B / n_dp, 1,
    n_node * N_samples_packet] a shard, in the mesh's row-major order, on
    the shard's device."""
    n_node, n_dp = mesh2d.devices.shape
    n_pkt = get_packet_sizes(PSDEF_NODES).N_samples_packet
    return [draw_noise(generator, (B // n_dp, 1, n_node * n_pkt),
                       generator.device).to(d) for d in mesh2d.devices.flat]


def cross_node_loopback(mesh2d: Mesh, plcf, tb, H: np.ndarray,
                        noise: list[torch.Tensor]) -> dict:
    """Phase 1 over mesh2d ("node", "dp"): plcf uint8 [n_node, B, 40], tb
    uint8 [n_node, B, N_TB_bits] (numpy or tensors), H from `edge_channels`,
    noise from `draw_loopback_noise`. Returns "tb_ok" / "plcf1_ok" bool
    numpy [n_node, B] and "mine", each shard's received frame before the
    noise ([B / n_dp, 1, n_node * n_pkt], row-major over the mesh)."""
    n_node, n_dp = mesh2d.devices.shape
    plcf, tb = torch.as_tensor(plcf), torch.as_tensor(tb)
    B = plcf.shape[1]
    b_loc = B // n_dp
    n_pkt = get_packet_sizes(PSDEF_NODES).N_samples_packet
    devs = list(mesh2d.devices.flat)
    txs = _per_device(lambda d: build_tx(PSDEF_NODES, NID, 1, device=d), devs)
    rxs = _per_device(lambda d: build_rx(PSDEF_NODES, NID, 1, device=d), devs)
    Hs = _per_device(lambda d: torch.as_tensor(H, device=d), devs)

    contrib = {}
    for (k, dp), d in np.ndenumerate(mesh2d.devices):
        rows = slice(dp * b_loc, (dp + 1) * b_loc)
        flags = torch.zeros((b_loc,), dtype=torch.bool, device=d)
        iq = txs[d](plcf[k, rows].to(d), tb[k, rows].to(d), flags, flags)
        # TDM frame: node k transmits in slot k
        frame = torch.zeros((b_loc, iq.shape[1], n_node * n_pkt),
                            dtype=torch.complex64, device=d)
        frame[..., k * n_pkt:(k + 1) * n_pkt] = iq
        delayed = torch.nn.functional.pad(frame, (TAP_DELAY, 0))[..., :-TAP_DELAY]
        taps = torch.stack([frame, delayed], 2)                  # [B, A, 2, T]
        # this node's contribution to every receiver i through H[k, i]
        contrib[k, dp] = torch.einsum("iat,bats->ibs", Hs[d][k],
                                      taps)[:, :, None]          # [N, B, 1, T]
    mine = {}
    for dp in range(n_dp):                     # the ether: psum over "node"
        col = psum([contrib[k, dp] for k in range(n_node)], scatter_dim=0)
        for k in range(n_node):
            mine[k, dp] = col[k][0]                              # [B, 1, T]
    tb_ok = np.zeros((n_node, B), bool)
    plcf1_ok = np.zeros((n_node, B), bool)
    for i, ((k, dp), d) in enumerate(np.ndenumerate(mesh2d.devices)):
        y = mine[k, dp] + NOISE_VAR ** 0.5 * noise[i]
        other = (k + 1) % n_node          # decode the other node's slot
        out = rxs[d](y[..., other * n_pkt:(other + 1) * n_pkt], NOISE_VAR)
        rows = slice(dp * b_loc, (dp + 1) * b_loc)
        tb_ok[k, rows] = out["tb_ok"].cpu().numpy()
        plcf1_ok[k, rows] = out["plcf1_ok"].cpu().numpy()
    return {"tb_ok": tb_ok, "plcf1_ok": plcf1_ok,
            "mine": [mine[kd] for kd in np.ndindex(n_node, n_dp)]}


def stream_offsets(n_devices: int) -> list[int]:
    """Phase 2's three packets: mid-shard, straddling the middle shard
    boundary, near the stream's end (`__graft_entry__.py:166-168`)."""
    n_chunks = 2 * n_devices
    n_pkt0 = get_packet_sizes(PSDEF_STREAM).N_samples_packet
    return [CHUNK // 2, (n_chunks // 2) * CHUNK - n_pkt0 // 3,
            (n_chunks - 2) * CHUNK + CHUNK // 3]


def make_stream(plcf, tb, offs, T: int, noise: torch.Tensor,
                psdef: PacketSizesDef = PSDEF_STREAM) -> torch.Tensor:
    """Phase 2's stream [1, T] on noise's device: SISO packets of psdef
    (unit power) with plcf / tb at offs, plus AWGN at 15 dB from
    unit-variance noise [1, T]."""
    d = noise.device
    plcf, tb = torch.as_tensor(plcf).to(d), torch.as_tensor(tb).to(d)
    flags = torch.zeros((plcf.shape[0],), dtype=torch.bool, device=d)
    iq = build_tx(psdef, NID, 1, device=d)(plcf, tb, flags, flags)
    z = torch.zeros((1, T), dtype=torch.complex64, device=d)
    for i, off in enumerate(offs):
        z[:, off:off + iq.shape[-1]] = iq[i]
    return z + NOISE_VAR ** 0.5 * noise


def sharded_sync_decode(mesh1d: Mesh, stream: torch.Tensor, offs) -> dict:
    """Phase 2 over mesh1d ("t"): stream [1, CHUNK * 2 n_devices] searched
    by build_sync_sharded, deduplicated, and every hit decoded from the same
    stream by build_rx_stream on the mesh's first device. Returns "hits"
    (dedup_reports' dicts, in time order), "found" (their times), "tb_ok"
    (a hit's TB decoded), "packets_ok" (each of offs has a hit within +-2
    samples whose TB decoded) and "false_alarms" (the times of hits near
    no offset: at b = 1 noise grazes the default 0.25 gate about once in
    50,000 samples, and such a hit decodes nothing)."""
    n_chunks = 2 * mesh1d.shape["t"]
    T = CHUNK * n_chunks
    sync_sh = build_sync_sharded(1, 1, CHUNK, n_chunks, mesh1d)
    rep = sync_sh(stream)
    hits = dedup_reports({k: v.cpu().numpy() for k, v in rep.items()}, 1, 1)
    found = [h["t_global"] for h in hits]
    d0 = sync_sh.devices[0]
    tb_ok = np.zeros((0,), bool)
    if hits:
        rxs = build_rx_stream(PSDEF_STREAM, NID, 1, T, device=d0)
        t0s = torch.tensor(found, dtype=torch.int32, device=d0)
        cfos = torch.tensor([h["cfo"] for h in hits], dtype=torch.float32,
                            device=d0)
        y = stream.to(d0).expand(len(hits), *stream.shape)
        tb_ok = rxs(y, t0s, cfos, NOISE_VAR)["tb_ok"].cpu().numpy()
    near = [[i for i, f in enumerate(found) if abs(f - o) <= 2] for o in offs]
    packets_ok = all(len(n) == 1 and tb_ok[n[0]] for n in near)
    matched = {i for n in near for i in n}
    return {"hits": hits, "found": found, "tb_ok": tb_ok,
            "packets_ok": packets_ok,
            "false_alarms": [f for i, f in enumerate(found) if i not in matched]}


def dryrun_multichip(devices: list) -> dict:
    """Both phases over the given devices (n = len(devices); one may be
    listed several times): phase 1 on an (n_node, n_dp) mesh, phase 2 on
    an n-long "t" mesh. TB and PLCF bits come from numpy seed 0 as the JAX
    dry run draws them; the noise from torch.Generators on the first device
    (NOISE_SEEDS). Returns each phase's records and "ok"."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    n_node, n_dp = node_split(n)
    mesh2d = Mesh(np.array(devices, dtype=object).reshape(n_node, n_dp),
                  ("node", "dp"))
    ps = get_packet_sizes(PSDEF_NODES)
    B = 2 * n_dp                              # per-node batch, sharded over dp
    rng = np.random.default_rng(0)
    plcf = rng.integers(0, 2, (n_node, B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (n_node, B, ps.N_TB_bits)).astype(np.uint8)
    gen = torch.Generator(device=devices[0]).manual_seed(NOISE_SEEDS[0])
    p1 = cross_node_loopback(mesh2d, plcf, tb, edge_channels(n_node, ps.tm_mode.N_TX),
                             draw_loopback_noise(gen, mesh2d, B))

    offs = stream_offsets(n)
    T = CHUNK * 2 * n
    ps0 = get_packet_sizes(PSDEF_STREAM)
    plcf1 = rng.integers(0, 2, (len(offs), 40)).astype(np.uint8)
    tb1 = rng.integers(0, 2, (len(offs), ps0.N_TB_bits)).astype(np.uint8)
    gen.manual_seed(NOISE_SEEDS[1])
    stream = make_stream(plcf1, tb1, offs, T, draw_noise(gen, (1, T), devices[0]))
    p2 = sharded_sync_decode(Mesh(np.array(devices, dtype=object), ("t",)),
                             stream, offs)
    ok = bool(p1["tb_ok"].all() and p1["plcf1_ok"].all() and p2["packets_ok"])
    return {"n_devices": n, "distinct_devices": len(set(devices)),
            "n_node": n_node, "n_dp": n_dp, "phase1": p1, "phase2": p2,
            "offsets": offs, "ok": ok}


def summary(rec: dict) -> dict:
    """The JSON-able part of dryrun_multichip's records."""
    p1, p2 = rec["phase1"], rec["phase2"]
    return {k: rec[k] for k in ("n_devices", "distinct_devices", "n_node",
                                "n_dp", "offsets", "ok")} | {
        "phase1": {"tb_ok": p1["tb_ok"].tolist(),
                   "plcf1_ok": p1["plcf1_ok"].tolist()},
        "phase2": {"found": p2["found"], "tb_ok": p2["tb_ok"].tolist(),
                   "packets_ok": p2["packets_ok"],
                   "false_alarms": p2["false_alarms"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="mesh size (default: the visible cards; 8 on cpu)")
    ap.add_argument("--repeat-card", action="store_true",
                    help="list cuda:0 n times instead of n distinct cards")
    a = ap.parse_args(argv)
    if a.device == "cpu":
        devices = ["cpu"] * (a.n_devices or 8)
    elif a.repeat_card:
        devices = [torch.device("cuda", 0)] * (a.n_devices or 8)
    else:
        mesh = Mesh.cuda(a.n_devices or torch.cuda.device_count())
        devices = list(mesh.devices.flat)
    rec = dryrun_multichip(devices)
    print(json.dumps(summary(rec)), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
