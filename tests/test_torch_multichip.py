"""The port's device mesh and multi-device dry run against the JAX package's
(`__graft_entry__.py::dryrun_multichip`).

Phase 1 (`cross_node_loopback`) runs on a 4 x 1 ("node", "dp") mesh of the
CPU fed JAX's AWGN draws, re-derived from the dry run's keys
(fold_in(fold_in(PRNGKey(7), node), dp), split as channels.awgn splits
it), and is held to the same phase composed of JAX's build_tx / awgn /
build_rx on one device with numpy superposition: equal tb_ok / plcf1_ok,
the received frames within 1e-5. Phase 2 (`sharded_sync_decode`) on the
stream the JAX dry run makes finds JAX's hits and decodes every TB. A
fresh interpreter runs the CLI and shows that the port loads no jax.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from dectnrp_tpu.phy.rx import build_rx as jax_build_rx
from dectnrp_tpu.phy.sync_sharded import build_sync_sharded as jax_sync_sharded
from dectnrp_tpu.phy.sync_sharded import dedup_reports as jax_dedup
from dectnrp_tpu.phy.tx import build_tx as jax_build_tx
from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu.simulation.channels import awgn as jax_awgn
from dectnrp_tpu_torch import multichip as M
from dectnrp_tpu_torch.common.mesh import Mesh, ppermute, psum

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
NV = np.float32(10.0 ** (-15.0 / 10.0))


def cpu_mesh(shape, axes):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


# ---- the mesh and its collectives

def test_mesh_shape_and_devices_along():
    m = cpu_mesh((4, 2), ("node", "dp"))
    assert m.shape == {"node": 4, "dp": 2}
    assert m.devices_along("node", 1) == [torch.device("cpu")] * 4
    assert m.devices_along("dp", (3,)) == [torch.device("cpu")] * 2
    assert cpu_mesh((3,), ("t",)).devices_along("t") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="other axes"):
        m.devices_along("node")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 4, dtype=object), ("a", "b"))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("a", "a"))


def test_mesh_cuda_takes_distinct_cards_or_raises():
    """Mesh.cuda(n) never repeats a card and never falls back to the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{have} CUDA device"):
        Mesh.cuda(have + 1)


def test_ppermute_and_psum():
    """ppermute: shard dst gets blocks[src], unnamed shards zeros; psum:
    every shard the sum in shard order, with scatter_dim its own slice."""
    blocks = [torch.full((4, 3), float(i + 1)) for i in range(4)]
    ring = ppermute(blocks, [((i + 1) % 4, i) for i in range(4)])
    assert [int(b[0, 0]) for b in ring] == [2, 3, 4, 1]
    assert ppermute(blocks, [(0, 1)])[0].abs().sum() == 0
    with pytest.raises(ValueError, match="receives twice"):
        ppermute(blocks, [(0, 1), (2, 1)])
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
          for _ in range(4)]
    full = psum(xs)
    want = xs[0] + xs[1] + xs[2] + xs[3]
    assert all(torch.equal(f, want) for f in full)
    assert full[0] is not xs[0] and not torch.equal(xs[0], want)
    sc = psum(xs, scatter_dim=0)
    assert all(torch.equal(s, want[2 * i:2 * i + 2]) for i, s in enumerate(sc))
    with pytest.raises(ValueError, match="not a multiple"):
        psum(xs, scatter_dim=1)


def test_node_split():
    assert [M.node_split(n) for n in (8, 4, 6, 2, 3, 1)] == [
        (4, 2), (4, 1), (2, 3), (2, 1), (1, 3), (1, 1)]


# ---- phase 1: the cross-node TDM loopback

def jax_phase1(plcf, tb, H, n_node, n_dp):
    """__graft_entry__.py's phase 1, composed of JAX's modules on one
    device with numpy superposition; returns (tb_ok, plcf1_ok, mine, the
    port's noise blocks re-derived from the same keys)."""
    psdef = PacketSizesDef(1, 1, 0, 2, 1, 1, 6144)      # M.PSDEF_NODES
    ps = get_packet_sizes(psdef)
    n_pkt, A = ps.N_samples_packet, ps.tm_mode.N_TX
    tx = jax_build_tx(psdef, M.NID, 1)
    rx = jax_build_rx(psdef, M.NID, 1)
    B = plcf.shape[1]
    bl = B // n_dp
    T_len = n_node * n_pkt
    contrib = np.zeros((n_node, n_node, B, T_len), np.complex128)
    for k in range(n_node):
        fl = jnp.zeros((B,), bool)
        iq = np.asarray(tx(jnp.asarray(plcf[k]), jnp.asarray(tb[k]), fl, fl))
        frame = np.zeros((B, A, T_len), np.complex64)
        frame[..., k * n_pkt:(k + 1) * n_pkt] = iq
        delayed = np.pad(frame, ((0, 0), (0, 0), (M.TAP_DELAY, 0)))[..., :-M.TAP_DELAY]
        taps = np.stack([frame, delayed], 2)
        contrib[k] = np.sum(H[k][:, None, :, :, None] * taps[None], axis=(2, 3))
    ether = contrib.sum(0)                                 # [N (rx), B, T]
    tb_ok = np.zeros((n_node, B), bool)
    plcf1_ok = np.zeros((n_node, B), bool)
    mine, noise = [], []
    for k in range(n_node):
        for dp in range(n_dp):
            m = ether[k, dp * bl:(dp + 1) * bl, None].astype(np.complex64)
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), k), dp)
            k1, k2 = jax.random.split(key)
            n = np.asarray(jax.random.normal(k1, m.shape)) \
                + 1j * np.asarray(jax.random.normal(k2, m.shape))
            noise.append(torch.from_numpy((n / np.sqrt(2.0)).astype(np.complex64)))
            y = jax_awgn(key, jnp.asarray(m), NV)
            other = (k + 1) % n_node
            out = rx(y[..., other * n_pkt:(other + 1) * n_pkt], NV)
            tb_ok[k, dp * bl:(dp + 1) * bl] = np.asarray(out["tb_ok"])
            plcf1_ok[k, dp * bl:(dp + 1) * bl] = np.asarray(out["plcf1_ok"])
            mine.append(m)
    return tb_ok, plcf1_ok, mine, noise


def test_cross_node_loopback_matches_jax():
    n_node, n_dp = 4, 1
    ps = get_packet_sizes(PacketSizesDef(1, 1, 0, 2, 1, 1, 6144))
    B = 2 * n_dp
    rng = np.random.default_rng(0)
    plcf = rng.integers(0, 2, (n_node, B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (n_node, B, ps.N_TB_bits)).astype(np.uint8)
    H = M.edge_channels(n_node, ps.tm_mode.N_TX)
    tb_j, p1_j, mine_j, noise = jax_phase1(plcf, tb, H, n_node, n_dp)
    got = M.cross_node_loopback(cpu_mesh((n_node, n_dp), ("node", "dp")),
                                plcf, tb, H, noise)
    np.testing.assert_array_equal(got["tb_ok"], tb_j)
    np.testing.assert_array_equal(got["plcf1_ok"], p1_j)
    assert tb_j.all() and p1_j.all()
    for m_t, m_j in zip(got["mine"], mine_j):
        np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-5, rtol=0)


def test_edge_channels_are_the_dry_runs():
    """H from numpy seed 1, as __graft_entry__.py:99-105 draws it."""
    crng = np.random.default_rng(1)
    mag0 = crng.uniform(0.8, 1.0, (4, 4, 2))
    ph = crng.uniform(0, 2 * np.pi, (2, 4, 4, 2))
    want = np.stack([mag0 * np.exp(1j * ph[0]), 0.4 * mag0 * np.exp(1j * ph[1])],
                    axis=-1).astype(np.complex64)
    np.testing.assert_array_equal(M.edge_channels(4, 2), want)


# ---- phase 2: the sharded sync over one stream, then decode

def test_sharded_sync_decode_matches_jax():
    """A stream made as the JAX dry run makes phase 2's (JAX's TX at its
    offsets, awgn with key 11), over 4 shards:
    the port's hits are JAX's build_sync_sharded + dedup_reports hits, each
    offset found within +-2, every TB decoded, no other hit."""
    n_dev = 4
    offs = M.stream_offsets(n_dev)
    T_len = M.CHUNK * 2 * n_dev
    psdef0 = PacketSizesDef(1, 1, 0, 1, 0, 1, 6144)
    ps0 = get_packet_sizes(psdef0)
    rng = np.random.default_rng(5)
    plcf = jnp.asarray(rng.integers(0, 2, (len(offs), 40)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (len(offs), ps0.N_TB_bits)), jnp.uint8)
    fl = jnp.zeros((len(offs),), bool)
    iq = jax_build_tx(psdef0, M.NID, 1)(plcf, tb, fl, fl)
    z = jnp.zeros((1, T_len), jnp.complex64)
    for i, off in enumerate(offs):
        z = jax.lax.dynamic_update_slice_in_dim(z, iq[i], off, axis=-1)
    stream = jax_awgn(jax.random.PRNGKey(11), z, NV)
    jrep = jax_sync_sharded(1, 1, M.CHUNK, 2 * n_dev,
                            JMesh(np.array(jax.devices()[:n_dev]), ("t",)))(stream)
    jhits = jax_dedup({k: np.asarray(v) for k, v in jrep.items()}, 1, 1)
    got = M.sharded_sync_decode(cpu_mesh((n_dev,), ("t",)),
                                torch.from_numpy(np.array(stream)), offs)
    assert [h["t_global"] for h in got["hits"]] == [h["t_global"] for h in jhits]
    assert [h["n_eff_tx"] for h in got["hits"]] == [h["n_eff_tx"] for h in jhits]
    np.testing.assert_allclose([h["cfo"] for h in got["hits"]],
                               [h["cfo"] for h in jhits], atol=1e-5)
    assert got["found"] == sorted(got["found"]) == [h["t_global"] for h in jhits]
    assert got["packets_ok"] and got["tb_ok"].shape == (3,) and got["tb_ok"].all()
    assert got["false_alarms"] == []


def test_sharded_sync_decode_reports_false_alarms():
    """A hit near no packet (noise grazing the gate, here a lone STF) is a
    false alarm: recorded, its TB not decoded, and the packets still ok;
    a packet not found fails the phase."""
    from dectnrp_tpu_torch.phy.sync import stf_time_template

    n_dev = 2
    offs = M.stream_offsets(n_dev)
    T_len = M.CHUNK * 2 * n_dev
    rng = np.random.default_rng(3)
    plcf = rng.integers(0, 2, (3, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (3, 32)).astype(np.uint8)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn((1, T_len), dtype=torch.complex64, generator=g)
    y = M.make_stream(plcf, tb, offs, T_len, noise)
    stf = torch.from_numpy(stf_time_template(1, 1, 1)) * 112 ** 0.5
    lone = 3 * M.CHUNK + 600        # in the one chunk that holds no packet
    y[:, lone:lone + 112] += stf
    mesh = cpu_mesh((n_dev,), ("t",))
    got = M.sharded_sync_decode(mesh, y, offs)
    assert got["packets_ok"] and len(got["found"]) == 4, got["found"]
    assert got["false_alarms"] == [f for f in got["found"]
                                   if min(abs(f - o) for o in offs) > 2]
    assert len(got["false_alarms"]) == 1 and abs(got["false_alarms"][0] - lone) <= 2
    assert got["tb_ok"].sum() == 3
    assert not M.sharded_sync_decode(mesh, y, offs + [T_len - 900])["packets_ok"]


def test_dryrun_multichip_on_8_cpu_shards():
    """The whole dry run on 8 shards of the CPU: 4 nodes x 2 dp, every TB
    and PLCF of phase 1, all three phase-2 packets found and decoded."""
    rec = M.dryrun_multichip(["cpu"] * 8)
    assert (rec["n_node"], rec["n_dp"], rec["distinct_devices"]) == (4, 2, 1)
    assert rec["phase1"]["tb_ok"].shape == (4, 4)
    assert rec["ok"], M.summary(rec)
    json.dumps(M.summary(rec))


def test_multichip_cli_runs_without_jax():
    """python -m dectnrp_tpu_torch.multichip --device cpu --n-devices 4 in a
    fresh interpreter: rc 0, ok, and neither jax nor the JAX package
    loaded."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["multichip", "--device", "cpu", "--n-devices", "4"]
        try:
            runpy.run_module("dectnrp_tpu_torch.multichip", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "jax" not in sys.modules, "the port loaded jax"
        assert "dectnrp_tpu" not in sys.modules, "the port loaded the JAX package"
        print("JAX_FREE_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "JAX_FREE_OK"
    rec = json.loads(lines[-2])
    assert rec["ok"] and rec["n_devices"] == 4 and rec["n_node"] == 4
