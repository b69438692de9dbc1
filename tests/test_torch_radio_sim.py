"""The port's radio layer against the JAX package's (tests/test_radio_sim.py
mirrored): gain LUT interpolation, hw rate negotiation and timed commands
(copies: both packages give the same answers), the simulator's RX ring
(the port's mirrored ring held to JAX's sliding window; the ring's
zero-fill, which the runtime's DECT-rate ring uses), and one packet
over the air between two simulated nodes: the port's ether on JAX's draws
hands node 1 the ring JAX's does, and both decode it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.radio import gain_lut as Jg, hw as Jh, hw_simulator as Js
from dectnrp_tpu.simulation import topology as Jtop, vspace as Jv
from dectnrp_tpu_torch.radio import gain_lut as Tg, hw as Th, hw_simulator as Ts
from dectnrp_tpu_torch.simulation import topology as Ttop, vspace as Tv
from test_torch_vspace import jax_tick_draws

torch.set_num_threads(1)
NID = 0x12345678
PKGS = pytest.mark.parametrize("g,h,s", [(Jg, Jh, Js), (Tg, Th, Ts)],
                               ids=["jax", "torch"])


@PKGS
def test_gain_lut_simulator(g, h, s):
    lut = g.GainLut(g.CAL_SIMULATOR)
    apg = lut.get_achievable_power_gain_tx(-10.0, 1.9e9)
    assert abs(apg.gain_db - 30.0) <= 0.5
    assert abs(apg.power_dbm - (-10.0)) <= 0.5
    apg_rx = lut.get_achievable_power_gain_rx(-30.0, 1.9e9)
    assert 0.0 <= apg_rx.gain_db <= 70.0
    want = Jg.GainLut(Jg.CAL_SIMULATOR).get_achievable_power_gain_rx(-30.0, 1.9e9)
    assert (apg_rx.gain_db, apg_rx.power_dbm) == (want.gain_db, want.power_dbm)


@PKGS
def test_hw_rate_negotiation(g, h, s):
    hw = h.Hw("test")
    assert hw.set_samp_rate(1_728_000) == 1_728_000
    assert hw.set_samp_rate(1_800_000) == 1_920_000
    assert hw.set_samp_rate(28_000_000) == 30_720_000


@PKGS
def test_hw_timed_commands(g, h, s):
    hw = h.Hw("test")
    hw.set_command_time(1000)
    hw.set_freq_tc(1.9e9)
    hw.apply_due_commands(500)
    assert hw.freq_hz == 0.0
    hw.apply_due_commands(1000)
    assert hw.freq_hz == 1.9e9


def test_two_node_packet_over_the_air():
    """A packet scheduled at tx_time on node 0 arrives at node 1's RX ring
    at the same global sample count, path-loss scaled, and decodes; the
    port's ring (on JAX's draws) equals JAX's within 1e-6 abs / 1e-5 rel
    and the port's RX decodes the same TB."""
    from dectnrp_tpu.phy.rx import build_rx as j_rx
    from dectnrp_tpu.phy.tx import build_tx as j_tx
    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
    from dectnrp_tpu_torch.phy.rx import build_rx as t_rx
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef as TPs

    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    ps = get_packet_sizes(psdef)
    rate, spp, d_m, nv = 1_728_000.0, 512, 5.0, 1e-9

    def driver(v, top, s, **kw):
        hws = [s.HwSimulator(1), s.HwSimulator(1)]
        cfg = v.VSpaceConfig(samp_rate=rate, spp_len=spp, freq_hz=1.9e9,
                             noise_var=nv)
        nodes = [v.VNodeConfig(1, top.Trajectory(top.Position(0, 0, 0))),
                 v.VNodeConfig(1, top.Trajectory(top.Position(d_m, 0, 0)))]
        return hws, s.SimDriver(cfg, hws, nodes, **kw)

    rng = np.random.default_rng(0)
    plcf = jnp.asarray(rng.integers(0, 2, (1, 40)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (1, ps.N_TB_bits)), jnp.uint8)
    fl = jnp.zeros((1,), bool)
    iq = np.asarray(j_tx(psdef, NID, 1)(plcf, tb, fl, fl))[0]     # [1, n]
    tx_time = 1000
    end = tx_time + iq.shape[1] + spp
    g = 10 ** (-Jtop.fspl_db(d_m, 1.9e9) / 20)

    hws_j, drv_j = driver(Jv, Jtop, Js)
    hws_j[0].tx_schedule(tx_time, iq)
    drv_j.run_until(end)
    hws_t, drv_t = driver(Tv, Ttop, Ts, device="cpu")
    hws_t[0].tx_schedule(tx_time, iq)
    while drv_t.now < end:
        drv_t.tick(jax_tick_draws(0, drv_t.now, 2, 1, spp, noise_var=nv))

    rx_j = hws_j[1].get_rx_stream(tx_time, iq.shape[1])
    rx_t = hws_t[1].get_rx_stream(tx_time, iq.shape[1])
    np.testing.assert_allclose(rx_t, rx_j, atol=1e-6, rtol=1e-5)
    out_j = j_rx(psdef, NID, 1)(jnp.asarray((rx_j / g)[None]), jnp.float32(nv / g ** 2))
    out_t = t_rx(TPs(1, 1, 0, 2, 0, 2, 6144), NID, 1, device="cpu")(
        torch.from_numpy((rx_t / g)[None]), torch.tensor(np.float32(nv / g ** 2)))
    assert bool(out_j["tb_ok"][0]) and bool(out_t["tb_ok"][0])
    np.testing.assert_array_equal(out_t["tb"][0].numpy(), np.asarray(tb[0]))
    np.testing.assert_array_equal(np.asarray(out_j["tb"][0]), np.asarray(tb[0]))
    # node 0 hears nothing of its own TX (no leakage configured)
    own = hws_t[0].get_rx_stream(tx_time, iq.shape[1])
    assert np.mean(np.abs(own) ** 2) < 1e-6


@PKGS
def test_rx_ring_sliding_window(g, h, s):
    hw = s.HwSimulator(1, rx_ring_len=1024)
    for i in range(8):
        hw.push_rx_spp(np.full((1, 256), i, np.complex64))
    assert hw.rx_time == 4 * 256
    blk = hw.get_rx_stream(4 * 256, 256)
    assert np.all(blk == 4)


RING_PUSHES = {
    # capacity, push lengths (and the seed of their samples)
    "divides": (1024, [256] * 11),
    "not_divides": (1000, [300, 7, 256, 999, 1, 512, 300, 300, 433]),
    "whole_capacity": (768, [100, 768, 5, 768, 333, 768]),
}


def _windows(lo: int, hi: int, cap: int, n: int) -> list[tuple[int, int]]:
    """Windows of [lo, hi): at the oldest edge, at the newest edge, the
    whole span and, where a multiple of the capacity lies inside, across
    the port's wrap point."""
    m = min(n, hi - lo, 37)
    out = [(lo, m), (hi - m, m), (lo, hi - lo)]
    k = hi // cap * cap
    if lo < k < hi:
        out += [(max(lo, k - 5), min(hi, k + 5) - max(lo, k - 5)), (k, hi - k)]
    return out


@pytest.mark.parametrize("case", sorted(RING_PUSHES))
def test_rx_ring_matches_the_sliding_window(case):
    """The port's mirrored ring against JAX's sliding window (the oracle)
    over one seeded sequence of pushes: the same times after every push,
    the same samples in every window, the same refusals outside."""
    cap, lengths = RING_PUSHES[case]
    rng = np.random.default_rng(cap)
    j, t = Js.HwSimulator(2, rx_ring_len=cap), Ts.HwSimulator(2, rx_ring_len=cap)
    for n in lengths:
        x = (rng.standard_normal((2, n))
             + 1j * rng.standard_normal((2, n))).astype(np.complex64)
        j.push_rx_spp(x)
        t.push_rx_spp(x)
        assert (t.rx_time, t.rx_time_passed) == (j.rx_time, j.rx_time_passed)
        lo, hi = t.rx_time, t.rx_time_passed
        for t0, m in _windows(lo, hi, cap, n):
            np.testing.assert_array_equal(t.get_rx_stream(t0, m),
                                          j.get_rx_stream(t0, m))
        np.testing.assert_array_equal(t.get_rx_stream(hi - n, n), x)
        for t0, m in ((lo - 1, 2), (hi - 1, 2)):
            for hw in (j, t):
                with pytest.raises(AssertionError):
                    hw.get_rx_stream(t0, m)
    assert t.rx_time > 0                     # the ring filled and wrapped


def test_rx_ring_counts_its_bytes():
    """`sim.rx_ring_bytes` grows by 2 A n 8 a push, before and after the
    ring fills: a push never costs the ring's capacity."""
    from dectnrp_tpu_torch.common import trace

    hw = Ts.HwSimulator(2, rx_ring_len=1000)
    for n in (300, 700, 300, 999, 0):
        c0 = trace.counters()["sim.rx_ring_bytes"]
        hw.push_rx_spp(np.ones((2, n), np.complex64))
        assert trace.counters()["sim.rx_ring_bytes"] - c0 == 2 * 2 * n * 8
    with pytest.raises(AssertionError):
        hw.push_rx_spp(np.ones((2, 1001), np.complex64))


@pytest.mark.parametrize("n", [999, 1000, 2501])
def test_ring_zero_fill_writes_at_most_its_capacity(n):
    """The shared ring's `skip` (an overrun's zero-fill, which the runtime's
    DECT-rate ring uses and the simulator does not): the time advances by n,
    the newest min(n, C) samples read as zeros, what is still held of the
    older ones is unmoved, and it writes 2 A min(n, C) 8 bytes."""
    from dectnrp_tpu_torch.common import trace
    from dectnrp_tpu_torch.common.ring import MirroredRing

    cap = 1000
    ring = MirroredRing(2, cap, "runtime.dbuf_ring_bytes")
    x = np.arange(2 * 1300, dtype=np.float32).reshape(2, 1300).astype(np.complex64)
    ring.push(x[:, :700])
    ring.push(x[:, 700:])
    c0 = trace.counters()["runtime.dbuf_ring_bytes"]
    ring.skip(n)
    assert trace.counters()["runtime.dbuf_ring_bytes"] - c0 \
        == 2 * 2 * min(n, cap) * 8
    assert (ring.start, ring.end) == (1300 + n - cap, 1300 + n)
    m = min(n, cap)
    assert not ring.window(ring.end - m, m).any()
    if n < cap:
        np.testing.assert_array_equal(ring.window(ring.start, cap - n),
                                      x[:, n - cap:])
    with pytest.raises(AssertionError):
        ring.window(ring.start - 1, 1)


def test_sim_driver_moves_the_ether_to_its_device():
    """SimDriver hands its device to the ether and to every radio."""
    hws = [Ts.HwSimulator(1), Ts.HwSimulator(2)]
    drv = Ts.SimDriver(Tv.VSpaceConfig(1_728_000.0, 256), hws, device="cpu")
    assert drv.vspace.device == torch.device("cpu")
    assert all(h.device == torch.device("cpu") for h in hws)
    drv.tick()
    assert [h.rx_time_passed for h in hws] == [256, 256]
