"""The runtime's resampler front end on radios at 1.92 Ms/s, on the CPU:
its counters (`runtime.pump_steps`, `runtime.pump_skipped_steps`,
`runtime.dbuf_ring_bytes`, `runtime.dbuf_slide_bytes`) and span
(`runtime.tx_resample`) against what the runtime did, and none of them
touched at the DECT rate; the DECT-rate ring after it has wrapped, and held
to the JAX runtime's sliding buffer (the oracle) over seeded appends; the
three-radio p2p scenario of the benchmark's
`p2p_u1b1_sdr` configuration, whose FT sent every other beacon behind its
radio's write head with 5,120-sample front-end steps; and the port's
resamplers against the benchmark's plain reference
(`benchmark/phyref/phy/resampler.py`)."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dectnrp_tpu.upper.runtime import NodeRuntime as JaxNodeRuntime
from dectnrp_tpu_torch import config as C
from dectnrp_tpu_torch.common import trace
from dectnrp_tpu_torch.phy.resampler import (ResamplerPlan, build_resampler,
                                             build_resampler_stream)
from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator, SimDriver
from dectnrp_tpu_torch.sections.part4.identity import Identity
from dectnrp_tpu_torch.simulation.topology import Position, Trajectory
from dectnrp_tpu_torch.simulation.vspace import VNodeConfig, VSpaceConfig
from dectnrp_tpu_torch.upper.p2p import AssocState
from dectnrp_tpu_torch.upper.runtime import NodeRuntime
from dectnrp_tpu_torch.upper.tpoint import Tpoint
from test_torch_radio_sim import _windows

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "benchmark" / "configs"
NET = 0x12345678
FRONT_END = ("runtime.pump_steps", "runtime.pump_skipped_steps",
             "runtime.dbuf_slide_bytes", "runtime.dbuf_ring_bytes",
             "span.runtime.tx_resample.calls")


def _delta(c0: dict) -> dict:
    c1 = trace.counters()
    return {k: c1[k] - c0[k] for k in FRONT_END}


def _listening_node(rate: int, ring: int, n_ant: int = 1):
    """One radio on noise and a runtime that only listens."""
    hw = HwSimulator(n_ant, rx_ring_len=ring)
    drv = SimDriver(VSpaceConfig(samp_rate=float(rate), spp_len=2048,
                                 noise_var=1e-8),
                    [hw], [VNodeConfig(n_ant, Trajectory(Position(0, 0, 0)))],
                    "cpu")
    return drv, NodeRuntime(hw, Tpoint(), NET, device="cpu")


def test_front_end_counts_its_steps_and_slides():
    """A DECT-rate ring of 8,192 samples takes steps of 1,152 over 24
    ticks and wraps: the counters follow every step and every append (2 A
    n 8 bytes, nothing slid), and every window of the ring, at both edges
    and across the wrap, is the concatenated step outputs bit for bit."""
    drv, rt = _listening_node(1_920_000, 8192)
    outs, grew = [], []
    step, push = rt._rx_step, rt._dbuf.push

    def kept_step(x, hist):
        y, h = step(x, hist)
        outs.append(y.numpy().copy())
        return y, h

    def counted_push(y):
        c = trace.counters()["runtime.dbuf_ring_bytes"]
        push(y)
        grew.append((trace.counters()["runtime.dbuf_ring_bytes"] - c,
                     2 * y.shape[0] * y.shape[-1] * 8))
    rt._rx_step, rt._dbuf.push = kept_step, counted_push
    c0 = trace.counters()
    for _ in range(24):
        drv.tick()
        rt.process()
    d = _delta(c0)
    assert rt.front_end_steps == len(outs) == len(grew) == 24 * 2048 // 1280
    assert d["runtime.pump_steps"] == rt.front_end_steps
    assert d["runtime.pump_skipped_steps"] == 0
    assert all(got == want > 0 for got, want in grew)
    assert d["runtime.dbuf_ring_bytes"] == sum(want for _, want in grew)
    assert d["runtime.dbuf_slide_bytes"] == 0
    allout = np.concatenate(outs, -1)
    cap, lo, hi = 8192, rt._dbuf.start, rt._dect_time_passed
    assert hi == allout.shape[-1] > 3 * cap and lo == hi - cap
    for t0, m in _windows(lo, hi, cap, outs[-1].shape[-1]):
        np.testing.assert_array_equal(rt._get_stream(t0, m),
                                      allout[:, t0:t0 + m])
    assert rt.stats.chunks > 0


# appends into a DECT-rate buffer of capacity C: n > 0 the step outputs of
# a front end, ("z", n) an overrun skip's n zeros
DBUF_APPENDS = {
    "divides": (1024, [256] * 11),
    "not_divides": (1000, [300, 7, 256, 999, 1, 512, 300, 300, 433]),
    "one": (64, [1] * 70 + [3, 1]),
    "cap_minus_1": (500, [499, 499, 1, 499, 3, 499]),
    "zero_fill_cap": (768, [100, ("z", 768), 5, 768, 333, ("z", 768), 40]),
    "zero_fill_over": (768, [100, ("z", 2000), 300, ("z", 769), 7, ("z", 5),
                             ("z", 3 * 768 + 11), 1]),
}


@pytest.mark.parametrize("n_ant", [1, 2])
@pytest.mark.parametrize("case", sorted(DBUF_APPENDS))
def test_dect_ring_matches_the_sliding_buffer(case, n_ant):
    """The runtime's DECT-rate ring against the JAX runtime's sliding buffer
    (its `_append_dect` / `_get_stream` on a bare object, the oracle) over
    one seeded sequence of appends and zero-fills: the same times after
    every append, the same samples in every window, the same refusal, word
    for word, one sample outside."""
    cap, appends = DBUF_APPENDS[case]
    rng = np.random.default_rng(cap + n_ant)
    _, rt = _listening_node(1_920_000, cap, n_ant)
    j = SimpleNamespace(plan_tx=rt.plan_tx, _dbuf_time=0, _dbuf_filled=0,
                        _dbuf=np.zeros((n_ant, cap), np.complex64))
    for a in appends:
        if isinstance(a, tuple):
            n = a[1]
            x = np.zeros((n_ant, n), np.complex64)
            rt._dbuf.skip(n)
        else:
            n = a
            x = (rng.standard_normal((n_ant, n))
                 + 1j * rng.standard_normal((n_ant, n))).astype(np.complex64)
            rt._dbuf.push(x)
        JaxNodeRuntime._append_dect(j, x)
        lo, hi = rt._dbuf.start, rt._dect_time_passed
        assert (lo, hi) == (j._dbuf_time, j._dbuf_time + j._dbuf_filled)
        for t0, m in _windows(lo, hi, cap, n):
            np.testing.assert_array_equal(
                rt._get_stream(t0, m), JaxNodeRuntime._get_stream(j, t0, m))
        m = min(n, cap)
        np.testing.assert_array_equal(rt._get_stream(hi - m, m), x[:, -m:])
        for t0, m in ((lo - 1, 2), (hi - 1, 2)):
            with pytest.raises(AssertionError) as mine:
                rt._get_stream(t0, m)
            with pytest.raises(AssertionError) as theirs:
                JaxNodeRuntime._get_stream(j, t0, m)
            assert str(mine.value) == str(theirs.value)
    assert rt._dbuf.start > 0                # the ring filled and wrapped


def test_dect_rate_touches_no_front_end_counter():
    sc = C.load_scenario(CONFIGS / "p2p_u1b1")
    run = C.build_scenario(sc, "cpu")
    c0 = trace.counters()
    run.run_ticks(40)
    assert all(rt.plan_tx.identity for rt in run.runtimes)
    assert sum(rt.stats.tx_packets for rt in run.runtimes) > 0
    assert _delta(c0) == dict.fromkeys(FRONT_END, 0)


def test_p2p_u1b1_sdr_associates_and_sends_on_time():
    """Three radios at 1.92 Ms/s: both PTs associate, no node schedules a
    burst behind its radio's write head, both PTs hear every beacon of the
    next three periods, and every burst goes through the TX resampler."""
    sc = C.load_scenario(CONFIGS / "p2p_u1b1_sdr")
    assert sc.radio.samp_rate == 1_920_000.0
    sc.radio.sim_seed = 2 ** 31 + 101
    run = C.build_scenario(sc, "cpu")
    pts = [f for f in run.firmwares if f.NAME == "p2p_pt"]
    ft = next(f for f in run.firmwares if f.NAME == "p2p_ft")
    c0 = trace.counters()
    for tick in range(200):
        run.tick()
        if all(p.state is AssocState.ASSOCIATED for p in pts):
            break
    assert all(p.state is AssocState.ASSOCIATED for p in pts), tick
    sent, heard = ft.stats["beacons"], [p.stats["beacons"] for p in pts]
    run.run_ticks(3 * 25 // 2 + 2)           # three beacon periods of 12.5 ticks
    assert ft.stats["beacons"] - sent == 3
    # the FT counts a beacon a prepare time before its air time
    assert all(p.stats["beacons"] - h >= 2 for p, h in zip(pts, heard))
    assert all(p.stats["beacons"] >= ft.stats["beacons"] - 1 for p in pts)
    assert [rt.stats.tx_late for rt in run.runtimes] == [0, 0, 0]
    d = _delta(c0)
    assert d["runtime.pump_steps"] == sum(rt.front_end_steps
                                          for rt in run.runtimes)
    assert d["runtime.pump_skipped_steps"] == 0
    assert d["span.runtime.tx_resample.calls"] == sum(
        rt.stats.tx_packets for rt in run.runtimes) > 0


# --------------------------------------------- against the plain reference

@pytest.fixture(scope="module")
def ref():
    from benchmark.phyref.phy import resampler
    return resampler


def _cplx(gen, *shape):
    return torch.complex(torch.randn(*shape, generator=gen),
                         torch.randn(*shape, generator=gen))


@pytest.mark.parametrize("LM", [(9, 10), (27, 40)])
def test_stream_chain_equals_reference(ref, LM):
    """Eight chained front-end steps of the port against the reference's
    steps (bit for bit: on the CPU both run the same plain FIR, and the
    history handed on is a slice of the input) and against the reference
    run as one stream from the first history (float32 sums of the taps in
    the einsum's order over other frame counts: within 1e-6 of the
    largest output)."""
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    L, M = LM
    plan, chunk = ResamplerPlan(L, M), 16 * M
    port = build_resampler_stream(plan, chunk, device="cpu")
    mine = ref.build_resampler_stream(ref.ResamplerPlan(L, M), chunk, device="cpu")
    one = ref.build_resampler_stream(ref.ResamplerPlan(L, M), 8 * chunk,
                                     device="cpu")
    assert (port.H, port.n_out) == (mine.H, mine.n_out)
    x = _cplx(gen, 2, 8 * chunk)
    h0 = _cplx(gen, 2, port.H)
    hp = hr = h0
    ys = []
    for k in range(8):
        xk = x[:, k * chunk:(k + 1) * chunk]
        yp, hp = port(xk, hp)
        yr, hr = mine(xk, hr)
        assert torch.equal(yp, yr) and torch.equal(hp, hr), k
        ys.append(yp)
    y1, h1 = one(x, h0)
    torch.testing.assert_close(torch.cat(ys, -1), y1, rtol=0,
                               atol=1e-6 * float(y1.abs().max()))
    assert torch.equal(hp, h1)


@pytest.mark.parametrize("LM,n_in", [((10, 9), 720), ((10, 9), 1377),
                                     ((40, 27), 540)])
def test_tx_resampler_equals_reference(ref, LM, n_in):
    """A TX burst through the port's Resampler and the reference's, bit for
    bit (the same plain FIR on the CPU)."""
    gen = torch.Generator().manual_seed(2 ** 31 + 9)
    L, M = LM
    x = _cplx(gen, 1, n_in)
    port = build_resampler(ResamplerPlan(L, M), n_in, device="cpu")
    mine = ref.build_resampler(ref.ResamplerPlan(L, M), n_in, device="cpu")
    assert torch.equal(port(x), mine(x))
    assert torch.equal(port.G, mine.G)
