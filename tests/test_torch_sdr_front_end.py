"""The runtime's front end (`NodeRuntime.front_end`) on the CPU: its two
forms at 1.728 and 1.92 Ms/s; the resampled form's clock mappings and
firmware view held to the JAX runtime's; on radios at 1.92 Ms/s its
counters (`runtime.pump_steps`, `runtime.pump_skipped_steps`,
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
from dectnrp_tpu_torch.upper.runtime import (IdentityFrontEnd, NodeRuntime,
                                              ResampledFrontEnd)
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
    fe = rt.front_end
    outs, grew = [], []
    step, push = fe.step, fe.ring.push

    def kept_step(x, hist):
        y, h = step(x, hist)
        outs.append(y.numpy().copy())
        return y, h

    def counted_push(y):
        c = trace.counters()["runtime.dbuf_ring_bytes"]
        push(y)
        grew.append((trace.counters()["runtime.dbuf_ring_bytes"] - c,
                     2 * y.shape[0] * y.shape[-1] * 8))
    fe.step, fe.ring.push = kept_step, counted_push
    c0 = trace.counters()
    for _ in range(24):
        drv.tick()
        rt.process()
    d = _delta(c0)
    assert fe.steps == len(outs) == len(grew) == 24 * 2048 // 1280
    assert d["runtime.pump_steps"] == fe.steps
    assert d["runtime.pump_skipped_steps"] == 0
    assert all(got == want > 0 for got, want in grew)
    assert d["runtime.dbuf_ring_bytes"] == sum(want for _, want in grew)
    assert d["runtime.dbuf_slide_bytes"] == 0
    allout = np.concatenate(outs, -1)
    cap, lo, hi = 8192, fe.start, fe.end
    assert hi == allout.shape[-1] > 3 * cap and lo == hi - cap
    for t0, m in _windows(lo, hi, cap, outs[-1].shape[-1]):
        np.testing.assert_array_equal(fe.window(t0, m), allout[:, t0:t0 + m])
    assert rt.stats.chunks > 0


@pytest.mark.parametrize("rate", [1_728_000, 1_920_000], ids=["dect", "sdr"])
def test_front_end_forms(rate):
    """The front end in its two forms after 12 ticks: at the DECT rate the
    radio's own clock and read, no step, no pump span, the identity
    conversions, and the firmware holds the radio; off it the DECT-rate
    ring's clock and read, the steps the counter saw, and the firmware holds
    the front end."""
    drv, rt = _listening_node(rate, 8192)
    fe, hw = rt.front_end, rt.hw
    c0 = trace.counters()
    for _ in range(12):
        drv.tick()
        rt.process()
    c1 = trace.counters()
    pumped, steps = (c1[k] - c0[k] for k in ("span.runtime.pump.calls",
                                             "runtime.pump_steps"))
    if rate == 1_728_000:
        src = hw.rx_time, hw.rx_time_passed, hw.get_rx_stream
        assert isinstance(fe, IdentityFrontEnd) and rt.tpoint.lower is hw
        assert fe.steps == steps == pumped == 0
        x = torch.ones(3)
        assert fe.to_hw(12_345) == fe.to_dect(12_345) == 12_345
        assert fe.to_radio(x) is x
    else:
        src = fe.ring.start, fe.ring.end, fe.ring.window
        assert isinstance(fe, ResampledFrontEnd) and rt.tpoint.lower is fe
        assert fe.steps == steps == 12 * 2048 // 1280 and pumped == 12
    assert (fe.start, fe.end) == src[:2] and fe.end - fe.start == 8192
    for t0, m in ((fe.start, 100), (fe.end - 2048, 2048)):
        np.testing.assert_array_equal(fe.window(t0, m), src[2](t0, m))
    assert fe.drained()


class _Clock:
    """A radio whose clock the test sets, read by both packages' runtimes."""
    n_ant, rx_ring_len, samp_rate = 1, 4096, 1_920_000

    def __init__(self):
        self.rx_time = self.rx_time_passed = self.tx_earliest = self.pps = 0
        self.commands = []

    def pps_set_full_sec_at_next_pps(self) -> int:
        return self.pps

    def set_command_time(self, time: int = 0) -> None:
        self.commands.append(time)


def test_resampled_clock_matches_jax():
    """The resampled front end's two clock mappings and the firmware's view
    of the radio (`lower`) against the JAX runtime's `_dect_to_hw`,
    `_hw_to_dect` and `_DectLower` over one radio at 100 states, the first
    ten before the first pump sets the origin; the front end forwards the
    radio's other names."""
    from dectnrp_tpu.upper.tpoint import Tpoint as JTpoint

    clock, rng = _Clock(), np.random.default_rng(2 ** 31 + 23)
    rt = NodeRuntime(clock, Tpoint(), NET, device="cpu")
    jrt = JaxNodeRuntime(clock, JTpoint(), NET)
    fe, lower, jlower = rt.front_end, rt.tpoint.lower, jrt.tpoint.lower
    assert lower is fe and type(jlower).__name__ == "_DectLower"
    assert fe.origin is None and fe.samp_rate == clock.samp_rate
    for k in range(100):
        if k == 10:          # a radio at rx_time with nothing to resample
            clock.rx_time = clock.rx_time_passed = int(rng.integers(1, 10 ** 6))
            fe.pump()
            jrt._pump()
            assert fe.origin == jrt._hw_origin == clock.rx_time
        n = int(rng.integers(0, 5000))
        fe.ring.skip(n)
        JaxNodeRuntime._append_dect(jrt, np.zeros((1, n), np.complex64))
        clock.rx_time, clock.tx_earliest, clock.pps = (
            int(v) for v in rng.integers(0, 10 ** 9, 3))
        for t in rng.integers(0, 10 ** 9, 4):
            assert fe.to_hw(int(t)) == jrt._dect_to_hw(int(t)), (k, t)
            assert fe.to_dect(int(t)) == jrt._hw_to_dect(int(t)), (k, t)
        for name in ("rx_time", "rx_time_passed", "tx_earliest"):
            assert getattr(lower, name) == getattr(jlower, name), (k, name)
        assert lower.rx_time_passed == fe.end
        assert lower.pps_set_full_sec_at_next_pps() == \
            jlower.pps_set_full_sec_at_next_pps()
        t = int(rng.integers(0, 10 ** 9)) if k % 3 else 0
        lower.set_command_time(t)
        jlower.set_command_time(t)
        assert clock.commands[-2] == clock.commands[-1], (k, t)
    assert fe.steps == 0


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
    fe = rt.front_end
    j = SimpleNamespace(plan_tx=fe.plan_tx, _dbuf_time=0, _dbuf_filled=0,
                        _dbuf=np.zeros((n_ant, cap), np.complex64))
    for a in appends:
        if isinstance(a, tuple):
            n = a[1]
            x = np.zeros((n_ant, n), np.complex64)
            fe.ring.skip(n)
        else:
            n = a
            x = (rng.standard_normal((n_ant, n))
                 + 1j * rng.standard_normal((n_ant, n))).astype(np.complex64)
            fe.ring.push(x)
        JaxNodeRuntime._append_dect(j, x)
        lo, hi = fe.start, fe.end
        assert (lo, hi) == (j._dbuf_time, j._dbuf_time + j._dbuf_filled)
        for t0, m in _windows(lo, hi, cap, n):
            np.testing.assert_array_equal(
                fe.window(t0, m), JaxNodeRuntime._get_stream(j, t0, m))
        m = min(n, cap)
        np.testing.assert_array_equal(fe.window(hi - m, m), x[:, -m:])
        for t0, m in ((lo - 1, 2), (hi - 1, 2)):
            with pytest.raises(AssertionError) as mine:
                fe.window(t0, m)
            with pytest.raises(AssertionError) as theirs:
                JaxNodeRuntime._get_stream(j, t0, m)
            assert str(mine.value) == str(theirs.value)
    assert fe.start > 0                      # the ring filled and wrapped


def test_dect_rate_touches_no_front_end_counter():
    sc = C.load_scenario(CONFIGS / "p2p_u1b1")
    run = C.build_scenario(sc, "cpu")
    c0 = trace.counters()
    run.run_ticks(40)
    assert all(isinstance(rt.front_end, IdentityFrontEnd) for rt in run.runtimes)
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
    assert d["runtime.pump_steps"] == sum(rt.front_end.steps
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
