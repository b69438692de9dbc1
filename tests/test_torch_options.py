"""The builders' last options through the port vs the JAX package.

- `build_sync`: the beta / integer-CFO stage (tests/test_sync.py::
  test_beta_and_integer_cfo_estimation mirrored) and the RMS window gate
  (the port's plain twin against JAX's XLA route, which is where JAX sends
  a gated sync);
- `build_rx`: the time-Wiener bank over a Doppler channel whose measured
  correlation selects a preset other than the first, and the
  decision-directed refinement on a frequency-selective channel where the
  receiver's selectivity flag holds, both checked to act;
- `loopback_mmie_roundtrip` (tests/test_loopback_experiments.py::
  test_mmie_over_the_air mirrored);
- end-to-end parity cases of ROADMAP A8b: a type-2 PLCF, the cl / bf flags,
  u = 2 and 8 at b = 1, PacketLengthType 1, tm 10 (N_TS = 8), MCS 7,
  Z = 2048.
Channels and noise are drawn in numpy and fed to both packages. Decisions
must be equal (tb where the CRC holds); sync reports equal in detected,
t_fine, beta and cfo_int.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu_torch.sections.part3.packet_sizes import \
    PacketSizesDef as TPacketSizesDef

torch.set_num_threads(1)

NID = 0x12345678


def _tx_both(args, B, rng, plcf_type=1, flags=False):
    """(iq from JAX's build_tx, plcf bits, tb bits): the port's TX held to
    it at rtol 1e-5 / atol 1e-6 on the same bits."""
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    ps = get_packet_sizes(PacketSizesDef(*args))
    plcf = rng.integers(0, 2, (B, 40 * plcf_type)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.full((B,), flags, bool)
    iq = np.asarray(build_tx(PacketSizesDef(*args), NID, plcf_type)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(TPacketSizesDef(*args), NID, plcf_type, device="cpu")(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq, rtol=1e-5, atol=1e-6)
    return iq, plcf, tb


def _awgn(y, nv, rng):
    return (y + np.sqrt(nv / 2) * (rng.standard_normal(y.shape)
                                   + 1j * rng.standard_normal(y.shape))
            ).astype(np.complex64)


def _rx_both(args, y, nv, plcf_type=1, t_rx=None, **kw):
    """Both packages' build_rx on y; decisions equal. Returns the port's."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx

    o_j = build_rx(PacketSizesDef(*args), NID, plcf_type, **kw)(
        jnp.asarray(y), jnp.float32(nv))
    rx = t_rx or t_build_rx(TPacketSizesDef(*args), NID, plcf_type,
                            device="cpu", **kw)
    o_t = rx(torch.as_tensor(y), float(nv))
    for key in ("plcf1", "plcf1_ok", "plcf1_cl", "plcf1_bf", "plcf2",
                "plcf2_ok", "tb_ok"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(o_j[key]),
                                      err_msg=key)
    ok = o_t["tb_ok"].numpy()
    np.testing.assert_array_equal(o_t["tb"].numpy()[ok], np.asarray(o_j["tb"])[ok])
    np.testing.assert_allclose(o_t["snr_db"].numpy(), np.asarray(o_j["snr_db"]),
                               atol=1e-3)
    return o_t


def test_beta_and_integer_cfo_estimation():
    """A beta = 2 packet received at the beta = 8 rate with integer CFO 0,
    +2 and -1 bins: both packages' sync detect it and report beta 2 (and
    equal t_fine and cfo_int); the estimator from the true STF start gives
    beta 2 and the shift exactly, in both."""
    from dectnrp_tpu.phy.resampler import ResamplerPlan, build_resampler
    from dectnrp_tpu.phy.sync import SyncParams, build_beta_icfo, build_sync
    from dectnrp_tpu_torch.phy import sync as T

    b_small, b_max = 2, 8
    rng = np.random.default_rng(3)
    iq, _, _ = _tx_both((1, b_small, 0, 1, 0, 1, 6144), 1, rng)
    up = build_resampler(ResamplerPlan(b_max // b_small, 1), iq.shape[-1])
    iq8 = np.asarray(up(jnp.asarray(iq[0])))                  # b_max rate
    Tn, off, Nfft = 1 << 14, 2000, 64 * b_max
    sync = build_sync(1, b_max, Tn, params=SyncParams(est_beta_icfo=True))
    t_sync = T.build_sync(1, b_max, Tn, params=T.SyncParams(est_beta_icfo=True),
                          device="cpu")
    est, t_est = build_beta_icfo(1, b_max), T.build_beta_icfo(1, b_max, device="cpu")
    for cfo_bins in (0, 2, -1):
        stream = _awgn(np.zeros((1, 1, Tn), np.complex64), 10 ** (-20 / 10), rng)
        rot = np.exp(2j * np.pi * cfo_bins * np.arange(iq8.shape[-1]) / Nfft)
        stream[0, :, off:off + iq8.shape[-1]] += (iq8 * rot).astype(np.complex64)
        rep = sync(jnp.asarray(stream))
        rep_t = t_sync(torch.as_tensor(stream))
        for k in ("detected", "t_fine", "beta", "cfo_int", "n_eff_tx"):
            np.testing.assert_array_equal(rep_t[k].numpy(), np.asarray(rep[k]),
                                          err_msg=k)
        assert bool(rep_t["detected"][0]) and int(rep_t["beta"][0]) == b_small
        assert abs(int(rep_t["t_fine"][0]) - off) <= 64
        seg = stream[0, :, off:off + Nfft]
        beta, s = t_est(torch.as_tensor(seg))
        assert (int(beta), int(s)) == (b_small, cfo_bins)
        assert (int(beta), int(s)) == tuple(int(v) for v in est(jnp.asarray(seg)))


@pytest.mark.parametrize("rms_min,rms_max,want", [
    (0.05, float("inf"), "packets"),      # between the noise's and the packets'
    (0.05, 10.0, "packets"),
    (5.0, float("inf"), "none"),          # above the packets' RMS
    (0.05, 0.2, "none"),                  # the packets' RMS above rms_max
])
def test_rms_gate_matches_jax(rms_min, rms_max, want):
    """build_sync with the RMS window gate (rms_min > 0): the port (its
    detection's plain twin with the gate folded in, and the peaks' own RMS
    gated) reports as JAX's XLA route on the same streams: detected, and
    t_fine / n_eff_tx / rms at the detected peaks. Packets at unit power
    in noise of RMS 0.03; max_peaks 2."""
    from dectnrp_tpu.phy.sync import SyncParams, build_sync
    from dectnrp_tpu_torch.phy import sync as T

    args = (1, 2, 0, 2, 0, 3, 6144)
    rng = np.random.default_rng(11)
    iq, _, _ = _tx_both(args, 3, rng)
    iq = iq / np.sqrt(np.mean(np.abs(iq) ** 2))
    n_pkt = iq.shape[-1]
    Tn = 3 * n_pkt + 1024
    y = _awgn(np.zeros((3, 1, Tn), np.complex64), 0.03 ** 2, rng)
    for i in range(3):
        o = int(rng.integers(64, Tn - n_pkt - 64))
        y[i, :, o:o + n_pkt] += iq[i]
    pj = SyncParams(rms_min=rms_min, rms_max=rms_max)
    rep = build_sync(1, 2, Tn, params=pj, max_peaks=2)(jnp.asarray(y))
    rep_t = T.build_sync(1, 2, Tn, params=T.SyncParams(rms_min=rms_min,
                                                       rms_max=rms_max),
                         max_peaks=2, device="cpu")(torch.as_tensor(y))
    det = np.asarray(rep["detected"])
    np.testing.assert_array_equal(rep_t["detected"].numpy(), det)
    for k in ("t_fine", "n_eff_tx"):
        np.testing.assert_array_equal(rep_t[k].numpy()[det], np.asarray(rep[k])[det],
                                      err_msg=k)
    np.testing.assert_allclose(rep_t["rms"].numpy()[det], np.asarray(rep["rms"])[det],
                               rtol=1e-5)
    # one packet a stream: the first peak detected, the second not
    if want == "packets":
        assert det[:, 0].all() and not det[:, 1].any()
    else:
        assert not det.any()


@pytest.mark.parametrize("u,b,R", [(1, 1, 1), (1, 2, 2), (8, 4, 1)])
def test_rms_gate_tiled_twin_matches_plain(u, b, R):
    """The tiled twin (the kernel's decomposition and order of operations)
    folds the RMS gate as the plain twin does: equal within rtol 1e-5 /
    atol 1e-6 off gate ties (metric and RMS within 1e-4); with the gate at rms_min = 0
    both are bit for bit what they are without it."""
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.sections.part3.stf import cover_sequence

    P = 16 * b
    g = torch.Generator().manual_seed(u + b + R)
    T = 90 * P + 3
    x = 0.05 * torch.randn((2, R, T), dtype=torch.complex64, generator=g)
    cov = torch.as_tensor(np.resize(cover_sequence(u), 12).astype(np.float32))
    for o in (5, 40):                     # two periodic segments, one weaker
        amp = 1.0 if o == 5 else 0.2
        x[:, :, o * P:(o + 12) * P] += amp * (
            torch.randn((2, R, P), dtype=torch.complex64, generator=g).repeat(
                1, 1, 12) * cov.repeat_interleave(P))
    cw = cover_sequence(u)
    w = torch.as_tensor((cw[:-1] * cw[1:]).astype(np.float32))
    sl, sr, thr, mmax = 7 * b, b, 0.25, 1.5
    metric, _, P2s = sync_detect.detect_metric_plain(x, P, w)
    rms = sync_detect.detect_rms(P2s, len(cw) * P * R)
    for rmin, rmax in ((0.5 * float(rms.max()), float("inf")),
                       (0.05, 0.5 * float(rms.max()))):
        gate = dict(rms_min=rmin, rms_max=rmax)
        plain = sync_detect.detect_sm_plain(x, P, w, sl, sr, thr, mmax, **gate)
        tiled = sync_detect.detect_sm_tiled(x, P, w, sl, sr, thr, mmax, **gate)
        ok = sync_detect.gate_tie_mask(metric, thr, mmax, sl, sr, 1e-4, rms,
                                       rmin, rmax)
        assert ok.float().mean() > 0.9
        torch.testing.assert_close(tiled[ok], plain[ok], rtol=1e-5, atol=1e-6)
        ungated = sync_detect.detect_sm_plain(x, P, w, sl, sr, thr, mmax)
        assert not torch.equal(plain, ungated)            # the gate acts
    for f in (sync_detect.detect_sm_plain, sync_detect.detect_sm_tiled):
        assert torch.equal(f(x, P, w, sl, sr, thr, mmax, rms_min=0.0, rms_max=1e-9),
                           f(x, P, w, sl, sr, thr, mmax))


@pytest.mark.parametrize("rms_min,rms_max,n_lr", [
    (0.3047, float("inf"), 1792), (0.05, 10.0, 224), (5.0, float("inf"), 2016),
    (0.05, 0.2, 224), (1e-30, 1e-20, 16), (2.0, 1.0, 112)])
def test_rms_gate_bounds_equal_the_sqrt_gate(rms_min, rms_max, n_lr):
    """The kernel's form of the RMS gate, P2 in [p2_lo, p2_hi], decides as
    sqrt(P2 / n_lr) in (rms_min, rms_max) computed in float32 (the twins'
    and JAX's form) at every P2: at both ends and their float32
    neighbours, and at 10^5 values spread over the whole float32 range."""
    from dectnrp_tpu_torch.phy.ops.sync_detect import rms_gate_bounds

    lo, hi = rms_gate_bounds(rms_min, rms_max, n_lr)
    rng = np.random.default_rng(n_lr)
    with np.errstate(over="ignore"):
        near = [np.nextafter(np.float32(v), np.float32(d)) for v in (lo, hi)
                for d in (-np.inf, np.inf)] if np.isfinite([lo, hi]).all() else []
    bits = rng.integers(0, 0x7F800001, 100_000).astype(np.int32)
    x = torch.as_tensor(np.concatenate([
        bits.view(np.float32), np.float32([lo, hi, 0.0, np.inf, -1.0]),
        np.float32(near)]))
    with np.errstate(invalid="ignore"):
        r = torch.sqrt(x / torch.full_like(x, float(n_lr)))
    want = (r > rms_min) & (r < rms_max)
    assert torch.equal((x >= lo) & (x <= hi), want)
    if rms_min < rms_max:
        assert want.any()


def _jakes(B, n, nu_per_sample, rng, n_sin=16):
    """Flat Rayleigh fading [B, n] from n_sin Jakes sinusoids, unit power."""
    a = rng.uniform(0, 2 * np.pi, (B, n_sin, 1))
    ph = rng.uniform(0, 2 * np.pi, (B, n_sin, 1))
    t = np.arange(n)[None, None, :]
    return np.exp(1j * (2 * np.pi * nu_per_sample * np.cos(a) * t + ph)
                  ).sum(1) / np.sqrt(n_sin)


def test_time_wiener_bank_follows_doppler():
    """time_kind="wiener" on a fast-fading flat channel (Jakes, nu = 0.05
    per symbol) at 30 dB: the port's bank is the three presets, the
    measured DRS-step correlation selects the last (fastest) one for most
    packets (a fading draw may stay correlated over a packet), and the
    decisions equal JAX's."""
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx

    args = (1, 2, 0, 2, 0, 3, 6144)
    ps = get_packet_sizes(PacketSizesDef(*args))
    q = ps.numerology
    rng = np.random.default_rng(21)
    B = 4
    iq, _, _ = _tx_both(args, B, rng)
    h = _jakes(B, iq.shape[-1], 0.05 / (q.N_b_DFT + q.N_b_CP), rng)
    nv = np.float32(10 ** (-30 / 10))
    y = _awgn(iq * h[:, None, :], nv, rng)
    rx = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu",
                    time_kind="wiener")
    assert rx.n_tm == 3
    picked = []
    orig = rx._time_preset
    rx._time_preset = lambda *a: picked.append(orig(*a)) or picked[-1]
    _rx_both(args, y, nv, t_rx=rx, time_kind="wiener")
    assert len(picked) == 1 and (picked[0] == 2).sum() >= B - 1, picked


def test_dd_passes_refine_on_selective_channel():
    """dd_passes=2 on a 3-tap channel (0, 2, 4 samples, equal power: the
    receiver's selectivity flag holds) with slow fading: the refinement
    runs where `selective` is set and moves the equalized PDC symbols, and
    the decisions equal JAX's."""
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx

    args = (1, 2, 0, 2, 0, 3, 6144)
    ps = get_packet_sizes(PacketSizesDef(*args))
    q = ps.numerology
    rng = np.random.default_rng(22)
    B = 4
    iq, _, _ = _tx_both(args, B, rng)
    n = iq.shape[-1]
    y = np.zeros_like(iq)
    for d in (0, 2, 4):
        h = _jakes(B, n, 0.01 / (q.N_b_DFT + q.N_b_CP), rng) / np.sqrt(3)
        y[..., d:] += iq[..., :n - d] * h[:, None, d:]
    nv = np.float32(10 ** (-25 / 10))
    y = _awgn(y, nv, rng)
    rx = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu", dd_passes=2)
    seen = {}
    orig = rx._dd_refine

    def spy(x, csi, y_pdc, h1, selective):
        out = orig(x, csi, y_pdc, h1, selective)
        seen["selective"] = selective.clone()
        seen["moved"] = (out[0] - x).abs().amax(-1)
        return out
    rx._dd_refine = spy
    o_t = _rx_both(args, y, nv, t_rx=rx, dd_passes=2)
    assert seen["selective"].all(), seen
    assert (seen["moved"] > 1e-3).all(), seen
    assert o_t["tb_ok"].any()


def test_mmie_over_the_air():
    """Three MMIEs in a MAC PDU over the port's AWGN loopback at 25 dB come
    back equal (tests/test_loopback_experiments.py:62-69)."""
    from dectnrp_tpu_torch.sections.part4.identity import Identity
    from dectnrp_tpu_torch.sections.part4.ies import RouteInfoIE
    from dectnrp_tpu_torch.sections.part4.ies2 import (MeasurementReportIE,
                                                       PowerTargetIE)
    from dectnrp_tpu_torch.upper.loopback import loopback_mmie_roundtrip

    sent = [RouteInfoIE(sink_address=0xAABBCCDD, route_cost=2,
                        application_sequence_number=7),
            MeasurementReportIE(rach=1, snr=120),
            PowerTargetIE(power_target_dbm_coded=55)]
    got = loopback_mmie_roundtrip(sent, Identity(0x12345678, 0x2222, 0x3333),
                                  snr_db=25.0, device="cpu")
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in sent]
    assert got[0] == sent[0] and got[1] == sent[1] and got[2] == sent[2]


def test_mmie_round_trip_on_jax_noise_decodes_as_jax():
    """The round trip's noise is an argument: handed the noise JAX's
    loopback_mmie_roundtrip draws (its key split as channels.awgn splits
    it), the port decodes the same MMIEs as JAX at 6 dB, near the
    waterfall."""
    import jax

    from dectnrp_tpu.sections.part4.identity import Identity as JIdentity
    from dectnrp_tpu.sections.part4.ies import RouteInfoIE as JRouteInfoIE
    from dectnrp_tpu.upper.loopback import loopback_mmie_roundtrip as j_rt
    from dectnrp_tpu_torch.sections.part4.identity import Identity
    from dectnrp_tpu_torch.sections.part4.ies import RouteInfoIE
    from dectnrp_tpu_torch.upper.loopback import loopback_mmie_roundtrip

    psdef = (1, 1, 0, 2, 0, 2, 6144)
    n = get_packet_sizes(PacketSizesDef(*psdef)).N_samples_packet
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    noise = ((np.asarray(jax.random.normal(k1, (1, 1, n)))
              + 1j * np.asarray(jax.random.normal(k2, (1, 1, n))))
             / np.sqrt(2)).astype(np.complex64)
    ident = (0x12345678, 0x2222, 0x3333)
    kw = dict(sink_address=0x01020304, route_cost=9, application_sequence_number=3)
    try:
        want = j_rt([JRouteInfoIE(**kw)], JIdentity(*ident),
                    PacketSizesDef(*psdef), snr_db=6.0, seed=5)
    except AssertionError:
        want = None
    try:
        got = loopback_mmie_roundtrip([RouteInfoIE(**kw)], Identity(*ident),
                                      TPacketSizesDef(*psdef), snr_db=6.0,
                                      device="cpu", noise=torch.as_tensor(noise))
    except AssertionError:
        got = None
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0].__dict__ == want[0].__dict__


def test_runtime_tx_takes_codebook_index():
    """The runtime builds its TX with the descriptor's codebook index
    (upper/runtime.py `_transmit`): for N_TX = 2 (tm 3) entry 4 is JAX's
    entry 4, within rtol 1e-5 / atol 1e-6."""
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.upper.runtime import _module

    args = (1, 1, 0, 2, 3, 2, 6144)
    ps = get_packet_sizes(PacketSizesDef(*args))
    rng = np.random.default_rng(4)
    plcf = rng.integers(0, 2, (1, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (1, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((1,), bool)
    tx = _module("tx", (TPacketSizesDef(*args), NID, 1, 4), "cpu")
    iq = tx(torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
            torch.as_tensor(fl)).numpy()
    want = np.asarray(build_tx(PacketSizesDef(*args), NID, 1, 4)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    np.testing.assert_allclose(iq, want, rtol=1e-5, atol=1e-6)


# ROADMAP A8b: (args, plcf_type, cl/bf flags, SNR dB), each end to end
A8B = {
    "plcf_type2_tm1": ((1, 1, 0, 2, 1, 2, 6144), 2, False, 20.0),
    "cl_bf_flags": ((1, 1, 0, 2, 0, 2, 6144), 1, True, 20.0),
    "u2_b1": ((2, 1, 0, 2, 0, 2, 6144), 1, False, 20.0),
    "u8_b1": ((8, 1, 0, 4, 0, 2, 6144), 1, False, 20.0),
    "packet_length_type1": ((1, 1, 1, 1, 0, 2, 6144), 1, False, 20.0),
    "tm10_nts8": ((1, 1, 0, 2, 10, 2, 6144), 1, False, 20.0),
    "mcs7": ((1, 1, 0, 2, 0, 7, 6144), 1, False, 28.0),
    "z2048": ((1, 4, 1, 2, 0, 4, 2048), 1, False, 20.0),
}


@pytest.mark.parametrize("case", sorted(A8B))
def test_a8b_packets_decide_as_jax(case):
    """Packet configurations no other parity test covers, TX through both
    packages (IQ within rtol 1e-5 / atol 1e-6) and RX on the same noisy
    input (a 1e-4 rad/sample CFO, numpy AWGN): plcf1 / plcf2 and their CRC
    and cl / bf fields, tb_ok equal, tb equal where the CRC holds, and
    every packet decoded with the bits sent."""
    args, plcf_type, flags, snr = A8B[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B = 2
    iq, plcf, tb = _tx_both(args, B, rng, plcf_type, flags)
    nv = np.float32(np.mean(np.abs(iq) ** 2) * 10 ** (-snr / 10))
    y = iq * np.exp(1j * 1e-4 * np.arange(iq.shape[-1]))
    if iq.shape[1] > 1:                   # N_TX antennas onto one RX
        y = y.sum(1, keepdims=True) / np.sqrt(iq.shape[1])
    y = _awgn(y, nv, rng)
    o_t = _rx_both(args, y, nv, plcf_type)
    assert o_t["tb_ok"].all()
    np.testing.assert_array_equal(o_t["tb"].numpy(), tb)
    key = "plcf1" if plcf_type == 1 else "plcf2"
    assert o_t[f"{key}_ok"].all()
    if flags:
        assert o_t[f"{key}_cl"].all() and o_t[f"{key}_bf"].all()


@pytest.mark.parametrize("part", ["windowing", "beamforming", "sync", "chestim",
                                  "mmie"])
def test_phy_options_path_small(part):
    """chip_smoke.py's phy_options path (options_check), each part with its
    gates, on the CPU at small widths: b = 2 (beamforming tm 3, sounded by
    tm 1), the sync part at b_max = 8 with b = 2 packets upsampled x4, the
    chestim part on 4 + 4 streams with 2 held to a second CPU run."""
    from dectnrp_tpu_torch import options_check as oc

    small = TPacketSizesDef(1, 2, 0, 2, 0, 3, 6144)
    if part == "windowing":
        out = oc.windowing(small, 4, "cpu")
        assert set(out) == {0.25, 0.5}
    elif part == "beamforming":
        out = oc.beamforming(oc.with_tm(small, 3), 1, 4, "cpu")
        assert len(out["entries"]) == 6 and sum(out["search_picks"]) == 4
    elif part == "sync":
        inp = oc.sync_inputs(TPacketSizesDef(1, 8, 0, 2, 0, 3, 6144), 4, 1 << 14,
                             "cpu")
        out = oc.sync(inp, "cpu")["summary"]
        assert out["upsampled"]["beta"] == 2 and out["rms"]["detected_above"] == 0
    elif part == "chestim":
        out = oc.chestim(small, 4, 4, 4096, "cpu", n_cpu=2)
        assert set(out["awgn"]) == {name for name, _ in oc.CHESTIM_OPTIONS}
    else:
        assert oc.mmie("cpu") == ["RouteInfoIE", "MeasurementReportIE",
                                  "PowerTargetIE"]
