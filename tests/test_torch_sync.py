"""Port's STF detection metric and sync report vs dectnrp_tpu.phy.sync.

The detection kernel's plain twin (the CPU path of its wrapper) is held to
the Pallas kernel in interpret mode and to the float64 straight-line
reference of tests/test_sync_detect_pallas.py, at that file's tolerance
(rtol 2e-3, atol 2e-4). The Pallas kernel only serves P % 128 == 0
(b in {8, 16}); the port serves every b, so b = 1 and 2 are held to the
float64 reference alone.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef

torch.set_num_threads(1)


def _sm_reference(x, u, b, thr, mmax, sl, sr):
    """Straight-line float64 numpy recomputation of the smoothed gated metric
    (the reference of tests/test_sync_detect_pallas.py) -> (sm, metric)."""
    from dectnrp_tpu.sections.part3.stf import cover_sequence, n_stf_patterns

    P = 16 * b
    n_pat = n_stf_patterns(u)
    L = n_pat * P
    B, R, T = x.shape
    n_t = T - L - P
    cov = cover_sequence(u)
    w = (cov[:-1] * cov[1:]).astype(np.float64)
    norm = n_pat / (n_pat - 1)
    p = x[..., :T - P] * np.conj(x[..., P:])
    pw = np.abs(x) ** 2
    Sp = np.concatenate([np.zeros((B, R, 1), np.complex128),
                         np.cumsum(p, -1)], -1)
    Sw = np.concatenate([np.zeros((B, R, 1)), np.cumsum(pw, -1)], -1)
    C = sum(w[j] * (Sp[..., (j + 1) * P:(j + 1) * P + n_t]
                    - Sp[..., j * P:j * P + n_t]) for j in range(n_pat - 1))
    P2 = Sw[..., L:L + n_t] - Sw[..., :n_t]
    Cs, P2s = C.sum(1), P2.sum(1)
    metric = norm * np.abs(Cs) / np.maximum(P2s, 1e-20)
    g = np.where((metric > thr) & (metric < mmax), metric, 0.0)
    k = sl + sr + 1
    gp = np.pad(g, ((0, 0), (sl, sr)))
    S = np.concatenate([np.zeros((B, 1)), np.cumsum(gp, -1)], -1)
    return (S[:, k:] - S[:, :-k]) / k, metric


def _assert_sm_close(got, ref, metric, pr, b):
    """sm within tolerance away from gate ties: a float32 metric within 1e-4
    of a gate edge may be gated either way, which moves sm by metric/k over
    its smoothing window (ops.sync_detect.gate_tie_mask)."""
    from dectnrp_tpu_torch.phy.ops.sync_detect import gate_tie_mask

    ok = gate_tie_mask(torch.as_tensor(metric), pr.metric_threshold,
                       pr.metric_max, pr.smooth_left * b, pr.smooth_right * b,
                       1e-4).numpy()
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got[ok], ref[ok], rtol=2e-3, atol=2e-4)


def _stream(u, b, T, B=2, R=2, seed=0):
    """Noise with one strongly periodic, cover-weighted segment in row 0."""
    from dectnrp_tpu.sections.part3.stf import cover_sequence

    P = 16 * b
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, R, T))
         + 1j * rng.standard_normal((B, R, T))).astype(np.complex64)
    seg = np.tile(x[0, :, :P], (1, 12))[:, :12 * P]
    x[0, :, 5 * P:17 * P] = seg * np.repeat(
        np.resize(cover_sequence(u), 12), P)[None, :]
    return x


def _plain_sm(x, u, b):
    from dectnrp_tpu.sections.part3.stf import cover_sequence
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.sync import SyncParams

    pr = SyncParams()
    cov = cover_sequence(u)
    w = torch.as_tensor((cov[:-1] * cov[1:]).astype(np.float32))
    n0 = sync_detect.launches
    sm = sync_detect.detect_sm(torch.as_tensor(x), 16 * b, w,
                               pr.smooth_left * b, pr.smooth_right * b,
                               pr.metric_threshold, pr.metric_max)
    assert sync_detect.launches == n0     # CPU tensors: plain twin, no launch
    return sm.numpy(), pr


@pytest.mark.parametrize("u,b", [(1, 8), (8, 16)])
def test_plain_sm_matches_pallas_interpret(u, b):
    from dectnrp_tpu.phy.ops.sync_detect import build_sync_sm
    from dectnrp_tpu.sections.part3.stf import cover_sequence

    T = 40 * 16 * b + 7                   # deliberately not row-aligned
    x = _stream(u, b, T)
    got, pr = _plain_sm(x, u, b)
    cov = cover_sequence(u)
    f = build_sync_sm(u, b, T, 2, tuple(float(v) for v in cov[:-1] * cov[1:]),
                      pr.metric_threshold, pr.metric_max, pr.smooth_left * b,
                      pr.smooth_right * b, interpret=True)
    want = np.asarray(f(jnp.asarray(x.real), jnp.asarray(x.imag)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    ref, metric = _sm_reference(x.astype(np.complex128), u, b,
                                pr.metric_threshold, pr.metric_max,
                                pr.smooth_left * b, pr.smooth_right * b)
    _assert_sm_close(got, ref, metric, pr, b)


@pytest.mark.parametrize("u,b", [(1, 1), (1, 2), (8, 2)])
def test_plain_sm_small_b_matches_float64(u, b):
    T = 60 * 16 * b + 5
    x = _stream(u, b, T, seed=b)
    got, pr = _plain_sm(x, u, b)
    ref, metric = _sm_reference(x.astype(np.complex128), u, b,
                                pr.metric_threshold, pr.metric_max,
                                pr.smooth_left * b, pr.smooth_right * b)
    assert ref.max() > pr.metric_threshold   # the gate opened somewhere
    _assert_sm_close(got, ref, metric, pr, b)


@pytest.mark.parametrize("max_peaks", [1, 2])
def test_sync_report_matches_jax(max_peaks):
    """Same packets in the same stream: the port's report equals JAX
    build_sync(detect_impl="pallas_interpret") (the fused branch)."""
    from dectnrp_tpu.phy.sync import build_sync
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.sync import build_sync as t_build_sync

    psdef = PacketSizesDef(1, 8, 0, 1, 0, 1, 6144)
    rng = np.random.default_rng(7)
    tx = build_tx(psdef, 0x12345678, 1)
    B = 3
    plcf = jnp.asarray(rng.integers(0, 2, (B, 40)), jnp.uint8)
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes
    tb = jnp.asarray(rng.integers(0, 2, (B, get_packet_sizes(psdef).N_TB_bits)),
                     jnp.uint8)
    fl = jnp.zeros((B,), bool)
    iq = np.asarray(tx(plcf, tb, fl, fl))
    T = 1 << 14
    offs = [[900, 9000], [4000, 12000], [9000, 2000]]
    cfo_true = 2e-4
    stream = (rng.standard_normal((B, 1, T))
              + 1j * rng.standard_normal((B, 1, T))).astype(np.complex64)
    stream *= np.sqrt(10 ** (-15 / 10) / 2)
    rot = np.exp(1j * cfo_true * np.arange(iq.shape[-1])).astype(np.complex64)
    for i in range(B):
        for o in offs[i][:max_peaks]:
            stream[i, :, o:o + iq.shape[-1]] += iq[i] * rot

    rj = build_sync(1, 8, T, max_peaks=max_peaks,
                    detect_impl="pallas_interpret")(jnp.asarray(stream))
    rt = t_build_sync(1, 8, T, max_peaks=max_peaks, device="cpu")(
        torch.as_tensor(stream))
    assert rt.keys() == {k for k in rj}
    for k in ("detected", "t_fine", "t_coarse", "n_eff_tx"):
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), err_msg=k)
    np.testing.assert_allclose(rt["cfo"].numpy(), np.asarray(rj["cfo"]), atol=1e-6)
    np.testing.assert_allclose(rt["metric"].numpy(), np.asarray(rj["metric"]),
                               rtol=1e-3)
    np.testing.assert_allclose(rt["rms"].numpy(), np.asarray(rj["rms"]), rtol=1e-4)
    assert rt["detected"].numpy().all()
    t_f = np.sort(rt["t_fine"].numpy().reshape(B, -1), axis=1)
    np.testing.assert_allclose(t_f, np.sort(np.asarray(offs)[:, :max_peaks], 1),
                               atol=2)


def _w_of(u):
    from dectnrp_tpu.sections.part3.stf import cover_sequence

    cov = cover_sequence(u)
    return torch.as_tensor((cov[:-1] * cov[1:]).astype(np.float32))


def _tiled_sm(x, u, b, span_rows=None):
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.sync import SyncParams

    pr = SyncParams()
    sm = sync_detect.detect_sm_tiled(torch.as_tensor(x), 16 * b, _w_of(u),
                                     pr.smooth_left * b, pr.smooth_right * b,
                                     pr.metric_threshold, pr.metric_max,
                                     span_rows)
    return sm.numpy(), pr


# (u, b, R): every DECT NR+ b the kernel serves beside b = 4, both cover
# lengths (n_pat 7 and 9), 1 and 4 antennas, and 8 antennas at b = 12 and 16
# (two antenna stages a sub-tile); T ragged (not a whole row)
TILED_CASES = [(1, 1, 1), (8, 1, 4), (1, 2, 4), (8, 2, 1), (1, 8, 1),
               (8, 8, 4), (1, 12, 4), (8, 12, 1), (1, 16, 1), (8, 16, 4),
               (1, 12, 8), (8, 16, 8)]


@pytest.mark.parametrize("u,b,R", TILED_CASES)
def test_tiled_sm_matches_float64(u, b, R):
    """The kernel's tiled twin against the float64 reference, and equal to
    itself bit for bit whatever the span a block walks (every sum in it is
    row-local): one sub-tile a block, a span that is no multiple of the
    sub-tile, one block a stream."""
    from dectnrp_tpu_torch.phy.ops.sync_detect import kernel_plan

    P = 16 * b
    T = 40 * P + 5 * b + 3
    x = _stream(u, b, T, R=R, seed=10 * b + R)
    got, pr = _tiled_sm(x, u, b)
    ref, metric = _sm_reference(x.astype(np.complex128), u, b,
                                pr.metric_threshold, pr.metric_max,
                                pr.smooth_left * b, pr.smooth_right * b)
    assert ref.max() > pr.metric_threshold
    _assert_sm_close(got, ref, metric, pr, b)
    G = kernel_plan(R, T, P, _w_of(u).numel() + 1, 7 * b, b).G
    for span in (G, 3):
        np.testing.assert_array_equal(_tiled_sm(x, u, b, span)[0], got)


@pytest.mark.parametrize("u,b", [(1, 8), (8, 16)])
def test_tiled_sm_matches_pallas_interpret(u, b):
    from dectnrp_tpu.phy.ops.sync_detect import build_sync_sm

    T = 40 * 16 * b + 7
    x = _stream(u, b, T)
    got, pr = _tiled_sm(x, u, b, 8)
    f = build_sync_sm(u, b, T, 2, tuple(float(v) for v in _w_of(u)),
                      pr.metric_threshold, pr.metric_max, pr.smooth_left * b,
                      pr.smooth_right * b, interpret=True)
    want = np.asarray(f(jnp.asarray(x.real), jnp.asarray(x.imag)))
    _, metric = _sm_reference(x.astype(np.complex128), u, b,
                              pr.metric_threshold, pr.metric_max,
                              pr.smooth_left * b, pr.smooth_right * b)
    _assert_sm_close(got, want, metric, pr, b)


@pytest.mark.parametrize("u,b,R", [(1, 16, 1), (8, 2, 4), (1, 1, 2)])
def test_tiled_sm_shorter_than_one_span(u, b, R):
    """A stream of fewer output rows than one sub-tile: prologue and
    epilogue in the same block."""
    from dectnrp_tpu.sections.part3.stf import n_stf_patterns

    P = 16 * b
    T = (n_stf_patterns(u) + 1 + 3) * P - 5
    rng = np.random.default_rng(b)
    x = (rng.standard_normal((2, R, T))
         + 1j * rng.standard_normal((2, R, T))).astype(np.complex64)
    x[0, :, P:] = x[0, :, :T - P]          # periodic at lag P: the gate opens
    got, pr = _tiled_sm(x, u, b)
    ref, metric = _sm_reference(x.astype(np.complex128), u, b,
                                pr.metric_threshold, pr.metric_max,
                                pr.smooth_left * b, pr.smooth_right * b)
    assert got.shape == ref.shape
    _assert_sm_close(got, ref, metric, pr, b)
    np.testing.assert_array_equal(_tiled_sm(x, u, b, 1)[0], got)


def test_tiled_sm_stf_across_block_and_subtile_boundary():
    """A cover-weighted segment whose metric peak and smoothing window
    straddle row 16 = the boundary of two blocks of 16 rows (and so of two
    sub-tiles) and row 8, a sub-tile boundary inside the first block."""
    u, b, R = 1, 8, 2
    P = 16 * b
    T = 100 * P + 3
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, R, T))
         + 1j * rng.standard_normal((2, R, T))).astype(np.complex64)
    from dectnrp_tpu.sections.part3.stf import cover_sequence
    for row in (13, 5):
        x[0 if row == 13 else 1, :, row * P:(row + 12) * P] = np.tile(
            x[0, :, :P], (1, 12)) * np.repeat(np.resize(cover_sequence(u), 12),
                                              P)[None]
    got, pr = _tiled_sm(x, u, b, 16)
    ref, metric = _sm_reference(x.astype(np.complex128), u, b,
                                pr.metric_threshold, pr.metric_max,
                                pr.smooth_left * b, pr.smooth_right * b)
    peak = ref.argmax(-1)
    assert ref[0, peak[0]] > pr.metric_threshold
    assert abs(int(peak[0]) - 16 * P) < 4 * P and abs(int(peak[1]) - 8 * P) < 4 * P
    _assert_sm_close(got, ref, metric, pr, b)
    np.testing.assert_array_equal(_tiled_sm(x, u, b)[0], got)


def test_kernel_plan_refuses_what_the_tiling_cannot_serve():
    from dectnrp_tpu_torch.phy.ops.sync_detect import auto_span, kernel_plan

    pl = kernel_plan(1, 192512, 256, 7, 112, 16)
    assert (pl.V, pl.Q, pl.G, pl.RC, pl.n_c, pl.n_rows) == (8, 32, 8, 1, 1, 744)
    assert pl.smem == 93600
    assert kernel_plan(4, 77310, 128, 7, 56, 8).V == 4
    assert kernel_plan(1, 2496, 16, 7, 7, 1).Q == 16
    # antennas beyond what a block's shared memory holds at once are taken
    # in even stages: every R is served
    for R, b, n_pat, RC, n_c in ((4, 16, 7, 4, 1), (8, 16, 7, 4, 2),
                                 (8, 12, 7, 4, 2), (16, 16, 9, 4, 4),
                                 (7, 16, 7, 4, 2), (8, 8, 7, 8, 1)):
        pl = kernel_plan(R, 40000, 16 * b, n_pat, 7 * b, b)
        assert (pl.RC, pl.n_c) == (RC, n_c) and pl.smem <= 232448
    with pytest.raises(ValueError, match="16 b"):
        kernel_plan(1, 4000, 48, 7, 21, 3)
    with pytest.raises(ValueError, match="one row"):
        kernel_plan(1, 4000, 16, 7, 17, 1)
    with pytest.raises(ValueError, match="one row"):
        kernel_plan(1, 4000, 16, 7, 7, 16)
    with pytest.raises(ValueError, match="n_pat"):
        kernel_plan(1, 40000, 256, 17, 112, 16)
    with pytest.raises(ValueError, match="shorter"):
        kernel_plan(1, 8 * 256, 256, 7, 112, 16)
    # one wave: 64 streams x 4 blocks <= 2 x 132 resident, whole sub-tiles
    assert auto_span(64, 744, 8, 264) == 192
    assert auto_span(128, 744, 8, 264) == 376
    assert auto_span(1000, 10, 8, 264) == 16


def _runtime_stream(u, b, T, with_packet, seed):
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes

    rng = np.random.default_rng(seed)
    stream = (rng.standard_normal((2, 1, T))
              + 1j * rng.standard_normal((2, 1, T))).astype(np.complex64)
    stream *= np.sqrt(10 ** (-15 / 10) / 2)
    if with_packet:
        psdef = PacketSizesDef(u, b, 0, 2, 0, 1, 6144)
        tx = build_tx(psdef, 0x12345678, 1)
        plcf = jnp.asarray(rng.integers(0, 2, (2, 40)), jnp.uint8)
        tb = jnp.asarray(rng.integers(0, 2, (2, get_packet_sizes(psdef).N_TB_bits)),
                         jnp.uint8)
        fl = jnp.zeros((2,), bool)
        iq = np.asarray(tx(plcf, tb, fl, fl))
        rot = np.exp(1j * 2e-4 * np.arange(iq.shape[-1])).astype(np.complex64)
        for i, o in enumerate((300, 1100)):
            n = min(iq.shape[-1], T - o)
            stream[i, :, o:o + n] += (iq[i] * rot)[:, :n]
    return stream


@pytest.mark.parametrize("with_packet", [True, False])
@pytest.mark.parametrize("u,b", [(1, 1), (1, 2), (2, 1)])
def test_runtime_shape_sync_report_matches_jax(u, b, with_packet):
    """The runtime's sync call (upper/runtime.py:139-140): a chunk of
    2048 + 4 N_STF samples, max_peaks = 4, with a packet starting in it and
    on noise alone; the port's report equals JAX build_sync's."""
    from dectnrp_tpu.phy.sync import build_sync
    from dectnrp_tpu.sections.part3.transmission_packet_structure import (
        get_N_samples_STF)
    from dectnrp_tpu_torch.phy.sync import build_sync as t_build_sync

    T = 2048 + 4 * get_N_samples_STF(u, b)
    stream = _runtime_stream(u, b, T, with_packet, 17 * u + b)
    rj = build_sync(u, b, T, max_peaks=4)(jnp.asarray(stream))
    sync = t_build_sync(u, b, T, max_peaks=4, device="cpu")
    rt = sync(torch.as_tensor(stream))
    np.testing.assert_array_equal(rt["detected"].numpy(), np.asarray(rj["detected"]))
    det = rt["detected"].numpy()
    assert det[:, 0].all() if with_packet else not det.any()
    # a peak is compared where the port's smoothed metric there is a real
    # value: after the masking rounds the rest of sm is 0 up to the plain
    # twin's prefix-sum residue (~2e-7 where XLA's is exactly 0), and argmax
    # over such ties lands anywhere; on noise alone every peak is such a tie
    # in both and all must agree
    sm = sync_detect_sm_of(sync, stream)
    real = np.take_along_axis(sm, rt["t_coarse"].numpy(), 1) > 1e-6
    keep = real | det if with_packet else np.ones_like(det)
    for k in ("t_fine", "n_eff_tx"):
        np.testing.assert_array_equal(rt[k].numpy()[keep], np.asarray(rj[k])[keep],
                                      err_msg=k)
    np.testing.assert_allclose(rt["cfo"].numpy()[keep], np.asarray(rj["cfo"])[keep],
                               atol=1e-6)
    np.testing.assert_allclose(rt["metric"].numpy()[keep],
                               np.asarray(rj["metric"])[keep], rtol=1e-3)


def sync_detect_sm_of(sync, stream):
    from dectnrp_tpu_torch.phy.ops.sync_detect import detect_sm_plain

    pr = sync.params
    return detect_sm_plain(torch.as_tensor(stream), sync.P, sync.w, sync.sl,
                           sync.sr, pr.metric_threshold, pr.metric_max).numpy()


# the report after detection (ops/sync_report.py) at the runtime's chunk:
# u = b = 1, T = 2048 + 4 N_STF = 2,496, n_t = 2,368
RT_T = 2496
REPORT_CASES = ["noise", "packet", "two_in_L", "edges", "sm_tie"]


def _report_stream(case, R, seed):
    """[2, R, RT_T] at the runtime's noise level (-15 dB) with, by case, no
    packet; one a row (offsets 300, 1100); two a row whose STFs start less
    than L = 112 apart (300 / 360, 1100 / 1190); one at each edge of the
    chunk (offset 3: the fine window clamps at 0; n_t - 8: the last coarse
    times). Each antenna sees the packet with its own phase and noise."""
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu.sections.part3.packet_sizes import get_packet_sizes

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, R, RT_T))
         + 1j * rng.standard_normal((2, R, RT_T))).astype(np.complex64)
    x *= np.sqrt(10 ** (-15 / 10) / 2)
    offs = {"noise": [[], []], "packet": [[300], [1100]], "sm_tie": [[300], [1100]],
            "two_in_L": [[300, 360], [1100, 1190]],
            "edges": [[3], [RT_T - 112 - 16 - 8]]}[case]
    if any(offs):
        psdef = PacketSizesDef(1, 1, 0, 2, 0, 1, 6144)
        tx = build_tx(psdef, 0x12345678, 1)
        n_p = 3
        plcf = jnp.asarray(rng.integers(0, 2, (n_p, 40)), jnp.uint8)
        tb = jnp.asarray(rng.integers(0, 2, (n_p, get_packet_sizes(psdef).N_TB_bits)),
                         jnp.uint8)
        fl = jnp.zeros((n_p,), bool)
        iq = np.asarray(tx(plcf, tb, fl, fl))[:, 0]
        rot = np.exp(1j * 2e-4 * np.arange(iq.shape[-1]))
        ant = np.exp(1j * 0.7 * np.arange(R))[:, None]
        for i, row in enumerate(offs):
            for j, o in enumerate(row):
                n = min(iq.shape[-1], RT_T - o)
                x[i, :, o:o + n] += (ant * (iq[j] * rot)[None])[:, :n].astype(np.complex64)
    return x


def report_args(s, templates):
    """The sizes and tables of Sync `s` that ops/sync_report's functions
    take after (iq, sm), with `templates` s.tconj or (the plain twin) s.Gc."""
    return (s.P, s.L, s.half, s.norm, s.params, s.max_peaks, s.w_rep,
            templates, s.neff)


def _fine_values64(x, rep, s):
    """The fine search's D M values [B, K, D M] in float64, at the report's
    coarse peaks and CFO: to flag near ties of its argmax."""
    x = torch.as_tensor(x).to(torch.complex128)
    t0 = (rep["t_coarse"].to(torch.int64) - s.half).clamp(0, s.T - s.seg_len)
    from dectnrp_tpu_torch.phy.ops.sync_report import _windows

    seg = _windows(x, t0, s.seg_len)                             # [B,K,R,S]
    n = torch.arange(s.seg_len, dtype=torch.float64)
    seg = seg * torch.exp(-1j * rep["cfo"].to(torch.float64)[..., None, None] * n)
    tc = s.tconj.to(torch.complex128)                            # [L, M]
    win = seg.unfold(-1, s.L, 1)                                 # [B,K,R,D,L]
    xc = torch.einsum("bkrdl,lm->bkrdm", win, tc)
    e = (win.abs() ** 2).sum(-1)
    return (xc.abs() ** 2 / e[..., None]).sum(2).flatten(-2)


def _fine_ties(x, rep, s, rel=1e-5):
    """[B, K] True where the best two fine-search values lie within `rel`."""
    v = _fine_values64(x, rep, s)
    top = v.topk(2, -1).values
    return ((top[..., 0] - top[..., 1]) <= rel * top[..., 0]).numpy()


@pytest.mark.parametrize("case", REPORT_CASES)
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("R", [1, 2])
def test_sync_report_tiled_matches_plain_and_jax(R, K, case):
    """The report kernel's tiled twin (its order of float32 operations:
    lane-strided peak sums, the direct correlation) at the runtime's chunk,
    against the plain twin on the same metric and against JAX build_sync on
    the same draws. Against the plain twin: detected and t_coarse equal
    (the argmax rounds are exact), t_fine and n_eff_tx equal but where the
    float64 fine values flag a near tie (t_fine then within 1), cfo within
    1e-7 rad/sample, metric within 1e-6 (|c| of a noise window is a sum
    with cancellation, so its rounding is relative to the sum of its terms'
    sizes, metric's to about 1) and rms within rtol 1e-6 (a sum of positive
    terms). `sm_tie` plants equal metric values (the first index wins, the
    second beyond L is the next peak). Against JAX as
    test_runtime_shape_sync_report_matches_jax: every field at the peaks
    that are real values of sm (all peaks on noise alone)."""
    from dectnrp_tpu.phy.sync import build_sync
    from dectnrp_tpu_torch.phy.ops import sync_report as sr
    from dectnrp_tpu_torch.phy.ops.sync_detect import detect_sm_plain
    from dectnrp_tpu_torch.phy.sync import build_sync as t_build_sync

    x = _report_stream(case, R, 100 * R + 10 * K + REPORT_CASES.index(case))
    s = t_build_sync(1, 1, RT_T, max_peaks=K, device="cpu")
    pr = s.params
    xt = torch.as_tensor(x)
    sm = detect_sm_plain(xt, s.P, s.w, s.sl, s.sr, pr.metric_threshold,
                         pr.metric_max)
    n0 = sr.launches
    for sm_in in ([sm, sm.clone()] if case == "sm_tie" else [sm]):
        if sm_in is not sm:
            # equal values above every real peak at 40 and 40 + L / 2
            # (masked), and at 40 + L (the next peak)
            sm_in[:, [40, 40 + 56, 40 + 112]] = 7.0
        tiled = sr.sync_report_tiled(xt, sm_in, *report_args(s, s.tconj))
        plain = sr.sync_report_plain(xt, sm_in, *report_args(s, s.Gc))
        for k in ("detected", "t_coarse"):
            np.testing.assert_array_equal(tiled[k].numpy(), plain[k].numpy(), k)
        if sm_in is not sm:
            assert (tiled["t_coarse"][:, 0] == 40).all()
            if K > 1:
                assert (tiled["t_coarse"][:, 1] == 40 + 112).all()
        tie = _fine_ties(x, tiled, s)
        assert tie.mean() <= 0.25
        dt = (tiled["t_fine"] - plain["t_fine"]).abs().numpy()
        assert (dt[~tie] == 0).all() and (dt <= 1).all()
        np.testing.assert_array_equal(tiled["n_eff_tx"].numpy()[~tie],
                                      plain["n_eff_tx"].numpy()[~tie])
        np.testing.assert_allclose(tiled["cfo"].numpy(), plain["cfo"].numpy(),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tiled["metric"].numpy(),
                                   plain["metric"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tiled["rms"].numpy(), plain["rms"].numpy(),
                                   rtol=1e-6)
    assert sr.launches == n0                  # CPU tensors: nothing launched
    rt = sr.sync_report_tiled(xt, sm, *report_args(s, s.tconj))
    det = rt["detected"].numpy()
    if case in ("packet", "two_in_L", "sm_tie") or case == "edges" and K > 1:
        assert det.any(-1).all()
    if case == "noise":
        assert not det.any()

    rj = build_sync(1, 1, RT_T, max_peaks=K)(jnp.asarray(x))
    if K == 1:
        rj = {k: np.asarray(v)[:, None] for k, v in rj.items()}
    np.testing.assert_array_equal(rt["detected"].numpy(), np.asarray(rj["detected"]))
    real = np.take_along_axis(sm.numpy(), rt["t_coarse"].numpy(), 1) > 1e-6
    keep = real | rt["detected"].numpy() if case != "noise" else np.ones_like(real)
    keep &= ~_fine_ties(x, rt, s)
    for k in ("t_coarse", "t_fine", "n_eff_tx"):
        np.testing.assert_array_equal(rt[k].numpy()[keep], np.asarray(rj[k])[keep],
                                      err_msg=k)
    np.testing.assert_allclose(rt["cfo"].numpy()[keep], np.asarray(rj["cfo"])[keep],
                               atol=1e-6)
    np.testing.assert_allclose(rt["metric"].numpy()[keep],
                               np.asarray(rj["metric"])[keep], rtol=1e-3)
    np.testing.assert_allclose(rt["rms"].numpy()[keep], np.asarray(rj["rms"])[keep],
                               rtol=1e-4)


def test_sync_report_refusal_names_what_a_block_cannot_hold():
    """The report kernel serves every chunk of the port's callers: the
    runtime's, the loopback points, the shards and the 192,512-sample
    streams up to 9 antennas at b = 16, u >= 2 (a block holds one peak's
    segments); what it refuses, `_refusal` names: a segment beyond a
    block's shared memory, degenerate sizes, a chunk shorter than STF +
    one pattern or than the fine search's segment, more antennas than a
    warp's lanes (one a lane)."""
    from dectnrp_tpu_torch.phy.ops.sync_report import _refusal, _smem

    assert _smem(1, 112, 16, 4, 4) == 1964
    assert _smem(2, 112, 16, 4, 4) == 3248
    for args in ((1, RT_T, 16, 112, 16, 4, 4), (2, RT_T, 16, 112, 16, 4, 4),
                 (1, 2048, 16, 112, 16, 4, 1), (8, 8192 + 128, 16, 112, 16, 4, 16),
                 (1, 192512, 256, 1792, 256, 4, 2),       # the flagship's streams
                 (9, 192512, 256, 2304, 256, 4, 8)):      # u = 8, b = 16, 9 RX
        assert _refusal(*args) == "", args
    for args, why in (((10, 192512, 256, 2304, 256, 4, 1), "bytes"),
                      ((0, RT_T, 16, 112, 16, 4, 4), "R = 0"),
                      ((33, RT_T, 16, 112, 16, 4, 4), "lanes"),
                      ((1, RT_T, 16, 112, 16, 4, 0), "K = 0"),
                      ((1, RT_T, 16, 16, 16, 4, 1), "L = 16"),
                      ((1, 140, 16, 112, 16, 4, 1), "shorter"),
                      ((1, 200, 16, 112, 60, 4, 1), "shorter")):
        assert why in _refusal(*args), (args, _refusal(*args))
