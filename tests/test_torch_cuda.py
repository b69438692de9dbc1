"""The port's CUDA kernels vs their plain twins, on the card.

Marked `cuda`: every test skips without a CUDA device (decided in the
fixture, never at import). Imports no JAX, so it runs on the card's machine
with tests/conftest.py (which loads jax) switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pathlib

import numpy as np
import pytest
import torch

from dectnrp_tpu_torch.bcjr_bf16_turns import SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# (K, B, Lw, D): windowed shapes, ragged row counts among them (B = 33, 50: a
# last block of 1 and 18 live threads), and one-window shapes (Lw = K+3, D = 0),
# up to the longest window the kernel's shared memory holds
BCJR_SHAPES = [(512, 3, 128, 32), (1056, 2, 128, 32), (6016, 64, 128, 32),
               (6080, 40, 128, 32), (6016, 33, 128, 32), (5632, 50, 128, 32),
               (1056, 5, 64, 32), (520, 7, 100, 24),
               (56, 128, 59, 0), (96, 16, 99, 0), (96, 1, 99, 0),
               (424, 50, 427, 0), (56, 3, 128, 32), (1056, 9, 1059, 0),
               (1813, 2, 1816, 0)]


@pytest.mark.parametrize("K,B,Lw,D", BCJR_SHAPES)
def test_bcjr_kernel_matches_plain(dev, K, B, Lw, D):
    """The kernel equals its plain twin bit for bit, and as one window the
    unwindowed BCJR."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior

    g = torch.Generator(device=dev).manual_seed(K)
    Lsys = torch.randn((K + 3, B), generator=g, device=dev) * 3
    Lp = torch.randn((K + 3, B), generator=g, device=dev) * 3
    n0, n1 = bcjr_cuda.launches, bcjr_cuda.launches_one_window
    got = bcjr_cuda.bcjr_posterior_cm(Lsys, Lp, K, Lw, D)
    assert bcjr_cuda.launches == n0 + 1
    assert bcjr_cuda.launches_one_window == n1 + (Lw >= K + 3)
    want = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, Lw, D)
    assert torch.equal(got, want), (got - want).abs().max().item()
    if Lw >= K + 3:
        La = torch.zeros((B, K), device=dev)
        unw = _bcjr_posterior(Lsys.T.contiguous(), Lp.T.contiguous(), La, K)
        assert torch.equal(got, unw.T), (got - unw.T).abs().max().item()


@pytest.mark.parametrize("K", [56, 96, 424])
def test_unwindowed_decode_on_card_takes_the_kernel(dev, K):
    """turbo_decode of CUDA tensors below 512 bits launches the kernel as one
    window, twice an iteration, and returns the plain route's bits and
    posterior."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode, turbo_encode

    g = torch.Generator(device=dev).manual_seed(K)
    bits = torch.randint(0, 2, (9, K), generator=g, device=dev, dtype=torch.uint8)
    d = turbo_encode(bits, K).float()
    llr = (2 * d - 1 + 0.9 * torch.randn(d.shape, generator=g, device=dev)) * 2.5
    n0, n1 = bcjr_cuda.launches, bcjr_cuda.launches_one_window
    got_b, got_p = turbo_decode(llr, K, 6)
    assert bcjr_cuda.launches == n0 + 12
    assert bcjr_cuda.launches_one_window == n1 + 12
    want_b, want_p = turbo_decode(llr, K, 6, impl="plain")
    assert bcjr_cuda.launches == n0 + 12
    assert torch.equal(got_b, want_b) and torch.equal(got_p, want_p)


def test_bcjr_wrapper_rejects_bad_input(dev):
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode

    x = torch.zeros((515, 4), device=dev)
    n0 = bcjr_cuda.launches
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x.T.contiguous().T, x, 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x.double(), x.double(), 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x, x, 600)
    # a window whose alpha checkpoints exceed a block's shared memory: the
    # whole K = 2048 trellis as one window; the wrapper raises, no fallback
    y = torch.zeros((2051, 4), device=dev)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(y, y, 2048, Lw=2051, D=0)
    with pytest.raises(ValueError):
        turbo_decode(torch.zeros((4, 3, 2052), device=dev), 2048, 1, window=0)
    assert bcjr_cuda.launches == n0


# (K, B, Lw, D) for the bf16 kernel: every shape it is timed at
# (bcjr_bf16_turns.SHAPES: the flagship's K = 6016 x 832 and 6080 x 192, 64
# codeblocks at four K, the FEC oracle's ten first-transmission decodes of
# 50); ragged B (50, 33, 1); K a multiple of Lw (the tail steps lie past the
# last launched window, in its acquisition only); one window (K + 3 < Lw, K + 3 = Lw); and the windows (64, 16),
# (128, 0), (68, 4) (Lw = 68 not a multiple of the checkpoint spacing)
BCJR_BF16_SHAPES = (
    [(K, B, 128, 32) for K, B in SHAPES]
    + [(512, 3, 128, 32), (1056, 2, 128, 32), (6080, 40, 128, 32),
       (5632, 33, 128, 32), (424, 1, 128, 32), (100, 5, 128, 32),
       (125, 33, 128, 32)]
    + [(K, B, Lw, D) for Lw, D in ((64, 16), (128, 0), (68, 4))
       for K, B in ((1056, 33), (4 * Lw, 1), (Lw - 3, 50))])


@pytest.mark.parametrize("K,B,Lw,D", BCJR_BF16_SHAPES)
def test_bcjr_bf16_kernel_matches_plain(dev, K, B, Lw, D):
    """The bf16 kernel rounds as its twin does: bit for bit."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    g = torch.Generator(device=dev).manual_seed(K + 1)
    Lsys = torch.randn((K + 3, B), generator=g, device=dev) * 3
    Lp = torch.randn((K + 3, B), generator=g, device=dev) * 3
    n0 = bcjr_cuda.launches_bf16
    got = bcjr_cuda.bcjr_posterior_cm_bf16(Lsys, Lp, K, Lw, D)
    assert bcjr_cuda.launches_bf16 == n0 + 1
    want = bcjr_cuda.bcjr_windowed_cm_bf16_plain(Lsys, Lp, K, Lw, D)
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_bcjr_bf16_wrapper_rejects_bad_input(dev):
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    x = torch.zeros((515, 4), device=dev)
    n0 = bcjr_cuda.launches_bf16
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x.T.contiguous().T, x, 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x.double(), x.double(), 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x, x, 600)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x, x, 512, Lw=126)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x, x, 512, Lw=128, D=-4)
    # a window whose alpha checkpoints exceed a block's shared memory; the
    # wrapper raises (no fallback), the C entry refuses it too
    M = bcjr_cuda.LW_MAX_BF16
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x, x, 512, Lw=M + 4, D=0)
    assert bcjr_cuda.launches_bf16 == n0
    lib = kernels.load()
    y = torch.empty((512, 4), device=dev)
    assert lib.bcjr_posterior_cm_bf16(x.data_ptr(), x.data_ptr(), y.data_ptr(),
                                      512, 4, M + 8, 0,
                                      kernels.stream_ptr(dev)) != 0


def test_bcjr_bf16_blocks_per_sm(dev):
    """The occupancy query: blocks an SM at the oracle's window and at the
    longest window, -1 beyond it."""
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    lib = kernels.load()
    assert lib.bcjr_bf16_blocks_per_sm(128) >= 1
    assert lib.bcjr_bf16_blocks_per_sm(bcjr_cuda.LW_MAX_BF16) >= 1
    assert lib.bcjr_bf16_blocks_per_sm(bcjr_cuda.LW_MAX_BF16 + 8) == -1


def test_turbo_decode_early_bf16_round_trip(dev):
    """CRC-carrying codeblocks through turbo_decode_early(impl="cuda_bf16")
    at sigma 0.8 return the sent bits, as impl="cuda" does."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.chain import _crc_device
    from dectnrp_tpu_torch.phy.fec.crc import POLY_CRC24B, crc_matrix
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode_early, turbo_encode

    K, B, sigma = 2560, 32, 0.8
    g = torch.Generator(device=dev).manual_seed(3)
    m = torch.as_tensor(crc_matrix(K - 24, POLY_CRC24B).astype(np.float32),
                        device=dev)
    pay = torch.randint(0, 2, (B, K - 24), generator=g, device=dev,
                        dtype=torch.uint8)
    c = torch.cat([pay, _crc_device(pay, m)], 1)
    d = turbo_encode(c, K).float()
    llr = (2 * d - 1 + sigma * torch.randn(d.shape, generator=g, device=dev)
           ) * (2 / sigma ** 2)
    n0 = bcjr_cuda.launches_bf16
    for impl in ("cuda_bf16", "cuda"):
        bits, _, ok, _ = turbo_decode_early(llr, m, K, n_iter_max=8,
                                            n_iter_min=2, impl=impl)
        assert torch.equal(bits, c) and bool(ok.all()), impl
    assert bcjr_cuda.launches_bf16 >= n0 + 4


# (u, b, R, B, T, span_rows, first row of the STF-like segment): small
# streams at every b; the shapes the kernel serves at full size (the flagship
# step, the wall step after its 9/10 resampler, the bench's u8b16 cell, the
# runtime's chunk of 2048 + 4 N_STF samples); b = 12 with 4 antennas; 8
# antennas at b = 12 and 16 and 16 at u = 8 (antennas in 2 and 4 stages);
# one sub-tile a block (the first version's tile); and a segment whose
# metric peak straddles a block and sub-tile boundary (span 16 rows: row 16).
# A given span is launched through the C entry; None is the wrapper's own.
SYNC_SHAPES = [(1, 1, 1, 3, 300 * 16 + 7, None, 5),
               (1, 2, 2, 3, 300 * 32 + 7, None, 5),
               (1, 8, 1, 3, 300 * 128 + 7, None, 5),
               (1, 16, 1, 3, 300 * 256 + 7, None, 5),
               (8, 16, 2, 3, 300 * 256 + 7, None, 5),
               (1, 16, 1, 64, 192512, None, 5),
               (1, 8, 4, 16, 77310, None, 5),
               (8, 16, 1, 128, 192512, None, 5),
               (1, 1, 1, 16, 2048 + 4 * 112, None, 5),
               (1, 12, 4, 3, 200 * 192 + 5, None, 5),
               (1, 12, 8, 3, 200 * 192 + 5, None, 5),
               (1, 16, 8, 3, 300 * 256 + 7, None, 5),
               (8, 16, 16, 2, 100 * 256 + 1, None, 5),
               (1, 16, 1, 64, 192512, 8, 5),
               (1, 8, 2, 3, 100 * 128 + 3, 16, 13),
               (1, 16, 8, 2, 100 * 256 + 1, 16, 13)]


def _sync_launch(x, P, w, sl, sr, thr, mmax, span):
    """sm of the kernel through its C entry, each block walking `span`
    rows (the wrapper always takes `default_span`), no RMS gate."""
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.phy.ops import sync_detect

    B, R, T = x.shape
    pl = sync_detect.kernel_plan(R, T, P, w.numel() + 1, sl, sr)
    sm = torch.empty((B, pl.n_t), device=x.device)
    kernels.check(kernels.load().sync_detect_sm(
        torch.view_as_real(x).data_ptr(), w.data_ptr(), sm.data_ptr(), B, R, T,
        P, w.numel() + 1, sl, sr, thr, mmax, 0.0, 0.0, pl.RC, span,
        kernels.stream_ptr(x.device)), "sync_detect_sm")
    return sm


@pytest.mark.parametrize("u,b,R,B,T,span,seg", SYNC_SHAPES)
def test_sync_kernel_matches_plain(dev, u, b, R, B, T, span, seg):
    """The kernel equals its tiled twin (same decomposition and order of
    operations; held at rtol 1e-5 / atol 1e-6, what differs is torch's
    own rounding of sqrt and division on the card) and the plain twin at
    rtol 2e-3 / atol 2e-4 off gate ties."""
    from dectnrp_tpu_torch.sections.part3.stf import cover_sequence
    from dectnrp_tpu_torch.phy.ops import sync_detect

    P = 16 * b
    g = torch.Generator(device=dev).manual_seed(b + R)
    x = torch.randn((B, R, T), dtype=torch.complex64, generator=g, device=dev)
    # a strongly periodic, cover-weighted segment so the gate opens
    cov = torch.as_tensor(np.resize(cover_sequence(u), 12).astype(np.float32),
                          device=dev)
    x[0, :, seg * P:(seg + 12) * P] = (x[0, :, :P].repeat(1, 12)
                                       * cov.repeat_interleave(P))
    w = torch.as_tensor((cover_sequence(u)[:-1] * cover_sequence(u)[1:]
                         ).astype(np.float32), device=dev)
    sl, sr, thr, mmax = 7 * b, b, 0.25, 1.5
    n0 = sync_detect.launches
    if span is None:
        got = sync_detect.detect_sm(x, P, w, sl, sr, thr, mmax)
        n0 += 1
        span = sync_detect.default_span(x, P, w.numel() + 1, sl, sr)
    else:
        got = _sync_launch(x, P, w, sl, sr, thr, mmax, span)
    assert sync_detect.launches == n0
    tiled = sync_detect.detect_sm_tiled(x, P, w, sl, sr, thr, mmax, span)
    want = sync_detect.detect_sm_plain(x, P, w, sl, sr, thr, mmax)
    assert sync_detect.launches == n0
    metric, _, _ = sync_detect.detect_metric_plain(x, P, w)
    ok = sync_detect.gate_tie_mask(metric, thr, mmax, sl, sr, 1e-3)
    assert ok.float().mean() > 0.9
    torch.testing.assert_close(got[ok], tiled[ok], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[ok], want[ok], rtol=2e-3, atol=2e-4)
    assert got[0].max() > thr


def _sync_input(dev, u, b, R, B, T, seg, seed):
    """x [B, R, T] of unit-power noise with a strongly periodic,
    cover-weighted segment in stream 0 at row `seg` (the gate opens), and
    the cover weights w."""
    from dectnrp_tpu_torch.sections.part3.stf import cover_sequence

    P = 16 * b
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, R, T), dtype=torch.complex64, generator=g, device=dev)
    cov = torch.as_tensor(np.resize(cover_sequence(u), 12).astype(np.float32),
                          device=dev)
    x[0, :, seg * P:(seg + 12) * P] = (x[0, :, :P].repeat(1, 12)
                                       * cov.repeat_interleave(P))
    w = torch.as_tensor((cover_sequence(u)[:-1] * cover_sequence(u)[1:]
                         ).astype(np.float32), device=dev)
    return x, w


# the shapes the phases of chip_smoke.py time B2 at (flagship, wall, u8b16,
# the runtime's chunk), and small streams at b = 1 and 2 antennas
SYNC_GATE_SHAPES = [(1, 16, 1, 64, 192512), (1, 8, 4, 16, 77310),
                    (8, 16, 1, 128, 192512), (1, 1, 1, 1, 2048 + 4 * 112),
                    (1, 1, 2, 3, 300 * 16 + 7)]


@pytest.mark.parametrize("u,b,R,B,T", SYNC_GATE_SHAPES)
def test_sync_kernel_rms_gate(dev, u, b, R, B, T):
    """The RMS window gate folded into the kernel (as the P2 interval of
    `rms_gate_bounds`; the twins compute the RMS): with rms_min > 0 (once
    between the noise's and the segment's RMS, once with rms_max below the
    segment's) the kernel equals its tiled twin and its plain twin off gate
    ties (metric and RMS within 1e-3), and the second shuts the segment
    out; at rms_min = 0
    the kernel is bit for bit what it is with no gate given, and bit for
    bit its tiled twin."""
    from dectnrp_tpu_torch.phy.ops import sync_detect

    P = 16 * b
    x, w = _sync_input(dev, u, b, R, B, T, 5, 3 * b + R)
    x[:, :, 3 * P:(3 + 40) * P] *= 3.0    # a louder span the gate keeps
    sl, sr, thr, mmax = 7 * b, b, 0.25, 1.5
    args = (x, P, w, sl, sr, thr, mmax)
    n_pat = w.numel() + 1
    span = sync_detect.default_span(x, P, n_pat, sl, sr)
    metric, _, P2s = sync_detect.detect_metric_plain(x, P, w)
    rms = sync_detect.detect_rms(P2s, n_pat * P * R)
    ungated = sync_detect.detect_sm(*args)
    n0 = sync_detect.launches
    off = sync_detect.detect_sm(*args, rms_min=0.0, rms_max=1e-9)
    assert sync_detect.launches == n0 + 1
    assert torch.equal(off, ungated)
    assert torch.equal(off, sync_detect.detect_sm_tiled(*args, span))
    r_lo, r_hi = float(rms.median()), float(rms.max())
    for rmin, rmax in ((1.5 * r_lo, float("inf")), (0.5 * r_lo, 1.5 * r_lo)):
        gate = {"rms_min": rmin, "rms_max": rmax}
        got = sync_detect.detect_sm(*args, **gate)
        tiled = sync_detect.detect_sm_tiled(*args, span, **gate)
        want = sync_detect.detect_sm_plain(*args, **gate)
        ok = sync_detect.gate_tie_mask(metric, thr, mmax, sl, sr, 1e-3, rms,
                                       rmin, rmax)
        assert ok.float().mean() > 0.9
        torch.testing.assert_close(got[ok], tiled[ok], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[ok], want[ok], rtol=2e-3, atol=2e-4)
    # the second gate shuts the louder span with the periodic segment out
    assert r_hi > 1.5 * r_lo and got[0].max() <= thr < ungated[0].max()


def test_sync_wrapper_rejects_bad_input(dev):
    """Shapes the tiling does not serve raise with the reason in the
    wrapper, and the C entry refuses them too: 16 antennas at b = 16 in one
    stage need more shared memory than a block has (the wrapper takes them
    in 4); more antennas a stage than the stream has; b = 3 has no lane
    layout; smoothing beyond one row."""
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.phy.ops import sync_detect

    w = torch.ones(6, device=dev)
    n0 = sync_detect.launches
    x = torch.zeros((1, 16, 20 * 256), dtype=torch.complex64, device=dev)
    sm = torch.empty((1, 20 * 256 - 8 * 256), device=dev)
    for R, RC in ((16, 16), (1, 2)):
        assert kernels.load().sync_detect_sm(
            torch.view_as_real(x).data_ptr(), w.data_ptr(), sm.data_ptr(), 1, R,
            20 * 256, 256, 7, 112, 16, 0.25, 1.5, 0.0, 0.0, RC, 8,
            kernels.stream_ptr(x.device)) != 0
    y = torch.zeros((1, 1, 20 * 48), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="16 b"):
        sync_detect.detect_sm(y, 48, w, 21, 3, 0.25, 1.5)
    z = torch.zeros((1, 1, 20 * 16), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="one row"):
        sync_detect.detect_sm(z, 16, w, 17, 1, 0.25, 1.5)
    with pytest.raises(ValueError):
        sync_detect.detect_sm(z.to(torch.complex128), 16, w, 7, 1, 0.25, 1.5)
    assert sync_detect.launches == n0


RATIOS = [(10, 9), (40, 27), (20, 9), (80, 27), (2, 1),
          (9, 10), (27, 40), (9, 20), (27, 80), (1, 2)]


def _poly_check(x, taps, L, M, off, n_out):
    """One kernel launch vs the plain twin (rtol/atol 2e-5) and vs the tiled
    twin, walked with the kernel's own block count: the kernel sums with
    fmaf, which the twin rounds through float64, so they agree to the same
    tolerance and bit for bit but for a rare double rounding."""
    from dectnrp_tpu_torch.phy.ops import polyphase

    n0 = polyphase.launches
    got = polyphase.polyphase_fir(x, taps, L, M, off, n_out)
    assert polyphase.launches == n0 + 1
    want = polyphase.polyphase_fir_plain(x, taps, L, M, off, n_out)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    pl = polyphase.kernel_plan(L, M, taps.shape[1])
    resident = polyphase.resident_blocks(x.device.index or 0, L, M, taps.shape[1])
    tiled = polyphase.polyphase_fir_tiled(x, taps, L, M, off, n_out,
                                          blocks=resident)
    torch.testing.assert_close(got, tiled, rtol=2e-5, atol=2e-5)
    assert (got == tiled).float().mean().item() > 0.999
    assert polyphase.block_count(x.numel() // x.shape[-1], n_out, L, pl,
                                 resident) <= resident


@pytest.mark.parametrize("os", [1, 2, 4, 8])
@pytest.mark.parametrize("LM", RATIOS)
@pytest.mark.parametrize("rows,n_in", [(3, 1), (2, 997), (64, 23040)])
def test_polyphase_kernel_matches_plain(dev, LM, rows, n_in, os):
    """Every ratio and oversampling factor at a one-sample input, a ragged
    edge (n_in not a multiple of M, several tiles) and the wall step's 10/9
    shape; both the one-shot frame offset m0 < 0 and a streaming offset
    >= 0."""
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    L, M = LM
    G, m0, W = _design(ResamplerPlan(L, M, os))
    taps = torch.as_tensor(G, device=dev)
    g = torch.Generator(device=dev).manual_seed(L * M + n_in + os)
    x = torch.randn((rows, n_in), dtype=torch.complex64, generator=g, device=dev)
    for off in (m0, max(0, -m0) + m0):
        _poly_check(x, taps, L, M, off, -(-n_in * L // M))


@pytest.mark.parametrize("LM_tx", [(80, 27), (10, 9)])
@pytest.mark.parametrize("rows", [1, 8])
def test_polyphase_runtime_chunk_matches_plain(dev, LM_tx, rows):
    """The runtime's RX stream step (dectnrp_tpu/upper/runtime.py:165-167:
    512 L hardware samples a step through the M/L stream resampler, after
    its history): 27/80 and 9/10."""
    from dectnrp_tpu_torch.phy.resampler import (ResamplerPlan,
                                                 build_resampler_stream)

    L_tx, M_tx = LM_tx
    plan = ResamplerPlan(M_tx, L_tx)
    st = build_resampler_stream(plan, 512 * L_tx, device=dev)
    g = torch.Generator(device=dev).manual_seed(rows + L_tx)
    xp = torch.randn((rows, st.H + 512 * L_tx), dtype=torch.complex64,
                     generator=g, device=dev)
    y, _ = st(xp[:, st.H:], xp[:, :st.H])
    assert y.shape == (rows, 512 * M_tx)
    _poly_check(xp, st.G, plan.L, plan.M, st.off, st.n_out)


def test_polyphase_wrapper_rejects_bad_input(dev):
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.phy.ops import polyphase
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    taps = torch.as_tensor(_design(ResamplerPlan(10, 9))[0], device=dev)
    x = torch.zeros((4, 90), dtype=torch.complex64, device=dev)
    n0 = polyphase.launches
    with pytest.raises(ValueError):
        polyphase.polyphase_fir(x.T.contiguous().T, taps, 10, 9, -11, 100)
    with pytest.raises(ValueError):
        polyphase.polyphase_fir(x.to(torch.complex128), taps, 10, 9, -11, 100)
    with pytest.raises(ValueError):
        polyphase.polyphase_fir(x.real.double(), taps, 10, 9, -11, 100)
    with pytest.raises(ValueError):
        polyphase.polyphase_fir(x, taps, 10, 3, -11, 100)
    # a design beyond the kernel's shared memory: the plan names it before
    # any launch, and the C entry refuses it too
    big = torch.zeros((10, 5000), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        polyphase.polyphase_fir(x, big, 10, 9, -11, 100)
    y = torch.empty((4, 100), dtype=torch.complex64, device=dev)
    err = kernels.load().polyphase_fir(
        torch.view_as_real(x).data_ptr(), big.data_ptr(), None,
        torch.view_as_real(y).data_ptr(), 4, 90, 100, 10, 9, 5000, -11, 1,
        kernels.stream_ptr(x.device))
    assert err != 0
    assert polyphase.launches == n0


LOOPBACK_VARIANTS = ["sync", "aligned", "fading", "fading_aligned", "fading_genie",
                     "resampled", "mimo", "mimo_fading"]


@pytest.mark.parametrize("variant", LOOPBACK_VARIANTS)
def test_loopback_point_card_matches_cpu(dev, variant):
    """One loopback point of each variant (MCS 2 at the committed threshold,
    8 packets) decides the same on the card as on the CPU, on the same
    inputs and draws, and launches the kernels as the loopback path must:
    the BCJR as one window (PCC) and at the variant's PDC sizes, sync once
    in the synced variants and never in the aligned ones, polyphase twice in
    `resampled` and never elsewhere, bcjr_bf16 never."""
    from dectnrp_tpu_torch import loopback_snr as L
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect

    def snap():
        return (bcjr_cuda.launches, bcjr_cuda.launches_one_window,
                bcjr_cuda.launches_bf16, sync_detect.launches, polyphase.launches)

    kw = dict(L.VARIANTS)[variant]
    ref = pathlib.Path(__file__).resolve().parents[1] / "results" / "loopback_snr"
    snr = L.cut_snrs(ref, variant, 2)[1]
    c0 = snap()
    card, cpu, tb = L.card_vs_cpu(variant, 2, snr, 8, 1, dev)
    d = [b - a for a, b in zip(c0, snap())]
    assert L.decisions_equal(card, cpu), (card["tb_ok"], cpu["tb_ok"])
    assert card["tb_ok"].any()
    assert d[1] > 0 and d[0] >= d[1] and d[2] == 0, d
    assert d[3] == (1 if kw.get("use_sync") else 0), d
    assert d[4] == (2 if kw.get("resampler_loop") else 0), d


@pytest.mark.parametrize("kind", ["dect", "sdr"])
def test_runtime_exchange_card_matches_cpu(dev, kind):
    """The beacon exchange (runtime_check) on the card and on the CPU with
    the same vspace draws: every beacon decoded with its payload, equal
    RuntimeStats, detection times and TBs; the sync and BCJR kernels
    launched, the polyphase kernel only at 1.92 Ms/s."""
    from dectnrp_tpu_torch import runtime_check as rc
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect

    runs = {}
    for d in (dev, "cpu"):
        ex = rc.build(kind, d)
        c0 = (sync_detect.launches, bcjr_cuda.launches_one_window,
              polyphase.launches, bcjr_cuda.launches_bf16)
        got = rc.run(ex, draws=rc.cpu_draws(ex, 3), ticks=40)
        assert got["ok"], got
        runs[str(d)] = ex
        if d is dev:
            c1 = (sync_detect.launches, bcjr_cuda.launches_one_window,
                  polyphase.launches, bcjr_cuda.launches_bf16)
            n = [x - y for x, y in zip(c1, c0)]
            assert n[0] == ex.rt_tx.stats.chunks + ex.rt_rx.stats.chunks
            assert n[1] > 0 and n[3] == 0
            assert (n[2] > 0) == (kind == "sdr"), n
    assert rc.differences(runs[str(dev)], runs["cpu"]) == []


def test_iq_file_card_matches_cpu(dev, tmp_path):
    """The real-IQ file ingress (iq_check: three packets at 25 dB, 1.92
    Ms/s, read free-running by HwIqStream into NodeRuntime) on the card and
    on the CPU: 3 of 3 TBs, no overrun, equal RuntimeStats, detection times
    and TBs; B2 once a chunk, B3 once a front-end step, B1 one window."""
    from dectnrp_tpu_torch import iq_check as iq
    from dectnrp_tpu_torch.common.native import native_available
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect
    from dectnrp_tpu_torch.radio.hw_iq import write_iq_file

    assert native_available()
    stream, payloads = iq.ingress_stream(device=dev)
    path = tmp_path / "ingress.cf32"
    write_iq_file(path, stream, spp=iq.SPP)
    c0 = (sync_detect.launches, polyphase.launches, bcjr_cuda.launches,
          bcjr_cuda.launches_one_window)
    hw, rt, fw = iq.run_file(path, payloads, dev)
    n = [a - b for a, b in zip((sync_detect.launches, polyphase.launches,
                                bcjr_cuda.launches,
                                bcjr_cuda.launches_one_window), c0)]
    _, rt_c, fw_c = iq.run_file(path, payloads, "cpu")
    assert fw.tb_match == 3 and hw.read_overruns == 0, rt.stats
    assert vars(rt.stats) == vars(rt_c.stats)
    assert fw.detection_times == fw_c.detection_times
    for a, b in zip(fw.tbs, fw_c.tbs, strict=True):
        np.testing.assert_array_equal(a, b)
    assert n[0] == rt.stats.chunks
    assert n[1] == rt.front_end.steps
    assert n[2] == n[3] > 0, n


def test_sharded_sync_card_matches_dense(dev):
    """The time-sharded sync at b = 1 (chunk 8,192 x 64 over 8 shards of the
    one card, SCALING_r04's chunk) is bit for bit the dense search
    (sync_dense: all 64 windows in one Sync call on the card, masked the
    same way), launches B2 once a shard, and finds the four packets: one
    mid-shard, one straddling a chunk boundary, one the shard boundary
    chunk 7 -> 8, one in the last shard."""
    from dectnrp_tpu_torch.common.mesh import Mesh
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.sync import SyncParams
    from dectnrp_tpu_torch.phy.sync_sharded import (build_sync_sharded,
                                                    dedup_reports, sync_dense)
    from dectnrp_tpu_torch.phy.tx import build_tx
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef

    chunk, n_chunks, n_sh = 8192, 64, 8
    offs = [3 * chunk + 3000, 10 * chunk - 50, 8 * chunk - 60, 60 * chunk + 1234]
    rng = np.random.default_rng(2)
    n = len(offs)
    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    plcf = torch.as_tensor(rng.integers(0, 2, (n, 40)), dtype=torch.uint8, device=dev)
    tb = torch.as_tensor(rng.integers(0, 2, (n, 456)), dtype=torch.uint8, device=dev)
    fl = torch.zeros((n,), dtype=torch.bool, device=dev)
    iq = build_tx(psdef, 0x12345678, 1, device=dev)(plcf, tb, fl, fl)
    g = torch.Generator(device=dev).manual_seed(2)
    y = 10 ** (-15 / 20) * torch.randn((1, chunk * n_chunks), dtype=torch.complex64,
                                       generator=g, device=dev)
    for i, o in enumerate(offs):
        y[:, o:o + iq.shape[-1]] += iq[i]
    sh = build_sync_sharded(1, 1, chunk, n_chunks,
                            Mesh(np.array([dev] * n_sh, dtype=object), ("t",)),
                            params=SyncParams(metric_threshold=0.35))
    n0 = sync_detect.launches
    got = sh(y)
    assert sync_detect.launches == n0 + n_sh
    want = sync_dense(sh.syncs[dev], y, chunk, n_chunks, sh.overlap)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    found = sorted(h["t_global"] for h in dedup_reports(
        {k: v.cpu() for k, v in got.items()}, 1, 1))
    assert len(found) == n and all(abs(f - o) <= 2 for f, o in zip(found, sorted(offs)))
