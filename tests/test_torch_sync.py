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
