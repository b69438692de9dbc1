"""The port's MIMO estimator and channel scanner against the JAX package's
(tests/test_mimo_estimator.py mirrored): wideband condensation, the
exhaustive codebook search (equal indices, metrics within rtol 1e-5), the
CSI tracker, the RX chain's h_cells and the AoA spectrum, each on the same
numpy inputs through both packages; and `Chscanner`'s RMS against JAX's
`_build_rms` within 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.phy import chscan as Jc, mimo as J
from dectnrp_tpu.sections.part3.beamforming import get_all_W
from dectnrp_tpu_torch.phy import chscan as Tc, mimo as T

torch.set_num_threads(1)


def _brute_force(cells, N_TS):
    """Reference metric in plain numpy: min-cell power, argmax codebook."""
    B, R, Tx, C = cells.shape
    Wall = get_all_W(N_TS, Tx)                    # [n, T, N_TS]
    best = []
    for b in range(B):
        metrics = [min(np.sum(np.abs(cells[b, :, :, c] @ W) ** 2)
                       for c in range(C)) for W in Wall]
        best.append(int(np.argmax(metrics)))
    return best


def _same_reports(got, want):
    assert [r.codebook_index for r in got] == [r.codebook_index for r in want]
    assert [(r.N_TS, r.N_TX) for r in got] == [(r.N_TS, r.N_TX) for r in want]
    np.testing.assert_allclose([r.power_min_cell for r in got],
                               [r.power_min_cell for r in want], rtol=1e-5)


def test_condense_wideband():
    h = np.arange(16, dtype=np.complex64).reshape(1, 1, 1, 16)
    c = T.condense_wideband(h)
    assert tuple(c.shape) == (1, 1, 1, 4)
    assert np.allclose(c[0, 0, 0].numpy(), [1.5, 5.5, 9.5, 13.5])
    rng = np.random.default_rng(1)
    h = (rng.normal(size=(2, 2, 2, 58)) + 1j * rng.normal(size=(2, 2, 2, 58))
         ).astype(np.complex64)
    np.testing.assert_allclose(T.condense_wideband(h).numpy(),
                               J.condense_wideband(h), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("Tx", [2, 4])
def test_codebook_search_matches_bruteforce(Tx):
    rng = np.random.default_rng(7)
    cells = (rng.normal(size=(8, 2, Tx, 4))
             + 1j * rng.normal(size=(8, 2, Tx, 4))).astype(np.complex64)
    reps = T.reports_from_cells(cells, N_TS=1)
    assert [r.codebook_index for r in reps] == _brute_force(cells, 1)
    assert all(r.N_TX == Tx and r.power_min_cell > 0 for r in reps)
    _same_reports(reps, J.reports_from_cells(cells, N_TS=1))
    _same_reports(T.reports_from_cells(torch.from_numpy(cells), N_TS=1), reps)


def test_search_prefers_matched_channel():
    """A channel aligned with codebook vector w selects that index, in both
    packages."""
    Wall = get_all_W(1, 2)                       # [6, 2, 1]
    for idx in range(len(Wall)):
        w = Wall[idx][:, 0]
        cells = (np.conj(w)[None, None, :, None] * np.ones((1, 1, 2, 4))
                 ).astype(np.complex64)
        rep = T.reports_from_cells(cells)[0]
        got_w = Wall[rep.codebook_index][:, 0]
        assert abs(np.vdot(got_w, np.conj(w))) >= abs(
            np.vdot(Wall[idx][:, 0], np.conj(w))) - 1e-6
        _same_reports([rep], J.reports_from_cells(cells))


def test_estimate_mimo_full_band_and_reciprocal():
    rng = np.random.default_rng(3)
    h = (rng.normal(size=(2, 4, 2, 56))
         + 1j * rng.normal(size=(2, 4, 2, 56))).astype(np.complex64)
    reps = T.estimate_mimo(h, N_TS=1)
    assert all(isinstance(r, T.MimoReport) for r in reps)
    _same_reports(reps, J.estimate_mimo(h, N_TS=1))
    recip = T.estimate_mimo(h, N_TS=1, reciprocal=True)
    assert recip[0].N_TX == 4                    # RX<->TX transposed
    _same_reports(recip, J.estimate_mimo(h, N_TS=1, reciprocal=True))
    # SISO: the one-entry codebook; (N_TS, N_TX) = (2, 1) has none
    siso = h[:, :1, :1]
    _same_reports(T.estimate_mimo(siso), J.estimate_mimo(siso))
    assert T.search(T.condense_wideband(siso), N_TS=2) is None
    _same_reports(T.estimate_mimo(siso, N_TS=2), J.estimate_mimo(siso, N_TS=2))


def test_mimo_csi_tracking():
    for pkg in (J, T):
        csi = pkg.MimoCsi()
        csi.update(pkg.MimoReport(3, 1.0, 1, 2), now=100)
        assert csi.codebook_index == 3 and csi.last_update == 100
        for t in range(20):
            csi.update(pkg.MimoReport(t % 4, 1.0, 1, 2), now=200 + t)
        assert len(csi.history) <= 16
    assert csi.history == J.MimoCsi(**vars(csi)).history


def test_rx_h_cells_end_to_end():
    """TxDiv 2x2 packets through the port's TX -> AWGN (numpy noise) -> RX:
    h_cells has the right shape, equals the JAX RX's on the same IQ within
    rtol 1e-4, and the codebook search picks the same indices."""
    from dectnrp_tpu.phy.rx import build_rx as j_rx
    from dectnrp_tpu_torch.phy.rx import build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx
    from dectnrp_tpu_torch.sections.part3.packet_sizes import (PacketSizesDef,
                                                               get_packet_sizes)
    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef as JPs

    psdef = PacketSizesDef(1, 1, 0, 2, 1, 2, 6144)   # tm 1: 2 TX diversity
    ps = get_packet_sizes(psdef)
    nid, B, nv = 0x12345678, 4, 1e-4
    rng = np.random.default_rng(0)
    plcf = torch.as_tensor(rng.integers(0, 2, (B, 40)), dtype=torch.uint8)
    tb = torch.as_tensor(rng.integers(0, 2, (B, ps.N_TB_bits)), dtype=torch.uint8)
    fl = torch.zeros((B,), dtype=torch.bool)
    iq = build_tx(psdef, nid, 1, device="cpu")(plcf, tb, fl, fl).numpy()
    noisy = (iq + np.sqrt(nv / 2) * (rng.standard_normal(iq.shape)
                                     + 1j * rng.standard_normal(iq.shape))
             ).astype(np.complex64)
    out = build_rx(psdef, nid, 1, device="cpu")(torch.from_numpy(noisy),
                                                 torch.tensor(np.float32(nv)))
    assert bool(out["tb_ok"].all())
    cells = out["h_cells"].numpy()
    assert cells.shape == (B, 2, 2, 4)
    reps = T.reports_from_cells(out["h_cells"])
    assert [r.codebook_index for r in reps] == _brute_force(cells, 1)
    out_j = j_rx(JPs(1, 1, 0, 2, 1, 2, 6144), nid, 1)(jnp.asarray(noisy),
                                                       jnp.float32(nv))
    np.testing.assert_allclose(cells, np.asarray(out_j["h_cells"]), rtol=1e-4,
                               atol=1e-5)
    _same_reports(reps, J.reports_from_cells(np.asarray(out_j["h_cells"])))


def test_aoa_bartlett_recovers_azimuth():
    """A plane wave from a known azimuth onto a half-wavelength ULA is
    localized to within the grid step; both packages give the same
    spectrum."""
    from dectnrp_tpu_torch.radio.antenna_array import AntennaArray, C0

    freq = 1.9e9
    arr = AntennaArray("linear", n_ant=4, spacing=(C0 / freq / 2,))
    rng = np.random.default_rng(0)
    for az_true in (-1.0, 0.3, 1.2):
        a = arr.steering(np.array([az_true]), freq)[0]      # [R]
        h = a[:, None] * np.exp(1j * rng.uniform(0, 2 * np.pi, (1, 8)))
        h = h + 0.02 * (rng.standard_normal((4, 8))
                        + 1j * rng.standard_normal((4, 8)))
        az, spec = T.estimate_aoa(h, arr, freq)
        err = min(abs(az - az_true), abs(-az - az_true))
        assert err < 0.05, (az, az_true)
        az_j, spec_j = J.estimate_aoa(h, arr, freq)
        assert az == az_j
        np.testing.assert_allclose(spec, spec_j, rtol=1e-12)


@pytest.mark.parametrize("n_partial,part,n_ant", [(1, 2048, 1), (4, 1024, 2)])
def test_chscanner_rms_matches_jax(n_partial, part, n_ant):
    """Chscanner.scan over a simulated ring: per-partial and per-antenna
    RMS within 1e-6 of JAX's `_build_rms` on the same window."""
    from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator

    rng = np.random.default_rng(n_partial)
    hw = HwSimulator(n_ant)
    hw.device = torch.device("cpu")
    for _ in range(3):
        hw.push_rx_spp((0.3 * (rng.standard_normal((n_ant, 2048))
                               + 1j * rng.standard_normal((n_ant, 2048)))
                        ).astype(np.complex64))
    cs = Tc.Chscanner(hw).scan(Tc.Chscan(1000, 1000 + n_partial * part, n_partial))
    assert cs is not None and cs.done
    win = hw.get_rx_stream(1000, n_partial * part)
    iq = np.ascontiguousarray(win.T).reshape(n_partial, part, -1)
    p_j, a_j = Jc._build_rms(n_partial, part)(jnp.asarray(iq))
    np.testing.assert_allclose(cs.rms_partial, np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(cs.rms_ant, np.asarray(a_j), atol=1e-6)
    assert Tc.Chscanner(hw).scan(Tc.Chscan(0, 10 ** 6, 1)) is None
