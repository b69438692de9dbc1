"""Doppler-axis chestim helpers and the hard-decision slicer, mirrored on
the port (tests/test_chestim_doppler.py), plus the series fallback of
`_j0` that no JAX test reaches: with scipy.special hidden, the A&S
polynomial against scipy's J0 and the fallback's time-Wiener bank against
JAX's.
"""
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_wiener_time_matrix_static_channel_exact():
    """Rows sum to 1: a static channel passes unchanged; nu = 0 degenerates
    to uniform DRS averaging; each table equals JAX's."""
    from dectnrp_tpu.phy import chestim as J
    from dectnrp_tpu_torch.phy.chestim import wiener_time_matrix

    for nu in (0.0, 0.008, 0.024):
        T = wiener_time_matrix(1, 1, 24, 1, nu)
        np.testing.assert_allclose(T.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(T, J.wiener_time_matrix(1, 1, 24, 1, nu))
    T0 = wiener_time_matrix(1, 1, 24, 1, 0.0)
    n = T0.shape[-1]
    np.testing.assert_allclose(T0[0, 5], np.full(n, 1.0 / n), atol=1e-3)


def test_wiener_time_matrix_edge_rows_clamped():
    """Beyond the DRS span the smoother holds the edge row."""
    from dectnrp_tpu_torch.phy.chestim import wiener_time_matrix

    T = wiener_time_matrix(1, 1, 24, 1, 0.024, 35.0)
    np.testing.assert_allclose(T[0, 22], T[0, 21], atol=1e-6)
    np.testing.assert_allclose(T[0, 23], T[0, 21], atol=1e-6)
    assert np.abs(T[0, 23]).sum() < 2.0, "extrapolation weights blew up"


def test_nu_from_drs_corr_inverts_j0():
    from dectnrp_tpu_torch.phy.chestim import _j0, nu_from_drs_corr

    for nu in (0.002, 0.01, 0.03):
        rho = _j0(2 * np.pi * nu * 5)
        np.testing.assert_allclose(nu_from_drs_corr(np.asarray(rho), 5), nu,
                                   rtol=1e-2)


def test_j0_series_fallback_matches_scipy():
    """`_j0` (scipy's J0 where scipy imports) against scipy on [0, 8] at
    the JAX test's 2e-4, and equal to the JAX package's `_j0`."""
    scipy_special = pytest.importorskip("scipy.special")
    from dectnrp_tpu.phy import chestim as J
    from dectnrp_tpu_torch.phy import chestim

    x = np.linspace(0.0, 8.0, 200)
    np.testing.assert_allclose(chestim._j0(x), scipy_special.j0(x), atol=2e-4)
    np.testing.assert_array_equal(chestim._j0(x), J._j0(x))


def test_j0_fallback_without_scipy(monkeypatch):
    """With scipy.special unimportable, `_j0` takes the Abramowitz & Stegun
    9.4.1 / 9.4.3 polynomials: within 1e-6 of scipy's J0 on [0, 8] (their
    stated error is below 1e-7), both branches reached; the time-Wiener
    bank built on it within 1e-5 of JAX's (built on scipy)."""
    scipy_special = pytest.importorskip("scipy.special")
    from dectnrp_tpu.phy import chestim as J
    from dectnrp_tpu_torch.phy import chestim

    x = np.linspace(0.0, 8.0, 200)
    monkeypatch.setitem(sys.modules, "scipy.special", None)
    with pytest.raises(ImportError):
        __import__("scipy.special")
    got = chestim._j0(x)
    T = chestim.wiener_time_matrix.__wrapped__(1, 1, 24, 1, 0.024, 35.0)
    monkeypatch.undo()
    assert (x <= 3.0).any() and (x > 3.0).any()
    np.testing.assert_allclose(got, scipy_special.j0(x), atol=1e-6)
    np.testing.assert_allclose(T, J.wiener_time_matrix(1, 1, 24, 1, 0.024, 35.0),
                               atol=1e-5)


def test_hard_decision_roundtrip():
    """Slicing noiseless mapped symbols recovers the exact points, and the
    port's slicer equals JAX's on noisy symbols."""
    import jax.numpy as jnp

    from dectnrp_tpu.phy import modulation as J
    from dectnrp_tpu_torch.phy.modulation import hard_decision, map_bits

    rng = np.random.default_rng(0)
    for n_bps in (1, 2, 4, 6):
        bits = rng.integers(0, 2, (3, 20 * n_bps)).astype(np.uint8)
        x = map_bits(torch.as_tensor(bits), n_bps)
        d = hard_decision(x + 0.01 * (1 + 1j), n_bps)
        np.testing.assert_allclose(d.numpy(), x.numpy(), atol=1e-6)
        y = (x.numpy() + 0.2 * (rng.standard_normal(x.shape)
                                + 1j * rng.standard_normal(x.shape))
             ).astype(np.complex64)
        np.testing.assert_allclose(
            hard_decision(torch.as_tensor(y), n_bps).numpy(),
            np.asarray(J.hard_decision(jnp.asarray(y), n_bps)), atol=1e-6)
