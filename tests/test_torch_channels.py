"""The port's channel models and hardware effects vs the JAX package.

Each random channel of the port is a draw and an apply; these tests hand the
JAX package's own draws to the apply. jax.random cannot be reproduced in
torch, so JAX's Jakes angles and phases are re-derived on the JAX side from
the same key exactly as `_doubly_impl` splits it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SAMP_RATE = 1_728_000          # the loopback's u = 1, b = 1 DECT rate


def _iq(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64) * np.float32(0.6)


@pytest.mark.parametrize("n_bits,limit", [(12, 1.0), (4, 0.5), (8, 2.0)])
def test_clip_quantize_bit_equal(n_bits, limit):
    from dectnrp_tpu.simulation import hardware as J
    from dectnrp_tpu_torch.simulation import hardware as T

    x = _iq(np.random.default_rng(n_bits), 3, 2, 500) * np.float32(1.5)
    x[0, 0, :4] = [limit, -limit, 1j * limit, 0]       # on the rails
    xt = torch.as_tensor(x)
    for jf, tf, args in ((J.clip, T.clip, (limit,)),
                         (J.quantize, T.quantize, (n_bits, limit)),
                         (J.clip_and_quantize, T.clip_and_quantize,
                          (n_bits, limit))):
        want = np.asarray(jf(jnp.asarray(x), *args))
        got = tf(xt, *args).numpy()
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, want, err_msg=jf.__name__)


def test_noise_var_for_snr():
    from dectnrp_tpu.simulation.channels import noise_var_for_snr as J
    from dectnrp_tpu_torch.simulation.channels import noise_var_for_snr as T

    for p, snr in ((1.0, 10.0), (0.37, -3.5), (2.5, 27.0)):
        want = float(J(np.float32(p), np.float32(snr)))
        got = float(T(torch.tensor(p), torch.tensor(snr)))
        assert got == pytest.approx(want, rel=1e-6)
        assert T(p, snr) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("n_tx,n_rx", [(1, 1), (2, 2), (4, 2)])
def test_flat_fading_apply(n_tx, n_rx):
    from dectnrp_tpu.simulation.channels import flat_fading
    from dectnrp_tpu_torch.simulation.channels import (apply_flat_fading,
                                                       draw_flat_fading)

    x = _iq(np.random.default_rng(n_tx), 3, n_tx, 400)
    y_j, H_j = flat_fading(jax.random.PRNGKey(n_rx), jnp.asarray(x), n_rx)
    y_t = apply_flat_fading(torch.as_tensor(x), torch.as_tensor(np.array(H_j)))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    H = draw_flat_fading(torch.Generator().manual_seed(0), 4000, n_rx, n_tx, "cpu")
    assert H.shape == (4000, n_rx, n_tx) and H.dtype == torch.complex64
    assert float((H.abs() ** 2).mean()) == pytest.approx(1.0, abs=0.05)


def _jax_draws(key, B, n_rx, n_tx, L, n_sin=8):
    """theta / phi as _doubly_impl draws them from `key`."""
    k_th, k_ph = jax.random.split(key)
    shape = (B, n_rx, n_tx, L, n_sin)
    return (np.array(jax.random.uniform(k_th, shape, maxval=2 * np.pi)),
            np.array(jax.random.uniform(k_ph, shape, maxval=2 * np.pi)))


def test_tap_table_matches_jax_taps():
    """The port's PDP table is the JAX package's; ITU Ped A scaled to 363 ns
    at 1.728 Ms/s has live taps at 0, 2, 3 and 6 samples, total power 1."""
    from dectnrp_tpu.simulation.channels import PDP_TABLE as JT
    from dectnrp_tpu_torch.simulation.channels import PDP_TABLE, tap_table

    assert PDP_TABLE.keys() == JT.keys()
    for k in PDP_TABLE:
        for a, b in zip(PDP_TABLE[k], JT[k]):
            np.testing.assert_array_equal(a, b)
    active, amps = tap_table(SAMP_RATE, 363e-9, 0)
    np.testing.assert_array_equal(active, [0, 2, 3, 6])
    assert float((amps ** 2).sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("pdp", [0, 1, 2])
@pytest.mark.parametrize("n_tx,n_rx", [(1, 1), (2, 2)])
def test_doubly_selective_apply(pdp, n_tx, n_rx):
    from dectnrp_tpu.simulation.channels import doubly_selective
    from dectnrp_tpu_torch.simulation.channels import apply_doubly, tap_table

    B, n = 3, 720
    x = _iq(np.random.default_rng(10 * pdp + n_tx), B, n_tx, n)
    key = jax.random.PRNGKey(pdp + 7 * n_rx)
    want = np.asarray(doubly_selective(key, jnp.asarray(x), n_rx, SAMP_RATE,
                                       tau_rms_s=363e-9, doppler_hz=222.0,
                                       pdp_idx=pdp))
    L = tap_table(SAMP_RATE, 363e-9, pdp)[0].size
    theta, phi = _jax_draws(key, B, n_rx, n_tx, L)
    got = apply_doubly(torch.as_tensor(x), torch.as_tensor(theta),
                       torch.as_tensor(phi), SAMP_RATE, 363e-9, 222.0, pdp)
    assert got.shape == (B, n_rx, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pdp", [0, 1, 2])
@pytest.mark.parametrize("n_tx,n_rx", [(1, 1), (2, 2)])
def test_doubly_selective_genie_apply(pdp, n_tx, n_rx):
    from dectnrp_tpu.simulation.channels import doubly_selective_genie
    from dectnrp_tpu_torch.sections.part3.phyres import k_b_OCC
    from dectnrp_tpu_torch.simulation.channels import apply_doubly_genie, tap_table

    B, n, N = 2, 720, 64
    sym_centers = tuple(range(20, n, 72))
    k_occ = tuple(int(k) for k in k_b_OCC(1))
    x = _iq(np.random.default_rng(20 * pdp + n_tx), B, n_tx, n)
    key = jax.random.PRNGKey(100 + pdp + 7 * n_rx)
    y_j, H_j = doubly_selective_genie(
        key, jnp.asarray(x), n_rx, SAMP_RATE, sym_centers, k_occ, N,
        tau_rms_s=363e-9, doppler_hz=222.0, pdp_idx=pdp)
    L = tap_table(SAMP_RATE, 363e-9, pdp)[0].size
    theta, phi = _jax_draws(key, B, n_rx, n_tx, L)
    y_t, H_t = apply_doubly_genie(torch.as_tensor(x), torch.as_tensor(theta),
                                  torch.as_tensor(phi), SAMP_RATE, sym_centers,
                                  k_occ, N, 363e-9, 222.0, pdp)
    assert H_t.shape == (B, n_rx, n_tx, len(sym_centers), len(k_occ))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-5, atol=1e-6)


def test_draws_and_composed_channels():
    """The port's own draws: shapes, ranges, unit power, and the composed
    channel equal to its draw + apply from the same generator state."""
    from dectnrp_tpu_torch.simulation import channels as C

    theta, phi = C.draw_doubly(torch.Generator().manual_seed(3), 400, 2, 2, 4, 8,
                               "cpu")
    assert theta.shape == phi.shape == (400, 2, 2, 4, 8)
    assert float(theta.min()) >= 0.0 and float(phi.max()) < 2 * np.pi
    x = torch.as_tensor(_iq(np.random.default_rng(5), 400, 1, 300))
    y = C.doubly_selective(x, 1, SAMP_RATE, torch.Generator().manual_seed(4))
    th, ph = C.draw_doubly(torch.Generator().manual_seed(4), 400, 1, 1, 4, 8, "cpu")
    torch.testing.assert_close(y, C.apply_doubly(x, th, ph, SAMP_RATE),
                               rtol=0, atol=0)
    # Rayleigh taps of total power 1: the output keeps the input's power
    assert float((y.abs() ** 2).mean() / (x.abs() ** 2).mean()) == \
        pytest.approx(1.0, abs=0.1)
    n = C.draw_noise(torch.Generator().manual_seed(6), (20000,), "cpu")
    assert float((n.abs() ** 2).mean()) == pytest.approx(1.0, abs=0.03)
    z = torch.zeros(20000, dtype=torch.complex64)
    torch.testing.assert_close(C.apply_awgn(z, 0.25, n), 0.5 * n)
