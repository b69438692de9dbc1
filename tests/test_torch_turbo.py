"""Port's turbo codec and windowed BCJR vs dectnrp_tpu.phy.fec.turbo_jax.

The windowed BCJR's plain twin (the CPU path of the CUDA kernel's wrapper)
is held to both the XLA windowed BCJR and the Pallas kernel in interpret
mode, at the tolerance of tests/test_fec_bcjr_pallas.py (rtol 1e-4,
atol 1e-3: the Pallas kernel leaves its metrics unnormalized, the others
subtract the max every step).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def _coded_llrs(K, B, seed, sigma=1.0):
    """Encoded random bits [B, K] and their noisy d-LLRs [B, 3, K+4]."""
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_encode

    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.asarray(turbo_encode(jnp.asarray(c), K)).astype(np.float32)
    llr = ((2.0 * d - 1.0) * 2.0 / sigma ** 2
           + 2.0 / sigma * rng.standard_normal(d.shape)).astype(np.float32)
    return c, llr


@pytest.mark.parametrize("K", [56, 96, 960, 1056, 6080])
def test_turbo_encode_bit_exact(K):
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_encode
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_encode as t_encode

    c = np.random.default_rng(K).integers(0, 2, (3, K)).astype(np.uint8)
    d_j = np.asarray(turbo_encode(jnp.asarray(c), K))
    d_t = t_encode(torch.as_tensor(c), K).numpy()
    assert d_t.dtype == np.uint8
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("K,B", [(512, 3), (1056, 2)])
def test_windowed_bcjr_matches_xla_and_pallas(K, B):
    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_pallas
    from dectnrp_tpu.phy.fec.turbo_jax import _bcjr_posterior_windowed
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior_windowed as t_win

    rng = np.random.default_rng(K)
    Ls = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    Lp = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    La = rng.standard_normal((B, K)).astype(np.float32)
    ref = np.asarray(_bcjr_posterior_windowed(
        jnp.asarray(Ls), jnp.asarray(Lp), jnp.asarray(La), K, Lw=128, D=32))
    pal = np.asarray(bcjr_posterior_pallas(
        jnp.asarray(Ls), jnp.asarray(Lp), jnp.asarray(La), K, Lw=128, D=32,
        interpret=True))
    n0 = bcjr_cuda.launches
    got = t_win(torch.as_tensor(Ls), torch.as_tensor(Lp), torch.as_tensor(La),
                K).numpy()
    # the kernel wrapper on CPU tensors takes the plain twin: no launch
    Lsys = torch.as_tensor(Ls) + torch.nn.functional.pad(torch.as_tensor(La), (0, 3))
    got_w = bcjr_cuda.bcjr_posterior_cm(Lsys.T.contiguous(),
                                        torch.as_tensor(Lp).T.contiguous(), K)
    assert bcjr_cuda.launches == n0
    np.testing.assert_array_equal(got_w.T.numpy(), got)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, pal, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("K", [56, 96])
def test_unwindowed_bcjr_matches_jax(K):
    from dectnrp_tpu.phy.fec.turbo_jax import _bcjr_posterior
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior as t_bcjr

    rng = np.random.default_rng(K)
    B = 4
    Ls = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    Lp = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    La = rng.standard_normal((B, K)).astype(np.float32)
    ref = np.asarray(_bcjr_posterior(jnp.asarray(Ls), jnp.asarray(Lp),
                                     jnp.asarray(La), K))
    got = t_bcjr(torch.as_tensor(Ls), torch.as_tensor(Lp),
                 torch.as_tensor(La), K).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("K,B,sigma", [(56, 6, 0.9), (1056, 4, 0.8)])
def test_turbo_decode_early_matches_jax(K, B, sigma):
    from dectnrp_tpu.phy.fec.crc import POLY_CRC24A, crc_matrix
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode, turbo_decode_early
    from dectnrp_tpu_torch.phy.fec import turbo as T

    c, llr = _coded_llrs(K, B, seed=K, sigma=sigma)
    m = crc_matrix(K - 24, POLY_CRC24A)
    bj, _, okj, itj = turbo_decode_early(jnp.asarray(llr), jnp.asarray(m), K,
                                         n_iter_max=6, n_iter_min=2)
    bt, _, okt, itt = T.turbo_decode_early(torch.as_tensor(llr),
                                           torch.as_tensor(m), K,
                                           n_iter_max=6, n_iter_min=2)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert itt == int(itj)
    b4j, _ = turbo_decode(jnp.asarray(llr), K, 4)
    b4t, _ = T.turbo_decode(torch.as_tensor(llr), K, 4)
    np.testing.assert_array_equal(b4t.numpy(), np.asarray(b4j))
