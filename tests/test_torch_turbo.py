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


@pytest.mark.parametrize("K,Lw,D", [(56, 59, 0), (96, 99, 0), (424, 427, 0),
                                    (56, 128, 32), (96, 128, 32),
                                    (424, 512, 32)])
def test_one_window_twin_is_unwindowed_bcjr(K, Lw, D):
    """The kernel's plain twin run as ONE window (Lw = K+3 with D = 0, or a
    longer window with its D = 32 acquisition steps outside the trellis) is
    the unwindowed BCJR bit for bit, and within the tolerance of
    test_unwindowed_bcjr_matches_jax of the JAX function."""
    from dectnrp_tpu.phy.fec.turbo_jax import _bcjr_posterior
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior as t_bcjr

    rng = np.random.default_rng(K + Lw)
    B = 5
    Ls = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    Lp = (rng.standard_normal((B, K + 3)) * 3).astype(np.float32)
    La = rng.standard_normal((B, K)).astype(np.float32)
    want = t_bcjr(torch.as_tensor(Ls), torch.as_tensor(Lp), torch.as_tensor(La), K)
    Lsys = torch.as_tensor(Ls) + torch.nn.functional.pad(torch.as_tensor(La), (0, 3))
    n0, n1 = bcjr_cuda.launches, bcjr_cuda.launches_one_window
    got = bcjr_cuda.bcjr_posterior_cm(Lsys.T.contiguous(),
                                      torch.as_tensor(Lp).T.contiguous(), K, Lw, D)
    assert (bcjr_cuda.launches, bcjr_cuda.launches_one_window) == (n0, n1)
    assert torch.equal(got.T, want)
    ref = np.asarray(_bcjr_posterior(jnp.asarray(Ls), jnp.asarray(Lp),
                                     jnp.asarray(La), K))
    np.testing.assert_allclose(got.T.numpy(), ref, rtol=1e-4, atol=1e-3)


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


@pytest.mark.parametrize("window,impl_t,impl_j", [(0, "plain", "xla"),
                                                  (64, "plain", "xla"),
                                                  (None, "plain", "xla"),
                                                  (64, "cuda", "xla")])
def test_turbo_entry_window_impl_matches_jax(window, impl_t, impl_j):
    """The decoder's full entry point: an unwindowed decode at K = 1056, a
    64-step window, and "plain" against JAX's "xla", at the tolerances of
    test_turbo_decode_early_matches_jax (the kernel impl runs its plain
    twin on CPU tensors)."""
    from dectnrp_tpu.phy.fec.crc import POLY_CRC24A, crc_matrix
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode, turbo_decode_early
    from dectnrp_tpu_torch.phy.fec import turbo as T

    K, B = 1056, 3
    c, llr = _coded_llrs(K, B, seed=7, sigma=0.85)
    m = crc_matrix(K - 24, POLY_CRC24A)
    bj, _, okj, itj = turbo_decode_early(jnp.asarray(llr), jnp.asarray(m), K,
                                         n_iter_max=4, n_iter_min=2,
                                         window=window, impl=impl_j)
    bt, pt, okt, itt = T.turbo_decode_early(torch.as_tensor(llr),
                                            torch.as_tensor(m), K,
                                            n_iter_max=4, n_iter_min=2,
                                            window=window, impl=impl_t)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert itt == int(itj) and pt.shape == (B, K)
    b3j, p3j = turbo_decode(jnp.asarray(llr), K, 3, window=window, impl=impl_j)
    b3t, p3t = T.turbo_decode(torch.as_tensor(llr), K, 3, window=window,
                              impl=impl_t)
    np.testing.assert_array_equal(b3t.numpy(), np.asarray(b3j))
    np.testing.assert_allclose(p3t.numpy(), np.asarray(p3j), rtol=1e-4, atol=1e-2)


def test_resolve_bcjr():
    """window=None: 128-step windows for K >= 512, none below; "auto" takes
    plain torch on the CPU and the float32 kernel on the card, for windowed
    decodes and, as one window over the whole trellis, for unwindowed
    decodes (one too long for its shared memory raises, it never turns to
    plain torch); the explicit kernel impls need a window, as JAX asserts."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec import turbo as T

    kind, fn = T._resolve_bcjr(6016, None, "auto", torch.device("cuda"))
    assert kind == "cm" and fn.func is bcjr_cuda.bcjr_posterior_cm
    assert fn.keywords == {"K": 6016, "Lw": 128, "D": 32}
    kind, fn = T._resolve_bcjr(6016, None, "auto", "cpu")
    assert kind == "rm" and fn.func is T._bcjr_posterior_windowed
    for K, window in ((56, None), (96, None), (424, None), (56, 0), (1056, 0)):
        kind, fn = T._resolve_bcjr(K, window, "auto", "cuda")
        assert kind == "cm" and fn.func is bcjr_cuda.bcjr_posterior_cm
        assert fn.keywords == {"K": K, "Lw": K + 3, "D": 0}
        assert T._resolve_bcjr(K, window, "auto", "cpu") == ("rm", T._bcjr_posterior)
        assert T._resolve_bcjr(K, window, "plain", "cuda") == ("rm", T._bcjr_posterior)
    # an unwindowed trellis longer than the kernel's shared memory holds
    assert bcjr_cuda.LW_MAX == 1816
    assert T._resolve_bcjr(1813, 0, "auto", "cuda")[1].keywords["Lw"] == 1816
    for K in (1814, 6144):
        with pytest.raises(ValueError, match="one window"):
            T._resolve_bcjr(K, 0, "auto", "cuda")
        assert T._resolve_bcjr(K, 0, "auto", "cpu") == ("rm", T._bcjr_posterior)
        assert T._resolve_bcjr(K, 0, "plain", "cuda") == ("rm", T._bcjr_posterior)
    kind, fn = T._resolve_bcjr(848, 64, "cuda_bf16", "cpu")
    assert kind == "cm" and fn.func is bcjr_cuda.bcjr_posterior_cm_bf16
    assert fn.keywords["Lw"] == 64
    for impl in ("cuda", "cuda_bf16"):
        with pytest.raises(ValueError):
            T._resolve_bcjr(1056, 0, impl, "cpu")
        with pytest.raises(ValueError):
            T._resolve_bcjr(96, None, impl, "cuda")
        with pytest.raises(ValueError):
            T._resolve_bcjr(56, 0, impl, "cuda")
    with pytest.raises(ValueError):
        T._resolve_bcjr(1056, None, "pallas", "cpu")
    llr = torch.zeros((1, 3, 1060))
    with pytest.raises(ValueError):
        T.turbo_decode(llr, 1056, 1, window=0, impl="cuda")
