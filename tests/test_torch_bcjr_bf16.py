"""The bf16 BCJR's plain twin (the CPU path of the bf16 kernel's wrapper) vs
dectnrp_tpu.phy.fec.bcjr_pallas._pallas_bcjr_call_bf16 in interpret mode.

The posterior is compared at rtol 2^-6 / atol 0.5, not bit for bit: XLA on
the CPU may keep the kernel's bf16 intermediates in float32 across fused
ops, where torch rounds after every op (as the CUDA kernel does). The
largest gap measured at these inputs is 0.125 (one bf16 step at |L| in
[16, 32)). Turbo decisions through `impl="cuda_bf16"` must equal JAX's
`impl="pallas_bf16_interpret"` on clean and on noisy LLRs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def _encoded(K, B, seed):
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_encode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    return rng, bits, np.asarray(turbo_encode(jnp.asarray(bits), K))


@pytest.mark.parametrize("K,B", [(512, 3), (1056, 2)])
def test_bf16_twin_matches_pallas_interpret(K, B):
    from dectnrp_tpu.phy.fec.bcjr_pallas import bcjr_posterior_pallas_cm
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    rng = np.random.default_rng(K)
    Lsys = (rng.standard_normal((K + 3, B)) * 3).astype(np.float32)
    Lp = (rng.standard_normal((K + 3, B)) * 3).astype(np.float32)
    ref = np.asarray(bcjr_posterior_pallas_cm(jnp.asarray(Lsys), jnp.asarray(Lp),
                                              K, bf16=True, interpret=True))
    n0 = bcjr_cuda.launches_bf16
    got = bcjr_cuda.bcjr_posterior_cm_bf16(torch.as_tensor(Lsys),
                                           torch.as_tensor(Lp), K)
    assert bcjr_cuda.launches_bf16 == n0          # CPU tensors: the twin
    assert got.dtype == torch.float32 and got.shape == (K, B)
    twin = bcjr_cuda.bcjr_windowed_cm_bf16_plain(torch.as_tensor(Lsys),
                                                 torch.as_tensor(Lp), K)
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -6, atol=0.5)
    # the posterior is the bf16 max-difference: a multiple of its bf16 ulp
    f32 = bcjr_cuda.bcjr_windowed_cm_plain(torch.as_tensor(Lsys),
                                           torch.as_tensor(Lp), K).numpy()
    np.testing.assert_allclose(got.numpy(), f32, rtol=2 ** -5, atol=1.0)


def test_bf16_turbo_decode_clean_matches_jax():
    """Clean +-4 LLRs: both packages' bf16 decodes return the sent bits."""
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode
    from dectnrp_tpu_torch.phy.fec import turbo as T

    K, B = 2048, 2
    _, bits, d = _encoded(K, B, 0)
    llr = np.where(d > 0, 4.0, -4.0).astype(np.float32)
    o_j = np.asarray(turbo_decode(jnp.asarray(llr), K, n_iter=2,
                                  impl="pallas_bf16_interpret")[0])
    o_t = T.turbo_decode(torch.as_tensor(llr), K, 2, impl="cuda_bf16")[0].numpy()
    np.testing.assert_array_equal(o_t, bits)
    np.testing.assert_array_equal(o_t, o_j)


def test_bf16_turbo_decode_noisy_matches_jax(sigma=1.0):
    """BPSK at sigma = 1.0, 4 iterations: the bf16 decode gives JAX's bf16
    decisions and the float32 decode's."""
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode
    from dectnrp_tpu_torch.phy.fec import turbo as T

    K, B = 1056, 2
    rng, bits, d = _encoded(K, B, 1)
    y = np.where(d > 0, 1.0, -1.0) + sigma * rng.standard_normal(d.shape)
    llr = (2.0 / sigma ** 2 * y).astype(np.float32)
    o_j = np.asarray(turbo_decode(jnp.asarray(llr), K, n_iter=4,
                                  impl="pallas_bf16_interpret")[0])
    o_t = T.turbo_decode(torch.as_tensor(llr), K, 4, impl="cuda_bf16")[0].numpy()
    o_f = T.turbo_decode(torch.as_tensor(llr), K, 4, impl="cuda")[0].numpy()
    np.testing.assert_array_equal(o_t, o_j)
    np.testing.assert_array_equal(o_t, o_f)
    np.testing.assert_array_equal(o_t, bits)


@pytest.mark.parametrize("Lw,D", [(126, 32), (128, 30)])
def test_bf16_twin_needs_4_step_groups(Lw, D):
    """The 4-step renormalization groups need Lw + 2D and D + Lw to be
    multiples of 4, as the TPU kernel asserts."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    x = torch.zeros((515, 2))
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm_bf16(x, x, 512, Lw, D)


# (K, Lw, D) for the kernel's own walk: K + 3 < Lw and K + 3 = Lw (one
# window), K a multiple of Lw (a window of tail steps only, left out), the
# oracle's K = 424 and K = 1056; Lw = 68 is not a multiple of the checkpoint
# spacing 8, D = 0 runs no acquisition
CKPT_CASES = [(K, Lw, D)
              for Lw, D in ((128, 32), (64, 16), (128, 0), (68, 4))
              for K in (Lw - 23, Lw - 3, 4 * Lw, 424, 1056)]


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("K,Lw,D", CKPT_CASES)
def test_bf16_ckpt_twin_matches_plain(K, Lw, D, B):
    """The kernel's order (valid positions only, every 8th alpha kept and
    the rest recomputed, renormalisation by position mod 4, tail-only
    windows skipped) gives the plain twin's bits."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    rng = np.random.default_rng(7 * K + B)
    Lsys = torch.as_tensor((rng.standard_normal((K + 3, B)) * 3).astype(np.float32))
    Lp = torch.as_tensor((rng.standard_normal((K + 3, B)) * 3).astype(np.float32))
    want = bcjr_cuda.bcjr_windowed_cm_bf16_plain(Lsys, Lp, K, Lw, D)
    got = bcjr_cuda.bcjr_windowed_cm_bf16_ckpt(Lsys, Lp, K, Lw, D)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("Lw,D", [(None, 32), (0, 32), (128, -4), (126, 32)])
def test_bf16_wrapper_refuses_windows_the_kernel_cannot_take(Lw, D):
    """The windows the bf16 wrapper's card route refuses
    (`check_bf16_window`): beyond the kernel's shared memory (`LW_MAX_BF16`
    steps: ceil(Lw / 8) checkpoints of 512 bytes in 232,448), empty, with
    D < 0, or not in whole 4-step groups. The longest window passes."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    M = bcjr_cuda.LW_MAX_BF16
    assert -(-M // 8) * 512 <= 232448 < (-(-M // 8) + 1) * 512
    bcjr_cuda.check_bf16_window(M, 32)
    Lw = M + 4 if Lw is None else Lw
    with pytest.raises(ValueError):
        bcjr_cuda.check_bf16_window(Lw, D)
