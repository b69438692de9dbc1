"""The port's polyphase resampler vs the JAX package's.

Same numpy inputs through JAX `build_resampler` (its gather path, and its
Pallas kernel in interpret mode) and the port's `build_resampler` (the CUDA
kernel's plain twin on CPU), at rtol 2e-5 / atol 2e-5, the tolerance the
JAX tests hold the Pallas path to (tests/test_resampler.py:136): both sum
the same ~23 float32 products per output in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("LM", [(10, 9), (9, 10), (40, 27)])
@pytest.mark.parametrize("ragged", [0, 7])
def test_resampler_matches_jax(LM, ragged):
    """[2, 4, n_in] batched input, n_in a multiple of M (ragged = 0) and
    not: the m0 < 0 left pad and the zero flush at the tail decide the
    first and last outputs."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu.phy.ops import polyphase as Jp
    from dectnrp_tpu_torch.phy import resampler as T
    from dectnrp_tpu_torch.phy.ops import polyphase

    L, M = LM
    n_in = M * 24 + ragged
    x = _cplx(np.random.default_rng(L * M + ragged), (2, 4, n_in))
    want = np.asarray(J.build_resampler(J.ResamplerPlan(L, M), n_in,
                                        impl="gather")(jnp.asarray(x)))
    n0 = polyphase.launches
    mod = T.build_resampler(T.ResamplerPlan(L, M), n_in, device="cpu")
    got = mod(torch.as_tensor(x)).numpy()
    assert polyphase.launches == n0          # CPU tensors: plain twin
    assert got.shape == want.shape == (2, 4, -(-n_in * L // M))
    np.testing.assert_allclose(got, want, **TOL)
    # the JAX kernel's cached call keeps a constant traced by its first
    # caller; start it afresh so another shape's trace does not reuse it
    Jp._pallas_call.cache_clear()
    pal = np.asarray(J.build_resampler(J.ResamplerPlan(L, M), n_in,
                                       impl="pallas_interpret")(jnp.asarray(x)))
    np.testing.assert_allclose(got, pal, **TOL)


@pytest.mark.parametrize("LM", [(10, 9), (9, 10), (40, 27)])
def test_stream_chain_matches_jax_and_oneshot(LM):
    """Three chunks through the port's streaming module equal JAX's chain and
    the port's one-shot resampler on the `stream_input_lag`-prefixed input."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu_torch.phy import resampler as T

    L, M = LM
    chunk, n_chunks = M * 8, 3
    x = _cplx(np.random.default_rng(L + M), (2, chunk * n_chunks))
    step_j, H_j = J.build_resampler_stream(J.ResamplerPlan(L, M), chunk,
                                           impl="gather")
    step_t = T.build_resampler_stream(T.ResamplerPlan(L, M), chunk, device="cpu")
    assert step_t.H == H_j
    hj = jnp.zeros((2, H_j), jnp.complex64)
    ht = torch.zeros((2, step_t.H), dtype=torch.complex64)
    outs = []
    for c in range(n_chunks):
        xc = x[:, c * chunk:(c + 1) * chunk]
        yj, hj = step_j(jnp.asarray(xc), hj)
        yt, ht = step_t(torch.as_tensor(xc), ht)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=0)
        outs.append(yt.numpy())
    y_stream = np.concatenate(outs, -1)
    lag = T.stream_input_lag(T.ResamplerPlan(L, M))
    x_del = np.concatenate([np.zeros((2, lag), np.complex64), x], -1)
    one = T.build_resampler(T.ResamplerPlan(L, M), x_del.shape[-1], device="cpu")
    y_one = one(torch.as_tensor(x_del)).numpy()
    np.testing.assert_allclose(y_stream, y_one[:, :y_stream.shape[-1]], **TOL)


def test_rate_table_and_lag():
    """get_resampler_fraction (errors included) and stream_input_lag agree
    over the whole verified rate table and every oversampling factor."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu_torch.phy import resampler as T

    assert T.VERIFIED_HW_RATES == J.VERIFIED_HW_RATES
    dect_rates = sorted({r for r, L, M in J.VERIFIED_HW_RATES if L == M == 1})
    n_ok = 0
    for hw, _, _ in J.VERIFIED_HW_RATES:
        for d in dect_rates:
            try:
                want = J.get_resampler_fraction(d, hw)
            except ValueError:
                with pytest.raises(ValueError):
                    T.get_resampler_fraction(d, hw)
                continue
            assert T.get_resampler_fraction(d, hw) == want
            n_ok += 1
            for os in (1, 2, 4, 8):
                assert T.stream_input_lag(T.ResamplerPlan(*want, os)) == \
                    J.stream_input_lag(J.ResamplerPlan(*want, os))
                L, M = want
                assert T.stream_input_lag(T.ResamplerPlan(M, L, os)) == \
                    J.stream_input_lag(J.ResamplerPlan(M, L, os))
    assert n_ok > 28
    for hw, L, M in J.VERIFIED_HW_RATES:
        assert T.get_resampler_fraction(hw * M // L, hw) == (L, M)


def test_identity_plan_passes_through():
    from dectnrp_tpu_torch.phy import resampler as T

    x = torch.as_tensor(_cplx(np.random.default_rng(0), (3, 50)))
    assert T.build_resampler(T.ResamplerPlan(1, 1), 50, device="cpu")(x) is x
    s = T.build_resampler_stream(T.ResamplerPlan(1, 1), 50, device="cpu")
    h = torch.zeros((3, 0), dtype=torch.complex64)
    assert s.H == 0 and s(x, h)[0] is x


def test_wrapper_rejects_bad_input():
    """The checks that guard the kernel hold on CPU tensors too."""
    from dectnrp_tpu_torch.phy.ops.polyphase import polyphase_fir
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    G = torch.as_tensor(_design(ResamplerPlan(10, 9))[0])
    x = torch.zeros((2, 90), dtype=torch.complex64)
    with pytest.raises(ValueError):
        polyphase_fir(x, G, 10, 7, -11, 100)            # ratio outside the set
    with pytest.raises(ValueError):
        polyphase_fir(x.to(torch.complex128), G, 10, 9, -11, 100)
    with pytest.raises(ValueError):
        polyphase_fir(torch.zeros((90, 2), dtype=torch.complex64).T, G, 10, 9,
                      -11, 100)
    with pytest.raises(ValueError):
        polyphase_fir(x, G.double(), 10, 9, -11, 100)
    with pytest.raises(ValueError):
        polyphase_fir(x, G[:9].contiguous(), 10, 9, -11, 100)
