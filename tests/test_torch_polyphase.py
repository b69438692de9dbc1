"""The polyphase FIR kernel's tiled twin vs the plain twin and the JAX kernel.

`polyphase_fir_tiled` walks the CUDA kernel's blocks, staged spans, thread
tiles, phase groups and tap ranges in plain torch, checking every staged
read against the input index it should hold, and sums as the kernel does
(fmaf in ascending tap order). It is held to the plain twin (the CPU route)
over every ratio and oversampling factor the resampler designs, and to the
JAX package's Pallas kernel in interpret mode at the wall step's ratios, at
rtol 2e-5 / atol 2e-5 (tests/test_resampler.py:136: the same ~23 float32
products per output summed in another order). The card tests
(tests/test_torch_cuda.py) hold the kernel to both twins.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
RATIOS = [(10, 9), (40, 27), (20, 9), (80, 27), (2, 1),
          (9, 10), (27, 40), (9, 20), (27, 80), (1, 2)]


def _cplx(rng, shape):
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).astype(np.complex64))


@pytest.mark.parametrize("os", [1, 2, 4, 8])
@pytest.mark.parametrize("LM", RATIOS)
def test_tiled_twin_matches_plain(LM, os):
    """A one-sample input; a ragged input over several blocks, each walking
    two tiles and one crossing a row; a ragged input over many blocks, each
    less than a tile: at the one-shot offset m0 < 0 and a stream offset
    >= 0."""
    from dectnrp_tpu_torch.phy.ops import polyphase as P
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    L, M = LM
    G, m0, W = _design(ResamplerPlan(L, M, os))
    taps = torch.as_tensor(G)
    pl = P.kernel_plan(L, M, W)
    rng = np.random.default_rng(L * M + os)
    for rows, n_in, blocks in ((1, 1, 264), (2, int(1.6 * pl.TF * M) + 7, 2),
                               (3, 997, 5)):
        x = _cplx(rng, (rows, n_in))
        n_out = -(-n_in * L // M)
        for off in (m0, max(0, -m0) + m0):
            got = P.polyphase_fir_tiled(x, taps, L, M, off, n_out, blocks=blocks)
            want = P.polyphase_fir_plain(x, taps, L, M, off, n_out)
            assert got.shape == want.shape == (rows, n_out)
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("LM", [(10, 9), (9, 10)])
def test_tiled_twin_matches_pallas_interpret(LM):
    """[2, 4, n_in] rows, n_in not a multiple of M, through three blocks
    whose shares cross rows, against the JAX resampler's Pallas kernel in
    interpret mode (its cached call cleared first, as
    tests/test_torch_resampler.py does)."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu.phy.ops import polyphase as Jp
    from dectnrp_tpu_torch.phy.ops import polyphase as P
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    L, M = LM
    n_in = M * 100 + 7
    x = _cplx(np.random.default_rng(L + 3 * M), (2, 4, n_in))
    G, m0, _ = _design(ResamplerPlan(L, M))
    n_out = -(-n_in * L // M)
    got = P.polyphase_fir_tiled(x, torch.as_tensor(G), L, M, m0, n_out, blocks=3)
    Jp._pallas_call.cache_clear()
    pal = np.asarray(J.build_resampler(J.ResamplerPlan(L, M), n_in,
                                       impl="pallas_interpret")(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), pal, **TOL)


def test_tiled_twin_bits_do_not_depend_on_blocks():
    """Every output is one chain of fmas over its group's taps, whatever
    block or tile computes it."""
    from dectnrp_tpu_torch.phy.ops import polyphase as P
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    G, m0, _ = _design(ResamplerPlan(80, 27))
    x = _cplx(np.random.default_rng(1), (3, 2000))
    outs = [P.polyphase_fir_tiled(x, torch.as_tensor(G), 80, 27, m0, 5926,
                                  blocks=b) for b in (1, 2, 7, 264)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_tap_ranges_and_zero_groups():
    """Each group's range runs from its first to its last nonzero tap; a
    group of zeros walks none and gives zeros, as the plain twin does."""
    from dectnrp_tpu_torch.phy.ops import polyphase as P
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    for L, M in RATIOS:
        G, _, W = _design(ResamplerPlan(L, M))
        LG = P.kernel_plan(L, M, W).LG
        for g, (lo, hi) in enumerate(P.tap_ranges(G, LG)):
            nz = np.flatnonzero((G[g * LG:(g + 1) * LG] != 0).any(0))
            assert (lo, hi) == (nz[0], nz[-1] + 1)
    G, m0, W = _design(ResamplerPlan(20, 9))
    G = G.copy()
    G[10:] = 0
    G[:10, 3] = 0                      # an interior zero column stays walked
    assert P.tap_ranges(G, 10) == (P.tap_ranges(_design(ResamplerPlan(20, 9))[0],
                                                10)[0], (0, 0))
    x = _cplx(np.random.default_rng(2), (2, 450))
    got = P.polyphase_fir_tiled(x, torch.as_tensor(G), 20, 9, m0, 1000, blocks=3)
    torch.testing.assert_close(
        got, P.polyphase_fir_plain(x, torch.as_tensor(G), 20, 9, m0, 1000), **TOL)
    assert torch.equal(got.reshape(2, -1, 20)[..., 10:],
                       torch.zeros((2, 50, 10), dtype=torch.complex64))


def test_kernel_plan_serves_every_design_and_names_refusals():
    """Every ratio x oversampling factor of _design fits a block (W up to
    143 at 27/80); designs beyond the kernel's limits raise with the reason,
    and the CPU route still serves them through the plain twin."""
    from dectnrp_tpu_torch.phy.ops import polyphase as P
    from dectnrp_tpu_torch.phy.resampler import ResamplerPlan, _design

    for L, M in RATIOS:
        for os in (1, 2, 4, 8):
            W = _design(ResamplerPlan(L, M, os))[2]
            pl = P.kernel_plan(L, M, W)
            assert pl.smem <= 232448 and pl.NG * pl.LG == L and pl.SP % 2 == 1
    with pytest.raises(ValueError, match="shared memory"):
        P.kernel_plan(10, 9, 5000)
    with pytest.raises(ValueError, match="groups of 1, 2, 9 or 10"):
        P.kernel_plan(7, 9, 40)
    with pytest.raises(ValueError, match="phase groups"):
        P.kernel_plan(90, 9, 40)
    with pytest.raises(ValueError, match="W >= M"):
        P.kernel_plan(10, 9, 8)
    x = _cplx(np.random.default_rng(3), (2, 900))
    big = torch.as_tensor(np.random.default_rng(4).standard_normal((10, 5000)),
                          dtype=torch.float32)
    torch.testing.assert_close(P.polyphase_fir(x, big, 10, 9, -2500, 1000),
                               P.polyphase_fir_plain(x, big, 10, 9, -2500, 1000))
