"""Port's QAM mapping / max-log demapping vs dectnrp_tpu.phy.modulation."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


@pytest.mark.parametrize("n_bps", [1, 2, 4, 6, 8, 10])
def test_map_and_demap_match_jax(n_bps):
    from dectnrp_tpu.phy import modulation as J
    from dectnrp_tpu_torch.phy import modulation as T

    rng = np.random.default_rng(n_bps)
    B, n_sym = 3, 64
    bits = rng.integers(0, 2, (B, n_sym * n_bps)).astype(np.uint8)
    x_j = np.asarray(J.map_bits(jnp.asarray(bits), n_bps))
    x_t = T.map_bits(torch.as_tensor(bits), n_bps).numpy()
    assert x_t.dtype == np.complex64
    np.testing.assert_allclose(x_t, x_j, rtol=1e-6, atol=1e-7)

    # noisy equalized symbols (noise well inside half the level spacing
    # 1/norm) and per-cell channel quality
    s = 0.2 / J._NORM[n_bps]
    y = (x_j + s * (rng.standard_normal(x_j.shape)
                       + 1j * rng.standard_normal(x_j.shape))).astype(np.complex64)
    csi = rng.uniform(0.5, 2.0, y.shape).astype(np.float32)
    nv = np.float32(0.03)
    l_j = np.asarray(J.demap_llr(jnp.asarray(y), jnp.asarray(csi), n_bps, nv))
    l_t = T.demap_llr(torch.as_tensor(y), torch.as_tensor(csi), n_bps,
                      float(nv)).numpy()
    assert l_t.dtype == np.float32 and l_t.shape == bits.shape
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=1e-4)
    # hard decisions of the demapper recover the mapped bits
    np.testing.assert_array_equal((l_t > 0).astype(np.uint8), bits)

    h_j = np.asarray(J.hard_decision(jnp.asarray(y), n_bps))
    h_t = T.hard_decision(torch.as_tensor(y), n_bps).numpy()
    np.testing.assert_allclose(h_t, h_j, rtol=1e-6, atol=1e-7)
