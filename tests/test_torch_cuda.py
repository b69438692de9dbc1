"""The port's CUDA kernels vs their plain twins, on the card.

Marked `cuda`: every test skips without a CUDA device (decided in the
fixture, never at import). Imports no JAX, so it runs on the card's machine
with tests/conftest.py (which loads jax) switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("K,B", [(512, 3), (1056, 2), (6016, 64), (6080, 40)])
def test_bcjr_kernel_matches_plain(dev, K, B):
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    g = torch.Generator(device=dev).manual_seed(K)
    Lsys = torch.randn((K + 3, B), generator=g, device=dev) * 3
    Lp = torch.randn((K + 3, B), generator=g, device=dev) * 3
    n0 = bcjr_cuda.launches
    got = bcjr_cuda.bcjr_posterior_cm(Lsys, Lp, K)
    assert bcjr_cuda.launches == n0 + 1
    want = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_bcjr_wrapper_rejects_bad_input(dev):
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda

    x = torch.zeros((515, 4), device=dev)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x.T.contiguous().T, x, 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x.double(), x.double(), 512)
    with pytest.raises(ValueError):
        bcjr_cuda.bcjr_posterior_cm(x, x, 600)


@pytest.mark.parametrize("u,b,R", [(1, 1, 1), (1, 2, 2), (1, 8, 1), (1, 16, 1),
                                   (8, 16, 2)])
def test_sync_kernel_matches_plain(dev, u, b, R):
    from dectnrp_tpu_torch.sections.part3.stf import cover_sequence
    from dectnrp_tpu_torch.phy.ops import sync_detect

    P, B = 16 * b, 3
    T = 300 * P + 7
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn((B, R, T), dtype=torch.complex64, generator=g, device=dev)
    # a strongly periodic, cover-weighted segment so the gate opens
    cov = torch.as_tensor(np.resize(cover_sequence(u), 12).astype(np.float32),
                          device=dev)
    x[0, :, 5 * P:17 * P] = x[0, :, :P].repeat(1, 12) * cov.repeat_interleave(P)
    w = torch.as_tensor((cover_sequence(u)[:-1] * cover_sequence(u)[1:]
                         ).astype(np.float32), device=dev)
    sl, sr, thr, mmax = 7 * b, b, 0.25, 1.5
    n0 = sync_detect.launches
    got = sync_detect.detect_sm(x, P, w, sl, sr, thr, mmax)
    assert sync_detect.launches == n0 + 1
    want = sync_detect.detect_sm_plain(x, P, w, sl, sr, thr, mmax)
    metric, _, _ = sync_detect.detect_metric_plain(x, P, w)
    ok = sync_detect.gate_tie_mask(metric, thr, mmax, sl, sr, 1e-3)
    assert ok.float().mean() > 0.9
    torch.testing.assert_close(got[ok], want[ok], rtol=2e-3, atol=2e-4)
    assert got[0].max() > thr
