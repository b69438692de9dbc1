"""PyTorch + CUDA port of the DECT NR+ (ETSI TS 103 636) PHY in `dectnrp_tpu`.

The JAX package `dectnrp_tpu` is the reference this port is held against
(tests/test_torch_*.py). This package imports torch and numpy and nothing of
the JAX package: the GPU machine has no jax, and every `dectnrp_tpu.phy`
module loads it. The numpy modules it needs (the standard's tables in
`sections/`, packet geometry, channel-estimation matrices, interleavers,
CRC and rate-match maps) are copies, held equal to the originals by
tests/test_torch_tables.py.

Layout mirrors the JAX package: `sections/part3` (ETSI TS 103 636-3
tables), `phy/` (TX, sync, RX), `phy/fec/` (turbo codec, FEC chains),
`phy/ops/` (kernel wrappers), `simulation/` (channels);
the hand-written CUDA sources live in `csrc/` and build at first use
(`kernels.py`). Every kernel wrapper launches its kernel for CUDA tensors and
runs its plain PyTorch twin, in the same module, for CPU tensors.

Numerics: the CRC and RSC GF(2) matmuls and the channel-estimation einsums
must run in full float32 (TF32 keeps ~3 decimal digits, which breaks the
GF(2) sums and the Wiener interpolation parity), so TF32 is off for cuBLAS
and cuDNN from import on.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
