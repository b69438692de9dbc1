"""Constant tables of the port: numpy builders -> device tensors.

This PHY has no trained weights; its parameters are per-configuration
constant tables (QPP interleavers, rate-match maps, scrambling sequences,
CRC GF(2) matrices, trellis LUTs, cell indices, STF templates, Wiener banks).
The port builds them with numpy from copies of the JAX package's builders
and turns them into tensors in one place, `tables_to_device`. The builder
modules (`build_tx`, `build_sync`, `build_rx`, `build_resampler`, ...)
register the result as buffers and move themselves to the device they are
asked for ("cuda" unless the caller says otherwise); the plain FEC
functions fetch theirs through `device_tables` on their inputs' device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Callable

import numpy as np
import torch

# numpy -> torch dtype, mirroring jnp.asarray with x64 off (float64 and
# complex128 narrow to 32-bit), except that integer tables widen to int64,
# the index dtype torch's gathers take
_DTYPES = {
    np.dtype(np.float64): torch.float32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.complex128): torch.complex64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def tables_to_device(np_tables: Any, device: torch.device | str) -> Any:
    """Numpy arrays (alone or in dicts/tuples/lists) -> tensors on `device`.

    Non-array leaves (ints, floats, strings, None) pass through unchanged.
    """
    if isinstance(np_tables, np.ndarray):
        return torch.as_tensor(np_tables, dtype=_DTYPES[np_tables.dtype],
                               device=device)
    if isinstance(np_tables, dict):
        return {k: tables_to_device(v, device) for k, v in np_tables.items()}
    if isinstance(np_tables, (tuple, list)):
        return type(np_tables)(tables_to_device(v, device) for v in np_tables)
    return np_tables


@lru_cache(maxsize=None)
def device_tables(builder: Callable, key: tuple, device: torch.device):
    """`tables_to_device(builder(*key), device)`, built once per device.

    The tensors are shared constants: callers must not write to them.
    """
    return tables_to_device(builder(*key), device)


def register_tables(module: torch.nn.Module, np_tables: dict) -> None:
    """Register each numpy table as a non-persistent buffer of `module`."""
    for name, t in tables_to_device(np_tables, "cpu").items():
        module.register_buffer(name, t, persistent=False)
