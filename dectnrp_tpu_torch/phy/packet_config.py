"""Per-packet-configuration static geometry for the jit TX/RX chains.

The reference pre-bakes stf/drs/pcc/pdc LUT objects at startup
(lib/src/phy/tx_rx.cpp); here the analogous bundle is a cached numpy struct of
scatter/gather index arrays so the whole packet maps onto the frequency grid
with a single scatter inside jit (static shapes, MXU/VPU-friendly).

Grid layout: [N_TS, N_PACKET_symb, N_b_DFT] centered spectrum (DC at N_b_DFT/2).
Flat cell index = ts * (S*N) + l * N + k.

Numpy-only copy of `dectnrp_tpu/phy/packet_config.py`: importing any `dectnrp_tpu.phy`
module loads jax through that package's `__init__`, so the port keeps
its own copy. `tests/test_torch_tables.py` holds it equal to the original.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..sections.part3 import drs, pcc, pdc, stf
from ..sections.part3.packet_sizes import PacketSizes, PacketSizesDef, get_packet_sizes
from ..sections.part3.tx_div import TS_PAIRS, get_modulo


@dataclass(frozen=True)
class AlamoutiLuts:
    """Static gather/sign arrays for space-frequency block coding of one
    cell stream onto N_TS transmit streams.

    out[t, i] = a[t, i] * x[ga[t, i]] + b[t, i] * conj(x[gb[t, i]])
    """
    a: np.ndarray    # [N_TS, n_cells] complex (0 or +-1/sqrt2)
    b: np.ndarray    # [N_TS, n_cells] complex
    ga: np.ndarray   # [N_TS, n_cells] int32
    gb: np.ndarray   # [N_TS, n_cells] int32


@lru_cache(maxsize=None)
def alamouti_luts(n_cells: int, N_TS: int) -> AlamoutiLuts:
    assert n_cells % 2 == 0
    a = np.zeros((N_TS, n_cells), dtype=np.complex128)
    b = np.zeros((N_TS, n_cells), dtype=np.complex128)
    ga = np.zeros((N_TS, n_cells), dtype=np.int32)
    gb = np.zeros((N_TS, n_cells), dtype=np.int32)
    pairs = TS_PAIRS[N_TS]
    mod = get_modulo(N_TS)
    s = 1.0 / np.sqrt(2.0)
    for p in range(n_cells // 2):
        ta, tb = pairs[p % mod]
        a[ta, 2 * p] = s
        ga[ta, 2 * p] = 2 * p
        a[ta, 2 * p + 1] = s
        ga[ta, 2 * p + 1] = 2 * p + 1
        b[tb, 2 * p] = -s
        gb[tb, 2 * p] = 2 * p + 1
        b[tb, 2 * p + 1] = s
        gb[tb, 2 * p + 1] = 2 * p
    return AlamoutiLuts(a=a, b=b, ga=ga, gb=gb)


@dataclass(frozen=True)
class PacketLuts:
    """All static arrays for one (u, b, N_PACKET_symb, tm_mode) bucket."""
    ps: PacketSizes
    # scatter targets into the flat [N_TS * S * N] grid
    drs_flat_idx: np.ndarray     # [n_drs_total] int32
    drs_values: np.ndarray       # [n_drs_total] complex64
    pcc_flat_idx: np.ndarray     # [N_TS, 98] int32  (per-TS copies of PCC cells)
    pdc_flat_idx: np.ndarray     # [N_TS, N_PDC_subc] int32
    pcc_alamouti: AlamoutiLuts | None
    pdc_alamouti: AlamoutiLuts | None
    stf_grid: np.ndarray         # [N_b_DFT] complex64 (freq, centered)
    # RX gathers (within [S * N] per-antenna grid)
    pcc_lin: np.ndarray          # [98]
    pdc_lin: np.ndarray          # [N_PDC_subc]
    drs_lin: np.ndarray          # [N_TS, n_drs_per_ts]
    drs_vals_per_ts: np.ndarray  # [N_TS, n_drs_per_ts] complex64
    # RX gathers into the occupied-subcarrier grid [S * N_b_OCC]
    pcc_locc: np.ndarray         # [98]
    pdc_locc: np.ndarray         # [N_PDC_subc]
    drs_locc: np.ndarray         # [N_TS, n_drs_symb, N_b_OCC/4]
    drs_l_symb: np.ndarray       # [N_TS, n_drs_symb] OFDM symbol carrying DRS
    tx_scale: float

    @property
    def n_grid(self) -> int:
        return self.ps.N_PACKET_symb * self.ps.numerology.N_b_DFT

    @property
    def n_drs_symb(self) -> int:
        return self.drs_locc.shape[1]


@lru_cache(maxsize=None)
def get_packet_luts(psdef: PacketSizesDef) -> PacketLuts:
    ps = get_packet_sizes(psdef)
    if ps is None:
        raise ValueError(f"invalid psdef {psdef}")
    u, b = psdef.u, psdef.b
    N = ps.numerology.N_b_DFT
    S = ps.N_PACKET_symb
    N_TS = ps.tm_mode.N_TS
    n_grid = S * N

    drs_lin = drs.drs_linear_indices(u, b, S, N_TS)          # [N_TS, n]
    _, _, drs_v = drs.drs_cells(u, b, S, N_TS)
    ts_off = (np.arange(N_TS) * n_grid)[:, None]
    drs_flat = (drs_lin + ts_off).ravel()

    pcc_lin = pcc.pcc_linear_indices(b, N_TS)                 # [98]
    pdc_lin = pdc.pdc_linear_indices(u, b, S, N_TS)           # [n_pdc]
    pcc_flat = pcc_lin[None, :] + ts_off
    pdc_flat = pdc_lin[None, :] + ts_off

    pcc_al = alamouti_luts(98, N_TS) if N_TS > 1 else None
    pdc_al = (alamouti_luts(ps.N_PDC_subc, N_TS)
              if (N_TS > 1 and ps.tm_mode.N_SS == 1) else None)

    # occupied-grid ("locc") versions: flat index l * N_b_OCC + occ_position
    occ_of_dft = np.full(N, -1, dtype=np.int64)
    from ..sections.part3.phyres import k_b_OCC, occ_to_dft_index
    occ_dft = occ_to_dft_index(k_b_OCC(b), b)            # [N_b_OCC]
    occ_of_dft[occ_dft] = np.arange(occ_dft.size)
    N_occ = occ_dft.size

    def to_locc(lin: np.ndarray) -> np.ndarray:
        l, k = lin // N, lin % N
        occ = occ_of_dft[k]
        assert (occ >= 0).all(), "cell off the occupied grid"
        return (l * N_occ + occ).astype(np.int32)

    drs_l, _, _ = drs.drs_cells(u, b, S, N_TS)           # [N_TS, n_symb*n4]
    n4 = N_occ // 4
    n_drs_symb = drs_lin.shape[1] // n4

    # time-domain RMS ~ 1 for a fully occupied symbol (numpy ifft 1/N convention)
    tx_scale = N / np.sqrt(ps.numerology.N_b_OCC)

    return PacketLuts(
        ps=ps,
        drs_flat_idx=drs_flat.astype(np.int32),
        drs_values=drs_v.ravel().astype(np.complex64),
        pcc_flat_idx=pcc_flat.astype(np.int32),
        pdc_flat_idx=pdc_flat.astype(np.int32),
        pcc_alamouti=pcc_al,
        pdc_alamouti=pdc_al,
        stf_grid=stf.stf_freq_grid(b, ps.tm_mode.N_eff_TX).astype(np.complex64),
        pcc_lin=pcc_lin.astype(np.int32),
        pdc_lin=pdc_lin.astype(np.int32),
        drs_lin=drs_lin.astype(np.int32),
        drs_vals_per_ts=drs_v.astype(np.complex64),
        pcc_locc=to_locc(pcc_lin),
        pdc_locc=to_locc(pdc_lin),
        drs_locc=np.stack([to_locc(drs_lin[t]) for t in range(N_TS)]
                          ).reshape(N_TS, n_drs_symb, n4),
        drs_l_symb=drs_l.reshape(N_TS, n_drs_symb, n4)[:, :, 0].astype(np.int32),
        tx_scale=float(tx_scale),
    )
