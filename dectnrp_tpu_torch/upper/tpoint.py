"""Termination point (firmware) interface + PHY<->MAC interface structs.

Counterpart of reference lib/include/dectnrp/upper/tpoint.hpp and
phy/interfaces/*: the 10 virtual work_*() callbacks become methods of Tpoint;
the POD report structs become dataclasses. The reference serializes all
firmware calls with token_t (phy/pool/token.hpp) -- here the MAC step runs
single-threaded between PHY calls, so ordering is by construction.

Copy of `dectnrp_tpu/upper/tpoint.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..sections.part3.packet_sizes import PacketSizesDef
from ..phy.harq import FinalizeRx, HarqProcessPool, HarqProcessRx, HarqProcessTx


@dataclass
class SyncReport:
    """Host-side mirror of phy/rx/sync/sync_report.hpp (per detected packet)."""
    detected: bool
    fine_peak_time: int            # sample index of STF start
    cfo_rad_per_sample: float
    n_eff_tx: int
    metric: float
    rms: float
    u: int = 1
    b: int = 1


@dataclass
class PccReport:
    """PCC decode outcome handed to work_pcc (phy/interfaces/phy_maclow.hpp)."""
    crc_ok: bool
    plcf_type: int                 # 1 or 2 (the CRC-passing candidate)
    plcf: Any                      # decoded Plcf10/20/21 instance or None
    plcf_bits: np.ndarray | None
    cl_flag: bool = False
    bf_flag: bool = False
    snr_db: float = 0.0


@dataclass
class PhyMacLow:
    """Input of work_pcc."""
    sync_report: SyncReport
    pcc_report: PccReport


@dataclass
class MacLowPhy:
    """Return of work_pcc: whether/how to continue with the PDC."""
    continue_with_pdc: bool = False
    psdef: PacketSizesDef | None = None
    network_id: int = 0
    plcf_type: int = 1
    hp_rx: HarqProcessRx | None = None
    handle: int = 0


@dataclass
class PdcReport:
    """PDC decode outcome handed to work_pdc."""
    crc_ok: bool
    tb_bits: np.ndarray | None
    snr_db: float = 0.0
    mimo_csi: Any = None


@dataclass
class PhyMacHigh:
    """Input of work_pdc / work_pdc_error."""
    phy_maclow: PhyMacLow
    pdc_report: PdcReport


@dataclass
class TxMeta:
    """Subset of phy/tx/tx_meta.hpp relevant without real radio hardware."""
    iq_phase_rad: float = 0.0
    cfo_hz: float = 0.0
    tx_power_adj_dB: float = 0.0


@dataclass
class TxDescriptor:
    """One packet the firmware wants transmitted (phy/tx/tx_descriptor.hpp)."""
    psdef: PacketSizesDef
    plcf: Any                      # Plcf10/20/21 instance
    hp_tx: HarqProcessTx | None = None
    tb_bits: np.ndarray | None = None
    network_id: int = 0
    codebook_index: int = 0
    tx_time: int = 0               # global sample count
    tx_meta: TxMeta = field(default_factory=TxMeta)


@dataclass
class IrregularReport:
    """Request for a future irregular callback at a given time (or none)."""
    call_at: int | None = None
    handle: int = 0


@dataclass
class MacHighPhy:
    """Return of the work_* callbacks that may transmit."""
    tx_descriptors: list[TxDescriptor] = field(default_factory=list)
    irregular: IrregularReport = field(default_factory=IrregularReport)


class Tpoint:
    """Firmware base: override the work_*() callbacks you need
    (reference upper/tpoint.hpp:45-203, tfw_basic is the empty skeleton)."""

    def __init__(self, config: dict | None = None,
                 harq_pool: HarqProcessPool | None = None):
        self.config = config or {}
        self.harq_pool = harq_pool or HarqProcessPool()

    # --- lifecycle ---------------------------------------------------------
    def work_start(self, start_time: int) -> IrregularReport:
        return IrregularReport()

    def work_stop(self) -> None:
        pass

    # --- time-driven -------------------------------------------------------
    def work_regular(self, now: int) -> MacHighPhy:
        return MacHighPhy()

    def work_irregular(self, now: int, handle: int) -> MacHighPhy:
        return MacHighPhy()

    # --- packet-driven -----------------------------------------------------
    def work_pcc(self, phy_maclow: PhyMacLow) -> MacLowPhy:
        return MacLowPhy()

    def work_pcc_error(self, phy_maclow: PhyMacLow) -> MacHighPhy:
        return MacHighPhy()

    def work_pdc(self, phy_machigh: PhyMacHigh) -> MacHighPhy:
        return MacHighPhy()

    def work_pdc_error(self, phy_machigh: PhyMacHigh) -> MacHighPhy:
        return MacHighPhy()

    # --- application / channel --------------------------------------------
    def work_application(self, datagrams: list[bytes]) -> MacHighPhy:
        return MacHighPhy()

    def work_channel(self, chscan) -> MacHighPhy:
        return MacHighPhy()

    # --- convenience (reference worksub_pcc2pdc, tpoint.hpp:283-336) -------
    def worksub_pcc2pdc(self, phy_maclow: PhyMacLow, plcf_type: int,
                        network_id: int, rv: int = 0,
                        finalize: FinalizeRx = FinalizeRx.RESET_AND_TERMINATE,
                        handle: int = 0) -> MacLowPhy:
        """Build the MacLowPhy that continues with PDC decoding, leasing an
        RX HARQ process and deriving the psdef from the decoded PLCF."""
        plcf = phy_maclow.pcc_report.plcf
        sr = phy_maclow.sync_report
        # tm mode from detected N_eff_TX (+ N_SS from PLCF type 2 if present)
        n_ss = getattr(plcf, "n_ss", 1)
        from ..sections.part3.tm_mode import equivalent_tm_mode
        psdef = PacketSizesDef(
            u=sr.u, b=sr.b,
            PacketLengthType=plcf.packet_length_type,
            PacketLength=plcf.packet_length,
            tm_mode_index=equivalent_tm_mode(sr.n_eff_tx, n_ss),
            mcs_index=plcf.df_mcs,
            Z=6144)
        hp = self.harq_pool.get_process_rx(plcf_type, network_id, psdef, rv,
                                           finalize)
        if hp is None:
            return MacLowPhy()
        return MacLowPhy(True, psdef, network_id, plcf_type, hp, handle)
