"""HARQ processes with d-domain soft combining (port of dectnrp_tpu/phy/harq.py).

Counterpart of reference lib/src/phy/harq/ (process_pool.cpp, buffer_rx/tx,
finalize policies): a pool of TX and RX processes leased per packet. The
reference's srsRAN softbuffers become d-domain LLR dicts
({K: [nK*B, 3, K+4]} on the LLRs' device, see fec.chain.pdc_dematch);
retransmission combining (chase or incremental redundancy via rv) is an
elementwise add. The outer/inner two-stage lock (lockable_outer_inner.hpp)
collapses to a single-threaded leased/running state: the MAC step is
serialized by design (the reference's token_t), so no locks are needed.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto

import torch

from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .fec.chain import PdcPlan, pdc_decode_d, pdc_dematch


class FinalizeTx(Enum):
    """reference finalize_tx_t: what happens when the packet left the radio."""
    RESET_AND_TERMINATE = auto()
    KEEP_FOR_RETRANSMISSION = auto()


class FinalizeRx(Enum):
    RESET_AND_TERMINATE = auto()
    KEEP_FOR_RETRANSMISSION = auto()


@dataclass
class HarqProcessTx:
    id: int
    leased: bool = False
    running: bool = False
    plcf_type: int = 0
    network_id: int = 0
    psdef: PacketSizesDef | None = None
    rv: int = 0
    finalize: FinalizeTx = FinalizeTx.RESET_AND_TERMINATE
    tb_bits: torch.Tensor | None = None

    def finalize_now(self) -> None:
        self.running = False
        if self.finalize == FinalizeTx.RESET_AND_TERMINATE:
            self.leased = False
            self.tb_bits = None
        # KEEP: stays leased, tb_bits retained for rv retransmission


@dataclass
class HarqProcessRx:
    id: int
    leased: bool = False
    running: bool = False
    plcf_type: int = 0
    network_id: int = 0
    psdef: PacketSizesDef | None = None
    rv: int = 0
    finalize: FinalizeRx = FinalizeRx.RESET_AND_TERMINATE
    softbuffer: dict[int, torch.Tensor] | None = None   # d-domain LLRs per K

    def combine(self, e_llr: torch.Tensor, n_iter: int = 6):
        """De-rate-match this transmission, add into the softbuffer, decode.

        Returns (tb_bits, tb_ok). The softbuffer persists while the process
        is kept for retransmission (reference buffer_rx softbuffer reuse);
        each combine makes a new dict, so an earlier one stays as it was.
        """
        ps = get_packet_sizes(self.psdef)
        plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, self.psdef.Z)
        d_new = pdc_dematch(e_llr, plan, self.network_id, self.plcf_type,
                            self.rv)
        if self.softbuffer is None:
            self.softbuffer = d_new
        else:
            self.softbuffer = {k: self.softbuffer[k] + d_new[k]
                               for k in d_new}
        return pdc_decode_d(self.softbuffer, plan, n_iter)

    def finalize_now(self) -> None:
        self.running = False
        if self.finalize == FinalizeRx.RESET_AND_TERMINATE:
            self.leased = False
            self.softbuffer = None


class HarqProcessPool:
    """Lease TX/RX processes (reference process_pool.cpp:27-129)."""

    def __init__(self, n_tx: int = 8, n_rx: int = 8):
        self.tx = [HarqProcessTx(i) for i in range(n_tx)]
        self.rx = [HarqProcessRx(i) for i in range(n_rx)]

    def get_process_tx(self, plcf_type: int, network_id: int,
                       psdef: PacketSizesDef,
                       finalize: FinalizeTx = FinalizeTx.RESET_AND_TERMINATE
                       ) -> HarqProcessTx | None:
        assert plcf_type in (1, 2)
        assert get_packet_sizes(psdef) is not None
        for p in self.tx:
            if not p.leased:
                p.leased = p.running = True
                p.plcf_type, p.network_id, p.psdef = plcf_type, network_id, psdef
                p.rv = 0
                p.finalize = finalize
                return p
        return None

    def get_process_rx(self, plcf_type: int, network_id: int,
                       psdef: PacketSizesDef, rv: int = 0,
                       finalize: FinalizeRx = FinalizeRx.RESET_AND_TERMINATE
                       ) -> HarqProcessRx | None:
        assert plcf_type in (1, 2)
        assert get_packet_sizes(psdef) is not None
        for p in self.rx:
            if not p.leased:
                p.leased = p.running = True
                p.plcf_type, p.network_id, p.psdef = plcf_type, network_id, psdef
                p.rv = rv
                p.finalize = finalize
                p.softbuffer = None
                return p
        return None

    def get_process_tx_running(self, pid: int,
                               finalize: FinalizeTx) -> HarqProcessTx | None:
        p = self.tx[pid]
        if not p.leased or p.running:
            return None
        p.running = True
        p.finalize = finalize
        return p

    def get_process_rx_running(self, pid: int, rv: int,
                               finalize: FinalizeRx) -> HarqProcessRx | None:
        p = self.rx[pid]
        if not p.leased or p.running:
            return None
        p.running = True
        p.rv = rv
        p.finalize = finalize
        return p
