"""Point-to-point FT <-> PT firmware (reference lib/src/upper/p2p/).

Reimplements the reference's tfw_p2p_ft / tfw_p2p_pt firmware pair
(tfw_p2p_ft.cpp:39-219, procedure/steady_ft.cpp:104-250,
procedure/steady_pt.cpp) as host-side Tpoint state machines; all PHY work
(TX synthesis, sync, demod, FEC) stays in the PHY modules driven by
NodeRuntime.

Protocol flow (as in the reference):
  FT  : periodic beacon (PLCF type 1; MAC beacon PDU with cluster beacon
        message + random access resource IE), self-rescheduled one
        prepare-duration ahead of the next beacon via irregular callbacks;
        on association request -> allocate UL/DL resources on the beacon
        grid (allocation_ft), reply association response + resource
        allocation IE; drains application datagrams into unicast DL
        packets inside each contact's DL allocation; downlink MCS follows
        the PT's feedback (PLCF type-2 feedback format 4).
  PT  : listens for beacons, phase-locks its clock via mac.pll, mirrors
        the allocation from the resource allocation IE, associates through
        the RACH window, drains application datagrams into unicast UL
        packets inside its UL allocation, reports CQI from measured SNR.

Resource units: the over-the-air resource allocation IE uses subslots
(6.4.3.3); the host-side grids (mac.allocation) use samples. One subslot =
5 OFDM symbols = 360*b samples at the DECT sample rate (numerologies:
N_SLOT_u_symb / N_SLOT_u_subslot = 5 for all u).

Decode-latency handling: unlike the reference's ~100 us turnaround, the
batched runtime only fires work_pdc once the whole packet (worst-case
length) is in the ring, so every TX opportunity is projected forward to
the next beacon period whose slot lies after `now` (the hw ring time,
available through the `lower` hook NodeRuntime installs — the analog of
the reference's phy/interfaces lower_ctrl_t).

Copy of `dectnrp_tpu/upper/p2p.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ..mac.allocation import AllocationFt, AllocationPt, Direction
from ..mac.contact_list import Contact, ContactList
from ..mac.cqi import CqiLut
from ..mac.pll import Pll
from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..sections.part3.tm_mode import get_tm_mode
from ..sections.part4.association import (AssociationReleaseMessage,
                                          AssociationRequestMessage,
                                          AssociationResponseMessage,
                                          HarqConfig)
from ..sections.part4.feedback_info import (FeedbackF4, FeedbackF5,
                                            MimoFeedback, TxFeedback)
from ..sections.part4.identity import Identity
from ..sections.part4.ies import (Allocation, LENGTH_IN_SUBSLOTS,
                                  RandomAccessResourceIE,
                                  ResourceAllocationIE, UserPlaneData)
from ..sections.part4.mac_pdu import (BeaconHeader, MacHeaderKind,
                                      MacHeaderType, UnicastHeader)
from ..sections.part4.mac_pdu_decoder import build_mac_pdu, decode_mac_pdu
from ..sections.part4.mmie import ClusterBeaconMessage
from ..sections.part4.plcf import Plcf10, Plcf20, bits_to_bytes, bytes_to_bits
from .tpoint import (IrregularReport, MacHighPhy, MacLowPhy, PhyMacHigh,
                     PhyMacLow, Tpoint, TxDescriptor)

HANDLE_BEACON = 1


def subslot_samples(u: int, b: int) -> int:
    """One subslot = 5 OFDM symbols = 5 * 72 * b samples."""
    return 5 * 72 * b


def psdef_for_bytes(u: int, b: int, tm_mode_index: int, mcs: int,
                    n_bytes: int, Z: int = 6144) -> PacketSizesDef | None:
    """Smallest subslot-length packet whose TB holds n_bytes
    (reference steady_*.cpp pick the packet length the same way)."""
    for plen in range(1, 17):
        psdef = PacketSizesDef(u, b, 0, plen, tm_mode_index, mcs, Z)
        ps = get_packet_sizes(psdef)
        if ps is not None and ps.N_TB_bits >= 8 * n_bytes:
            return psdef
    return None


@dataclass
class P2pConfig:
    """Shared FT/PT firmware configuration (reference tfw_p2p config in
    upper.json: identities, beacon period, allocation layout)."""
    u: int = 1
    b: int = 1
    ft_identity: Identity = field(
        default_factory=lambda: Identity(0x12345678, 0x00ABCDEF, 0x0ABC))
    beacon_period_subslots: int = 64
    beacon_prepare_subslots: int = 12   # irregular callback lead time
    rach_offset_subslots: int = 8       # RACH window within beacon period
    rach_length_subslots: int = 6
    ul_offset_subslots: int = 20        # first UL allocation
    dl_offset_subslots: int = 40        # first DL allocation
    alloc_length_subslots: int = 8      # per-contact allocation length
    turnaround_subslots: int = 2
    beacon_mcs: int = 2
    ctrl_mcs: int = 2                   # association request/response
    mcs_min: int = 0
    mcs_max: int = 4
    tm_mode_index: int = 0              # data/beacon transmission mode
    tx_power: int = 7

    @property
    def subslot(self) -> int:
        return subslot_samples(self.u, self.b)

    @property
    def beacon_period(self) -> int:
        return self.beacon_period_subslots * self.subslot


class RdMode(Enum):
    """Radio-device lifecycle (reference p2p/data/rd_mode.hpp:25-28)."""
    NORMAL_OPERATION = "normal_operation"
    SHUTTING_DOWN = "shutting_down"


class TfwP2pRd(Tpoint):
    """Shared p2p radio-device base: FT and PT are both RDs.

    Counterpart of reference tfw_p2p_rd.cpp/.hpp (tpoint_t -> tfw_p2p_rd_t
    -> tfw_p2p_{ft,pt}_t): owns identity, app-data queues, packet builders,
    the IQ-streaming start time (work_start, tfw_p2p_rd.cpp:28-33) and the
    NORMAL_OPERATION -> SHUTTING_DOWN lifecycle.  The reference's work_stop
    blocks the main thread until all DECT NR+ connections closed gracefully
    (stop_request_block_nto); here shutdown is cooperative: `work_stop()`
    flips the mode, the role subclasses wind their connections down on their
    regular schedule, and `is_stop_complete()` reports when done.
    """

    NAME = "p2p_rd"

    def __init__(self, cfg: P2pConfig, identity: Identity, **kw):
        super().__init__(**kw)
        self.cfg = cfg
        self.identity = identity
        self.cqi = CqiLut(cfg.mcs_min, cfg.mcs_max)
        self.lower = None                  # set by NodeRuntime (hw handle)
        self.app_tx: list[bytes] = []      # datagrams waiting to go out
        self.app_rx: list[bytes] = []      # datagrams received for the app
        self.rd_mode = RdMode.NORMAL_OPERATION
        self.start_time_iq_streaming: int | None = None
        self.stats = {"beacons": 0, "assoc_req": 0, "assoc_resp": 0,
                      "data_tx": 0, "data_rx": 0, "release": 0}

    def work_start(self, start_time: int) -> IrregularReport:
        self.start_time_iq_streaming = start_time
        return IrregularReport()

    def work_stop(self) -> None:
        """Begin graceful shutdown (reference work_stop, rd_mode store)."""
        self.rd_mode = RdMode.SHUTTING_DOWN

    @property
    def is_shutting_down(self) -> bool:
        return self.rd_mode == RdMode.SHUTTING_DOWN

    def is_stop_complete(self) -> bool:
        """True once all connections are closed (subclasses refine)."""
        return self.is_shutting_down

    @property
    def now(self) -> int:
        """Hardware ring time (reference buffer_rx time via lower_ctrl_t)."""
        return self.lower.rx_time_passed if self.lower is not None else 0

    def work_application(self, datagrams: list[bytes]) -> MacHighPhy:
        self.app_tx.extend(datagrams)
        return MacHighPhy()

    # --- packet builders -----------------------------------------------
    def _plcf2(self, psdef: PacketSizesDef, receiver_short: int,
               feedback_format: int = 0, feedback=None,
               harq_process: int = 0, rv: int = 0, ndi: int = 1) -> Plcf20:
        tm = get_tm_mode(psdef.tm_mode_index)
        p = Plcf20(packet_length_type=psdef.PacketLengthType,
                   packet_length=psdef.PacketLength,
                   short_network_id=self.identity.short_network_id,
                   transmitter_identity=self.identity.short_rdid,
                   transmit_power=self.cfg.tx_power,
                   df_mcs=psdef.mcs_index,
                   receiver_identity=receiver_short,
                   df_redundancy_version=rv,
                   df_new_data_indication=ndi,
                   df_harq_process_number=harq_process,
                   feedback_format=feedback_format,
                   feedback=feedback)
        p.set_n_ss(tm.N_SS)
        return p

    def _unicast_td(self, receiver: Contact, mmies: list, mcs: int,
                    tx_time: int, max_samples: int | None = None,
                    feedback_format: int = 0, feedback=None,
                    codebook_index: int = 0) -> TxDescriptor | None:
        """Unicast MAC PDU -> TX descriptor (worksub_tx_unicast...)."""
        hdr = UnicastHeader(
            sequence_number=receiver.next_sequence_number(),
            receiver_address=receiver.identity.long_rdid,
            transmitter_address=self.identity.long_rdid)
        n = (MacHeaderType.SIZE + hdr.SIZE
             + sum(m.packed_size_mmh_sdu() for m in mmies))
        psdef = psdef_for_bytes(self.cfg.u, self.cfg.b,
                                self.cfg.tm_mode_index, mcs, n)
        if psdef is None:
            return None
        ps = get_packet_sizes(psdef)
        if max_samples is not None and ps.N_samples_packet > max_samples:
            return None
        pdu = build_mac_pdu(
            MacHeaderType(mac_header_type=MacHeaderKind.UNICAST),
            hdr, mmies, ps.N_TB_bits // 8)
        plcf = self._plcf2(psdef, receiver.identity.short_rdid,
                           feedback_format, feedback)
        return TxDescriptor(psdef=psdef, plcf=plcf,
                            tb_bits=bytes_to_bits(pdu, ps.N_TB_bits),
                            network_id=self.identity.network_id,
                            tx_time=tx_time, codebook_index=codebook_index)

    # --- reception helpers -------------------------------------------------
    def _accept_pcc(self, phy_maclow: PhyMacLow) -> bool:
        rep = phy_maclow.pcc_report
        if rep.plcf is None:
            return False
        if rep.plcf.short_network_id != self.identity.short_network_id:
            return False
        if rep.plcf_type == 2 and \
                rep.plcf.receiver_identity not in (self.identity.short_rdid,
                                                   0xFFFF):
            return False
        return True

    def work_pcc(self, phy_maclow: PhyMacLow) -> MacLowPhy:
        if not self._accept_pcc(phy_maclow):
            return MacLowPhy()
        return self.worksub_pcc2pdc(phy_maclow,
                                    phy_maclow.pcc_report.plcf_type,
                                    self.identity.network_id)

    def _decode_pdu(self, phy_machigh: PhyMacHigh):
        tb = phy_machigh.pdc_report.tb_bits
        if tb is None:
            return None
        return decode_mac_pdu(bits_to_bytes(tb), self.cfg.u)


class AssocState(Enum):
    """PT association lifecycle (reference tpoint_state_t chain
    resource_t -> steady_pt_t -> dissociation_t -> nop_t)."""
    SCANNING = "scanning"
    WAIT_RESPONSE = "wait_response"
    ASSOCIATED = "associated"
    DISSOCIATED = "dissociated"


class TfwP2pFt(TfwP2pRd):
    """Fixed termination point: beacon master + resource owner
    (reference tfw_p2p_ft.cpp + procedure/steady_ft.cpp)."""

    NAME = "p2p_ft"

    def __init__(self, cfg: P2pConfig, **kw):
        super().__init__(cfg, cfg.ft_identity, **kw)
        self.contacts = ContactList()
        self.alloc = AllocationFt(cfg.beacon_period)
        # keep the beacon head + RACH windows out of the free pool
        self.alloc.allocate(-1, Direction.DL, 0,
                            cfg.rach_offset_subslots * cfg.subslot)
        self.alloc.allocate(-2, Direction.UL,
                            cfg.rach_offset_subslots * cfg.subslot,
                            cfg.rach_length_subslots * cfg.subslot)
        self.sfn = 0
        self.beacon_time_next = 0
        # control replies staged for the next beacon batch: (contact, mmies)
        self._pending_ctrl: list[tuple[Contact, list]] = []

    # --- beacon ----------------------------------------------------------
    def work_start(self, start_time: int) -> IrregularReport:
        super().work_start(start_time)
        prep = self.cfg.beacon_prepare_subslots * self.cfg.subslot
        self.beacon_time_next = start_time + self.cfg.beacon_period
        return IrregularReport(self.beacon_time_next - prep, HANDLE_BEACON)

    # --- shutdown (reference work_stop: close all connections first) ------
    def work_stop(self) -> None:
        super().work_stop()
        for c in self.contacts.associated():
            self._pending_ctrl.append(
                (c, [AssociationReleaseMessage(release_cause=0)]))
            self.alloc.release_pt(c.identity.short_rdid)
            c.associated = False
            self.stats["release"] += 1

    def is_stop_complete(self) -> bool:
        return self.is_shutting_down and not self.contacts.associated() \
            and not self._pending_ctrl

    def _beacon_td(self) -> TxDescriptor | None:
        cfg = self.cfg
        cb = ClusterBeaconMessage(
            system_frame_number=self.sfn & 0xFF,
            network_beacon_period_coded=0,
            cluster_beacon_period_coded=0, mu=cfg.u)
        rach = RandomAccessResourceIE(
            allocation=Allocation(cfg.rach_offset_subslots,
                                  LENGTH_IN_SUBSLOTS,
                                  cfg.rach_length_subslots),
            max_rach_length_type=LENGTH_IN_SUBSLOTS,
            max_rach_length=cfg.rach_length_subslots,
            response_window_length=15, mu=cfg.u)
        hdr = BeaconHeader(transmitter_address=self.identity.long_rdid)
        hdr.set_network_id(self.identity.network_id)
        n = MacHeaderType.SIZE + hdr.SIZE + cb.packed_size_mmh_sdu() \
            + rach.packed_size_mmh_sdu()
        psdef = psdef_for_bytes(cfg.u, cfg.b, cfg.tm_mode_index,
                                cfg.beacon_mcs, n)
        if psdef is None:
            return None
        ps = get_packet_sizes(psdef)
        pdu = build_mac_pdu(
            MacHeaderType(mac_header_type=MacHeaderKind.BEACON),
            hdr, [cb, rach], ps.N_TB_bits // 8)
        plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                      packet_length=psdef.PacketLength,
                      short_network_id=self.identity.short_network_id,
                      transmitter_identity=self.identity.short_rdid,
                      transmit_power=cfg.tx_power,
                      df_mcs=psdef.mcs_index)
        return TxDescriptor(psdef=psdef, plcf=plcf,
                            tb_bits=bytes_to_bits(pdu, ps.N_TB_bits),
                            network_id=self.identity.network_id,
                            tx_time=self.beacon_time_next)

    def work_irregular(self, now: int, handle: int) -> MacHighPhy:
        if handle != HANDLE_BEACON:
            return MacHighPhy()
        cfg = self.cfg
        out = MacHighPhy()
        # while shutting down: no new beacons/data, only drain the pending
        # control (association releases) so connections close gracefully
        td = None if self.is_shutting_down else self._beacon_td()
        if td is not None:
            out.tx_descriptors.append(td)
            self.stats["beacons"] += 1
        # control replies ride in the response window right after the RACH
        resp_off = (cfg.rach_offset_subslots + cfg.rach_length_subslots) \
            * cfg.subslot
        for c, mmies in self._pending_ctrl:
            ctd = self._unicast_td(c, mmies, cfg.ctrl_mcs,
                                   self.beacon_time_next + resp_off)
            if ctd is not None:
                out.tx_descriptors.append(ctd)
                resp_off += get_packet_sizes(ctd.psdef).N_samples_packet \
                    + cfg.turnaround_subslots * cfg.subslot
                self.stats["assoc_resp"] += 1
        self._pending_ctrl = []
        # drain app datagrams into each associated contact's DL allocation
        for c in self.contacts.associated():
            if not self.app_tx:
                break
            dl = self.alloc.per_pt.get(c.identity.short_rdid,
                                       {}).get(Direction.DL, [])
            for r in dl:
                if not self.app_tx:
                    break
                data = self.app_tx.pop(0)
                mcs = self.cqi.clamp_mcs(c.mcs_dl)
                dtd = self._unicast_td(
                    c, [UserPlaneData(1, data)], mcs,
                    self.beacon_time_next + r.offset,
                    max_samples=r.length, codebook_index=c.codebook_index)
                if dtd is None:       # doesn't fit: put back, try next period
                    self.app_tx.insert(0, data)
                    break
                out.tx_descriptors.append(dtd)
                self.stats["data_tx"] += 1
        # self-reschedule one prepare-duration ahead of the next beacon
        self.sfn += 1
        self.beacon_time_next += cfg.beacon_period
        prep = cfg.beacon_prepare_subslots * cfg.subslot
        out.irregular = IrregularReport(self.beacon_time_next - prep,
                                        HANDLE_BEACON)
        return out

    # --- reception ---------------------------------------------------------
    def work_pdc(self, phy_machigh: PhyMacHigh) -> MacHighPhy:
        dec = self._decode_pdu(phy_machigh)
        out = MacHighPhy()
        if dec is None or dec.common_header is None:
            return out
        plcf = phy_machigh.phy_maclow.pcc_report.plcf
        snr = phy_machigh.pdc_report.snr_db
        for m in dec.mmies:
            if isinstance(m, AssociationRequestMessage):
                self._on_assoc_request(dec.common_header, plcf, m, snr)
                self.stats["assoc_req"] += 1
            elif isinstance(m, AssociationReleaseMessage):
                c = self.contacts.by_long(
                    dec.common_header.transmitter_address)
                if c is not None:
                    self.alloc.release_pt(c.identity.short_rdid)
                    self.contacts.remove(c.identity.short_rdid)
                    self.stats["release"] += 1
            elif isinstance(m, UserPlaneData):
                self.app_rx.append(m.data)
                self.stats["data_rx"] += 1
        # downlink MCS feedback from the PLCF (format 4)
        c = self.contacts.by_long(
            getattr(dec.common_header, "transmitter_address", -1))
        if c is not None:
            c.last_heard = phy_machigh.phy_maclow.sync_report.fine_peak_time
            c.snr_db = snr
            fmt = getattr(plcf, "feedback_format", 0)
            if fmt == 4 and plcf.feedback is not None:
                c.mcs_dl = self.cqi.clamp_mcs(plcf.feedback.mcs)
            elif fmt == 5 and plcf.feedback is not None:
                c.codebook_index = plcf.feedback.codebook_index
        return out

    def _on_assoc_request(self, hdr, plcf, msg: AssociationRequestMessage,
                          snr_db: float) -> None:
        cfg = self.cfg
        long_rdid = hdr.transmitter_address
        if self.contacts.by_long(long_rdid) is not None:
            return                                   # duplicate request
        # the PT's short RD ID comes from the PLCF transmitter identity
        short = plcf.transmitter_identity
        ident = Identity(self.identity.network_id, long_rdid, short)
        c = self.contacts.add(ident)
        c.snr_db = snr_db
        c.mcs_dl = self.cqi.get_highest_mcs_possible(snr_db)
        length = cfg.alloc_length_subslots * cfg.subslot
        ul_off = self.alloc.find_free(length,
                                      cfg.ul_offset_subslots * cfg.subslot)
        dl_off = self.alloc.find_free(
            length, max(cfg.dl_offset_subslots * cfg.subslot,
                        (ul_off if ul_off is not None else 0) + length))
        if ul_off is None or dl_off is None:
            self.contacts.remove(short)
            mmies = [AssociationResponseMessage(reject_cause=2,
                                                reject_time_coded=0)]
        else:
            self.alloc.allocate(short, Direction.UL, ul_off, length)
            self.alloc.allocate(short, Direction.DL, dl_off, length)
            c.associated = True
            resp = AssociationResponseMessage(
                harq_configuration=(msg.harq_rx, msg.harq_tx))
            alloc_ie = ResourceAllocationIE(
                allocation_ul=Allocation(ul_off // cfg.subslot,
                                         LENGTH_IN_SUBSLOTS,
                                         cfg.alloc_length_subslots),
                allocation_dl=Allocation(dl_off // cfg.subslot,
                                         LENGTH_IN_SUBSLOTS,
                                         cfg.alloc_length_subslots),
                short_rd_id=short, mu=cfg.u)
            mmies = [resp, alloc_ie]
        self._pending_ctrl.append((c, mmies))


class TfwP2pPt(TfwP2pRd):
    """Portable termination point (reference tfw_p2p_pt.cpp +
    procedure/steady_pt.cpp): beacon-synchronized, CQI-reporting client."""

    NAME = "p2p_pt"

    def __init__(self, cfg: P2pConfig, identity: Identity,
                 samp_rate: int | None = None, **kw):
        super().__init__(cfg, identity, **kw)
        self.state = AssocState.SCANNING
        self.alloc = AllocationPt(
            beacon_period=cfg.beacon_period,
            validity_after_beacon=8 * cfg.beacon_period,
            validity_after_now=8 * cfg.beacon_period,
            turnaround_time=cfg.turnaround_subslots * cfg.subslot)
        self.pll = Pll(cfg.beacon_period,
                       samp_rate or 1_728_000 * cfg.u * cfg.b)
        self.ft_contact: Contact | None = None
        self.mcs_ul = cfg.mcs_min
        self.snr_ft_db = float("nan")
        self._rach: tuple[int, int] | None = None    # (offset, length) samples
        self._release_pending = False
        self._assoc_wait_beacons = 0       # response-window timeout counter
        import random
        self._rng = random.Random(identity.long_rdid)

    def _next_slot_time(self, beacon_time: int, offset: int) -> int:
        """Project beacon_time + offset into the first beacon period whose
        slot starts after now + turnaround (decode latency compensation)."""
        period = self.cfg.beacon_period
        earliest = self.now + self.alloc.turnaround_time
        t = beacon_time + offset
        if t < earliest:
            k = -((t - earliest) // period)          # ceil division
            t += k * period
        return t

    # --- reception ---------------------------------------------------------
    def work_pdc(self, phy_machigh: PhyMacHigh) -> MacHighPhy:
        dec = self._decode_pdu(phy_machigh)
        out = MacHighPhy()
        if dec is None or dec.common_header is None:
            return out
        kind = dec.header_type.mac_header_type
        if kind == MacHeaderKind.BEACON:
            self._on_beacon(phy_machigh, dec, out)
        else:
            self._on_unicast(phy_machigh, dec, out)
        return out

    def _on_beacon(self, phy_machigh: PhyMacHigh, dec, out: MacHighPhy):
        cfg = self.cfg
        beacon_time = phy_machigh.phy_maclow.sync_report.fine_peak_time
        self.pll.provide_beacon_time(beacon_time)
        self.alloc.beacon_time_last_known = beacon_time
        self.snr_ft_db = phy_machigh.pdc_report.snr_db
        self.mcs_ul = self.cqi.get_highest_mcs_possible(self.snr_ft_db)
        # beamforming feedback source: the MIMO report of the beacon packet
        if phy_machigh.pdc_report.mimo_csi is not None:
            self.mimo_report = phy_machigh.pdc_report.mimo_csi
        self.stats["beacons"] += 1
        if self.ft_contact is None:
            hdr = dec.common_header
            ident = Identity(
                self.identity.network_id, hdr.transmitter_address,
                phy_machigh.phy_maclow.pcc_report.plcf.transmitter_identity)
            self.ft_contact = Contact(ident)
        for m in dec.mmies:
            if isinstance(m, RandomAccessResourceIE):
                self._rach = (m.allocation.start_subslot * cfg.subslot,
                              m.allocation.length * cfg.subslot)
        # response-window timeout: a collided/lost request is retried after
        # 2 beacons back in SCANNING (random access contention resolution)
        if self.state is AssocState.WAIT_RESPONSE:
            self._assoc_wait_beacons += 1
            if self._assoc_wait_beacons > 2:
                self.state = AssocState.SCANNING
        if self.state is AssocState.SCANNING and self._rach is not None:
            td = self._assoc_request_td(beacon_time)
            if td is not None:
                out.tx_descriptors.append(td)
                self.state = AssocState.WAIT_RESPONSE
                self._assoc_wait_beacons = 0
                self.stats["assoc_req"] += 1
        elif self.state is AssocState.ASSOCIATED:
            if self._release_pending:
                self._release_pending = False
                t = self._next_slot_time(beacon_time, self._rach[0])
                td = self._unicast_td(self.ft_contact,
                                      [AssociationReleaseMessage()],
                                      cfg.ctrl_mcs, t,
                                      max_samples=self._rach[1])
                if td is not None:
                    out.tx_descriptors.append(td)
                    self.state = AssocState.DISSOCIATED
                    self.stats["release"] += 1
            else:
                self._drain_ul(beacon_time, out)

    def _on_unicast(self, phy_machigh: PhyMacHigh, dec, out: MacHighPhy):
        hdr = dec.common_header
        if getattr(hdr, "receiver_address", None) != self.identity.long_rdid:
            return
        cfg = self.cfg
        for m in dec.mmies:
            if isinstance(m, AssociationResponseMessage):
                self.stats["assoc_resp"] += 1
                if m.rejected:
                    self.state = AssocState.SCANNING
                else:
                    self.state = AssocState.ASSOCIATED
            elif isinstance(m, ResourceAllocationIE):
                self.alloc.clear()
                if m.allocation_ul is not None:
                    self.alloc.add_resource(
                        Direction.UL,
                        m.allocation_ul.start_subslot * cfg.subslot,
                        m.allocation_ul.length * cfg.subslot)
                if m.allocation_dl is not None:
                    self.alloc.add_resource(
                        Direction.DL,
                        m.allocation_dl.start_subslot * cfg.subslot,
                        m.allocation_dl.length * cfg.subslot)
            elif isinstance(m, AssociationReleaseMessage):
                self.state = AssocState.DISSOCIATED
                self.stats["release"] += 1
            elif isinstance(m, UserPlaneData):
                self.app_rx.append(m.data)
                self.stats["data_rx"] += 1

    # --- transmission ------------------------------------------------------
    def _assoc_request_td(self, beacon_time: int) -> TxDescriptor | None:
        cfg = self.cfg
        req = AssociationRequestMessage(
            setup_cause=0, flow_ids=(1,),
            harq_tx=HarqConfig(1, 0), harq_rx=HarqConfig(1, 0))
        # random subslot within the RACH window: several PTs racing the same
        # window must not systematically collide (random access contention,
        # reference random_access_resource IE semantics)
        psdef_probe = psdef_for_bytes(
            cfg.u, cfg.b, cfg.tm_mode_index, cfg.ctrl_mcs,
            MacHeaderType.SIZE + 10 + req.packed_size_mmh_sdu())
        pkt_subslots = 1 if psdef_probe is None else \
            -(-get_packet_sizes(psdef_probe).N_samples_packet // cfg.subslot)
        slack = max(0, self._rach[1] // cfg.subslot - pkt_subslots)
        rnd_off = self._rng.randint(0, slack) * cfg.subslot
        tx_time = self._next_slot_time(beacon_time, self._rach[0] + rnd_off)
        return self._unicast_td(self.ft_contact, [req], cfg.ctrl_mcs,
                                tx_time, max_samples=self._rach[1] - rnd_off)

    def _drain_ul(self, beacon_time: int, out: MacHighPhy) -> None:
        """UL data in our allocation, with MCS feedback for the downlink;
        when the FT beamforms (N_TX > 1), alternate in the codebook-index
        feedback (format 5, reference mimo_report -> feedback_info_f5)."""
        fmt, fb = 4, FeedbackF4(mcs=self.cqi.clamp_mcs(self.mcs_ul))
        rep = getattr(self, "mimo_report", None)
        if rep is not None and rep.N_TX > 1 and self.stats["data_tx"] % 2:
            fmt = 5
            fb = FeedbackF5(transmission_feedback=TxFeedback.ACK,
                            mimo_feedback=MimoFeedback.SINGLE_LAYER,
                            codebook_index=rep.codebook_index)
        used: set[int] = set()
        while self.app_tx:
            slot = None
            for r in self.alloc.resources(Direction.UL):
                if r.offset not in used:
                    slot = r
                    break
            if slot is None:
                break
            t = self._next_slot_time(beacon_time, slot.offset)
            data = self.app_tx.pop(0)
            td = self._unicast_td(self.ft_contact, [UserPlaneData(1, data)],
                                  self.cqi.clamp_mcs(self.mcs_ul),
                                  t, max_samples=slot.length,
                                  feedback_format=fmt, feedback=fb)
            if td is None:
                self.app_tx.insert(0, data)
                break
            used.add(slot.offset)
            out.tx_descriptors.append(td)
            self.stats["data_tx"] += 1

    def dissociate(self) -> None:
        """Queue an association release (dissociation_t state)."""
        self._release_pending = True

    # --- shutdown (reference: dissociate, then report stop complete) ------
    def work_stop(self) -> None:
        super().work_stop()
        if self.state == AssocState.ASSOCIATED:
            self.dissociate()

    def is_stop_complete(self) -> bool:
        return self.is_shutting_down and self.state in (
            AssocState.SCANNING, AssocState.DISSOCIATED)
