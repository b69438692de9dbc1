"""Node runtime: chunked sync search + packet decode + tpoint callbacks
(port of dectnrp_tpu/upper/runtime.py).

Counterpart of the reference PHY pool (lib/src/phy/pool/): worker_sync_t's
chunked ring search, the job queue, token-serialized tpoint calls and
worker_tx_rx_t's pcc->work_pcc->pdc->work_pdc dispatch collapse into one
single-threaded `NodeRuntime.process()` driven after each SimDriver tick
(or, over a real-IQ radio, as its samples arrive); the PHY work (sync,
demod, FEC, TX synthesis, resampling) runs in the port's modules on
`device`.

Blind packet-dimension handling: the PCC sits in the first symbols at cells
that depend only on (u, b, N_TS), so the PCC stage runs the aligned rx of a
minimum-length packet of the detected geometry (its PDC output is ignored);
once the PLCF yields the true PacketLength/MCS, the full packet is
re-demodulated with the right psdef (the reference's two-phase
demoddecod_rx_pcc / demoddecod_rx_pdc split, rx_synced.cpp:186-436).

Front end: `NodeRuntime` meets its radio only at the DECT rate, through
`front_end`, the one object that knows whether a resampler sits between:
`IdentityFrontEnd` (the radio itself) or `ResampledFrontEnd` (a DECT-rate
`common/ring.MirroredRing` on the host). The benchmark's SDR loop and its
tests reach it through older names, kept in one block of `NodeRuntime`.

Host boundary: a sync chunk, a packet window or a resampler input goes to
the device once, each PHY call's report comes back in one transfer
(`_host`), and each PHY module is built once per (arguments, device).

Tracing (common/trace.py): `runtime.process` spans a call, with a child
span for each stage (`runtime.pump`, `runtime.sync` a chunk,
`runtime.pcc`, `runtime.pdc`, `runtime.tx`, inside it
`runtime.tx_resample`) and `firmware.<callback>` around each firmware
call; the spans of one packet carry its `t_global`. Every copy to the
device and read back is counted (`xfer.*`), and so is a PHY module built
(`runtime.module_builds`). The resampled front end counts its steps
(`runtime.pump_steps`, overrun skips `runtime.pump_skipped_steps`) and
the bytes written into its ring (`runtime.dbuf_ring_bytes`, mirror
included); at the DECT rate these and its spans stay 0, as does
`runtime.dbuf_slide_bytes` always.

Application layer: an `app_server` (application/socket_app.SocketServer or
anything with `read_all()`) is drained into `work_application` each
process(), and what the firmware received (`tpoint.app_rx`) goes out
through an `app_client` (reference application_report_t jobs).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from operator import attrgetter

import numpy as np
import torch

from ..common.ring import MirroredRing
from ..common.trace import count, d2h, h2d, span
from ..phy.mimo import MimoReport, search as mimo_search
from ..phy.resampler import (ResamplerPlan, build_resampler,
                             build_resampler_stream, get_resampler_fraction,
                             stream_input_lag)
from ..phy.sync import build_rx_stream, build_sync
from ..phy.tx import build_tx
from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..sections.part3.transmission_packet_structure import get_N_samples_STF
from ..sections.part4.plcf import decode_plcf
from .tpoint import (MacHighPhy, MacLowPhy, PccReport, PdcReport, PhyMacHigh,
                     PhyMacLow, SyncReport, Tpoint)

_BUILDERS = {"sync": build_sync, "rx_stream": build_rx_stream,
             "tx": build_tx, "resampler": build_resampler,
             "resampler_stream": build_resampler_stream}
_SYNC_FIELDS = ("detected", "t_fine", "cfo", "n_eff_tx", "metric", "rms")
_PCC_FLAGS = ("plcf1_ok", "plcf2_ok", "plcf1_cl", "plcf1_bf", "plcf2_cl",
              "plcf2_bf", "snr_db")


@lru_cache(maxsize=None)
def _module(kind: str, args: tuple, device: str, **kw) -> torch.nn.Module:
    """The PHY module `kind` built once per (arguments, device)."""
    count("runtime.module_builds")
    return _BUILDERS[kind](*args, device=device, **kw)


def _host(*parts: torch.Tensor) -> np.ndarray:
    """The parts flattened into one float64 vector, moved to the host in one
    transfer (bits, flags, int32 and float32 values are exact in float64)."""
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    d2h(flat.numel() * 8)
    return flat.cpu().numpy()


def _to_dev(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    h2d(x.nbytes)
    return torch.from_numpy(x).to(device)


@lru_cache(maxsize=None)
def _min_len_psdef(u: int, b: int, tm_mode_index: int) -> PacketSizesDef:
    """Smallest valid packet of this geometry (PCC cells are identical)."""
    for plt, plen in ((0, 1), (0, 2), (0, 4), (1, 1), (1, 2)):
        psdef = PacketSizesDef(u, b, plt, plen, tm_mode_index, 0, 6144)
        if get_packet_sizes(psdef) is not None:
            return psdef
    raise ValueError("no valid minimum psdef")


@dataclass
class RuntimeStats:
    """Counters mirroring the reference's worker stats (worker_tx_rx.cpp:269)."""
    chunks: int = 0
    detections: int = 0
    detections_dropped: int = 0    # pending PCC lost to a ring-overrun skip
    pcc_ok: int = 0
    pcc_err: int = 0
    pdc_ok: int = 0
    pdc_err: int = 0
    tx_packets: int = 0
    tx_late: int = 0               # scheduled behind the radio write head
    regular_calls: int = 0
    irregular_calls: int = 0


class IdentityFrontEnd:
    """The front end of a radio at the DECT rate: the radio itself."""

    steps = 0
    start = property(attrgetter("hw.rx_time"))
    end = property(attrgetter("hw.rx_time_passed"))

    def __init__(self, hw):
        self.hw = self.lower = hw

    def window(self, t0: int, n: int) -> np.ndarray:
        return self.hw.get_rx_stream(t0, n)

    def pump(self) -> None:
        pass

    def drained(self) -> bool:
        return True

    def to_hw(self, x):
        return x

    to_dect = to_radio = to_hw


class ResampledFrontEnd:
    """The front end of a radio off the DECT rate (phy_config.cpp:32-67):
    rx_pacer's resample_until_nto (rx_pacer.cpp:227-295), tx.cpp's TX
    resampling, and the firmware's `lower`, converting the radio's times."""

    start = property(attrgetter("ring.start"))
    end = property(attrgetter("ring.end"))

    def __init__(self, hw, plan_tx: ResamplerPlan, plan_rx: ResamplerPlan,
                 device: torch.device):
        self.hw, self.plan_tx, self.plan_rx = hw, plan_tx, plan_rx
        self.lower = self
        self.device, self._dev = device, str(device)
        # hw samples per step; the ring (so sync and irregular callbacks)
        # lags the radio by up to a step: steps of 2.67 ms (512 L) made a p2p
        # FT's beacon callback, 2.5 ms before air time, late every 2nd period
        self.chunk = 128 * plan_tx.L
        # looked up at each step, so a wrapper set later takes effect
        self.step = _module("resampler_stream", (plan_rx, self.chunk), self._dev)
        self._d_in = stream_input_lag(plan_rx)
        self._hist = torch.zeros((hw.n_ant, self.step.H), dtype=torch.complex64,
                                 device=device)
        self.origin: int | None = None         # hw time of feed start
        self.consumed = 0                      # hw time of the next step's input
        self.ring = MirroredRing(hw.n_ant, getattr(hw, "rx_ring_len", 1 << 20),
                                 "runtime.dbuf_ring_bytes", "dect buffer")

    def window(self, t0: int, n: int) -> np.ndarray:
        return self.ring.window(t0, n)

    def to_hw(self, t_d: int) -> int:
        """DECT-rate sample count -> hw sample count (same instant)."""
        L, M = self.plan_rx.L, self.plan_rx.M          # dect k ~ hw k*M/L - D
        return int(round(t_d * M / L)) - self._d_in + (self.origin or 0)

    def to_dect(self, t_h: int) -> int:
        L, M = self.plan_rx.L, self.plan_rx.M
        return int(round((t_h - (self.origin or 0) + self._d_in) * L / M))

    def pump(self) -> None:
        """Resample newly received hw samples into the DECT-rate ring."""
        with span("runtime.pump"):
            if self.origin is None:
                self.origin = self.consumed = self.hw.rx_time
            # one call resamples what had arrived when it began, so a real-IQ
            # radio that outruns the runtime cannot keep it from returning (a
            # free-running stream is consumed in the same steps over more calls)
            end = self.hw.rx_time_passed
            while self.consumed + self.chunk <= end:
                try:
                    x = self.hw.get_rx_stream(self.consumed, self.chunk)
                except ValueError:
                    # ring overflow: the producer lapped this reader. Skip to
                    # its oldest sample and zero-fill the lost span, so the
                    # time mapping holds (reference restream, hw_usrp.cpp:
                    # 1093-1219: ring time recomputed from md.time_spec)
                    oldest = self.hw.rx_time
                    skip = max(1, -(-(oldest - self.consumed) // self.chunk))
                    out_per_chunk = self.chunk * self.plan_rx.L // self.plan_rx.M
                    self.consumed += skip * self.chunk
                    count("runtime.pump_skipped_steps", skip)
                    self._hist = torch.zeros_like(self._hist)
                    self.ring.skip(skip * out_per_chunk)
                    continue
                y, self._hist = self.step(_to_dev(x, self.device), self._hist)
                self.consumed += self.chunk
                count("runtime.pump_steps")
                d2h(y.numel() * y.element_size())
                self.ring.push(y.cpu().numpy())

    @property
    def steps(self) -> int:
        """Steps taken so far, overrun skips included."""
        return (self.consumed - (self.origin or 0)) // self.chunk

    def drained(self) -> bool:
        """Whether every whole step the radio holds is resampled."""
        return self.consumed + self.chunk > self.hw.rx_time_passed

    def to_radio(self, iq: torch.Tensor) -> torch.Tensor:
        with span("runtime.tx_resample"):
            return _module("resampler", (self.plan_tx, iq.shape[-1]),
                           self._dev)(iq)

    @property
    def rx_time(self) -> int:
        return self.to_dect(self.hw.rx_time)

    rx_time_passed = end

    def set_command_time(self, time: int = 0) -> None:
        self.hw.set_command_time(self.to_hw(time) if time > 0 else time)

    def pps_set_full_sec_at_next_pps(self) -> int:
        return self.to_dect(self.hw.pps_set_full_sec_at_next_pps())

    @property
    def tx_earliest(self) -> int:
        return self.to_dect(self.hw.tx_earliest)

    def __getattr__(self, name):
        return getattr(self.hw, name)


def _delegated(name: str) -> property:
    """A NodeRuntime name read and set on its front end."""
    return property(lambda rt: getattr(rt.front_end, name),
                    lambda rt, value: setattr(rt.front_end, name, value))


class NodeRuntime:
    """Per-node MAC/PHY event loop over a radio's RX ring (HwSimulator,
    HwIqStream, HwIqSocket), its PHY on `device`. hw_samp_rate: the radio's
    rate; off the DECT rate (1.728 MHz * u * b) `front_end` resamples. All
    runtime and firmware times are DECT-rate sample counts."""

    # the benchmark's SDR loop and its tests read and replace these (and
    # plan_tx, plan_rx, _sync, _dev, hw): the port itself uses `front_end`
    _rx_step = _delegated("step")
    _hw_consumed = _delegated("consumed")
    _chunk_pump = _delegated("chunk")

    def __init__(self, hw, tpoint: Tpoint, network_id: int,
                 u: int = 1, b: int = 1,
                 chunk_len: int = 2048,
                 regular_period: int | None = None,
                 tm_by_n_eff: dict[int, int] | None = None,
                 app_server=None, app_client=None,
                 hw_samp_rate: int | None = None,
                 json_export_dir: str | None = None,
                 device: torch.device | str = "cuda"):
        self.hw = hw
        self.tpoint = tpoint
        self.network_id = network_id
        self.u, self.b = u, b
        self.chunk_len = chunk_len
        self.overlap = 4 * get_N_samples_STF(u, b)
        self.regular_period = regular_period
        # detected N_eff_TX -> tm_mode used for demod (single-stream default)
        self.tm_by_n_eff = tm_by_n_eff or {1: 0, 2: 1, 4: 5, 8: 10}
        self.stats = RuntimeStats()
        self.device = torch.device(device)
        self._dev = str(self.device)
        self._processed = 0            # DECT-rate time up to which sync ran
        self._last_regular = 0
        self._irregular: list[tuple[int, int]] = []    # (time, handle)
        self._handled_times: list[int] = []
        self._pending: list[tuple] = []        # detections awaiting PCC window
        self._pending_pdc: list[tuple] = []    # PCC done, awaiting full packet
        self._started = False
        # up to 4 packets per chunk (reference sync_chunk keeps searching
        # after each hit, sync_chunk.cpp:146-278)
        self.max_peaks = 4
        self._sync = _module("sync", (u, b, chunk_len + self.overlap),
                             self._dev, max_peaks=self.max_peaks)
        self._stf_len = get_N_samples_STF(u, b)
        # application layer (reference posts application_report_t jobs into
        # the PHY job queue, README.md:248; here: drained per process())
        self.app_server = app_server
        self.app_client = app_client
        # per-received-packet JSON records (reference worker_tx_rx.cpp:
        # 355-415 json_export of sync report/channel/PLCF per packet,
        # README.md:333-337 — feeds the offline analysis tooling)
        self.json_export = None
        if json_export_dir is not None:
            from ..common.json_export import JsonExport
            self.json_export = JsonExport(json_export_dir, prefix="packets")

        # --- the front end (rx_pacer analog)
        self.dect_rate = 1_728_000 * u * b
        hw_rate = hw_samp_rate or getattr(hw, "samp_rate", 0) or self.dect_rate
        L, M = get_resampler_fraction(self.dect_rate, hw_rate)
        self.plan_tx = ResamplerPlan(L, M)             # dect -> hw
        self.plan_rx = ResamplerPlan(M, L)             # hw -> dect
        self.front_end = IdentityFrontEnd(hw) if self.plan_tx.identity else \
            ResampledFrontEnd(hw, self.plan_tx, self.plan_rx, self.device)
        tpoint.lower = self.front_end.lower

    def caught_up(self, hw_eof: bool) -> bool:
        """Whether a stream that had ended when the last process() began
        (`hw_eof`, read before it) is all consumed: every whole front-end
        step resampled, every whole chunk synced, no detection awaiting its
        decode (a process() takes only what had arrived when it began)."""
        return (hw_eof and self.front_end.drained()
                and self._processed + self.chunk_len + self.overlap
                > self.front_end.end
                and not self._pending and not self._pending_pdc)

    # ------------------------------------------------------------------ TX
    def _transmit(self, machigh: MacHighPhy) -> None:
        from ..sections.part4.plcf import bytes_to_bits
        if machigh.tx_descriptors:
            with span("runtime.tx"):
                for td in machigh.tx_descriptors:
                    ps = get_packet_sizes(td.psdef)
                    tx = _module("tx", (td.psdef, td.network_id or self.network_id,
                                        td.plcf.TYPE, td.codebook_index), self._dev)
                    n_bits = 40 if td.plcf.TYPE == 1 else 80
                    plcf_bits = bytes_to_bits(td.plcf.pack(), n_bits)
                    tb = td.tb_bits if td.tb_bits is not None else \
                        np.zeros(ps.N_TB_bits, np.uint8)
                    # PLCF and TB bits to the device in one transfer
                    bits = _to_dev(np.concatenate(
                        [np.asarray(plcf_bits), np.asarray(tb)]).astype(np.uint8),
                        self.device)[None]
                    fl = torch.zeros((1,), dtype=torch.bool, device=self.device)
                    iq = self.front_end.to_radio(
                        tx(bits[:, :n_bits], bits[:, n_bits:], fl, fl)[0])
                    d2h(iq.numel() * iq.element_size())
                    iq = iq.cpu().numpy()
                    t_hw = self.front_end.to_hw(td.tx_time)
                    if t_hw < self.hw.rx_time_passed:
                        # behind the radio write head: the burst head is lost
                        # (reference: UHD late-command error accounting)
                        self.stats.tx_late += 1
                    self.hw.tx_schedule(t_hw, iq[:self.hw.n_ant])
                    self.stats.tx_packets += 1
                    if td.hp_tx is not None:
                        td.hp_tx.finalize_now()
        if machigh.irregular.call_at is not None:
            self._irregular.append((machigh.irregular.call_at,
                                    machigh.irregular.handle))

    def _firmware(self, callback: str, key, *args):
        """The firmware's `work_<callback>(*args)` in its span (`key`: the
        packet's t_global, or None)."""
        with span(f"firmware.{callback}", key):
            return getattr(self.tpoint, f"work_{callback}")(*args)

    def work_application(self, datagrams: list[bytes]) -> None:
        """An application-report job: hand datagrams to the firmware and
        transmit what it returns (process() does so with an app server's
        datagrams; the scenario runner's --datagrams calls it directly)."""
        if datagrams:
            self._transmit(self._firmware("application", None, datagrams))

    # ------------------------------------------------------------------ RX
    def _is_unique(self, t: int) -> bool:
        """Baton unique-sync-time filter (worker_pool.cpp:299-324)."""
        for h in self._handled_times:
            if abs(t - h) < self._stf_len:
                return False
        self._handled_times.append(t)
        if len(self._handled_times) > 64:
            self._handled_times = self._handled_times[-32:]
        return True

    def _noise_var(self, chunk: np.ndarray) -> float:
        return float(np.median(np.abs(chunk) ** 2) + 1e-12)

    def _rx_stream(self, psdef, network_id: int, plcf_type: int,
                   win: np.ndarray, cfo: float, nv: float) -> dict:
        """The stream RX over the whole window [A, n] at t0 = 0."""
        rxs = _module("rx_stream", (psdef, network_id, plcf_type, win.shape[-1]),
                      self._dev)
        dev = self.device
        h2d(4)                      # the cfo and the noise variance below
        h2d(4)
        return rxs(_to_dev(win[None], dev), torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.tensor([cfo], dtype=torch.float32, device=dev),
                   torch.tensor(np.float32(nv), device=dev))

    def _handle_detection(self, t_global: int, cfo: float, n_eff: int,
                          metric: float, rms: float) -> bool:
        """PCC-first streaming decode (reference worker_tx_rx.cpp:110-228).

        Fires `work_pcc` as soon as the minimum-length window (STF + the PCC
        symbols) is buffered — NOT after a worst-case maximum-length packet:
        the reference decodes the PCC from the first ~5 OFDM symbols
        (rx_synced.cpp:186-323) and only then decides on the PDC. The PDC
        stage runs once the PLCF-declared packet length has arrived
        (`_run_pdc`, retried via `_pending_pdc`). Returns False if the PCC
        window is not fully received yet (retry next process()).
        """
        tm = self.tm_by_n_eff.get(n_eff, 0)
        sr = SyncReport(True, t_global, cfo, n_eff, metric, rms, self.u, self.b)

        # --- PCC stage on the minimum-length packet window
        ps_min = _min_len_psdef(self.u, self.b, tm)
        n_min = get_packet_sizes(ps_min).N_samples_packet
        if t_global + n_min > self.front_end.end:
            return False
        with span("runtime.pcc", t_global):
            try:
                win = self.front_end.window(t_global, n_min)
            except ValueError:
                # identity-plan ring overrun between the time check and the
                # read: the samples are gone; drop the detection (reference
                # overflow semantics: restream, packet lost)
                self.stats.pcc_err += 1
                return True
            nv = self._noise_var(win)
            out = self._rx_stream(ps_min, self.network_id, 1, win, cfo, nv)
            h = _host(out["plcf1"][0], out["plcf2"][0],
                      *(out[k][0] for k in _PCC_FLAGS))
            plcf_all = {1: h[:40], 2: h[40:120]}
            flags = dict(zip(_PCC_FLAGS, h[120:]))
            snr_db = float(flags["snr_db"])
            plcf_bits, plcf_type = None, 0
            if flags["plcf1_ok"]:
                plcf_bits, plcf_type = plcf_all[1].astype(np.uint8), 1
            elif flags["plcf2_ok"]:
                plcf_bits, plcf_type = plcf_all[2].astype(np.uint8), 2
            if plcf_type:
                plcf = decode_plcf(plcf_type, plcf_bits)
        if plcf_type == 0:
            self.stats.pcc_err += 1
            pcc_fail = PccReport(False, 0, None, None)
            if self.json_export is not None:
                from ..common.json_export import packet_record
                self.json_export.append(packet_record(sr, pcc_fail, snr_db, None))
            self._transmit(self._firmware("pcc_error", t_global,
                                          PhyMacLow(sr, pcc_fail)))
            return True
        pcc_rep = PccReport(True, plcf_type, plcf, plcf_bits,
                            bool(flags[f"plcf{plcf_type}_cl"]),
                            bool(flags[f"plcf{plcf_type}_bf"]), snr_db)
        self.stats.pcc_ok += 1
        phy_maclow = PhyMacLow(sr, pcc_rep)
        maclow = self._firmware("pcc", t_global, phy_maclow)
        if not maclow.continue_with_pdc or plcf is None:
            return True
        if not self._run_pdc(t_global, cfo, nv, phy_maclow, maclow):
            self._pending_pdc.append((t_global, cfo, nv, phy_maclow, maclow))
        return True

    def _drop_pdc(self, phy_maclow: PhyMacLow, maclow: MacLowPhy) -> None:
        """A promised PDC can no longer be demodulated (overrun skip ate the
        window): release the HARQ lease, count the error and tell the
        firmware — silence would leak HARQ processes and hide the loss."""
        if maclow.hp_rx is not None:
            maclow.hp_rx.finalize_now()
        self.stats.pdc_err += 1
        self._transmit(self._firmware(
            "pdc_error", phy_maclow.sync_report.fine_peak_time,
            PhyMacHigh(phy_maclow, PdcReport(False, None, 0.0, None))))

    def _run_pdc(self, t_global: int, cfo: float, nv: float,
                 phy_maclow: PhyMacLow, maclow: MacLowPhy) -> bool:
        """PDC stage with the PLCF-declared psdef; False = window not in yet."""
        psdef = maclow.psdef
        ps = get_packet_sizes(psdef)
        if t_global + ps.N_samples_packet > self.front_end.end:
            return False
        try:
            win = self.front_end.window(t_global, ps.N_samples_packet)
        except ValueError:
            self._drop_pdc(phy_maclow, maclow)
            return True
        with span("runtime.pdc", t_global):
            out2 = self._rx_stream(psdef, maclow.network_id, maclow.plcf_type,
                                   win, cfo, nv)
            # the codebook search on the channel estimates stays on the
            # device; its result comes back with the PDC's report
            cells = out2["h_cells"]
            found = mimo_search(cells)
            n_tb = ps.N_TB_bits
            h = _host(out2["tb"][0], out2["tb_ok"][0], out2["snr_db"][0],
                      out2["sto_frac"][0], out2["cfo_res"][0],
                      *(x[0] for x in (found or ())))
        ok = bool(h[n_tb])
        snr_db, sto_frac, cfo_res = (float(v) for v in h[n_tb + 1:n_tb + 4])
        n_tx = cells.shape[2]
        mimo = MimoReport(int(h[n_tb + 4]), float(h[n_tb + 5]), 1, n_tx) \
            if found is not None else MimoReport(0, 0.0, 1, n_tx)
        pdc_rep = PdcReport(ok, h[:n_tb].astype(np.uint8) if ok else None,
                            snr_db, mimo)
        if maclow.hp_rx is not None:
            maclow.hp_rx.finalize_now()
        phy_machigh = PhyMacHigh(phy_maclow, pdc_rep)
        if self.json_export is not None:
            from ..common.json_export import packet_record
            from ..sections.part4.plcf import bits_to_bytes
            pcc = phy_maclow.pcc_report
            rec = packet_record(
                phy_maclow.sync_report, pcc, snr_db,
                bits_to_bytes(pcc.plcf_bits) if pcc.plcf_bits is not None
                else None)
            rec["pdc"] = {"crc_ok": ok, "n_tb_bits": int(ps.N_TB_bits),
                          "mcs": int(psdef.mcs_index),
                          "sto_frac": sto_frac, "cfo_res": cfo_res}
            self.json_export.append(rec)
        if ok:
            self.stats.pdc_ok += 1
            self._transmit(self._firmware("pdc", t_global, phy_machigh))
        else:
            self.stats.pdc_err += 1
            self._transmit(self._firmware("pdc_error", t_global, phy_machigh))
        return True

    # ------------------------------------------------------------------ loop
    def process(self) -> None:
        """Advance sync/decode/callbacks as far as received samples allow."""
        with span("runtime.process"):
            self.front_end.pump()
            if not self._started:
                self._started = True
                now_d = self.front_end.to_dect(self.hw.rx_time)
                irr = self._firmware("start", None, now_d)
                if irr.call_at is not None:
                    self._irregular.append((irr.call_at, irr.handle))
                self._processed = now_d
                self._last_regular = now_d

            # application ingress/egress (application_report_t jobs)
            if self.app_server is not None:
                if hasattr(self.app_server, "poll"):
                    self.app_server.poll()
                self.work_application(self.app_server.read_all())
            if self.app_client is not None:
                out = getattr(self.tpoint, "app_rx", None)
                if out:
                    self.app_client.write_all(out)
                    out.clear()

            # retry stages waiting for more samples: PDC first (older packets,
            # FIFO job order), then detections awaiting their PCC window
            window_start = self.front_end.start
            still_pdc = []
            for args in self._pending_pdc:
                if args[0] < window_start:
                    self._drop_pdc(args[3], args[4])    # lost to an overrun skip
                elif not self._run_pdc(*args):
                    still_pdc.append(args)
            self._pending_pdc = still_pdc
            still = []
            for args in self._pending:
                if args[0] < window_start:
                    # lost to an overrun skip before its PCC window arrived
                    self.stats.detections_dropped += 1
                    continue
                if not self._handle_detection(*args):
                    still.append(args)
            self._pending = still

            avail = self.front_end.end      # as for the pump: what has arrived
            while self._processed + self.chunk_len + self.overlap <= avail:
                if self._processed < window_start:
                    # overrun skip moved the window past the sync cursor
                    self._processed = window_start
                t0 = self._processed
                try:
                    chunk = self.front_end.window(t0, self.chunk_len + self.overlap)
                except ValueError:
                    # identity-plan ring overflow: sync fell behind the producer;
                    # skip forward to the oldest sample still available (the lost
                    # span is unrecoverable, reference restream on overflow)
                    self._processed = max(self._processed + self.chunk_len,
                                          self.front_end.start)
                    continue
                with span("runtime.sync"):
                    rep = self._sync(_to_dev(chunk[None], self.device))
                    self.stats.chunks += 1
                    # [field, peak]: detected, t_fine, cfo, n_eff_tx, metric, rms
                    det, tf, cfo, n_eff, met, rms = _host(
                        *(rep[k][0] for k in _SYNC_FIELDS)
                    ).reshape(len(_SYNC_FIELDS), -1)
                # handle peaks in time order (the reference enqueues sync
                # reports FIFO as the search advances through the chunk)
                for k in np.argsort(tf.astype(np.int32)):
                    if not det[k]:
                        continue
                    t_fine = int(tf[k])
                    t_global = t0 + t_fine
                    if t_fine < self.chunk_len and self._is_unique(t_global):
                        self.stats.detections += 1
                        args = (t_global, float(cfo[k]), int(n_eff[k]),
                                float(met[k]), float(rms[k]))
                        if not self._handle_detection(*args):
                            self._pending.append(args)
                self._processed += self.chunk_len

                # regular job cadence (baton_t::is_job_regular_due)
                if self.regular_period is not None and \
                        self._processed - self._last_regular >= self.regular_period:
                    self._last_regular = self._processed
                    self.stats.regular_calls += 1
                    self._transmit(self._firmware("regular", None, self._processed))

                # irregular queue (irregular_queue_t)
                due = [x for x in self._irregular if x[0] <= self._processed]
                self._irregular = [x for x in self._irregular if x[0] > self._processed]
                for t, handle in sorted(due):
                    self.stats.irregular_calls += 1
                    self._transmit(self._firmware("irregular", None, t, handle))
