"""Loopback experiments: the link-level PER-vs-SNR and PER-vs-amplitude
oracles (port of dectnrp_tpu/upper/loopback.py).

Reference: lib/src/upper/loopback/tfw_loopback{,_snr,_ratio}.cpp. Each
(parameter, SNR) point is one batched call of a `PointStep`: B packets
synthesized, [clipped and quantized], [passed through the 10/9 up and 9/10
down resampler pair], [through a doubly-selective Rayleigh channel], [placed
at random offsets in zero streams], under AWGN, then synchronized and
received, or received aligned.

Every random number of a point comes from numpy (TB bits, offsets, seeded
as the JAX package seeds them) or from an explicit `torch.Generator` seeded
with the point's seed on the step's device (channel draws, noise), made by
`PointStep.draw` and handed to the step, so a test can hand the step the
JAX package's own draws instead.

Outputs match tfw_loopback_snr_t::save_all_results_to_file: per MCS a JSON
record {snr_vec, nof_experiment_per_snr, PER_pcc_crc, PER_pcc_crc_and_plcf,
PER_pdc_crc, snr_min/max_vec}. `loopback_mmie_roundtrip`
(tfw_loopback_mmie) sends MMIEs in a MAC PDU over the AWGN loopback and
decodes them back.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..phy.resampler import ResamplerPlan, build_resampler
from ..phy.rx import build_rx
from ..phy.sync import build_rx_stream, build_sync
from ..phy.tx import build_tx
from ..sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..sections.part3.phyres import k_b_OCC
from ..sections.part4.identity import Identity
from ..sections.part4.mac_pdu_decoder import build_mac_pdu, decode_mac_pdu
from ..sections.part4.plcf import Plcf10, bits_to_bytes, bytes_to_bits
from ..simulation.channels import (apply_awgn, apply_doubly, apply_doubly_genie,
                                   draw_doubly, draw_noise, noise_var_for_snr,
                                   tap_table)
from ..simulation.hardware import clip_and_quantize

N_SIN = 8                       # Jakes sinusoids per tap (channels.py default)


@dataclass
class LoopbackPoint:
    n: int
    n_pcc: int
    n_pcc_and_plcf: int
    n_pdc: int
    snr_min: float
    snr_max: float

    @property
    def per_pcc(self):
        return 1.0 - self.n_pcc / self.n

    @property
    def per_pcc_and_plcf(self):
        return 1.0 - self.n_pcc_and_plcf / self.n

    @property
    def per_pdc(self):
        return 1.0 - self.n_pdc / self.n


def parse_channel(channel: str):
    """"awgn" -> None; "doubly_<pdp>_<tau_ns>_<fd_hz>" -> (pdp, tau_rms_s,
    doppler_hz) (reference radio.json sim_channel_name_inter)."""
    if channel == "awgn":
        return None
    kind, pdp, tau, fd = channel.split("_")
    if kind != "doubly":
        raise ValueError(f"unknown channel {channel!r}")
    return int(pdp), float(tau) * 1e-9, float(fd)


class PointStep(torch.nn.Module):
    """One loopback point of a configuration (JAX `_point_step`):

    step(plcf_b [B, 40], tb [B, N_TB], snr_db (0-dim float32), offs [B],
    amp, draws) -> rx dict plus `detected` [B].

    Stages, in the JAX package's order: TX x amp -> [clip and quantize]
    -> signal power over the whole batch and noise variance -> [10/9 up,
    9/10 down resampler pair] -> [doubly-selective channel, or its genie
    variant with the true per-symbol response] -> [scatter at `offs` into
    zero streams of T = 2^ceil(log2(n_pkt + 512)) samples] -> AWGN ->
    [sync -> stream RX] or aligned RX. `draws` is `draw`'s dict: "noise"
    (unit-variance complex64, the shape of the received signal) and, with
    a doubly channel, "theta" and "phi" [B, N_TX, N_TX, L, 8].
    """

    def __init__(self, psdef: PacketSizesDef, nid: int, use_sync: bool,
                 quantize_bits: int | None, channel: str = "awgn",
                 resampler_loop: bool = False, genie: bool = False,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.fading = parse_channel(channel)
        if genie and (use_sync or self.fading is None):
            raise ValueError("genie mode is aligned-only over a doubly channel")
        ps = self.ps = get_packet_sizes(psdef)
        self.use_sync, self.quantize_bits, self.genie = use_sync, quantize_bits, genie
        self.tx = build_tx(psdef, nid, 1, device=device)
        self.n_pkt = n_pkt = ps.N_samples_packet
        self.n_tx = ps.tm_mode.N_TX
        self.samp_rate = 1_728_000 * psdef.u * psdef.b
        self.up = self.down = None
        if resampler_loop:
            self.up = build_resampler(ResamplerPlan(10, 9), n_pkt, device)
            self.down = build_resampler(ResamplerPlan(9, 10), self.up.n_out, device)
        self.T = int(2 ** np.ceil(np.log2(n_pkt + 512)))
        if use_sync:
            self.sync = build_sync(psdef.u, psdef.b, self.T, device=device)
            self.rxs = build_rx_stream(psdef, nid, 1, self.T, device)
        else:
            self.rx = build_rx(psdef, nid, 1, device=device, genie=genie)
        if self.fading is not None:
            pdp, tau, _ = self.fading
            self.n_taps = tap_table(self.samp_rate, tau, pdp)[0].size
        if genie:
            q = ps.numerology
            N, cp = q.N_b_DFT, q.N_b_CP
            # FFT-window center of every packet symbol (symbol 0 = STF slot)
            self.sym_centers = tuple(
                min(n_pkt - 1,
                    ps.N_samples_STF // 2 if s == 0
                    else ps.N_samples_STF + (s - 1) * (N + cp) + cp + N // 2)
                for s in range(ps.N_PACKET_symb))
            self.k_occ = tuple(int(k) for k in k_b_OCC(psdef.b))
            self.N = N
        self.device = torch.device(device)

    def noise_shape(self, B: int) -> tuple[int, int, int]:
        """The received signal's shape: [B, N_RX = N_TX, T or n_pkt]."""
        return (B, self.n_tx, self.T if self.use_sync else self.n_pkt)

    def draw(self, generator: torch.Generator, B: int) -> dict:
        """The point's random channel draws and noise, on the step's device."""
        out = {}
        if self.fading is not None:
            out["theta"], out["phi"] = draw_doubly(
                generator, B, self.n_tx, self.n_tx, self.n_taps, N_SIN, self.device)
        out["noise"] = draw_noise(generator, self.noise_shape(B), self.device)
        return out

    def scatter(self, iq: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """Packets [B, R, n_pkt] at `offs` [B] in zero streams [B, R, T]."""
        B, R = iq.shape[:2]
        out = torch.zeros((B, R, self.T, 2), dtype=torch.float32, device=iq.device)
        idx = (offs.to(torch.int64)[:, None]
               + torch.arange(self.n_pkt, device=iq.device))
        out.scatter_(2, idx[:, None, :, None].expand(B, R, -1, 2),
                     torch.view_as_real(iq.contiguous()))
        return torch.view_as_complex(out)

    def forward(self, plcf_b, tb, snr_db, offs, amp, draws: dict) -> dict:
        B = plcf_b.shape[0]
        flags = torch.zeros((B,), dtype=torch.bool, device=plcf_b.device)
        iq = self.tx(plcf_b, tb, flags, flags) * amp
        if self.quantize_bits is not None:
            iq = clip_and_quantize(iq, self.quantize_bits)
        # signal power over the whole batch, on the device (no host read)
        nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
        if self.up is not None:
            iq = self.down(self.up(iq))[..., :self.n_pkt]
        h_genie = None
        if self.fading is not None:
            pdp, tau, fd = self.fading
            th, ph = draws["theta"], draws["phi"]
            if self.genie:
                iq, h_genie = apply_doubly_genie(
                    iq, th, ph, self.samp_rate, self.sym_centers, self.k_occ,
                    self.N, tau, fd, pdp)
            else:
                iq = apply_doubly(iq, th, ph, self.samp_rate, tau, fd, pdp)
        if self.use_sync:
            y = apply_awgn(self.scatter(iq, offs), nv, draws["noise"])
            rep = self.sync(y)
            out = dict(self.rxs(y, rep["t_fine"], rep["cfo"], nv))
            out["detected"] = rep["detected"]
        else:
            y = apply_awgn(iq, nv, draws["noise"])
            out = dict(self.rx(y, nv, h_genie) if self.genie else self.rx(y, nv))
            out["detected"] = torch.ones((B,), dtype=torch.bool, device=y.device)
        return out


@lru_cache(maxsize=None)
def point_step(psdef: PacketSizesDef, nid: int, use_sync: bool,
               quantize_bits: int | None, channel: str = "awgn",
               resampler_loop: bool = False, genie: bool = False,
               device: torch.device | str = "cuda") -> PointStep:
    """The configuration's PointStep, built once on `device` and shared by
    all its SNR points (the JAX package's lru_cache)."""
    return PointStep(psdef, nid, use_sync, quantize_bits, channel,
                     resampler_loop, genie, device)


def point_inputs(psdef: PacketSizesDef, identity: Identity, n_packets: int,
                 seed: int, T: int, n_pkt: int):
    """(plcf bits [B, 40], tb [B, N_TB], offs [B]) as numpy, drawn as the
    JAX package draws them: the PLCF type 1 of `identity` on every packet,
    then TB bits and offsets from default_rng(seed)."""
    ps = get_packet_sizes(psdef)
    rng = np.random.default_rng(seed)
    plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                  packet_length=psdef.PacketLength,
                  short_network_id=identity.short_network_id,
                  transmitter_identity=identity.short_rdid,
                  transmit_power=7, df_mcs=psdef.mcs_index)
    plcf_b = np.tile(bytes_to_bits(plcf.pack(), 40), (n_packets, 1)).astype(np.uint8)
    tb = rng.integers(0, 2, (n_packets, ps.N_TB_bits)).astype(np.uint8)
    offs = rng.integers(64, T - n_pkt - 64, n_packets)
    return plcf_b, tb, offs


def _run_point(psdef: PacketSizesDef, identity: Identity, snr_db: float,
               n_packets: int, seed: int, use_sync: bool,
               amplitude_scale: float = 1.0, quantize_bits: int | None = None,
               channel: str = "awgn", resampler_loop: bool = False,
               genie: bool = False,
               device: torch.device | str = "cuda") -> LoopbackPoint:
    """One batched loopback point: TX -> [scale/clip/quantize] ->
    [resample pair] -> [fading] -> AWGN -> [sync] -> RX decode."""
    step = point_step(psdef, identity.network_id, use_sync, quantize_bits,
                      channel, resampler_loop, genie, device)
    dev = step.device
    B = n_packets
    plcf_b, tb, offs = point_inputs(psdef, identity, B, seed, step.T, step.n_pkt)
    draws = step.draw(torch.Generator(device=dev).manual_seed(seed), B)
    out = step(torch.as_tensor(plcf_b, device=dev), torch.as_tensor(tb, device=dev),
               torch.tensor(snr_db, dtype=torch.float32, device=dev),
               torch.as_tensor(offs, device=dev), amplitude_scale, draws)
    out = {k: out[k].cpu().numpy()
           for k in ("detected", "plcf1_ok", "tb_ok", "snr_db", "plcf1", "tb")}

    pcc_ok = out["plcf1_ok"] & out["detected"]
    pdc_ok = out["tb_ok"] & pcc_ok
    # PLCF content check (reference work_pcc: transmitter identity match)
    plcf_match = np.zeros(B, bool)
    for i in np.nonzero(pcc_ok)[0]:
        c = Plcf10()
        if c.unpack(bits_to_bytes(out["plcf1"][i])) and \
                c.transmitter_identity == identity.short_rdid:
            plcf_match[i] = True
    good = pdc_ok & plcf_match
    tb_match = good & np.all(out["tb"] == tb, axis=1)
    if tb_match.any():
        snrs = out["snr_db"][tb_match]
        snr_min, snr_max = float(snrs.min()), float(snrs.max())
    else:
        snr_min = snr_max = float("nan")
    return LoopbackPoint(
        n=B, n_pcc=int(pcc_ok.sum()), n_pcc_and_plcf=int(plcf_match.sum()),
        n_pdc=int(tb_match.sum()), snr_min=snr_min, snr_max=snr_max)


@dataclass
class LoopbackSnrExperiment:
    """PER vs SNR per MCS (reference tfw_loopback_snr.cpp:34-187:
    MCS 1-6 x SNR -2..20 dB x 100 packets)."""
    identity: Identity = field(
        default_factory=lambda: Identity(0x12345678, 0x2222, 0x3333))
    u: int = 1
    b: int = 1
    packet_length_type: int = 0
    packet_length: int = 2
    tm_mode_index: int = 0        # e.g. 2 = 2x2 N_SS=2 spatial multiplexing
    mcs_list: tuple[int, ...] = (1, 2, 3, 4, 5, 6)
    snr_db: tuple[float, ...] = tuple(float(s) for s in range(-2, 21))
    n_per_snr: int = 100
    use_sync: bool = True
    channel: str = "awgn"            # or "doubly_<pdp>_<tau_ns>_<fd_hz>"
    resampler_loop: bool = False     # TX 10/9 up + RX 9/10 down in the loop
    genie: bool = False              # true-channel equalization (aligned)
    seed: int = 0
    device: str = "cuda"

    def psdef(self, mcs: int) -> PacketSizesDef:
        return PacketSizesDef(self.u, self.b, self.packet_length_type,
                              self.packet_length, self.tm_mode_index, mcs, 6144)

    def run_point(self, mcs: int, i: int, snr: float) -> LoopbackPoint:
        """The point at SNR `snr`, the i-th of its MCS's sweep (its seed)."""
        return _run_point(self.psdef(mcs), self.identity, snr, self.n_per_snr,
                          self.seed + 1000 * mcs + i, self.use_sync,
                          channel=self.channel,
                          resampler_loop=self.resampler_loop, genie=self.genie,
                          device=self.device)

    def run(self) -> dict:
        results = {}
        for mcs in self.mcs_list:
            if get_packet_sizes(self.psdef(mcs)) is None:
                continue
            pts = [self.run_point(mcs, i, snr) for i, snr in enumerate(self.snr_db)]
            results[mcs] = {
                "experiment_range": {"snr_vec": list(self.snr_db),
                                     "nof_experiment_per_snr": self.n_per_snr},
                "parameter": {"mcs": mcs, "channel": self.channel,
                              "resampler_loop": self.resampler_loop},
                "result": {
                    "snr_max_vec": [p.snr_max for p in pts],
                    "snr_min_vec": [p.snr_min for p in pts],
                    "PER_pcc_crc": [p.per_pcc for p in pts],
                    "PER_pcc_crc_and_plcf": [p.per_pcc_and_plcf for p in pts],
                    "PER_pdc_crc": [p.per_pdc for p in pts],
                },
            }
        return results

    def save_json(self, out_dir: str) -> list[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for mcs, rec in self.run().items():
            p = os.path.join(out_dir, f"rx_loopback_MCS_{mcs:04d}.json")
            with open(p, "w") as f:
                json.dump(rec, f, indent=4)
            paths.append(p)
        return paths


@dataclass
class LoopbackRatioExperiment:
    """PER vs TX amplitude ratio under clip+quantize at fixed SNR
    (reference tfw_loopback_ratio.cpp)."""
    identity: Identity = field(
        default_factory=lambda: Identity(0x12345678, 0x2222, 0x3333))
    psdef: PacketSizesDef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    snr_db: float = 30.0
    ratios: tuple[float, ...] = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
    quantize_bits: int = 12
    n_per_ratio: int = 50
    use_sync: bool = False
    seed: int = 0
    device: str = "cuda"

    def run(self) -> dict:
        return {r: _run_point(self.psdef, self.identity, self.snr_db,
                              self.n_per_ratio, self.seed + i, self.use_sync,
                              amplitude_scale=r, quantize_bits=self.quantize_bits,
                              device=self.device)
                for i, r in enumerate(self.ratios)}


def loopback_mmie_roundtrip(mmies, identity: Identity,
                            psdef: PacketSizesDef | None = None,
                            snr_db: float = 20.0, seed: int = 0,
                            device: torch.device | str = "cuda",
                            noise: torch.Tensor | None = None):
    """MMIE codec round trip over the air (reference tfw_loopback_mmie.cpp,
    port of dectnrp_tpu/upper/loopback.py:304): build a MAC PDU from
    `mmies`, TX through AWGN loopback at `snr_db`, decode the PDU. Without
    `psdef`, the shortest (1, 1, 0, PacketLength, 0, 2, 6144) whose TB holds
    the PDU. `noise` (unit variance, complex64 [1, N_TX, n]) defaults to a
    draw from a torch.Generator seeded with `seed` on `device`. Returns the
    list of decoded MMIEs (asserting CRC pass)."""
    from ..sections.part4.mac_pdu import (BeaconHeader, MacHeaderKind,
                                          MacHeaderType)

    mht = MacHeaderType(mac_header_type=MacHeaderKind.BEACON)
    ch = BeaconHeader(network_id_3_lsb=identity.network_id & 0xFFFFFF,
                      transmitter_address=identity.long_rdid)
    need = 1 + ch.SIZE + sum(m.packed_size_mmh_sdu() for m in mmies)

    if psdef is None:
        for plen in range(1, 17):
            psdef = PacketSizesDef(1, 1, 0, plen, 0, 2, 6144)
            ps = get_packet_sizes(psdef)
            if ps is not None and ps.N_TB_bits // 8 >= need:
                break
    ps = get_packet_sizes(psdef)
    assert ps.N_TB_bits // 8 >= need, "MAC PDU does not fit TB"

    pdu = build_mac_pdu(mht, ch, mmies, tb_size_bytes=ps.N_TB_bits // 8)
    tb_bits = np.unpackbits(np.frombuffer(pdu, np.uint8))[:ps.N_TB_bits]

    nid = identity.network_id
    tx = build_tx(psdef, nid, 1, device=device)
    rx = build_rx(psdef, nid, 1, device=device)
    dev = tx.W.device
    plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                  packet_length=psdef.PacketLength,
                  short_network_id=identity.short_network_id,
                  transmitter_identity=identity.short_rdid,
                  df_mcs=psdef.mcs_index)
    plcf_b = torch.as_tensor(bytes_to_bits(plcf.pack(), 40)[None, :].astype(np.uint8),
                             device=dev)
    fl = torch.zeros((1,), dtype=torch.bool, device=dev)

    iq = tx(plcf_b, torch.as_tensor(tb_bits[None, :].astype(np.uint8), device=dev),
            fl, fl)
    nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
    if noise is None:
        noise = draw_noise(torch.Generator(device=dev).manual_seed(seed),
                           iq.shape, dev)
    out = rx(apply_awgn(iq, nv, noise.to(dev)), nv)
    assert bool(out["tb_ok"][0]), "loopback decode failed"
    rx_pdu = np.packbits(out["tb"][0].cpu().numpy().astype(np.uint8)).tobytes()
    dec = decode_mac_pdu(rx_pdu)
    assert not dec.aborted
    return dec.mmies
