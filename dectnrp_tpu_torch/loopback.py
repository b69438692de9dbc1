"""The bench's stream loopback step (port of bench.py::_make_step).

One step: TX synthesis of `n_pkts` packets per stream -> [10/9 resampler to
the radio rate] -> scatter into a stream at the given offsets -> AWGN at the
radio rate -> [9/10 resampler back to the DECT rate] -> STF sync search with
multi-peak masking -> per packet: stream slice + CFO derotation -> aligned
RX (blind PCC + PDC turbo decode). This is the reference's hot path
(sync_chunk.cpp:146-278 feeding rx_synced.cpp:186-436); the resamplers are
the radio's rate bridge (resampler.cpp).

Two configurations of it:
- flagship (`make_flagship_step`): u=1 b=16 SISO MCS4, no resampler, 64
  streams of T = 4 packet lengths + 8192 samples with 2 packets at offsets
  at least 1.5 packet lengths apart, at 15 dB: 64 channels of 27.648 Ms/s,
  each carrying about 7 ms of air time.
- wall (`make_wall_step`): u=1 b=8 with N_TX = 4 Alamouti transmit
  diversity, MCS2, the resampler in both directions (13.824 <-> 15.36 Ms/s),
  16 streams of 3 packet lengths + 8192 DECT-rate samples with 1 packet
  each, at 20 dB; the reference's compute wall (bench.py:9-11).
"""
from __future__ import annotations

import numpy as np
import torch

from .phy.resampler import ResamplerPlan, build_resampler
from .phy.sync import build_rx_stream, build_sync
from .phy.tx import build_tx
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .simulation.channels import awgn

FLAGSHIP_PSDEF = PacketSizesDef(1, 16, 1, 4, 0, 4, 6144)
WALL_PSDEF = PacketSizesDef(1, 8, 1, 4, 5, 2, 6144)
NETWORK_ID = 0x12345678


def dect_rate(psdef: PacketSizesDef) -> int:
    """Native DECT NR+ sample rate of a configuration: 1.728 MHz * u * b."""
    return 1_728_000 * psdef.u * psdef.b


def hw_rate(psdef: PacketSizesDef, resample: bool) -> int:
    """Radio sample rate of the bench step: the DECT rate, or 10/9 of it
    with the resampler (bench.py:118-119)."""
    return dect_rate(psdef) * 10 // 9 if resample else dect_rate(psdef)


def stream_len(psdef: PacketSizesDef, t_factor: int = 4) -> int:
    """Bench stream length: t_factor packet lengths + 8192 (bench.py:115)."""
    return get_packet_sizes(psdef).N_samples_packet * t_factor + 8192


def packet_offsets(rng: np.random.Generator, B: int, n_pkts: int, T: int,
                   n_pkt: int) -> np.ndarray:
    """[B, n_pkts] sorted offsets, pairwise >= 1.5 packet lengths apart
    (bench.py:95-104)."""
    sep = int(1.5 * n_pkt)
    out = np.zeros((B, n_pkts), np.int64)
    for i in range(B):
        while True:
            o = np.sort(rng.integers(64, T - n_pkt - 64, n_pkts))
            if n_pkts == 1 or np.diff(o).min() >= sep:
                out[i] = o
                break
    return out


class StreamStep(torch.nn.Module):
    """step(plcf [B,40], tb [B,N_TB], offsets [B,n_pkts], generator)
    -> (tb_ok [B, n_pkts], detected [B, n_pkts], t_fine [B, n_pkts]).

    `T` and `n_pkt` are the stream and packet lengths at the radio rate,
    where the offsets lie; `T_dect` is the stream length the receiver sees
    (the same without the resampler). The stages are also callable one by
    one (`transmit`, `resample_up`, `scatter`, `awgn`, `resample_down`,
    `receive`; `stream` is the first three), which is how a test adds its
    own noise and how a timer splits the step.
    """

    def __init__(self, psdef: PacketSizesDef, T: int, n_pkts: int,
                 network_id: int, snr_db: float, resample: bool,
                 device: torch.device | str):
        super().__init__()
        self.n_pkts = n_pkts
        n_pkt = get_packet_sizes(psdef).N_samples_packet
        self.noise_var = float(np.float32(10.0 ** (-snr_db / 10.0)))
        self.tx = build_tx(psdef, network_id, 1, device=device)
        if resample:
            # the bench's roundings (bench.py:52-58)
            self.up = build_resampler(ResamplerPlan(10, 9), n_pkt, device)
            self.n_pkt = -(-n_pkt * 10 // 9)
            self.T = -(-T * 10 // 9) // 10 * 10
            self.down = build_resampler(ResamplerPlan(9, 10), self.T, device)
            self.T_dect = -(-self.T * 9 // 10)
        else:
            self.up = self.down = None
            self.n_pkt, self.T, self.T_dect = n_pkt, T, T
        self.sync = build_sync(psdef.u, psdef.b, self.T_dect, max_peaks=n_pkts,
                               device=device)
        self.rxs = build_rx_stream(psdef, network_id, 1, self.T_dect, device)

    def transmit(self, plcf_bits, tb_bits):
        """TX at the DECT rate: -> iq complex64 [B, N_TX, N_samples_packet]."""
        flags = torch.zeros((plcf_bits.shape[0],), dtype=torch.bool,
                            device=plcf_bits.device)
        return self.tx(plcf_bits, tb_bits, flags, flags)

    def resample_up(self, iq):
        return iq if self.up is None else self.up(iq)

    def scatter(self, iq, offsets):
        """Packets [B, N_TX, n_pkt] at `offsets` -> stream [B, N_TX, T]."""
        B, n_tx = iq.shape[:2]
        out = torch.zeros((B, n_tx, self.T, 2), dtype=torch.float32,
                          device=iq.device)
        ar = torch.arange(self.n_pkt, device=iq.device)
        src = torch.view_as_real(iq)
        for k in range(self.n_pkts):
            idx = (offsets[:, k, None] + ar)[:, None, :, None].expand(B, n_tx, -1, 2)
            out.scatter_add_(2, idx, src)
        return torch.view_as_complex(out)

    def stream(self, plcf_bits, tb_bits, offsets):
        """TX + [up-resampler] + scatter: -> stream complex64 [B, N_TX, T]."""
        return self.scatter(self.resample_up(self.transmit(plcf_bits, tb_bits)),
                            offsets)

    def awgn(self, stream, generator):
        return awgn(stream, self.noise_var, generator)

    def resample_down(self, y):
        return y if self.down is None else self.down(y)

    def receive(self, y):
        """sync + per-packet stream RX of the DECT-rate stream y [B, R, T_dect]
        -> (tb_ok, detected, t_fine), [B, n_pkts]."""
        rep = self.sync(y)
        tf, cf, det = rep["t_fine"], rep["cfo"], rep["detected"]
        if self.n_pkts == 1:
            tf, cf, det = tf[:, None], cf[:, None], det[:, None]
        oks = [self.rxs(y, tf[:, k], cf[:, k], self.noise_var)["tb_ok"]
               for k in range(self.n_pkts)]
        return torch.stack(oks, -1), det, tf

    def forward(self, plcf_bits, tb_bits, offsets, generator):
        y = self.awgn(self.stream(plcf_bits, tb_bits, offsets), generator)
        return self.receive(self.resample_down(y))


def make_flagship_step(psdef: PacketSizesDef = FLAGSHIP_PSDEF,
                       T: int | None = None, n_pkts: int = 2,
                       network_id: int = NETWORK_ID, snr_db: float = 15.0,
                       device: torch.device | str = "cuda") -> StreamStep:
    """The bench's stream step without the resampler, on `device`; T
    defaults to the bench's stream length (4 packet lengths + 8192)."""
    return StreamStep(psdef, stream_len(psdef) if T is None else T, n_pkts,
                      network_id, snr_db, False, device)


def make_wall_step(psdef: PacketSizesDef = WALL_PSDEF, T: int | None = None,
                   n_pkts: int = 1, network_id: int = NETWORK_ID,
                   snr_db: float = 20.0,
                   device: torch.device | str = "cuda") -> StreamStep:
    """The bench's stream step with the 10/9 resampler in both directions
    (bench.py:303-310), on `device`; T is the DECT-rate length the radio
    stream is cut from and defaults to 3 packet lengths + 8192."""
    return StreamStep(psdef, stream_len(psdef, 3) if T is None else T, n_pkts,
                      network_id, snr_db, True, device)
