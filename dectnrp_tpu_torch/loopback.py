"""The flagship stream loopback step (port of bench.py::_make_step, no resampler).

One step: TX synthesis of `n_pkts` packets per stream -> scatter into a
T-sample stream at the given offsets -> AWGN -> STF sync search with
multi-peak masking -> per packet: stream slice + CFO derotation -> aligned
RX (blind PCC + PDC turbo decode). This is the reference's hot path
(sync_chunk.cpp:146-278 feeding rx_synced.cpp:186-436).

The flagship configuration is u=1 b=16 SISO MCS4 (`FLAGSHIP_PSDEF`), 64
streams of T = 4 packet lengths + 8192 samples with 2 packets at offsets at
least 1.5 packet lengths apart, at 15 dB: 64 channels of 27.648 Ms/s, each
carrying about 7 ms of air time.
"""
from __future__ import annotations

import numpy as np
import torch

from .phy.sync import build_rx_stream, build_sync
from .phy.tx import build_tx
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .simulation.channels import awgn

FLAGSHIP_PSDEF = PacketSizesDef(1, 16, 1, 4, 0, 4, 6144)
NETWORK_ID = 0x12345678


def dect_rate(psdef: PacketSizesDef) -> int:
    """Native DECT NR+ sample rate of a configuration: 1.728 MHz * u * b."""
    return 1_728_000 * psdef.u * psdef.b


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


class FlagshipStep(torch.nn.Module):
    """step(plcf [B,40], tb [B,N_TB], offsets [B,n_pkts], generator)
    -> (tb_ok [B, n_pkts], detected [B, n_pkts], t_fine [B, n_pkts]).

    The stages are also callable one by one (`stream`, `awgn`, `receive`),
    which is how a test adds its own noise and how a timer splits the step.
    """

    def __init__(self, psdef: PacketSizesDef, T: int, n_pkts: int,
                 network_id: int = NETWORK_ID, snr_db: float = 15.0):
        super().__init__()
        self.T, self.n_pkts = T, n_pkts
        self.n_pkt = get_packet_sizes(psdef).N_samples_packet
        self.noise_var = float(np.float32(10.0 ** (-snr_db / 10.0)))
        self.tx = build_tx(psdef, network_id, 1)
        self.sync = build_sync(psdef.u, psdef.b, T, max_peaks=n_pkts)
        self.rxs = build_rx_stream(psdef, network_id, 1, T)

    def stream(self, plcf_bits, tb_bits, offsets):
        """TX + scatter: -> stream complex64 [B, N_TX, T]."""
        B = plcf_bits.shape[0]
        flags = torch.zeros((B,), dtype=torch.bool, device=plcf_bits.device)
        iq = self.tx(plcf_bits, tb_bits, flags, flags)           # [B,NTX,n_pkt]
        n_tx = iq.shape[1]
        out = torch.zeros((B, n_tx, self.T, 2), dtype=torch.float32,
                          device=iq.device)
        ar = torch.arange(self.n_pkt, device=iq.device)
        src = torch.view_as_real(iq)
        for k in range(self.n_pkts):
            idx = (offsets[:, k, None] + ar)[:, None, :, None].expand(B, n_tx, -1, 2)
            out.scatter_add_(2, idx, src)
        return torch.view_as_complex(out)

    def awgn(self, stream, generator):
        return awgn(stream, self.noise_var, generator)

    def receive(self, y):
        """sync + per-packet stream RX -> (tb_ok, detected, t_fine), [B, n_pkts]."""
        rep = self.sync(y)
        tf, cf, det = rep["t_fine"], rep["cfo"], rep["detected"]
        if self.n_pkts == 1:
            tf, cf, det = tf[:, None], cf[:, None], det[:, None]
        oks = [self.rxs(y, tf[:, k], cf[:, k], self.noise_var)["tb_ok"]
               for k in range(self.n_pkts)]
        return torch.stack(oks, -1), det, tf

    def forward(self, plcf_bits, tb_bits, offsets, generator):
        return self.receive(self.awgn(self.stream(plcf_bits, tb_bits, offsets),
                                      generator))


def make_flagship_step(psdef: PacketSizesDef = FLAGSHIP_PSDEF,
                       T: int | None = None, n_pkts: int = 2,
                       network_id: int = NETWORK_ID,
                       snr_db: float = 15.0) -> FlagshipStep:
    """The bench's stream step for one configuration; T defaults to the
    bench's stream length (4 packet lengths + 8192)."""
    return FlagshipStep(psdef, stream_len(psdef) if T is None else T, n_pkts,
                        network_id, snr_db)
