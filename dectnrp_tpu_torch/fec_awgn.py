"""FEC AWGN oracle with HARQ retransmissions, on the port (port of
tools/run_fec_awgn.py; reference analog lib/src/phy/fec/test/tb2pdc_awgn.cpp:39-56).

MCS 0..9 x SNR -15..25 dB (2 dB step) x HARQ retx 0..3 (rv sequence 0,2,3,1,
tb2pdc_awgn.cpp:216-228) x N packets, psdef (1, 1, 0, 4, 0, mcs, 6144): one
codeblock per TB, K = 424 (MCS 0, unwindowed BCJR in plain torch) and
848 ... 5632 (MCS 1-9, windowed: the BCJR kernel on the card). Per
transmission: TB -> pdc_encode(rv) -> MCS constellation map -> complex AWGN
-> soft demap -> d-domain de-rate-match and add into the HARQ softbuffer
(`HarqProcessRx.combine`) -> turbo decode (CRC early stop, 8 iterations at
most) -> TB CRC. Measures uncoded BER (hard decisions on the coded bits of
all transmissions) and PER after each cumulative retransmission.

    python -m dectnrp_tpu_torch.fec_awgn [--n 50] [--mcs-min 0] [--mcs-max 9]
        [--snr -15 25 2] [--retx 3] [--out DIR] [--device cuda]
        [--ref results/fec_awgn]

Writes DIR/fec_awgn_MCS_<mm>.json in the schema of results/fec_awgn/ and
DIR/meta.json; "platform" names the card (or "cpu"). With --ref, the
sweep's curves are then compared with the curves there (`compare_curves`),
printed and written to DIR/compare.json. Noise comes from a
torch.Generator on the device, seeded per (MCS, SNR point); TBs from numpy,
seeded per MCS, as the JAX tool draws them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .phy.fec.chain import PdcPlan, pdc_encode
from .phy.harq import FinalizeRx, HarqProcessPool
from .phy.modulation import demap_llr, map_bits
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes

RV_SEQ = (0, 2, 3, 1)          # tb2pdc_awgn.cpp:216-228
NID = 123456789                # tb2pdc_awgn.cpp network_id
N_ITER = 8                     # pdc_decode_d's default, as the JAX tool runs it


def fec_psdef(mcs: int) -> PacketSizesDef:
    """The oracle's packet configuration at one MCS."""
    return PacketSizesDef(1, 1, 0, 4, 0, mcs, 6144)


def codeblock_K(mcs: int) -> int:
    """The oracle's codeblock size at one MCS: one codeblock a transport
    block, TB bits plus the CRC24, rounded up to a QPP size."""
    ps = get_packet_sizes(fec_psdef(mcs))
    K, = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, fec_psdef(mcs).Z).cb_K
    return K


def noise_scale(snr_db: float) -> tuple[float, float]:
    """(noise variance, per-component noise amplitude sqrt(nv / 2)), both
    rounded to float32 as the JAX tool computes them."""
    nv = np.float32(10.0 ** (-snr_db / 10.0))
    return float(nv), float(np.sqrt(nv / np.float32(2.0)))


class FecAwgnStep:
    """One SNR point of the oracle for one packet configuration.

    step(tb [B, N_TB] uint8, snr_db, gen=None, noise=None) ->
    (tb_ok bool [B, n_retx_max+1], uncoded bit errors int64 [],
    softbuffer after the first transmission {K: [B, 3, K+4]}).
    `noise` (a unit-variance complex64 tensor [B, G / N_bps] per
    transmission, real and imaginary parts each N(0, 1)) replaces the draws
    from `gen`.
    """

    def __init__(self, psdef: PacketSizesDef, n_retx_max: int,
                 device: torch.device | str = "cuda"):
        self.psdef, self.n_retx = psdef, n_retx_max
        self.ps = get_packet_sizes(psdef)
        self.plan = PdcPlan.get(self.ps.N_TB_bits, self.ps.G,
                                self.ps.mcs.N_bps, psdef.Z)
        self.n_bps = self.ps.mcs.N_bps
        self.device = torch.device(device)
        self.pool = HarqProcessPool(n_tx=0, n_rx=1)

    def __call__(self, tb: torch.Tensor, snr_db: float,
                 gen: torch.Generator | None = None, noise=None):
        nv, amp = noise_scale(snr_db)
        shape = (tb.shape[0], self.ps.G // self.n_bps)
        errs = torch.zeros((), dtype=torch.int64, device=self.device)
        oks, first, proc = [], None, None
        for t, rv in enumerate(RV_SEQ[:self.n_retx + 1]):
            fin = (FinalizeRx.RESET_AND_TERMINATE if t == self.n_retx
                   else FinalizeRx.KEEP_FOR_RETRANSMISSION)
            proc = (self.pool.get_process_rx(1, NID, self.psdef, rv, fin)
                    if t == 0 else self.pool.get_process_rx_running(proc.id, rv, fin))
            e = pdc_encode(tb, self.plan, NID, 1, rv=rv)            # [B, G]
            sym = map_bits(e, self.n_bps)                           # [B, G/n_bps]
            n = noise[t] if noise is not None else torch.complex(
                torch.randn(shape, generator=gen, device=self.device),
                torch.randn(shape, generator=gen, device=self.device))
            llr = demap_llr(sym + amp * n, torch.ones_like(sym.real),
                            self.n_bps, nv)                         # [B, G]
            errs = errs + ((llr > 0).to(torch.uint8) != e).sum()
            _, ok = proc.combine(llr, n_iter=N_ITER)
            if t == 0:
                first = proc.softbuffer
            oks.append(ok)
            proc.finalize_now()
        return torch.stack(oks, -1), errs, first


def build_fec_awgn_step(psdef: PacketSizesDef, n_retx_max: int,
                        device: torch.device | str = "cuda") -> FecAwgnStep:
    """The oracle's step for one configuration (run_fec_awgn._build_step)."""
    return FecAwgnStep(psdef, n_retx_max, device)


def sweep(mcs: int, snrs, n: int, n_retx: int,
          device: torch.device | str = "cuda", on_point=None) -> dict:
    """One MCS over `snrs`: the JSON record of results/fec_awgn/.

    on_point(i, snr, softbuffer0), if given, sees each point's softbuffer
    after its first transmission.
    """
    dev = torch.device(device)
    step = build_fec_awgn_step(fec_psdef(mcs), n_retx, dev)
    ps = step.ps
    rng = np.random.default_rng(1234 + mcs)
    ber, per = [], [[] for _ in range(n_retx + 1)]
    t0 = time.perf_counter()
    for i, snr in enumerate(snrs):
        tb = torch.as_tensor(rng.integers(0, 2, (n, ps.N_TB_bits)),
                             dtype=torch.uint8, device=dev)
        gen = torch.Generator(device=dev).manual_seed(100 * mcs + i)
        oks, errs, soft0 = step(tb, float(snr), gen)
        if on_point is not None:
            on_point(i, float(snr), soft0)
        oks = oks.cpu().numpy()
        ber.append(int(errs) / (ps.G * n * (n_retx + 1)))
        for t in range(n_retx + 1):
            per[t].append(1.0 - float(oks[:, t].mean()))
    return {
        "experiment_range": {"snr_vec": [float(s) for s in snrs],
                             "nof_packets_per_snr": n,
                             "rv_sequence": list(RV_SEQ[:n_retx + 1])},
        "parameter": {"mcs": mcs, "N_TB_bits": ps.N_TB_bits, "G": ps.G,
                      "N_bps": ps.mcs.N_bps, "psdef": "u=1 b=1 type0 len4"},
        "result": {"BER_uncoded_vec": ber,
                   **{f"PER_retx{t}": per[t] for t in range(n_retx + 1)}},
        "platform": platform(dev),
        "wall_s": time.perf_counter() - t0,
    }


def platform(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def first_below(snrs, per, limit=0.1):
    """The first SNR whose PER is at most `limit` (None if none is)."""
    return next((s for s, p in zip(snrs, per) if p <= limit), None)


def compare_curves(out_dir, ref_dir, mcs_range=range(10)) -> dict:
    """Per MCS: the first SNR with PER <= 0.1 after each retransmission,
    here and in the reference, and the uncoded BER's largest gap from the
    reference in standard deviations of the difference of two binomial
    estimates, sqrt(p (1 - p) (1/n_here + 1/n_ref)) at the pooled p, over
    the SNR points where the reference BER exceeds 1e-3."""
    out = {}
    for mcs in mcs_range:
        recs = []
        for d in (out_dir, ref_dir):
            path = os.path.join(d, f"fec_awgn_MCS_{mcs:02d}.json")
            if not os.path.exists(path):
                break
            with open(path) as f:
                recs.append(json.load(f))
        if len(recs) < 2:
            continue
        got, ref = recs
        snrs = got["experiment_range"]["snr_vec"]
        if snrs != ref["experiment_range"]["snr_vec"]:
            raise ValueError(f"MCS {mcs}: the SNR points differ from the reference's")
        n_retx = len(got["experiment_range"]["rv_sequence"])
        thr = {}
        for t in range(n_retx):
            a = first_below(snrs, got["result"][f"PER_retx{t}"])
            b = first_below(snrs, ref["result"][f"PER_retx{t}"])
            thr[t] = {"port": a, "ref": b,
                      "diff_db": None if a is None or b is None else a - b}
        nbits = [r["parameter"]["G"] * r["experiment_range"]["nof_packets_per_snr"]
                 * len(r["experiment_range"]["rv_sequence"]) for r in recs]
        z = []
        for s, pg, pr in zip(snrs, got["result"]["BER_uncoded_vec"],
                             ref["result"]["BER_uncoded_vec"]):
            if pr > 1e-3:
                p = (pg * nbits[0] + pr * nbits[1]) / sum(nbits)
                z.append((s, (pg - pr) / np.sqrt(p * (1 - p) * (1 / nbits[0]
                                                             + 1 / nbits[1]))))
        out[mcs] = {"first_snr_per_le_0.1": thr,
                    "ber_z": z, "max_abs_ber_z": max(abs(v) for _, v in z)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--mcs-min", type=int, default=0)
    ap.add_argument("--mcs-max", type=int, default=9)
    ap.add_argument("--snr", type=float, nargs=3, default=(-15.0, 25.0, 2.0),
                    metavar=("MIN", "MAX", "STEP"))
    ap.add_argument("--retx", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/fec_awgn")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ref", default=None,
                    help="compare the sweep with the curves in this directory")
    args = ap.parse_args(argv)
    run_sweep(args)
    if args.ref:
        cmp = compare_curves(args.out, args.ref,
                             range(args.mcs_min, args.mcs_max + 1))
        with open(os.path.join(args.out, "compare.json"), "w") as f:
            json.dump(cmp, f, indent=1)
        for mcs, c in cmp.items():
            thr = c["first_snr_per_le_0.1"]
            print(f"mcs {mcs}: first SNR with PER <= 0.1 (here / ref, dB) "
                  + ", ".join(f"retx{t} {v['port']} / {v['ref']}"
                              for t, v in thr.items())
                  + f"; uncoded BER max |z| {c['max_abs_ber_z']:.2f}", flush=True)


def run_sweep(args) -> None:
    """The sweep of `main`: one record per MCS and meta.json in args.out."""
    dev = torch.device(args.device)
    snrs = np.arange(args.snr[0], args.snr[1] + 1e-9, args.snr[2])
    os.makedirs(args.out, exist_ok=True)
    t00 = time.perf_counter()
    for mcs in range(args.mcs_min, args.mcs_max + 1):
        if get_packet_sizes(fec_psdef(mcs)) is None:
            continue
        rec = sweep(mcs, snrs, args.n, args.retx, dev)
        with open(os.path.join(args.out, f"fec_awgn_MCS_{mcs:02d}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        res = rec["result"]
        mid = len(snrs) // 2
        print(f"mcs {mcs}: BER@{snrs[mid]:g}dB={res['BER_uncoded_vec'][mid]:.4f} "
              f"PER_retx0 {res['PER_retx0'][mid]:.2f} -> retx{args.retx} "
              f"{res[f'PER_retx{args.retx}'][mid]:.2f} ({rec['wall_s']:.1f} s)",
              flush=True)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"platform": platform(dev),
                   "total_wall_s": time.perf_counter() - t00}, f, indent=1)


if __name__ == "__main__":
    main()
