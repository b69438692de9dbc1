"""Drive the PyTorch + CUDA port's main paths once on one GPU.

    python3 chip_smoke.py

Nine main paths, each driven once through its entry points with every
kernel's launch count set to 0 just before it (and before each part of
phy_options, multichip and multiprocess) and read just after:
  flagship  make_flagship_step: u=1 b=16 SISO MCS4, B = 64 streams of
            T = 192,512 samples, 2 packets each, 15 dB, no resampler;
  wall      make_wall_step: u=1 b=8, N_TX = 4 Alamouti transmit diversity,
            MCS2, the 10/9 resampler in both directions (15.36 Ms/s radio
            rate), B = 16 streams of 85,900 radio-rate samples, 1 packet
            each, 20 dB;
  fec_awgn  the FEC AWGN oracle (fec_awgn.sweep): psdef (1, 1, 0, 4, 0,
            mcs, 6144) for MCS 0-9, 50 packets a point, HARQ rv 0,2,3,1
            combined in HarqProcessRx, at 3 SNR points per MCS (w - 4, w,
            w + 2 dB around the committed retx-0 waterfall w; cut in depth
            from the oracle's 21 points), plus the bf16 and float32 kernel
            decodes of each point's first-transmission softbuffers;
  loopback_snr  the link-level loopback sweep (upper.loopback.
            LoopbackSnrExperiment, as python -m dectnrp_tpu_torch.loopback_snr
            runs it): its eight variants (sync, aligned, fading,
            fading_aligned, fading_genie, resampled, mimo, mimo_fading) over
            each variant's MCS at 500 packets a point, the committed sweep's
            width, and 3 SNR points each (w - 4, w, w + 2 dB around the
            committed curve's first PER_pdc_crc <= 0.1, or its three
            lowest-PER points where it never reaches 0.1; cut in depth from
            851 points to 129);
  runtime   the node runtime and the scenario runner (python -m
            dectnrp_tpu_torch.apps.dectnrp_main <dir> --ticks N, through
            apps.dectnrp_main.run) over the committed simulator
            configurations, not cut: u = 1, b = 1, 1.728 Ms/s, spp 2048,
            1 Mi-sample RX rings; basic_simulator 40 ticks, rtt_simulator
            40 ticks with 3 datagrams echoed over the air, p2p_simulator 120
            ticks, loopback_simulator 4 ticks (its firmware's PER sweep: MCS
            1, 2 at 0, 10, 20 dB, 20 packets); then the exchanges of
            tools/run_tpu_runtime_check.py rebuilt on the port
            (runtime_check): 4 beacons between two nodes at 1.728 Ms/s and
            at 1.92 Ms/s (the 9/10 front end and the 10/9 TX resampler in
            the loop), and 2 beacons of the 2 x 2 N_SS = 2 exchange;
  iq_ingress  the same runtime over the real-IQ radios (radio/hw_iq.py,
            the native host runtime common/native.py built with g++) at
            configurations/socket_radio's sizes, not cut: 1.92 Ms/s, spp
            2048, a 1 Mi-sample ring, u = 1, b = 1, 1 antenna (4 on the
            UDP egress): a cf32 file read free-running, socket_radio
            through apps.dectnrp_main.run, the paced UDP egress looped into
            the ingress, and apps.rtt through the application layer;
  phy_options  the builder options the port took last
            (dectnrp_tpu_torch/options_check.py) at the flagship's width,
            (1, 16, 1, 4, 0, 4, 6144) and B = 64 packets, not cut in width:
            TX windowing, beamforming over every codebook entry of tm 3,
            beta / integer-CFO estimation and the RMS gate on [64, 1,
            192,512] streams, every chestim option through build_rx_stream
            (16 fading packets, 2 of them also on the CPU: cut in depth),
            the MMIE round trip.
  multichip  the multi-device code (common/mesh.py, phy/sync_sharded.py,
            vspace.tick_sharded, multichip.dryrun_multichip) on ONE card
            listed 8 times in the mesh (one process, every shard on
            cuda:0; the count of distinct cards, 1, is printed): the
            time-sharded sync at the flagship's numerology, u = 1, b = 16,
            [1, 2,097,152] (75.9 ms of 27.648 Ms/s radio time) in 64 chunks
            of 32,768 over 8 shards, and at b = 1 in 64 chunks of 8,192
            (SCALING_r04's chunk); the node-sharded tick at 8 nodes x 4
            antennas x spp 2,048 over 4 shards; the dry run on 4 nodes x 2
            dp (its own sizes, not cut);
  multiprocess  the multi-process code (common/dist.py, the process-
            spanning mesh of common/mesh.py, dcn_dryrun.py, scaling.py):
            two spawned processes joined by gloo (a FileStore), each
            holding the one card as its shards: the node-sharded tick at
            N = 4, A = 1, spp 2,048 over 2 x 2 shards, four channels of
            (1, 1, 0, 2, 0, 2) at 15 dB one a shard, and the time-sharded
            sync at the flagship's numerology, [1, 2,097,152] in 64 chunks
            of 32,768 over 2 x 4 shards (windows [8, 1, 39,936]), 4
            flagship packets at 15 dB; then scaling in this process at its
            full sizes (the sync at u = b = 1, chunk 8,192, 32 chunks
            strong and 4 a shard weak, the tick at N = 8, spp 4,096, over
            1, 2, 4, 8 shards of the card). Not cut.

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc-builds the kernels of dectnrp_tpu_torch/csrc for sm_90a,
     one nvcc per source, all at once; registers a thread (ptxas log) and
     blocks an SM of the bf16 BCJR, sync and polyphase kernels;
  3. BCJR kernel vs its plain twin at every K of both paths, on 64
     codeblocks, on as many as a step decodes in one call and on the
     oracle's ragged 50, at rtol 1e-4, atol 1e-3 (the report
     states the measured max |err|, 0 when bit-identical); the kernel run
     as ONE window (Lw = K+3, D = 0), as every unwindowed decode on the
     card calls it: K = 56 and 96 (the PCC) x 64 rows (a flagship RX call),
     x 16 (wall), x 128, x 50 and x 3 (ragged), and K = 424 x 50 (the
     oracle's MCS 0), each equal bit for bit to its plain twin AND to the
     unwindowed turbo._bcjr_posterior on the same card tensors; and a
     turbo_decode_early round trip of 64 CRC-carrying codeblocks per K that
     must return the sent bits;
  3b. bf16 BCJR kernel vs its plain twin, bit for bit (max |err| 0), at
     every shape bcjr_bf16_turns.SHAPES lists: K = 1056/5632/6016/6080 x 64,
     the flagship's K = 6016 x 832 and 6080 x 192 and the FEC oracle's ten
     first-transmission decodes (K from fec_awgn.codeblock_K x 50, window
     128); turbo_decode(impl="cuda_bf16") at
     K = 6144 x 4 returns the sent bits from clean +-4 LLRs (2 iterations)
     and the float32 kernel's bits at sigma 1.0 (4 iterations);
  4. sync-detection kernel vs its plain twin at the flagship shape (b = 16),
     at b = 1, at the wall shape (b = 8, 4 RX rows), at the bench's u8b16
     cell (u = 8, b = 16, B = 128 streams of 192,512 samples carrying STFs)
     and at the runtime's chunk (u = 1, b = 1, 2048 + 4 N_STF samples,
     max_peaks 4): sm within rtol 2e-3 / atol 2e-4 away from gate ties, and
     the sync reports' t_fine, detected and n_eff_tx equal (with max_peaks
     4, t_fine and n_eff_tx where a peak is detected); and vs its tiled twin
     (the kernel's own decomposition) at rtol 1e-5 / atol 1e-6, the
     measured max |err| reported, and bit for bit at the flagship, wall,
     u8b16 and runtime shapes (the RMS gate skipped at rms_min = 0);
  5. polyphase kernel vs its plain twin at the wall step's shapes (10/9 on
     [16, 4, 23,040], 9/10 on [16, 4, 85,900]), at 40/27 and at a ragged
     9/10 length, rtol 2e-5 / atol 2e-5; a 3-chunk streaming chain equal to
     the one-shot resampler on the lag-prefixed input; each of these calls,
     the chain's too, vs the tiled twin (the kernel's own blocks, tiles and
     fma order) at the same tolerance, its bit-equal share reported;
  6. small steps on the card equal the same steps on the CPU (plain twins):
     flagship-shaped (u=1 b=1 SISO) and wall-shaped (u=1 b=1 N_TX = 4 with
     the resampler); then the flagship and the wall step, each with
     decode_ok >= 0.95, detected >= 0.95 and its kernels launched in the
     step: the BCJR as one window exactly packets x 2 PLCF types x 2
     constituent decoders x the RX's n_iter times (the blind PCC decode),
     windowed at least 2 x 2 times per codeblock size (the PDC decode's two
     iterations before its first CRC check) and at most 2 x n_iter times,
     sync once, polyphase twice on the wall and never on the flagship,
     bcjr_bf16 in neither;
  6b. the FEC oracle path: PER_retx0 <= 0.1 at w + 2, PER_retx3 <= 0.1 at
     w - 4, PER never rising from one retransmission to the next; the
     first-transmission softbuffers decoded by turbo_decode_early with
     impl "cuda" and "cuda_bf16" (window 128, 8 iterations at most) give
     the same crc_ok packet for packet at w - 4 and w + 2 (the
     disagreements at w are recorded; their time, kernel_decode_s, is
     reported per MCS); both kernels launched on the path;
  6c. the loopback sweep: first one point per variant (MCS 2 at the
     committed threshold, 8 packets) on the card and on the CPU on the same
     inputs and draws, with equal detected / plcf_ok / tb_ok and equal TB
     bits where the CRC holds; then the loopback_snr path, each point's
     PER_pdc_crc within 4 two-binomial standard deviations (pooled PER,
     500 packets on both sides) + 0.01 of the committed curve's, and per
     variant: the BCJR launched as one window and windowed, sync once a
     point in the synced variants and never in the aligned ones, polyphase
     twice a point in `resampled` and never elsewhere, bcjr_bf16 never;
     the path's seconds and each variant's median point time;
  6d. the runtime path: rtt_simulator returns every datagram without a
     PDC error, the p2p PT is ASSOCIATED after >= 2 beacons,
     loopback_simulator's PER records are 0 at 20 dB, every exchange decodes
     every beacon with its payload with no TX late (and reads n_ss = 2 from
     the PLCF in the 2 x 2 exchange); per run: sync launched once a chunk
     (and once a loopback point), the BCJR as one window (windowed only at
     the 2 x 2 exchange's PDC, K = 880), polyphase once a front-end step
     and a resampled TX burst in the 1.92 Ms/s exchange and never
     elsewhere, bcjr_bf16 never; each run's ticks, median host ms a tick
     and realtime multiple (spp / radio rate / tick time); then the
     DECT-rate exchange on the card and on the CPU with the same vspace
     draws: equal RuntimeStats, detection times and TBs;
  6e. the iq_ingress path (phase_iq): (a) three packets (1, 1, 0, 2, 0, 2)
     at 25 dB in a cf32 file read free-running: 3 of 3 TBs, 0 overruns,
     the whole file delivered, RuntimeStats, detection times and TBs equal
     to a CPU run on the same file, B2 once a chunk, B3 once a front-end
     step and a TX burst, B1 as one window only, B4 never; (b)
     socket_radio (a copy on a free UDP port), 24 ticks: >= 40,000 samples
     back on the RX ring, chunks synced, 0 malformed; (c) three bursts
     through the paced egress looped into the ingress: 0 malformed, late
     or unsent (TBs decoded, overruns and seconds recorded, not gated:
     they depend on the runtime's speed), and on 4 antennas the bursts
     back bit for bit; (d) apps.rtt -> SocketServer -> TfwRtt over the
     ether on the card -> echo -> SocketClient: >= 1 of 2 back;
  6f. the phy_options path (phase_options): (a) window fractions 0.25
     and 0.5, aligned RX at 30 dB: 64/64 TBs, in-band power within 2 % of
     the unwindowed TX, the skirt > 1 dB lower and lower again at 0.5; (b)
     tm 3 with codebook entries 0-5 through one numpy flat 2 x 1 channel
     (|h|^2 = 2) at 20 dB: 64/64 on the entries above the median gain, and
     phy/mimo.py's search on tm 1 soundings of the channel picking entries
     at or above it; (c) est_beta_icfo: the flagship's packets beta 16 /
     cfo_int 0, b = 4 packets upsampled x4 (prepared before the count)
     with integer CFO 0, +2, -1: beta 4, the shifts from their true STF
     start; rms_min between the noise's and the packets' RMS detects as
     the ungated sync, above the packets' RMS nothing; B2 exactly 4
     launches; (d) lr_f, freq_kind linear, time_kind wiener, dd_passes 2,
     est_sto off, est_cfo off through build_rx_stream: decode_ok >= 0.95 at
     20 dB (B2 once a sync), tb_ok over the loopback's doubly-selective
     channel recorded, and on 2 fading streams the card deciding as the
     CPU; (e) loopback_mmie_roundtrip: the three MMIEs back. B1 in (a),
     (b), (d), (e); B3 and B4 never;
  6g. the multichip path (phase_multichip): (a) the sharded sync finds
     exactly the four packets sent (mid-shard, straddling a chunk
     boundary, straddling the shard boundary chunk 7 -> 8, in the last
     shard; +-2 samples), its report is bit for bit the dense search (all
     64 windows in one Sync call on the card, masked the same way) and
     equal to a CPU run of the port (detected; t_global, n_eff_tx where
     detected; cfo within 1e-5), B2 exactly 8 launches (one a shard),
     at b = 16 (threshold 0.25) and at b = 1 (threshold 0.35, its hits
     at 0.25 recorded); (b) tick_sharded equals the dense awgn tick on the
     same draws within 1e-5, no kernel; (c) dryrun_multichip: every phase-1
     TB and PLCF, every phase-2 packet found (+-2) and decoded (false
     alarms recorded), B1 in both phases, B2 8 in phase 2, B3 and B4
     never;
  6h. the multiprocess path (phase_multiprocess): dcn_dryrun over gloo,
     two processes on the card: (a) every shard within 0.02 of the host
     superposition and bit for bit the one-process tick; (b) 4/4 TBs in
     each process; (c) the report gathered on rank 0 finds the 4 packets
     (+-2) and is bit for bit the one-process 8-shard and dense searches;
     each child's launches: none in (a), B1 in (b), B2 once a shard (4) in
     (c), B3 and B4 never; then scaling, every row held to the dense
     output before it is timed, its held sharded call's launches counted
     (B2 once a shard in the sync rows, none in the tick rows); each
     process's host ms of the spanning search beside the one-process and
     dense calls;
  7. times with CUDA events / synchronized host clocks: each step's median
     over 5 steps, its realtime multiple B*T / step time / radio rate,
     per-stage times, and each kernel next to its plain twin, its bound on
     the card and, where one PyTorch call computes the same function, that
     call (conv1d for the polyphase FIR). The BCJR calls (float32 and
     bf16 at K = 6016 x 832, in turns on the same inputs; the bf16 kernel
     at every shape of phase 3b, each in turns with the float32 kernel
     (bf16, f32, bf16, f32) beside its bound; the float32 kernel as one
     window at the PCC's and the oracle's shapes beside
     turbo._bcjr_posterior) and the sync and polyphase calls, tens to
     hundreds of microseconds, by CUDA events around CUDA-graph replays (no
     host launch gaps), and eagerly; the sync kernel at all four shapes it
     serves on a path or a cell (flagship, wall, u8b16, the runtime's chunk
     at B = 1), each beside its bound and plain twin, with its registers
     (from the ptxas log) and blocks per SM; the polyphase kernel at the
     wall's two calls, 80/27 up and 27/80 down on 64 rows of a wall-length
     input, and the runtime's RX chunk (27/80, 2 rows), each beside conv1d,
     its plain twin and its bound;
  7b. the kernels at the loopback path's shapes, each held to its plain
     twin on the same card inputs, then timed beside it and its bound: B1
     as one window at K = 56 / 96 (PCC) and 320 / 480 (PDC) x 500 rows, bit
     for bit its plain twin and turbo._bcjr_posterior, and windowed at
     every other PDC K of the path (576, 640, 880, 960, 1152, 1280, 1440,
     1760) x 500 codeblocks, bit for bit its plain twin, each through the
     decoder's own route; B2 at b = 1 on the streams the sync of one `sync`
     point [500, 1, 2048] and one `mimo` point [500, 2, 2048] is handed (as
     phase 4 checks it); B3 on the inputs of one `resampled` point, 10/9
     [500, 1, 720] and 9/10 [500, 1, 800], bit for bit its tiled twin and
     at rtol 2e-5 / atol 2e-5 its plain twin, beside conv1d;
  7c. the kernels on the inputs the runtime path handed them (caught while
     it ran), each held to its plain twin, then timed beside it and its
     bound: B1 at every (K, rows) decoded (one window below K = 512, bit for
     bit its plain twin and turbo._bcjr_posterior; windowed at K = 880),
     B2 on a sync chunk [1, R, 2,496] at R = 1 and 2, B3 on the 10/9 TX
     burst and the 9/10 front-end step (history + 1,280 radio samples), bit
     for bit its tiled twin and at rtol 2e-5 / atol 2e-5 its plain twin;
  7d. a runtime tick's host time by layer: one exchange at each rate with
     every stage synchronized and timed (vspace tick, the 9/10 front end,
     sync, the PCC and PDC stages, TX, firmware; the rest is the runtime's
     own host logic);
  7e. the kernels on the inputs the iq_ingress path handed them, as 7c:
     B1 one window at the PCC's and the PDCs' K on 1 row, B2 on a sync
     chunk [1, 1, 2,496], B3 on the 9/10 front-end step and the 10/9 TX
     burst;
  7f. the kernels on the inputs the phy_options path handed them: B1 at
     every (K, rows) caught (one window at the PCC's and the MMIE packet's
     K, windowed at the flagship's PDC), bit for bit its plain twin; B2 on
     the [64, 1, 192,512] streams of (c) with the RMS gate off and on, held
     to its plain twin off gate ties and to its tiled twin, each timed by
     graph replay in turns (off, on, on, off) beside its plain twin and
     bound;
  7g. the kernels on the inputs the multichip path handed them: B2 on a
     shard's windows at b = 16 [8, 1, 39,936] and b = 1 [8, 1, 8,640],
     held to its plain twin off gate ties and to its tiled twin, timed by
     graph replay beside its plain twin and bound; B1 at every (K, rows)
     the dry run decoded (one window), bit for bit its plain twin; the
     b = 16 sharded search's host ms at 1, 2, 4 and 8 shards of the card
     beside the dense single call (recorded, not gated: on one card a
     split adds host work and no speed);
  7h. the kernels on the multiprocess path's inputs, rebuilt in this
     process from the children's seeds: B2 on rank 0's first shard's
     windows of (c) [8, 1, 39,936], B1 on every (K, rows) of (b)'s four
     channel steps (one window), each held to its twins, then timed as 7g;
  8. torch.profiler (device activity only) over one flagship and one wall
     step, one loopback point of `sync` and of `mimo_fading` (MCS 2 at
     the committed threshold, 500 packets) and one runtime exchange at each
     rate: device kernels launched, their busy time and the device's idle
     share under the profiler, the top kernels by time. Details go to
     chiprun_out/profile_{flagship,wall,loopback,runtime}.json.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
B_FLAG, N_PKTS, SNR_DB = 64, 2, 15.0
B_WALL, SNR_WALL = 16, 20.0
# published NVIDIA H100 SXM peaks at 700 W: HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
# bf16 outside the tensor cores: twice the fp32 rate through bf16x2
# instructions (NVIDIA H100 Tensor Core GPU Architecture white paper, peak
# BF16 non-tensor 133.8 TFLOP/s on the SXM part)
PEAK_BF16X2 = 2 * PEAK_FP32
FEC_N, FEC_SNR_OFFSETS = 50, (-4.0, 0.0, 2.0)
# the loopback sweep's width (results/loopback_snr/meta.json: 500 packets a
# point), its committed curves and the per-point gate: |PER - committed| <=
# LB_SIGMAS two-binomial standard deviations at the pooled PER, + 0.01
LB_N, LB_SIGMAS = 500, 4.0
LB_REF = ROOT / "results/loopback_snr"
POLY_TOL = dict(rtol=2e-5, atol=2e-5)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAIL: {msg}")


def cuda_ms(fn, reps=10, warm=2):
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn):
    """Host time of fn() between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def bound(nbytes, ops, peak_ops=PEAK_FP32):
    """(least time in ms on the card, "bytes" or "operations"): compulsory
    bytes over the HBM rate vs operations over their peak rate (float32
    outside the tensor cores unless `peak_ops` says otherwise)."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ptxas_regs(log, kernel):
    """{(template arguments): registers a thread} of each instance of
    `kernel` in nvcc's -Xptxas -v log (instances templated on ints; () for
    a kernel that is not a template)."""
    found = re.findall(
        rf"Compiling entry function '[^']*{kernel}(?:I((?:Li\d+E)+)E)?[^']*'.*?"
        r"Used (\d+) registers", log, flags=re.S)
    return {tuple(int(a) for a in re.findall(r"Li(\d+)E", args)): int(n)
            for args, n in found}


def bcjr_work(K, n_cb, windowed=True):
    """(bytes, ops) of one max-log-MAP call: Lsys and Lp read once, the
    posterior written once; per trellis step and codeblock 3 ops of branch
    metrics, 39 forward (16 adds, 8 maxes, renormalization 7 maxes + 8
    subs), 39 backward, 47 posterior (32 adds, 2 x 7 maxes, 1 sub), and,
    when windowed, 21 for the D = 32 acquisition steps on each side of
    every Lw = 128 window (2 x 42 x 32 / 128); a single window over the
    whole trellis runs none."""
    return ((2 * (K + 3) + K) * n_cb * 4,
            (149 if windowed else 128) * (K + 3) * n_cb)


def sync_work(B, R, T, P, n_pat):
    """(bytes, ops) of the detection metric: x read once, sm written once;
    per output sample and antenna 12 ops for the lag product, power and
    their prefix sums, 6 per pattern lag for C, 2 for P2; per output 8 for
    the gated metric and 3 for the box smoothing."""
    n_t = T - (n_pat + 1) * P
    return (B * R * T * 8 + B * n_t * 4,
            B * n_t * (R * (14 + 6 * (n_pat - 1)) + 11))


def poly_work(G, L, rows, n_in, n_out):
    """(bytes, ops) of one resampler FIR call: x read once, y written once,
    the taps once; 4 flops per nonzero tap of each output's phase."""
    G = G.cpu().numpy()
    nnz = (G != 0).sum(1)
    per_row = (n_out // L) * int(nnz.sum()) + int(nnz[:n_out % L].sum())
    return rows * (n_in + n_out) * 8 + G.size * 4, 4 * rows * per_row


def counts():
    from dectnrp_tpu_torch.kernels import LAUNCH_KEYS, launch_counts
    c = launch_counts()
    return {k: c[k] for k in LAUNCH_KEYS}


def launched_since(c0):
    """Launches of each kernel since counts() returned c0."""
    return {k: v - c0[k] for k, v in counts().items()}


def zero_counts():
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect
    bcjr_cuda.launches = bcjr_cuda.launches_one_window = 0
    bcjr_cuda.launches_bf16 = 0
    sync_detect.launches = polyphase.launches = 0


def bcjr_llrs(K, Bc, g, dev):
    """Random column-major (Lsys with a-priori, Lp) [K+3, Bc] on `dev`."""
    Lp = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
    Lsys = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
    Lsys[:K] += torch.randn((K, Bc), generator=g, device=dev)
    return Lsys, Lp


def phase_bcjr_one_window(dev, report, shapes):
    """The kernel as one window (Lw = K+3, D = 0) at `shapes` [(K, rows)]:
    bit-equal to its plain twin and to the unwindowed plain BCJR."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior, _resolve_bcjr

    res = {}
    for K, Bc in shapes:
        kind, route = _resolve_bcjr(K, None, "auto", dev)
        require(kind == "cm" and route.func is bcjr_cuda.bcjr_posterior_cm
                and route.keywords == {"K": K, "Lw": K + 3, "D": 0},
                f"one-window BCJR K={K}: the decoder does not take the kernel")
        Lsys, Lp = bcjr_llrs(K, Bc, torch.Generator(device=dev).manual_seed(K + Bc),
                             dev)
        n1 = bcjr_cuda.launches_one_window
        got = route(Lsys, Lp)
        require(bcjr_cuda.launches_one_window == n1 + 1,
                f"one-window BCJR K={K} x {Bc}: launch not counted")
        twin = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, K + 3, 0)
        # the row-major unwindowed BCJR; the a-priori is inside Lsys already
        unw = _bcjr_posterior(Lsys.T.contiguous(), Lp.T.contiguous(),
                              torch.zeros((Bc, K), device=dev), K).T
        torch.cuda.synchronize()
        require(torch.isfinite(got).all(),
                f"one-window BCJR K={K} x {Bc}: non-finite output")
        e_twin = (got - twin).abs().max().item()
        e_unw = (got - unw).abs().max().item()
        require(torch.equal(got, twin), f"one-window BCJR K={K} x {Bc}: kernel vs "
                f"plain twin max |err| {e_twin} (must be 0)")
        require(torch.equal(got, unw), f"one-window BCJR K={K} x {Bc}: kernel vs "
                f"turbo._bcjr_posterior max |err| {e_unw} (must be 0)")
        res[f"K{K}_{Bc}rows"] = {"vs_twin": e_twin, "vs_bcjr_posterior": e_unw}
    report["bcjr_one_window_check"] = res
    print("bcjr one window (Lw = K+3, D = 0): kernel == plain twin == "
          "turbo._bcjr_posterior bit for bit at K x rows "
          + ", ".join(f"{K} x {Bc}" for K, Bc in shapes), flush=True)


def phase_bcjr(dev, report, main_shapes):
    """Kernel vs plain twin on 64 codeblocks and at `main_shapes` ({K:
    codeblocks per call}, as the steps' PDC decodes call it) and on the
    oracle's ragged 50, then a 64-codeblock turbo round trip per K."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.chain import _crc_device
    from dectnrp_tpu_torch.phy.fec.crc import POLY_CRC24B, crc_matrix
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode_early, turbo_encode

    B = 64
    errs, res = [], {}
    for K, B_main in main_shapes.items():
        g = torch.Generator(device=dev).manual_seed(K)
        res[K] = {}
        for Bc in (B, B_main, FEC_N):
            Lsys, Lp = bcjr_llrs(K, Bc, g, dev)
            got = bcjr_cuda.bcjr_posterior_cm(Lsys, Lp, K)
            want = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K)
            torch.cuda.synchronize()
            require(torch.isfinite(got).all(),
                    f"BCJR K={K} x {Bc}: non-finite output")
            err = (got - want).abs().max().item()
            require(torch.allclose(got, want, rtol=1e-4, atol=1e-3),
                    f"BCJR K={K} x {Bc}: kernel vs plain max |err| {err}")
            errs.append(err)
            res[K][f"max_abs_err_{Bc}cb"] = err

        # round trip: payload + CRC24B, turbo encode, BPSK at sigma 0.8
        m = torch.as_tensor(crc_matrix(K - 24, POLY_CRC24B).astype(np.float32),
                            device=dev)
        pay = torch.randint(0, 2, (B, K - 24), generator=g, device=dev,
                            dtype=torch.uint8)
        c = torch.cat([pay, _crc_device(pay, m)], 1)
        d = turbo_encode(c, K).float()
        sigma = 0.8
        llr = (2 * d - 1 + sigma * torch.randn(d.shape, generator=g, device=dev)
               ) * (2 / sigma ** 2)
        bits, _, ok, n_it = turbo_decode_early(llr, m, K, n_iter_max=8,
                                               n_iter_min=2)
        require(torch.equal(bits, c), f"turbo round trip K={K}: bits differ")
        require(bool(ok.all()), f"turbo round trip K={K}: CRC failed")
        res[K]["round_trip_iters"] = n_it
    report["bcjr_check"] = res
    shapes = ", ".join(f"K={K} x {B}/{Bm}/{FEC_N}" for K, Bm in main_shapes.items())
    iters = "/".join(str(r["round_trip_iters"]) for r in res.values())
    print(f"bcjr: kernel == plain twin at {shapes} codeblocks (max |err| "
          f"{max(errs):.3g}, rtol 1e-4 atol 1e-3); turbo round trip bits exact "
          f"in {iters} iterations", flush=True)
    return max(errs)


def phase_bcjr_bf16(dev, report, main_shapes):
    """bf16 kernel vs its plain twin, bit for bit, at every shape it is
    timed at (bcjr_bf16_turns.SHAPES: 64 codeblocks at four K, the
    flagship's two decodes, the oracle's ten) and at `main_shapes`; then the
    turbo decoder's decisions through it at K = 6144 x 4."""
    from dectnrp_tpu_torch.bcjr_bf16_turns import SHAPES
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode, turbo_encode

    shapes = dict.fromkeys([*SHAPES, *main_shapes.items()])
    errs = {}
    for K, Bc in shapes:
        g = torch.Generator(device=dev).manual_seed(K + Bc)
        Lsys = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
        Lp = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
        got = bcjr_cuda.bcjr_posterior_cm_bf16(Lsys, Lp, K)
        want = bcjr_cuda.bcjr_windowed_cm_bf16_plain(Lsys, Lp, K)
        torch.cuda.synchronize()
        require(torch.isfinite(got).all(), f"bf16 BCJR K={K} x {Bc}: non-finite")
        errs[f"K{K}_{Bc}cb"] = (got - want).abs().max().item()
        require(torch.equal(got, want), f"bf16 BCJR K={K} x {Bc}: kernel vs "
                f"plain max |err| {errs[f'K{K}_{Bc}cb']} (must be 0)")

    K, Bc, sigma = 6144, 4, 1.0
    g = torch.Generator(device=dev).manual_seed(6144)
    bits = torch.randint(0, 2, (Bc, K), generator=g, device=dev, dtype=torch.uint8)
    d = turbo_encode(bits, K)
    clean = torch.where(d > 0, 4.0, -4.0)
    require(torch.equal(turbo_decode(clean, K, 2, impl="cuda_bf16")[0], bits),
            "bf16 turbo decode of clean LLRs: bits differ")
    noisy = (2.0 * d.float() - 1.0 + sigma * torch.randn(
        d.shape, generator=g, device=dev)) * (2.0 / sigma ** 2)
    o_b = turbo_decode(noisy, K, 4, impl="cuda_bf16")[0]
    o_f = turbo_decode(noisy, K, 4, impl="cuda")[0]
    require(torch.equal(o_b, o_f), "bf16 turbo decode at sigma 1.0: "
            f"{int((o_b != o_f).sum())} bits differ from the float32 kernel's")
    report["bcjr_bf16_check"] = {**errs, "sigma1_bits_equal_f32": True,
                                 "sigma1_bit_errors": int((o_b != bits).sum())}
    print("bcjr_bf16: kernel == plain twin bit for bit at K x codeblocks "
          + ", ".join(f"{K} x {Bc}" for K, Bc in shapes)
          + f" (max |err| {max(errs.values())}); turbo_decode(impl=cuda_bf16) "
          f"K=6144 x 4: clean bits exact in 2 iterations, sigma 1.0 equal to "
          f"impl=cuda in 4", flush=True)
    return max(errs.values())


def fec_waterfall(mcs):
    """The committed retx-0 waterfall: the first SNR of
    results/fec_awgn/fec_awgn_MCS_<mcs>.json with PER_retx0 <= 0.1."""
    rec = json.loads((ROOT / f"results/fec_awgn/fec_awgn_MCS_{mcs:02d}.json")
                     .read_text())
    return next(s for s, p in zip(rec["experiment_range"]["snr_vec"],
                                  rec["result"]["PER_retx0"]) if p <= 0.1)


def phase_fec_awgn(dev, card, report):
    """The FEC oracle over MCS 0-9 at w - 4, w, w + 2 (launch counts zeroed
    before, read after), with its gates and the kernel decodes of the
    first-transmission softbuffers."""
    from dectnrp_tpu_torch import fec_awgn
    from dectnrp_tpu_torch.phy.fec.chain import _pdc_crc_tables
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode_early
    from dectnrp_tpu_torch.phy.plan import device_tables

    res = {}
    zero_counts()
    for mcs in range(10):
        w = fec_waterfall(mcs)
        snrs = [w + o for o in FEC_SNR_OFFSETS]
        plan = fec_awgn.build_fec_awgn_step(fec_awgn.fec_psdef(mcs), 0, dev).plan
        m_k = device_tables(_pdc_crc_tables, (plan,), dev)["m_k"]
        cmp = {"disagree": [], "ok_cuda": [], "ok_bf16": [], "s": 0.0}

        def on_point(i, snr, soft0):
            t0 = time.perf_counter()
            (K, d), = soft0.items()            # one codeblock per TB here
            ok = {impl: turbo_decode_early(d, m_k[K], K, n_iter_max=8,
                                           n_iter_min=2, window=128,
                                           impl=impl)[2].cpu()
                  for impl in ("cuda", "cuda_bf16")}
            n_dis = int((ok["cuda"] != ok["cuda_bf16"]).sum())
            cmp["disagree"].append(n_dis)
            cmp["ok_cuda"].append(float(ok["cuda"].float().mean()))
            cmp["ok_bf16"].append(float(ok["cuda_bf16"].float().mean()))
            cmp["s"] += time.perf_counter() - t0
            require(i == 1 or n_dis == 0, f"fec_awgn MCS {mcs} at {snr:g} dB: "
                    f"bf16 and float32 kernel decodes disagree on {n_dis} packets")

        rec = fec_awgn.sweep(mcs, snrs, FEC_N, 3, dev, on_point=on_point)
        per = [rec["result"][f"PER_retx{t}"] for t in range(4)]
        require(per[0][2] <= 0.1, f"fec_awgn MCS {mcs}: PER_retx0 {per[0][2]} "
                f"> 0.1 at w + 2 = {snrs[2]:g} dB")
        require(per[3][0] <= 0.1, f"fec_awgn MCS {mcs}: PER_retx3 {per[3][0]} "
                f"> 0.1 at w - 4 = {snrs[0]:g} dB")
        for i, snr in enumerate(snrs):
            seq = [per[t][i] for t in range(4)]
            require(all(b <= a for a, b in zip(seq, seq[1:])),
                    f"fec_awgn MCS {mcs} at {snr:g} dB: PER rises over the "
                    f"retransmissions {seq}")
        res[mcs] = {"w": w, "snr": snrs, "per": per,
                    "ber": rec["result"]["BER_uncoded_vec"],
                    "K": list(plan.cb_K), "oracle_s": rec["wall_s"] - cmp["s"],
                    "kernel_decode_s": cmp["s"], **cmp}
        print(f"[{card}] fec_awgn MCS {mcs} (K={plan.cb_K[0]}, w={w:g} dB): "
              "PER retx0..3 at " + "; ".join(
                  f"{s:g} dB " + "/".join(f"{per[t][i]:.2f}" for t in range(4))
                  for i, s in enumerate(snrs))
              + f"; bf16 vs float32 kernel disagreements {cmp['disagree']}; "
              f"oracle {res[mcs]['oracle_s']:.1f} s, kernel decodes "
              f"{cmp['s']:.3f} s", flush=True)
    torch.cuda.synchronize()
    launches = counts()
    require(launches["bcjr"] > 0 and launches["bcjr_bf16"] > 0,
            f"fec_awgn: a BCJR kernel was not launched ({launches})")
    report["fec_awgn"] = {"n": FEC_N, "rv": list(fec_awgn.RV_SEQ),
                          "cut": "3 of the oracle's 21 SNR points per MCS",
                          "mcs": res, "launches": launches}
    print(f"fec_awgn: 10 MCS x 3 SNR points (cut from 21) x {FEC_N} packets x "
          "rv 0,2,3,1 passed its gates; launches on the path: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches


def stf_stream(u, b, B, T, n_stf, gen, dev, snr_db=SNR_DB):
    """[B, 1, T] unit-power noise-like payload after each of n_stf
    unit-power STFs (N_eff_TX = 1) a stream, at offsets at least 4 STF
    lengths apart, under AWGN at snr_db: the sync input of a cell whose
    packets are not synthesized here."""
    from dectnrp_tpu_torch.phy.sync import stf_time_template

    stf = torch.as_tensor(stf_time_template(u, b, 1), device=dev)
    L = stf.numel()
    stf = stf * L ** 0.5
    rng = np.random.default_rng(T + B)
    y = torch.zeros((B, 1, T), dtype=torch.complex64, device=dev)
    slot = (T - 8 * L) // n_stf
    for i in range(B):
        for k in range(n_stf):
            o = k * slot + int(rng.integers(0, slot - 4 * L))
            n = min(4 * L, T - o - L)
            y[i, 0, o:o + L] = stf
            y[i, 0, o + L:o + L + n] = torch.randn(
                n, dtype=torch.complex64, generator=gen, device=dev)
    return y + 10 ** (-snr_db / 20) * torch.randn(
        y.shape, dtype=torch.complex64, generator=gen, device=dev)


def _sync_check(s, y, label, report):
    """Kernel sm vs plain and tiled sm on the card (the Sync module's RMS
    gate included); kernel report vs CPU report."""
    from dectnrp_tpu_torch.phy.ops.sync_detect import (default_span,
                                                       detect_metric_plain,
                                                       detect_rms, detect_sm,
                                                       detect_sm_plain,
                                                       detect_sm_tiled,
                                                       gate_tie_mask)

    pr = s.params
    args = (s.P, s.w, s.sl, s.sr, pr.metric_threshold, pr.metric_max)
    gate = {"rms_min": pr.rms_min, "rms_max": pr.rms_max}
    got = detect_sm(y, *args, **gate)
    want = detect_sm_plain(y, *args, **gate)
    tiled = detect_sm_tiled(y, *args, default_span(y, s.P, s.n_pat, s.sl, s.sr),
                            **gate)
    metric, _, P2s = detect_metric_plain(y, s.P, s.w)
    rms = detect_rms(P2s, s.L * y.shape[1])

    def ok_at(eps):
        return gate_tie_mask(metric, pr.metric_threshold, pr.metric_max, s.sl,
                             s.sr, eps, rms, pr.rms_min, pr.rms_max)
    ok = ok_at(1e-3)
    require(torch.isfinite(got).all(), f"sync {label}: non-finite sm")
    masked = 1.0 - ok.float().mean().item()
    require(masked < 0.05, f"sync {label}: {masked:.3f} of sm near gate ties")
    err = (got - want).abs()[ok].max().item()
    require(torch.allclose(got[ok], want[ok], rtol=2e-3, atol=2e-4),
            f"sync {label}: kernel vs plain max |err| {err}")
    ok_t = ok_at(1e-5)
    err_t = (got - tiled).abs()[ok_t].max().item()
    n_eq = int((got == tiled).sum())
    require(torch.allclose(got[ok_t], tiled[ok_t], rtol=1e-5, atol=1e-6),
            f"sync {label}: kernel vs tiled twin max |err| {err_t}")
    rep_k = s(y)
    rep_p = s.cpu()(y.cpu())
    s.to(y.device)
    det = rep_p["detected"]
    require(torch.equal(rep_k["detected"].cpu(), det),
            f"sync {label}: report field detected differs")
    # with several peaks, an undetected one is the argmax of what the
    # masking rounds left: zeros up to each twin's rounding residue
    keep = det if s.max_peaks > 1 else torch.ones_like(det)
    for key in ("t_fine", "n_eff_tx"):
        require(torch.equal(rep_k[key].cpu()[keep], rep_p[key][keep]),
                f"sync {label}: report field {key} differs")
    report[f"sync_check_{label}"] = {
        "shape": list(y.shape), "max_abs_err": err, "tie_masked": masked,
        "max_abs_err_tiled": err_t, "bit_equal_tiled": n_eq / got.numel(),
        "detected": det.float().mean().item()}
    print(f"sync {label} {list(y.shape)}: kernel sm == plain twin (max |err| "
          f"{err:.3g} over {1 - masked:.4f} of samples off gate ties; rtol 2e-3 "
          f"atol 2e-4), == tiled twin (max |err| {err_t:.3g}, "
          f"{n_eq / got.numel():.6f} of samples bit-equal); t_fine/detected/"
          f"n_eff_tx equal to the plain path (detected {det.float().mean():.3f})",
          flush=True)
    return err, err_t


def poly_tiled(x, G, L, M, m0, n_out):
    """The polyphase tiled twin walked with the kernel's block count."""
    from dectnrp_tpu_torch.phy.ops import polyphase

    return polyphase.polyphase_fir_tiled(
        x, G, L, M, m0, n_out,
        blocks=polyphase.resident_blocks(x.device.index, L, M, G.shape[1]))


def phase_polyphase(wall, dev, report):
    """Kernel vs plain twin at the wall step's two calls, at 40/27 and at a
    ragged 9/10 length; a 3-chunk streaming chain vs the one-shot; each
    call also vs the tiled twin."""
    from dectnrp_tpu_torch.phy.ops.polyphase import polyphase_fir_plain
    from dectnrp_tpu_torch.phy.resampler import (ResamplerPlan, build_resampler,
                                                 build_resampler_stream,
                                                 stream_input_lag)

    g = torch.Generator(device=dev).manual_seed(5)
    tiled = {}

    def check_tiled(label, got, x, G, L, M, m0, n_out):
        want = poly_tiled(x, G, L, M, m0, n_out)
        tiled[label] = {"max_abs_err": (got - want).abs().max().item(),
                        "bit_equal": (got == want).float().mean().item()}
        require(torch.allclose(got, want, **POLY_TOL),
                f"polyphase {label}: kernel vs tiled twin max |err| "
                f"{tiled[label]['max_abs_err']}")

    def rand(*shape):
        return torch.randn(shape, dtype=torch.complex64, generator=g, device=dev)

    cases = [("10/9 [16,4,23040]", wall.up, (B_WALL, 4)),
             ("9/10 [16,4,85900]", wall.down, (B_WALL, 4)),
             ("40/27 [8,13500]", build_resampler(ResamplerPlan(40, 27), 13500), (8,)),
             ("9/10 ragged [3,9973]", build_resampler(ResamplerPlan(9, 10), 9973), (3,))]
    errs = {}
    for label, mod, lead in cases:
        x = rand(*lead, mod.n_in)
        got = mod(x)
        want = polyphase_fir_plain(x, mod.G, mod.plan.L, mod.plan.M, mod.m0,
                                   mod.n_out)
        torch.cuda.synchronize()
        require(got.shape == (*lead, mod.n_out) and torch.isfinite(got).all(),
                f"polyphase {label}: bad output")
        errs[label] = (got - want).abs().max().item()
        require(torch.allclose(got, want, **POLY_TOL),
                f"polyphase {label}: kernel vs plain max |err| {errs[label]}")
        check_tiled(label, got, x, mod.G, mod.plan.L, mod.plan.M, mod.m0,
                    mod.n_out)

    plan, chunk = ResamplerPlan(9, 10), 10 * 2048
    st = build_resampler_stream(plan, chunk)
    x = rand(B_WALL * 4, 3 * chunk)
    hist = torch.zeros((B_WALL * 4, st.H), dtype=torch.complex64, device=dev)
    outs = []
    for c in range(3):
        xp = torch.cat([hist, x[:, c * chunk:(c + 1) * chunk]], -1)
        y, hist = st(x[:, c * chunk:(c + 1) * chunk], hist)
        check_tiled(f"stream_chunk{c}", y, xp, st.G, plan.L, plan.M, st.off,
                    st.n_out)
        outs.append(y)
    y_st = torch.cat(outs, -1)
    lag = stream_input_lag(plan)
    xd = torch.cat([torch.zeros((B_WALL * 4, lag), dtype=x.dtype, device=dev), x], -1)
    y_one = build_resampler(plan, xd.shape[-1])(xd)[:, :y_st.shape[-1]]
    errs["stream_chain"] = (y_st - y_one).abs().max().item()
    require(torch.allclose(y_st, y_one, **POLY_TOL),
            f"polyphase stream chain vs one-shot max |err| {errs['stream_chain']}")
    report["polyphase_check"] = errs
    report["polyphase_check_tiled"] = tiled
    print("polyphase: kernel == plain twin at " + ", ".join(
        f"{k} (max |err| {v:.3g})" for k, v in errs.items() if k != "stream_chain")
        + f"; 3-chunk stream chain == one-shot on the lag-{lag} input (max |err| "
        f"{errs['stream_chain']:.3g}); == tiled twin at " + ", ".join(
            f"{k} (max |err| {v['max_abs_err']:.3g}, bit-equal {v['bit_equal']:.6f})"
            for k, v in tiled.items()) + "; rtol 2e-5 atol 2e-5", flush=True)
    return max(errs.values()), max(v["max_abs_err"] for v in tiled.values())


def _inputs(step, B, seed, dev):
    from dectnrp_tpu_torch.loopback import packet_offsets

    ps = step.tx.ps
    rng = np.random.default_rng(seed)
    plcf = torch.as_tensor(rng.integers(0, 2, (B, 40)), dtype=torch.uint8,
                           device=dev)
    tb = torch.as_tensor(rng.integers(0, 2, (B, ps.N_TB_bits)),
                         dtype=torch.uint8, device=dev)
    offs = torch.as_tensor(packet_offsets(rng, B, step.n_pkts, step.T,
                                          step.n_pkt), device=dev)
    return plcf, tb, offs


def small_step_check(step, dev, gen, label):
    """The same noisy radio-rate stream received on the card (kernels) and
    on the CPU (plain twins) gives the same decisions."""
    p, t, o = _inputs(step, 2, 8, dev)
    y = step.awgn(step.stream(p, t, o), gen)
    ok_k, det_k, tf_k = step.receive(step.resample_down(y))
    before = counts()
    cpu = step.cpu()
    ok_c, det_c, tf_c = cpu.receive(cpu.resample_down(y.cpu()))
    step.to(dev)
    require(counts() == before, f"small {label} step: CPU run launched a kernel")
    require(torch.equal(tf_k.cpu(), tf_c) and torch.equal(det_k.cpu(), det_c)
            and torch.equal(ok_k.cpu(), ok_c),
            f"small {label} step: card and CPU decisions differ")
    require(bool(ok_c.all()), f"small {label} step: decode failed")
    print(f"reference: small {label} step on the card decodes the same "
          "t_fine/detected/tb_ok as on the CPU", flush=True)


def counted_step(step, B, seed, dev, gen, name, report):
    """One step through the main path, launch counts 0 before and read
    after; the bench's gate."""
    p, t, o = _inputs(step, B, seed, dev)
    zero_counts()
    ok, det, _ = step(p, t, o, gen)
    torch.cuda.synchronize()
    launches = counts()
    ok_frac = ok.float().mean().item()
    det_frac = det.float().mean().item()
    report[name] = {"B": B, "T": step.T, "T_dect": step.T_dect,
                    "n_pkts": step.n_pkts, "snr_db": -10 * np.log10(step.noise_var),
                    "decode_ok": ok_frac, "detected": det_frac,
                    "launches": launches}
    require(ok_frac >= 0.95 and det_frac >= 0.95,
            f"{name} gate: decode_ok {ok_frac:.3f} detected {det_frac:.3f}")
    print(f"{name}: B={B} T={step.T} {step.n_pkts} packet(s)/stream: decode_ok "
          f"{ok_frac:.4f} detected {det_frac:.4f}; launches in the step: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches


def time_stages(step, B, dev, gen, seed0):
    """Step median over 5 steps and per-stage medians (ms)."""
    from dectnrp_tpu_torch.phy import rx as rx_mod

    split = {"pcc": [], "pdc": []}

    def timed(fn, key):
        def wrap(*a, **kw):
            ms, out = host_ms(lambda: fn(*a, **kw))
            split[key].append(ms)
            return out
        return wrap

    pcc0, pdc0 = rx_mod.pcc_decode, rx_mod.pdc_decode
    names = ["step", "tx", "scatter", "awgn", "sync", "rx_stream"]
    if step.up is not None:
        names += ["resample_up", "resample_down"]
    stages = {k: [] for k in names}

    def add(key, fn):
        ms, out = host_ms(fn)
        if key in stages:
            stages[key].append(ms)
        return out

    for i in range(5):
        p, t, o = _inputs(step, B, seed0 + i, dev)
        add("step", lambda: step(p, t, o, gen))
        iq = add("tx", lambda: step.transmit(p, t))
        iq = add("resample_up", lambda: step.resample_up(iq))
        s = add("scatter", lambda: step.scatter(iq, o))
        y = add("awgn", lambda: step.awgn(s, gen))
        y = add("resample_down", lambda: step.resample_down(y))
        rep = add("sync", lambda: step.sync(y))
        tf, cf = rep["t_fine"], rep["cfo"]
        if step.n_pkts == 1:
            tf, cf = tf[:, None], cf[:, None]
        rx_mod.pcc_decode, rx_mod.pdc_decode = timed(pcc0, "pcc"), timed(pdc0, "pdc")
        try:
            add("rx_stream", lambda: [step.rxs(y, tf[:, k], cf[:, k], step.noise_var)
                                      for k in range(step.n_pkts)])
        finally:
            rx_mod.pcc_decode, rx_mod.pdc_decode = pcc0, pdc0
    med = {k: statistics.median(v) for k, v in stages.items()}
    # per-step totals: median call time x calls per step (pcc_decode runs
    # twice per packet, once per PLCF type; pdc_decode once per packet)
    med["pcc_decode"] = statistics.median(split["pcc"]) * len(split["pcc"]) / 5
    med["pdc_decode"] = statistics.median(split["pdc"]) * len(split["pdc"]) / 5
    return med, stages


def profile_device(fn, name):
    """torch.profiler with device activity only over one fn() call (after
    one untraced call): (device events, host ms of the call, ms in which
    the device was busy, [(kernel, count, ms)] by time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(fn)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    require(ev, f"profile {name}: no device activity traced")
    busy_ns, cur_s, cur_e = 0, None, None
    for s0, s1 in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in ev):
        if cur_e is None or s0 > cur_e:
            busy_ns += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy_ms = (busy_ns + cur_e - cur_s) / 1e6
    by_name = {}
    for e in ev:
        n, ms = by_name.get(e.name(), (0, 0.0))
        by_name[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return ev, wall_ms, busy_ms, top


def phase_profile(step, name, B, dev, gen, card, report):
    """torch.profiler with device activity only over one step."""
    p, t, o = _inputs(step, B, 200, dev)
    ev, wall_ms, busy_ms, top = profile_device(lambda: step(p, t, o, gen), name)
    prof_rep = {"card": card, "wall_ms": wall_ms, "n_device_events": len(ev),
                "busy_union_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                "unprofiled_step_ms": report[f"{name}_times_ms_all"]["step"],
                "top": [[n, c, ms] for n, (c, ms) in top]}
    (OUT / f"profile_{name}.json").write_text(json.dumps(prof_rep, indent=1))
    print(f"[{card}] profile (torch.profiler, device activity, one {name} "
          f"step): {len(ev)} device events, busy {busy_ms:.1f} ms in a "
          f"{wall_ms:.1f} ms step, idle share {1 - busy_ms / wall_ms:.3f}; "
          "top: " + "; ".join(f"{n[:48]} x{c} {ms:.1f} ms"
                              for n, (c, ms) in top[:5]), flush=True)


def phase_loopback_card_vs_cpu(dev, card, report):
    """One loopback point per variant (MCS 2 at the committed curve's
    threshold, 8 packets) on the card and on the CPU, on the same inputs
    and draws: equal decisions."""
    from dectnrp_tpu_torch import loopback_snr as L

    res = {}
    for name, _ in L.VARIANTS:
        snr = L.cut_snrs(LB_REF, name, 2)[1]
        a, b, tb = L.card_vs_cpu(name, 2, snr, 8, 1, dev)
        require(L.decisions_equal(a, b), f"loopback {name} at {snr:g} dB: card "
                "and CPU decisions differ")
        res[name] = {"snr_db": snr, "tb_ok": a["tb_ok"].tolist(),
                     "detected": a["detected"].tolist()}
    report["loopback_card_vs_cpu"] = res
    print(f"[{card}] loopback: one point per variant (MCS 2 at the committed "
          "threshold, 8 packets) decides the same detected/plcf_ok/tb_ok/tb on "
          "the card as on the CPU: " + ", ".join(
              f"{k} {sum(v['tb_ok'])}/8" for k, v in res.items()), flush=True)


def phase_loopback(dev, card, report):
    """The loopback_snr path: every variant and MCS through
    LoopbackSnrExperiment at 500 packets a point, 3 SNR points each (launch
    counts zeroed before, read after), held to the committed curves."""
    from dectnrp_tpu_torch import loopback_snr as L

    zero_counts()
    t_path = time.perf_counter()
    res, n_points = {}, 0
    for name, kw in L.VARIANTS:
        c0, point_ms, curves = counts(), [], {}
        for mcs in L.experiment(name, LB_N, dev).mcs_list:
            snrs = L.cut_snrs(LB_REF, name, mcs)
            exp = L.experiment(name, LB_N, dev, mcs=(mcs,), snr_db=snrs)
            run_point = exp.run_point

            def timed(*a, run_point=run_point):
                ms, pt = host_ms(lambda: run_point(*a))
                point_ms.append(ms)
                return pt
            exp.run_point = timed
            got = exp.run()[mcs]["result"]
            ref = L._load(LB_REF, name, mcs)
            ref_snrs = ref["experiment_range"]["snr_vec"]
            n_ref = ref["experiment_range"]["nof_experiment_per_snr"]
            for s, pg, pcc in zip(snrs, got["PER_pdc_crc"], got["PER_pcc_crc"]):
                pr = ref["result"]["PER_pdc_crc"][ref_snrs.index(s)]
                p = (pg * LB_N + pr * n_ref) / (LB_N + n_ref)
                lim = LB_SIGMAS * np.sqrt(p * (1 - p) * (1 / LB_N + 1 / n_ref)) + 0.01
                require(abs(pg - pr) <= lim, f"loopback {name} MCS {mcs} at {s:g} "
                        f"dB: PER_pdc_crc {pg:.3f} vs committed {pr:.3f} "
                        f"(limit {lim:.3f})")
            curves[mcs] = {"snr_db": snrs, "PER_pdc_crc": got["PER_pdc_crc"],
                           "PER_pcc_crc": got["PER_pcc_crc"],
                           "ref": [ref["result"]["PER_pdc_crc"][ref_snrs.index(s)]
                                   for s in snrs]}
            n_points += len(snrs)
        torch.cuda.synchronize()
        c1 = counts()
        d = {k: c1[k] - c0[k] for k in c1}
        n = len(point_ms)
        want_sync = n if kw.get("use_sync") else 0
        want_poly = 2 * n if kw.get("resampler_loop") else 0
        require(d["bcjr_one_window"] > 0 and d["bcjr"] > d["bcjr_one_window"]
                and d["sync"] == want_sync and d["polyphase"] == want_poly
                and d["bcjr_bf16"] == 0,
                f"loopback {name}: kernels not launched as expected ({d}; one "
                f"window and windowed bcjr > 0, sync {want_sync}, polyphase "
                f"{want_poly}, bcjr_bf16 0)")
        res[name] = {"curves": curves, "launches": d, "points": n,
                     "point_ms": point_ms,
                     "point_ms_median": statistics.median(point_ms)}
        print(f"[{card}] loopback_snr {name}: {n} points x {LB_N} packets within "
              f"{LB_SIGMAS:g} sigma + 0.01 of the committed PER_pdc_crc; point "
              f"median {res[name]['point_ms_median']:.1f} ms; launches "
              + " ".join(f"{k} {v}" for k, v in d.items()), flush=True)
    path_s = time.perf_counter() - t_path
    launches = counts()
    report["loopback_snr"] = {
        "n": LB_N, "cut": "3 SNR points per variant x MCS: w - 4, w, w + 2 "
        "around the committed curve's first PER_pdc_crc <= 0.1 (the 3 "
        "lowest-PER points where it never reaches 0.1)", "points": n_points,
        "path_s": path_s, "variants": res, "launches": launches}
    print(f"[{card}] loopback_snr: 8 variants, {n_points} points (cut from 851) "
          f"x {LB_N} packets passed their gates in {path_s:.1f} s; launches on "
          "the path: " + " ".join(f"{k} {v}" for k, v in launches.items()),
          flush=True)
    return launches


def loopback_pdc_shapes():
    """[(K, rows)] of the PDC decodes on the loopback path: per codeblock
    size of every variant's MCS, its codeblocks a packet x LB_N."""
    from dectnrp_tpu_torch import loopback_snr as L
    from dectnrp_tpu_torch.phy.fec.chain import PdcPlan
    from dectnrp_tpu_torch.sections.part3.packet_sizes import get_packet_sizes

    shapes = set()
    for name, _ in L.VARIANTS:
        exp = L.experiment(name, LB_N, "cpu")
        for mcs in exp.mcs_list:
            psdef = exp.psdef(mcs)
            ps = get_packet_sizes(psdef)
            plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
            shapes |= {(K, n * LB_N) for K, n in Counter(plan.cb_K).items()}
    return sorted(shapes)


def loopback_stage_inputs(dev, n=LB_N):
    """{(variant, module): (module, its input)}: what the loopback path hands
    B2 and B3, caught by forward pre-hooks on the cached PointStep while one
    point runs (MCS 2 at the committed threshold, n packets): the sync's
    stream in `sync` (R = 1) and `mimo` (R = 2), the 10/9 and 9/10
    resamplers' inputs in `resampled`."""
    from dectnrp_tpu_torch import loopback_snr as L
    from dectnrp_tpu_torch.upper.loopback import point_step

    got = {}

    def catch(key):
        def hook(mod, args):
            got.setdefault(key, (mod, args[0].clone()))
        return hook
    for name, mods in (("sync", ("sync",)), ("mimo", ("sync",)),
                       ("resampled", ("up", "down"))):
        exp = L.experiment(name, n, dev, mcs=(2,))
        # the arguments exactly as _run_point passes them: the same cache entry
        step = point_step(exp.psdef(2), exp.identity.network_id, exp.use_sync,
                          None, exp.channel, exp.resampler_loop, exp.genie,
                          exp.device)
        hooks = [getattr(step, m).register_forward_pre_hook(catch((name, m)))
                 for m in mods]
        try:
            exp.run_point(2, 0, L.cut_snrs(LB_REF, name, 2)[1])
        finally:
            for h in hooks:
                h.remove()
        require(all((name, m) in got for m in mods),
                f"loopback {name}: the point did not run {mods}")
    return got


def phase_loopback_kernels(dev, report):
    """The kernels at the shapes the loopback path launches them, each held
    to its plain twin on the same card inputs, then timed beside it and its
    bound. B1 as one window at K = 56 / 96 (PCC) and 320 / 480 (PDC) x 500
    rows: bit for bit its plain twin and turbo._bcjr_posterior; windowed at
    every other PDC K of the path x 500 codeblocks: bit for bit its plain
    twin; each through the route the decoder takes. B2 at b = 1 on the
    streams of one sync point [500, 1, 2048] and one mimo point [500, 2,
    2048] (`_sync_check`). B3 on the inputs of one resampled point, 10/9
    [500, 1, 720] and 9/10 [500, 1, 800]: bit for bit its tiled twin and
    within POLY_TOL of its plain twin, conv1d beside it."""
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior, _resolve_bcjr
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.ops.polyphase import polyphase_fir, polyphase_fir_plain

    out = {"bcjr": {}, "sync": {}, "polyphase": {}}
    g = torch.Generator(device=dev).manual_seed(9)
    for K, rows in [(56, LB_N), (96, LB_N)] + loopback_pdc_shapes():
        windowed = K >= 512
        lw = (128, 32) if windowed else (K + 3, 0)
        kind, route = _resolve_bcjr(K, None, "auto", dev)
        require(kind == "cm" and route.func is bcjr_cuda.bcjr_posterior_cm
                and route.keywords == {"K": K, "Lw": lw[0], "D": lw[1]},
                f"loopback BCJR K={K}: the decoder does not take the kernel")
        Lsys, Lp = bcjr_llrs(K, rows, g, dev)
        got = route(Lsys, Lp)
        twin = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, *lw)
        if windowed:
            def plain():
                return bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, *lw)
            others = {}
        else:
            Ls_r, Lp_r = Lsys.T.contiguous(), Lp.T.contiguous()
            La = torch.zeros((rows, K), device=dev)

            def plain():
                return _bcjr_posterior(Ls_r, Lp_r, La, K)
            others = {"turbo._bcjr_posterior": plain().T}
        torch.cuda.synchronize()
        label = f"K{K}_{rows}{'cb' if windowed else 'rows_one_window'}"
        require(torch.isfinite(got).all(), f"loopback BCJR {label}: non-finite")
        err = (got - twin).abs().max().item()
        require(torch.equal(got, twin), f"loopback BCJR {label}: kernel vs "
                f"plain twin max |err| {err} (must be 0)")
        for name, want in others.items():
            require(torch.equal(got, want), f"loopback BCJR {label}: kernel vs "
                    f"{name} max |err| {(got - want).abs().max().item()} (must be 0)")
        b_ms, b_by = bound(*bcjr_work(K, rows, windowed))
        out["bcjr"][label] = {
            "max_abs_err": err,
            "ms": 1e-3 * graph_us(lambda: route(Lsys, Lp)),
            "eager_ms": cuda_ms(lambda: route(Lsys, Lp)),
            "plain_ms": cuda_ms(plain, reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    stage = loopback_stage_inputs(dev)
    for name in ("sync", "mimo"):
        s, ys = stage[(name, "sync")]
        label = f"[{LB_N},{ys.shape[1]},{ys.shape[2]}]_b{s.P // 16}"
        err, err_t = _sync_check(s, ys, f"loopback_{name}", report)
        sargs = (s.P, s.w, s.sl, s.sr, s.params.metric_threshold,
                 s.params.metric_max)
        b_ms, b_by = bound(*sync_work(*ys.shape, s.P, s.n_pat))
        out["sync"][label] = {
            "variant": name, "max_abs_err": err, "max_abs_err_tiled": err_t,
            "ms": 1e-3 * graph_us(lambda: sync_detect.detect_sm(ys, *sargs)),
            "eager_ms": cuda_ms(lambda: sync_detect.detect_sm(ys, *sargs)),
            "plain_ms": 1e-3 * graph_us(
                lambda: sync_detect.detect_sm_plain(ys, *sargs), reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    for m in ("up", "down"):
        mod, x = stage[("resampled", m)]
        G, L_, M_, m0, n_out = mod.G, mod.plan.L, mod.plan.M, mod.m0, mod.n_out
        label = f"{L_}/{M_}_{list(x.shape)}".replace(" ", "")
        got = polyphase_fir(x, G, L_, M_, m0, n_out)
        want = polyphase_fir_plain(x, G, L_, M_, m0, n_out)
        tiled = poly_tiled(x, G, L_, M_, m0, n_out)
        torch.cuda.synchronize()
        require(torch.isfinite(got).all(), f"loopback polyphase {label}: non-finite")
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, **POLY_TOL), f"loopback polyphase "
                f"{label}: kernel vs plain max |err| {err}")
        err_t = (got - tiled).abs().max().item()
        require(torch.equal(got, tiled), f"loopback polyphase {label}: kernel vs "
                f"tiled twin max |err| {err_t} (must be 0)")
        b_ms, b_by = bound(*poly_work(G, L_, x.numel() // x.shape[-1],
                                      x.shape[-1], n_out))
        out["polyphase"][label] = {
            "max_abs_err": err, "max_abs_err_tiled": err_t,
            **poly_times(x, G, L_, M_, m0, n_out), "bound_ms": b_ms,
            "bound_by": b_by}
    return out


def print_path_times(card, path, times):
    """One line: the kernels on the inputs a path handed them (7c, 7e)."""
    print(f"[{card}] kernels on the {path} path's inputs, each equal to its "
          "plain twin (B1 bit for bit, B2 rtol 2e-3 atol 2e-4 off gate ties, B3 "
          "bit for bit its tiled twin and rtol 2e-5 atol 2e-5 its plain twin); "
          "max |err|, graph replay (eager) vs plain twin[, conv1d], bound: "
          + "; ".join(
              f"{kern} {k} {v['max_abs_err']:.3g}, {v['ms'] * 1e3:.1f} us "
              f"({v['eager_ms'] * 1e3:.1f}) vs {v['plain_ms']:.3f} ms"
              + (f", {v['library_ms'] * 1e3:.1f} us" if v.get("library_ms") else "")
              + f", {v['bound_ms'] * 1e3:.3f} us {v['bound_by']}"
              for kern, by in times.items() for k, v in by.items()), flush=True)


def path_entry(times):
    """A kernels line entry of one path's shapes (`loopback`, `runtime`,
    `iq_ingress`):
    per shape its max |err|, times and bound."""
    return {k: {kk: v[kk] for kk in ("max_abs_err", "ms", "eager_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
            for k, v in times.items()}


def phase_profile_loopback(dev, card, report):
    """torch.profiler over one sync point and one mimo_fading point (MCS 2
    at the committed threshold, 500 packets): the device's idle share."""
    from dectnrp_tpu_torch import loopback_snr as L

    res = {}
    for name in ("sync", "mimo_fading"):
        snr = L.cut_snrs(LB_REF, name, 2)[1]
        exp = L.experiment(name, LB_N, dev, mcs=(2,), snr_db=(snr,))
        ev, wall_ms, busy_ms, top = profile_device(
            lambda: exp.run_point(2, 0, snr), f"loopback {name}")
        res[name] = {"snr_db": snr, "wall_ms": wall_ms, "n_device_events": len(ev),
                     "busy_union_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                     "top": [[n, c, ms] for n, (c, ms) in top]}
        print(f"[{card}] profile (torch.profiler, device activity, one loopback "
              f"{name} point, MCS 2 at {snr:g} dB, {LB_N} packets): {len(ev)} "
              f"device events, busy {busy_ms:.1f} ms in a {wall_ms:.1f} ms point, "
              f"idle share {1 - busy_ms / wall_ms:.3f}; top: " + "; ".join(
                  f"{n[:48]} x{c} {ms:.1f} ms" for n, (c, ms) in top[:5]),
              flush=True)
    (OUT / "profile_loopback.json").write_text(json.dumps(res, indent=1))
    report["loopback_profile"] = res


def poly_times(x, G, L, M, m0, n_out):
    """Times (ms) of one polyphase FIR call: the kernel, its plain twin and
    the conv1d yardstick by CUDA graph replay, the kernel also eagerly and
    by graph replay again; and the yardstick's max |err| against the
    kernel. The yardstick is torch.nn.functional.conv1d on the real and
    imaginary rows, padded as the FIR reads them (the padding is not
    timed): out[c, l, g] = sum_w G[l, w] x[c, g M + w]."""
    import torch.nn.functional as F

    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.ops.polyphase import (polyphase_fir,
                                                     polyphase_fir_plain)

    W, n_in = G.shape[1], x.shape[-1]
    n_frames = -(-n_out // L)
    pad_l = max(0, -m0)
    pad_r = max(0, (n_frames - 1) * M + m0 + W - n_in)
    rows = torch.view_as_real(x).movedim(-1, -2).reshape(-1, 1, n_in)
    xr = F.pad(rows, (pad_l, pad_r))[..., m0 + pad_l:].contiguous()
    wt = G[:, None, :].contiguous()
    lib = F.conv1d(xr, wt, stride=M)                            # [2r, L, >=F]
    lib = lib[..., :n_frames].permute(0, 2, 1).reshape(-1, 2, n_frames * L)
    lib = torch.view_as_complex(lib[..., :n_out].movedim(-2, -1).contiguous())

    def kernel():
        return polyphase_fir(x, G, L, M, m0, n_out)
    lib_err = (lib.reshape(x.shape[:-1] + (n_out,)) - kernel()).abs().max().item()
    return {"ms": 1e-3 * graph_us(kernel),
            "plain_ms": 1e-3 * graph_us(
                lambda: polyphase_fir_plain(x, G, L, M, m0, n_out), reps=5),
            "library_ms": 1e-3 * graph_us(lambda: F.conv1d(xr, wt, stride=M)),
            "ms_again": 1e-3 * graph_us(kernel),
            "eager_ms": cuda_ms(kernel), "library_max_abs_err": lib_err}


# ---------------------------------------------------------------- runtime

# the scenario runs of the runtime path: (configuration, ticks, datagrams
# handed to node 0); p2p_simulator as tests/test_config_cli.py:58 runs it
RT_SCENARIOS = (("basic_simulator", 40, 0), ("rtt_simulator", 40, 3),
                ("p2p_simulator", 120, 0), ("loopback_simulator", 4, 0))


def rt_pumps(runtimes):
    """Resampler front-end steps the runtimes ran (0 at the DECT rate)."""
    return sum(rt.front_end.steps for rt in runtimes)


def rt_tick_stats(tick_ms, spp, rate, n_nodes):
    """Host ms a tick, median and mean, and the realtime multiple: radio
    time a tick (spp / rate) over the mean tick. The first tick, which
    builds the PHY modules (and in loopback_simulator runs the firmware's
    sweep), is left out. The mean, not the median, sets the multiple: at
    1.92 Ms/s most ticks only resample, and every second or third one
    syncs."""
    steady = tick_ms[1:]
    mean = statistics.fmean(steady)
    return {"ticks": len(tick_ms), "tick_ms_median": statistics.median(steady),
            "tick_ms_mean": mean, "tick_ms_max": max(steady),
            "first_tick_ms": tick_ms[0],
            "realtime_multiple": spp / rate / (mean * 1e-3), "nodes": n_nodes}


class RuntimeCatch:
    """Catches, while a run goes, the first card input of each shape that
    the runtime hands B1 (the decoder's BCJR route, patched), B2 (the Sync
    modules) and B3 (the resamplers): a forward pre-hook on every module
    and a recording route. Nothing is launched for it."""

    def __init__(self):
        from dectnrp_tpu_torch.phy.fec import turbo
        from dectnrp_tpu_torch.phy.resampler import Resampler, ResamplerStream
        from dectnrp_tpu_torch.phy.sync import Sync

        self.bcjr, self.sync, self.poly = {}, {}, {}
        self._turbo, self._resolve = turbo, turbo._resolve_bcjr

        def hook(mod, args):
            if not (args and torch.is_tensor(args[0]) and args[0].is_cuda):
                return                      # a CPU twin run beside the path
            if isinstance(mod, Sync):
                self.sync.setdefault(tuple(args[0].shape), (mod, args[0].clone()))
            elif isinstance(mod, ResamplerStream):
                xp = torch.cat([args[1], args[0]], -1)
                self.poly.setdefault((mod.plan.L, mod.plan.M, tuple(xp.shape)),
                                     (mod.G, mod.off, mod.n_out, xp.clone()))
            elif isinstance(mod, Resampler):
                self.poly.setdefault(
                    (mod.plan.L, mod.plan.M, tuple(args[0].shape)),
                    (mod.G, mod.m0, mod.n_out, args[0].contiguous().clone()))

        def resolve(K, window, impl, device):
            kind, route = self._resolve(K, window, impl, device)
            if kind != "cm":
                return kind, route

            def rec(Lsys, Lp):
                self.bcjr.setdefault((K, Lsys.shape[1]),
                                     (route, Lsys.clone(), Lp.clone()))
                return route(Lsys, Lp)
            return kind, rec
        self._hook = torch.nn.modules.module.register_module_forward_pre_hook(hook)
        turbo._resolve_bcjr = resolve

    def close(self):
        self._hook.remove()
        self._turbo._resolve_bcjr = self._resolve


def phase_runtime(dev, card, report):
    """The runtime path: the scenario runner (apps.dectnrp_main.run, as
    `python -m dectnrp_tpu_torch.apps.dectnrp_main <dir> --ticks N` runs it)
    over the committed simulator configurations, then the exchanges of
    tools/run_tpu_runtime_check.py (runtime_check: beacons at 1.728 and
    1.92 Ms/s, the 2 x 2 N_SS = 2 exchange), each gated, its kernels
    counted: B1 as one window (windowed only at the 2 x 2 exchange's PDC,
    K = 880), B2 once a sync chunk (and once a
    loopback point), B3 once a front-end step and a resampled TX burst and
    never at the DECT rate, B4 never. Returns (launches on the path, the
    inputs caught for phase 7c)."""
    from dectnrp_tpu_torch import runtime_check as rc
    from dectnrp_tpu_torch.apps import dectnrp_main
    from dectnrp_tpu_torch.upper.p2p import AssocState
    from dectnrp_tpu_torch.upper.runtime import ResampledFrontEnd

    zero_counts()
    catch = RuntimeCatch()
    runs, t_path = {}, time.perf_counter()
    try:
        for name, ticks, n_dg in RT_SCENARIOS:
            c0, t0 = counts(), time.perf_counter()
            argv = [str(ROOT / "configurations" / name), "--ticks", str(ticks)]
            if n_dg:
                argv += ["--datagrams", str(n_dg)]
            run, recs = dectnrp_main.run(argv)
            torch.cuda.synchronize()
            d = launched_since(c0)
            fws, rts = run.firmwares, run.runtimes
            extra_sync = 0
            if name == "rtt_simulator":
                require([r["firmware"] for r in recs] == [{"tx": n_dg, "rx": n_dg}] * 2
                        and fws[0].app_rx == dectnrp_main.datagrams(n_dg)
                        and all(r["runtime"]["pdc_err"] == 0 for r in recs),
                        f"rtt_simulator: {n_dg} round trips not all returned "
                        f"without a PDC error ({recs})")
            elif name == "p2p_simulator":
                require(fws[1].state is AssocState.ASSOCIATED
                        and fws[1].stats["beacons"] >= 2,
                        f"p2p_simulator: PT {fws[1].state}, {fws[1].stats}")
            elif name == "loopback_simulator":
                res = fws[0].results
                require(sorted(res) == [1, 2] and all(
                    r["experiment_range"]["snr_vec"][-1] == 20.0
                    and r["result"]["PER_pdc_crc"][-1] == 0.0
                    and r["result"]["PER_pcc_crc"][-1] == 0.0
                    for r in res.values()),
                    f"loopback_simulator: PER records at 20 dB {res}")
                extra_sync = sum(len(r["experiment_range"]["snr_vec"])
                                 for r in res.values())
            runs[name] = {"records": recs, "launches": d,
                          "seconds": time.perf_counter() - t0,
                          **rt_tick_stats(run.tick_ms, run.driver.spp,
                                          run.driver.vspace.cfg.samp_rate, len(rts)),
                          "want": {"sync": sum(r.stats.chunks for r in rts) + extra_sync,
                                   "polyphase": rt_pumps(rts)}}
        for kind in ("dect", "sdr", "mimo"):
            c0, t0 = counts(), time.perf_counter()
            ex = rc.build(kind, dev)
            got = rc.run(ex, sync=torch.cuda.synchronize)
            d = launched_since(c0)
            require(got["ok"] and got["tx_late"] == 0,
                    f"runtime exchange {kind}: not every beacon decoded with its "
                    f"payload, or a TX late ({got})")
            rts = (ex.rt_tx, ex.rt_rx)
            n_tx_resampled = sum(r.stats.tx_packets for r in rts
                                 if isinstance(r.front_end, ResampledFrontEnd))
            runs[f"exchange_{kind}"] = {
                **{k: v for k, v in got.items() if k not in ("tx_stats",)},
                "launches": d, "seconds": time.perf_counter() - t0,
                **rt_tick_stats(ex.tick_ms, rc.SPP, rc.KINDS[kind][2], 2),
                "want": {"sync": sum(r.stats.chunks for r in rts),
                         "polyphase": rt_pumps(rts) + n_tx_resampled}}
    finally:
        catch.close()
    path_s = time.perf_counter() - t_path
    for name, r in runs.items():
        d, w = r["launches"], r["want"]
        # every code block of the path has K < 512 (one window) but the
        # 2 x 2 exchange's PDC, K = 880 (128-step windows)
        packets = name != "basic_simulator"
        windowed = d["bcjr"] - d["bcjr_one_window"]
        require(d["sync"] == w["sync"] and d["polyphase"] == w["polyphase"]
                and (d["bcjr_one_window"] > 0 or not packets)
                and (windowed > 0) == (name == "exchange_mimo")
                and d["bcjr_bf16"] == 0
                and (d["polyphase"] > 0) == (name == "exchange_sdr"),
                f"runtime {name}: kernels not launched as expected ({d}; sync "
                f"{w['sync']}, polyphase {w['polyphase']}, bcjr as one window, "
                "windowed only in exchange_mimo, bcjr_bf16 0)")
        print(f"[{card}] runtime {name}: {r['ticks']} ticks, median "
              f"{r['tick_ms_median']:.2f} ms / mean {r['tick_ms_mean']:.2f} ms "
              f"a tick = {r['realtime_multiple']:.2f}x realtime "
              f"({r['nodes']} node(s)); "
              + ("" if not name.startswith("exchange") else
                 f"{r['tb_payload_match']}/{r['tx_sent']} beacons decoded, ")
              + "launches " + " ".join(f"{k} {v}" for k, v in d.items()),
              flush=True)
    launches = counts()
    report["runtime"] = {"path_s": path_s, "runs": runs, "launches": launches}
    print(f"[{card}] runtime: 4 scenarios and 3 exchanges passed their gates "
          f"in {path_s:.1f} s; launches on the path: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, catch


def phase_runtime_card_vs_cpu(dev, card, report):
    """The DECT-rate exchange on the card and on the CPU with the same
    vspace draws (runtime_check.cpu_draws): equal RuntimeStats, detection
    times and TBs."""
    from dectnrp_tpu_torch import runtime_check as rc

    exs = {}
    for d in (dev, "cpu"):
        exs[str(d)] = ex = rc.build("dect", d)
        got = rc.run(ex, draws=rc.cpu_draws(ex, 3), ticks=40)
        require(got["ok"], f"runtime card vs CPU: the {d} run failed its gate {got}")
    diff = rc.differences(exs[str(dev)], exs["cpu"])
    require(not diff, f"runtime card vs CPU: {diff}")
    a = exs[str(dev)]
    report["runtime_card_vs_cpu"] = {
        "rx_stats": vars(a.rt_rx.stats),
        "detection_times": a.rx_fw.detection_times,
        "pdc_snr_db": {"card": a.rx_fw.pdc_snr_db,
                       "cpu": exs["cpu"].rx_fw.pdc_snr_db}}
    print(f"[{card}] runtime: the DECT-rate exchange decides the same on the "
          "card as on the CPU (same draws): RuntimeStats, detection times "
          f"{a.rx_fw.detection_times}, {len(a.rx_fw.tbs)} TBs", flush=True)


def phase_runtime_kernels(dev, report, catch, path="runtime"):
    """The kernels on the inputs the runtime path (or the iq_ingress path,
    which runs the same runtime over the real-IQ radios) handed them
    (caught in phase_runtime / phase_iq), each held to its plain twin, then
    timed beside it and its bound. B1 at every (K, rows) the path decoded: as one window
    (K < 512: PCC 56 / 96, the minimum-length packet's PDC, the beacon's
    PDC 480, the loopback firmware's 20-row batches), bit for bit its plain
    twin and turbo._bcjr_posterior, and windowed at the 2 x 2 exchange's
    PDC (K = 880), bit for bit its plain twin; B2 on a sync chunk [1, R, 2,496] at R = 1 and 2
    (`_sync_check`); B3 on the 10/9 TX burst and the 9/10 front-end step
    (history + 1,280 radio samples), bit for bit its tiled twin and within
    POLY_TOL of its plain twin, conv1d beside it."""
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.ops.polyphase import polyphase_fir, polyphase_fir_plain

    out = {"bcjr": {}, "sync": {}, "polyphase": {}}
    require({56, 96, 480} <= {K for K, _ in catch.bcjr} and catch.sync
            and {(10, 9), (9, 10)} <= {k[:2] for k in catch.poly},
            f"{path}: inputs not caught (bcjr {sorted(catch.bcjr)}, sync "
            f"{sorted(catch.sync)}, polyphase {sorted(catch.poly)})")
    out["bcjr"] = bcjr_caught(catch, path, dev)
    for shape, (s, ys) in sorted(catch.sync.items()):
        label = f"{list(shape)}_b{s.P // 16}".replace(" ", "")
        err, err_t = _sync_check(s, ys, f"{path}_{label}", report)
        sargs = (s.P, s.w, s.sl, s.sr, s.params.metric_threshold,
                 s.params.metric_max)
        b_ms, b_by = bound(*sync_work(*ys.shape, s.P, s.n_pat))
        out["sync"][label] = {
            "max_abs_err": err, "max_abs_err_tiled": err_t,
            "ms": 1e-3 * graph_us(lambda: sync_detect.detect_sm(ys, *sargs)),
            "eager_ms": cuda_ms(lambda: sync_detect.detect_sm(ys, *sargs)),
            "plain_ms": 1e-3 * graph_us(
                lambda: sync_detect.detect_sm_plain(ys, *sargs), reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    for (L_, M_, shape), (G, m0, n_out, x) in sorted(catch.poly.items()):
        label = f"{L_}/{M_}_{list(shape)}".replace(" ", "")
        got = polyphase_fir(x, G, L_, M_, m0, n_out)
        want = polyphase_fir_plain(x, G, L_, M_, m0, n_out)
        tiled = poly_tiled(x, G, L_, M_, m0, n_out)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_t = (got - tiled).abs().max().item()
        require(torch.isfinite(got).all() and torch.allclose(got, want, **POLY_TOL)
                and torch.equal(got, tiled), f"{path} polyphase {label}: kernel "
                f"vs plain max |err| {err}, vs tiled twin {err_t} (must be 0)")
        b_ms, b_by = bound(*poly_work(G, L_, x.numel() // x.shape[-1],
                                      x.shape[-1], n_out))
        out["polyphase"][label] = {
            "max_abs_err": err, "max_abs_err_tiled": err_t,
            **poly_times(x, G, L_, M_, m0, n_out), "bound_ms": b_ms,
            "bound_by": b_by}
    return out


def bcjr_caught(catch, path, dev):
    """B1 on each (K, rows) a path handed it (caught by RuntimeCatch): the
    decoder's route must be the kernel (windowed from K = 512, else one
    window), bit for bit its plain twin (and, as one window,
    turbo._bcjr_posterior), then timed beside them and its bound."""
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior

    out = {}
    for (K, rows), (route, Lsys, Lp) in sorted(catch.bcjr.items()):
        windowed = K >= 512
        lw = (128, 32) if windowed else (K + 3, 0)
        require(route.func is bcjr_cuda.bcjr_posterior_cm
                and route.keywords == {"K": K, "Lw": lw[0], "D": lw[1]},
                f"{path} BCJR K={K}: the decoder does not take the kernel")
        got = route(Lsys, Lp)
        twin = bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, *lw)
        if windowed:
            def plain():
                return bcjr_cuda.bcjr_windowed_cm_plain(Lsys, Lp, K, *lw)
            unw = twin
        else:
            Ls_r, Lp_r = Lsys.T.contiguous(), Lp.T.contiguous()
            La = torch.zeros((rows, K), device=dev)

            def plain():
                return _bcjr_posterior(Ls_r, Lp_r, La, K)
            unw = plain().T
        torch.cuda.synchronize()
        label = f"K{K}_{rows}{'cb' if windowed else 'rows_one_window'}"
        err = (got - twin).abs().max().item()
        require(torch.isfinite(got).all() and torch.equal(got, twin)
                and torch.equal(got, unw), f"{path} BCJR {label}: kernel vs "
                f"plain twin max |err| {err}, vs turbo._bcjr_posterior "
                f"{(got - unw).abs().max().item()} (must be 0)")
        b_ms, b_by = bound(*bcjr_work(K, rows, windowed))
        out[label] = {
            "max_abs_err": err, "ms": 1e-3 * graph_us(lambda: route(Lsys, Lp)),
            "eager_ms": cuda_ms(lambda: route(Lsys, Lp)),
            "plain_ms": cuda_ms(plain, reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return out


def phase_runtime_stages(dev, card, report):
    """Where a runtime tick's host time goes, per layer: one exchange at
    each rate (40 ticks) with every stage wrapped in device synchronizations
    and host clocks: the vspace tick (TX assembly, the ether on the card,
    the RX rings), the 9/10 front end, sync per chunk, the PCC stage's and
    the PDC stage's stream RX, TX synthesis (with the 10/9 resampler at
    1.92 Ms/s) and scheduling, and the firmware callbacks; the rest of the
    tick is the runtime's own host logic. The synchronizations lengthen
    the ticks; their unwrapped time is phase 6d's."""
    from dectnrp_tpu_torch import runtime_check as rc
    from dectnrp_tpu_torch.upper.runtime import ResampledFrontEnd, _min_len_psdef

    res = {}
    for kind in ("dect", "sdr"):
        ex = rc.build(kind, dev)
        acc, n = Counter(), Counter()

        def timed(fn, key):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                acc[key] += (time.perf_counter() - t0) * 1e3
                n[key] += 1
                return out
            return call

        ex.drv.vspace.tick = timed(ex.drv.vspace.tick, "vspace_tick")
        for rt in (ex.rt_tx, ex.rt_rx):
            rt._sync = timed(rt._sync, "sync")
            if isinstance(rt.front_end, ResampledFrontEnd):
                rt.front_end.step = timed(rt.front_end.step, "resample_rx")

            def rx_stream(psdef, *a, rt=rt, orig=rt._rx_stream):
                pcc = psdef == _min_len_psdef(rt.u, rt.b, psdef.tm_mode_index)
                return timed(orig, "pcc" if pcc else "pdc")(psdef, *a)
            rt._rx_stream = rx_stream
            rt._transmit = timed(rt._transmit, "tx")
            for name in ("work_start", "work_regular", "work_irregular",
                         "work_pcc", "work_pcc_error", "work_pdc",
                         "work_pdc_error"):
                setattr(rt.tpoint, name, timed(getattr(rt.tpoint, name),
                                               "firmware"))
        got = rc.run(ex, ticks=40, sync=torch.cuda.synchronize)
        require(got["ok"], f"runtime stages {kind}: the exchange failed {got}")
        total = sum(ex.tick_ms[1:])
        first = ex.tick_ms[0]
        stages = {k: {"ms": v, "calls": n[k]} for k, v in acc.items()}
        other = total + first - sum(acc.values())
        res[kind] = {"ticks": len(ex.tick_ms), "total_ms": total + first,
                     "first_tick_ms": first, "stages": stages,
                     "runtime_host_ms": other}
        print(f"[{card}] runtime stages, {kind} exchange, 40 ticks with each "
              f"stage synchronized ({total + first:.1f} ms, first tick "
              f"{first:.1f}): " + "; ".join(
                  f"{k} {v['ms']:.1f} ms / {v['calls']} calls"
                  for k, v in sorted(stages.items(), key=lambda kv: -kv[1]["ms"]))
              + f"; runtime host logic {other:.1f} ms", flush=True)
    report["runtime_stages"] = res


def phase_profile_runtime(dev, card, report):
    """torch.profiler over one beacon exchange at each rate (runtime_check,
    built and run until every beacon is decoded): device events, busy ms,
    idle share."""
    from dectnrp_tpu_torch import runtime_check as rc

    res = {}
    for kind in ("dect", "sdr"):
        ev, wall_ms, busy_ms, top = profile_device(
            lambda: rc.run(rc.build(kind, dev)), f"runtime {kind}")
        res[kind] = {"wall_ms": wall_ms, "n_device_events": len(ev),
                     "busy_union_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                     "top": [[n, c, ms] for n, (c, ms) in top]}
        print(f"[{card}] profile (torch.profiler, device activity, one {kind} "
              f"exchange incl. its build): {len(ev)} device events, busy "
              f"{busy_ms:.1f} ms in {wall_ms:.1f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; top: " + "; ".join(
                  f"{n[:48]} x{c} {ms:.2f} ms" for n, (c, ms) in top[:5]),
              flush=True)
    (OUT / "profile_runtime.json").write_text(json.dumps(res, indent=1))
    report["runtime_profile"] = res


# ---------------------------------------------------------------- iq_ingress

# ticks of configurations/socket_radio through dectnrp_main.run: the TX
# pacer starts within 0.25 s (a few ticks of RADIO_WAIT_S), then a tick
# waits for spp = 2048 samples, so 40,000 samples arrive in ~20 ticks even
# when the runtime keeps up with the radio
SOCKET_TICKS = 24


def phase_iq(dev, card, report):
    """The iq_ingress path: the runtime over the real-IQ radios (radio/
    hw_iq.py over the native host runtime) at the socket_radio
    configuration's sizes (1.92 Ms/s, spp 2048, 1 Mi-sample ring, u = 1,
    b = 1, chunk 2048 + 4 * 112, 1 antenna), each part gated:
      (a) three packets of iq_check.PSDEF synthesized and resampled 10/9 on
          the card, written to a cf32 file at 25 dB, read free-running by
          HwIqStream into NodeRuntime on the card: all 3 TBs, no overrun,
          the whole file delivered, and the same RuntimeStats, detection
          times and TBs as on the CPU; B2 once a chunk, B3 once a 1,280-
          sample front-end step and once a TX burst, B1 as one window
          only, B4 never;
      (b) configurations/socket_radio through apps.dectnrp_main.run (a copy
          with a free UDP port): its paced TX zeros come back on its RX
          ring (>= 40,000 samples), the runtime syncs chunks, nothing
          malformed;
      (c) three bursts through the paced UDP egress looped into the
          ingress, the runtime decoding as they arrive: nothing malformed,
          late or unsent (the TBs decoded, the overruns and the seconds
          are recorded: they depend on the runtime's speed); and the same
          bursts on 4 antennas from a 4-antenna egress (65,536-byte chunks
          split into whole-sample datagrams) back bit for bit on a
          4-antenna ring;
      (d) apps.rtt through the application layer: SocketServer -> node 0's
          TfwRtt -> the virtual ether on the card -> node 1's echo ->
          SocketClient -> run_rtt, >= 1 of 2 datagrams back.
    The PHY modules are built and run once before it starts (iq_check.
    prewarm). Returns (launches on the path, the card inputs caught)."""
    import shutil
    import tempfile
    import threading

    from dectnrp_tpu_torch import iq_check as iq
    from dectnrp_tpu_torch.application.socket_app import SocketClient, SocketServer
    from dectnrp_tpu_torch.apps import dectnrp_main
    from dectnrp_tpu_torch.apps.rtt import run_rtt
    from dectnrp_tpu_torch.common.native import (NativeIqSocketProducer,
                                                 NativeRingBuffer,
                                                 NativeTxConsumer,
                                                 native_available)
    from dectnrp_tpu_torch.radio.hw_iq import write_iq_file
    from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator, SimDriver
    from dectnrp_tpu_torch.simulation.topology import Position, Trajectory
    from dectnrp_tpu_torch.simulation.vspace import VNodeConfig, VSpaceConfig
    from dectnrp_tpu_torch.upper.misc import TfwRtt
    from dectnrp_tpu_torch.upper.runtime import NodeRuntime

    require(native_available(), "iq_ingress: the native host runtime "
            "(native/dectnrp_rt.cc) did not build")
    iq.prewarm(dev)
    res = {}
    tmp = tempfile.TemporaryDirectory()
    zero_counts()
    catch = RuntimeCatch()
    t_path = time.perf_counter()
    try:
        # (a) file ingress, free-running, on the card and on the CPU
        c0, t0 = counts(), time.perf_counter()
        stream, payloads = iq.ingress_stream(device=dev)
        path = pathlib.Path(tmp.name) / "ingress_1p92.cf32"
        n_chunks = write_iq_file(path, stream, spp=iq.SPP)
        hw, rt, fw = iq.run_file(path, payloads, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d = launched_since(c0)
        t1 = time.perf_counter()
        _, rt_c, fw_c = iq.run_file(path, payloads, "cpu")
        cpu_secs = time.perf_counter() - t1
        require(fw.tb_match == len(payloads) == 3 and hw.read_overruns == 0
                and hw.rx_time_passed == n_chunks * iq.SPP,
                f"iq_ingress file: {fw.tb_match}/3 TBs, {hw.read_overruns} "
                f"overruns, {hw.rx_time_passed} of {n_chunks * iq.SPP} samples "
                f"delivered ({rt.stats})")
        require(vars(rt.stats) == vars(rt_c.stats)
                and fw.detection_times == fw_c.detection_times
                and len(fw.tbs) == len(fw_c.tbs)
                and all(np.array_equal(a, b) for a, b in zip(fw.tbs, fw_c.tbs)),
                f"iq_ingress file: the card decides otherwise than the CPU "
                f"({rt.stats} / {rt_c.stats}; {fw.detection_times} / "
                f"{fw_c.detection_times})")
        pumps = rt_pumps([rt])
        require(d["sync"] == rt.stats.chunks and d["polyphase"] == pumps + 3
                and d["bcjr_one_window"] > 0 and d["bcjr"] == d["bcjr_one_window"]
                and d["bcjr_bf16"] == 0,
                f"iq_ingress file: kernels not launched as expected ({d}; sync "
                f"{rt.stats.chunks}, polyphase {pumps} front-end steps + 3 TX "
                "bursts, bcjr as one window only, bcjr_bf16 0)")
        res["file"] = {"samples": hw.rx_time_passed, "tb_decoded": fw.tb_match,
                       "read_overruns": hw.read_overruns,
                       "stats": vars(rt.stats),
                       "detection_times": fw.detection_times,
                       "front_end_steps": pumps, "launches": d,
                       "seconds": secs, "cpu_seconds": cpu_secs,
                       "realtime_multiple": hw.rx_time_passed / iq.RATE / secs}
        print(f"[{card}] iq_ingress (a) file ingress, free-running: "
              f"{fw.tb_match}/3 TBs, {rt.stats.chunks} chunks, {pumps} front-"
              f"end steps, 0 overruns, {secs:.2f} s on the card (TX synthesis "
              f"included; CPU {cpu_secs:.2f} s), decisions equal to the CPU's "
              f"(detections at {fw.detection_times}); launches "
              + " ".join(f"{k} {v}" for k, v in d.items()), flush=True)

        # (b) configurations/socket_radio through the scenario runner
        c0, t0 = counts(), time.perf_counter()

        def run_socket_radio(port):
            cfg = pathlib.Path(tmp.name) / f"socket_radio_{port}"
            shutil.copytree(ROOT / "configurations" / "socket_radio", cfg)
            radio = json.loads((cfg / "radio.json").read_text())
            radio["hws"][0].update(rx_port=port, tx_sink=f"udp:{port}")
            (cfg / "radio.json").write_text(json.dumps(radio))
            return dectnrp_main.run([str(cfg), "--ticks", str(SOCKET_TICKS),
                                     "--device", str(dev)])
        # a bind that loses its port to another process (PortInUse, raised
        # while the scenario is built, before its first tick) is the only
        # error retried: any other fails the phase at once
        run, recs = iq.on_free_port(run_socket_radio)
        try:
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            hw, rt = run.hws[0], run.runtimes[0]
            d = launched_since(c0)
            pumps = rt_pumps([rt])
            require(hw.rx_time_passed >= 40000 and rt.stats.chunks > 0
                    and hw.producer.malformed == 0 and run.driver is None,
                    f"iq_ingress socket_radio: {hw.rx_time_passed} samples, "
                    f"{rt.stats.chunks} chunks, {hw.producer.malformed} malformed")
            # an overrun skips front-end steps the ring no longer holds: B3
            # runs once a step that was read
            require(d["sync"] == rt.stats.chunks and 0 < d["polyphase"] <= pumps
                    and (d["polyphase"] == pumps or hw.read_overruns > 0)
                    and d["bcjr_bf16"] == 0,
                    f"iq_ingress socket_radio: kernels not launched as expected "
                    f"({d}; sync {rt.stats.chunks}, polyphase {pumps} steps, "
                    f"fewer only after an overrun ({hw.read_overruns}))")
            res["socket_radio"] = {
                "ticks": SOCKET_TICKS, "samples": hw.rx_time_passed,
                "datagrams": hw.producer.datagrams,
                "malformed": hw.producer.malformed,
                "read_overruns": hw.read_overruns, "stats": vars(rt.stats),
                "front_end_steps": pumps, "launches": d, "seconds": secs,
                "tick_ms_median": statistics.median(run.tick_ms),
                "tick_ms_max": max(run.tick_ms)}
        finally:
            run.close()
        print(f"[{card}] iq_ingress (b) configurations/socket_radio, "
              f"{SOCKET_TICKS} ticks through dectnrp_main.run: "
              f"{res['socket_radio']['samples']} samples back on the RX ring, "
              f"{rt.stats.chunks} chunks, 0 malformed, "
              f"{res['socket_radio']['read_overruns']} overruns, {secs:.2f} s; "
              "launches " + " ".join(f"{k} {v}" for k, v in d.items()), flush=True)

        # (c) paced UDP egress looped into the ingress, and 4 antennas
        c0 = counts()
        bursts, payloads, _ = iq.packet_bursts(3, 11, dev)
        lb = iq.socket_loopback(bursts, payloads, dev)
        torch.cuda.synchronize()
        lb["launches"] = launched_since(c0)
        require(lb["malformed"] == 0 and lb["late_bursts"] == 0
                and lb["send_errors"] == 0 and lb["order_violations"] == 0
                and lb["launches"]["bcjr_bf16"] == 0,
                f"iq_ingress loopback: the wire failed {lb}")
        n_ant, n_up = 4, bursts[0].shape[-1]
        ring = NativeRingBuffer(iq.RING, n_ant)
        try:
            prod, port = iq.on_free_port(lambda p: (NativeIqSocketProducer(
                ring, p, max_samples_per_dgram=4096), p))
            txc = NativeTxConsumer(f"udp:{port}", n_ant=n_ant, spp=iq.SPP,
                                   rate_hz=float(iq.RATE), deferred_start=True)
            rot = np.exp(0.5j * np.pi * np.arange(n_ant))[:, None]
            b4 = [(b * rot).astype(np.complex64) for b in bursts]
            times = [iq.SPP + i * (n_up + iq.GAP) for i in range(len(b4))]
            for i, (t, b) in enumerate(zip(times, b4)):
                txc.schedule(i, t, b)
            txc.start()
            end, deadline = times[-1] + n_up, time.time() + 10.0
            while ring.time < end + iq.SPP and time.time() < deadline:
                time.sleep(0.01)
            wire = {"samples": ring.time, "late_bursts": txc.late_bursts,
                    "send_errors": txc.send_errors,
                    "malformed": prod.malformed,
                    "bit_equal": ring.time >= end and all(
                        np.array_equal(ring.read(t, n_up), b)
                        for t, b in zip(times, b4))}
            txc.close()
        finally:
            ring.close()
        require(wire["bit_equal"] and wire["late_bursts"] == 0
                and wire["send_errors"] == 0 and wire["malformed"] == 0,
                f"iq_ingress 4-antenna egress: {wire}")
        lb["four_antennas"] = wire
        res["loopback"] = lb
        print(f"[{card}] iq_ingress (c) paced UDP egress looped into the "
              f"ingress: {lb['tb_decoded']}/3 TBs decoded in {lb['seconds']:.2f} "
              f"s, {lb['read_overruns']} overruns (recorded, not gated), 0 "
              f"malformed / late / unsent; 4 antennas: 3 bursts back bit for "
              f"bit; launches " + " ".join(f"{k} {v}" for k, v
                                           in lb["launches"].items()), flush=True)

        # (d) apps.rtt over the air through the application layer
        c0, t0 = counts(), time.perf_counter()
        hws = [HwSimulator(1), HwSimulator(1)]
        drv = SimDriver(VSpaceConfig(samp_rate=1_728_000.0, spp_len=2048,
                                     noise_var=1e-8), hws,
                        [VNodeConfig(1, Trajectory(Position(0, 0, 0))),
                         VNodeConfig(1, Trajectory(Position(1.0, 0, 0)))], dev)
        srv, out_srv = SocketServer([0]), SocketServer([0])
        net = iq.IDENT.network_id
        try:
            fw0, fw1 = TfwRtt(net, 0x2222), TfwRtt(net, 0x3333, echo=True)
            rt0 = NodeRuntime(hws[0], fw0, net, app_server=srv,
                              app_client=SocketClient(out_srv.bound_ports),
                              device=dev)
            rt1 = NodeRuntime(hws[1], fw1, net, device=dev)
            got = {}
            th = threading.Thread(target=lambda: got.setdefault("res", run_rtt(
                srv.bound_ports[0], out_srv.bound_ports[0], n=2,
                payload_bytes=24, timeout_s=30.0)), daemon=True)
            th.start()
            ticks = 0
            while th.is_alive() and ticks < 400:
                drv.tick()
                rt0.process()
                rt1.process()
                ticks += 1
            th.join(timeout=35.0)
        finally:
            srv.stop()
            out_srv.stop()
        torch.cuda.synchronize()
        rtt = got.get("res")
        d = launched_since(c0)
        require(rtt is not None and rtt.n >= 1 and d["bcjr_bf16"] == 0,
                f"iq_ingress rtt: no datagram came back ({fw0.stats}, "
                f"{fw1.stats}, {rt0.stats}, {rt1.stats})")
        res["rtt"] = {**rtt.summary(), "ticks": ticks, "launches": d,
                      "seconds": time.perf_counter() - t0,
                      "stats": [vars(rt0.stats), vars(rt1.stats)]}
        print(f"[{card}] iq_ingress (d) apps.rtt over the air through the "
              f"application layer: {rtt.n}/2 back ({rtt.summary()}), {ticks} "
              "ticks; launches " + " ".join(f"{k} {v}" for k, v in d.items()),
              flush=True)
    finally:
        catch.close()
        tmp.cleanup()
    launches = counts()
    res["path_s"] = time.perf_counter() - t_path
    res["launches"] = launches
    report["iq_ingress"] = res
    print(f"[{card}] iq_ingress: (a)-(d) passed their gates in "
          f"{res['path_s']:.1f} s; launches on the path: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return launches, catch


OPT_B, OPT_B_FADE, OPT_N_CPU = 64, 16, 2


def phase_options(dev, card, report):
    """The phy_options path (dectnrp_tpu_torch/options_check.py) at the
    flagship's width, (1, 16, 1, 4, 0, 4, 6144) and B = 64 packets: (a) TX
    windowing, (b) beamforming over every codebook entry of tm 3 (and the
    codebook search on tm 1 soundings), (c) beta / integer CFO and the RMS
    gate on [64, 1, 192,512] streams, (d) every chestim option through
    build_rx_stream (AWGN gated, 16 fading packets recorded, 2 of them on
    the CPU too), (e) the MMIE round trip; each part gated, every kernel's
    count set to 0 before it and read after it. B1 in (a), (b), (d) and
    (e); B2 exactly once a sync: 4 in (c), 2 in (d), none elsewhere; B3
    and B4 never (the x4 upsampled stream of (c) is made before its count
    starts). Returns (launches on the path, the B1 inputs caught, the
    ungated and gated Sync modules with the streams they took)."""
    from dectnrp_tpu_torch import options_check as oc

    from dectnrp_tpu_torch.loopback import FLAGSHIP_PSDEF as F

    T = 192512
    res, launches = {}, Counter()
    catch = RuntimeCatch()
    t_path = time.perf_counter()

    def part(name, fn, want):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        d = counts()
        secs = time.perf_counter() - t0
        require(all((d[k] > 0) if v == ">0" else d[k] == v
                    for k, v in want.items()),
                f"phy_options ({name}): kernels not launched as expected "
                f"({d}; want {want})")
        launches.update(d)
        res[name] = {"result": out, "launches": d, "seconds": secs}
        print(f"[{card}] phy_options ({name}) passed its gates in {secs:.2f} s: "
              f"{json.dumps(out if name != 'sync' else out['summary'])[:900]}; "
              "launches " + " ".join(f"{k} {v}" for k, v in d.items()), flush=True)
        return out

    none = {"sync": 0, "polyphase": 0, "bcjr_bf16": 0}
    try:
        part("windowing", lambda: oc.windowing(F, OPT_B, dev),
             {"bcjr": ">0", "bcjr_one_window": ">0", **none})
        part("beamforming", lambda: oc.beamforming(oc.with_tm(F, 3), 1, OPT_B, dev),
             {"bcjr": ">0", "bcjr_one_window": ">0", **none})
        inp = oc.sync_inputs(F, OPT_B, T, dev)
        syn = part("sync", lambda: oc.sync(inp, dev),
                   {"bcjr": 0, **none, "sync": 4})
        part("chestim", lambda: oc.chestim(F, OPT_B, OPT_B_FADE, T, dev,
                                           n_cpu=OPT_N_CPU),
             {"bcjr": ">0", **none, "sync": 2})
        part("mmie", lambda: oc.mmie(dev),
             {"bcjr": ">0", "bcjr_one_window": ">0", **none})
    finally:
        catch.close()
    for name in res:
        if name == "sync":
            res[name]["result"] = res[name]["result"]["summary"]
    res["path_s"] = time.perf_counter() - t_path
    res["launches"] = dict(launches)
    report["phy_options"] = res
    print(f"[{card}] phy_options: (a)-(e) passed their gates in "
          f"{res['path_s']:.1f} s; launches on the path: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return dict(launches), catch, syn


def phase_options_kernels(dev, report, catch, syn):
    """7f: B1 on every (K, rows) the phy_options path handed it (one window
    at the PCC's and the MMIE packet's K, windowed at the flagship's PDC),
    bit for bit its plain twin (`bcjr_caught`); B2 on the [64, 1, 192,512]
    streams of its sync part with the RMS gate off and on (`_sync_check`:
    the plain twin off gate ties, the tiled twin), each timed beside its
    plain twin and bound, gate off and on in turns (off, on, on, off)."""
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.ops import sync_detect

    require(catch.bcjr and {56, 96} <= {K for K, _ in catch.bcjr},
            f"phy_options: B1 inputs not caught ({sorted(catch.bcjr)})")
    out = {"bcjr": bcjr_caught(catch, "phy_options", dev), "sync": {}}
    runs = {}
    for gated, (s, ys) in (("off", syn["ungated"]), ("on", syn["gated"])):
        label = f"{list(ys.shape)}_b{s.P // 16}_rms_gate_{gated}".replace(" ", "")
        err, err_t = _sync_check(s, ys, f"phy_options_{label}", report)
        pr = s.params
        sargs = (s.P, s.w, s.sl, s.sr, pr.metric_threshold, pr.metric_max)
        gate = {"rms_min": pr.rms_min, "rms_max": pr.rms_max}
        runs[gated] = lambda sargs=sargs, gate=gate, ys=ys: sync_detect.detect_sm(
            ys, *sargs, **gate)
        b_ms, b_by = bound(*sync_work(*ys.shape, s.P, s.n_pat))
        out["sync"][label] = {
            "max_abs_err": err, "max_abs_err_tiled": err_t,
            "rms_min": pr.rms_min,
            "eager_ms": cuda_ms(runs[gated]),
            "plain_ms": 1e-3 * graph_us(lambda sargs=sargs, gate=gate, ys=ys:
                                        sync_detect.detect_sm_plain(ys, *sargs, **gate),
                                        reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    # the gate's cost: graph replays in turns on the same streams
    turns = [1e-3 * graph_us(runs[g]) for g in ("off", "on", "on", "off")]
    for label, v in out["sync"].items():
        v["ms"] = turns[0] if label.endswith("off") else turns[1]
        v["ms_again"] = turns[3] if label.endswith("off") else turns[2]
    return out


MC_SHARDS = 8
# (label, u, b, chunk, n_chunks, psdef, offsets as (chunk, sample in it),
# metric threshold): mid-shard, straddling a chunk boundary, straddling the
# shard boundary chunk 7 -> 8, within the last shard. b = 16 is the
# flagship's numerology (75.9 ms of 27.648 Ms/s radio time); b = 1 at chunk
# 8,192 is the SCALING_r04 chunk (tests/test_sync_sharded.py:100). At b = 1
# the 112-sample STF lets noise graze the default 0.25 gate about once in
# 50,000 samples (the same in the sharded and the dense search, and in the
# JAX package): the b = 1 stream is searched at 0.35, as
# tests/test_sync_sharded.py's noise case is, and its hits at 0.25 recorded
MC_SYNC = (("b16", 1, 16, 32768, 64, (1, 16, 1, 4, 0, 4, 6144),
            ((3, 4000), (10, -1000), (8, -900), (60, 5000)), 0.25),
           ("b1", 1, 1, 8192, 64, (1, 1, 0, 2, 0, 2, 6144),
            ((3, 3000), (10, -50), (8, -60), (60, 1234)), 0.35))


def mc_stream(psdef, offs, T, gen, dev, seed):
    """[1, T] on the card: packets of psdef (TB and PLCF bits from numpy
    `seed`) at offs, AWGN at 15 dB (multichip.make_stream)."""
    from dectnrp_tpu_torch.multichip import make_stream
    from dectnrp_tpu_torch.sections.part3.packet_sizes import (PacketSizesDef,
                                                               get_packet_sizes)

    psdef = PacketSizesDef(*psdef)
    rng = np.random.default_rng(seed)
    plcf = rng.integers(0, 2, (len(offs), 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (len(offs), get_packet_sizes(psdef).N_TB_bits)
                      ).astype(np.uint8)
    noise = torch.randn((1, T), dtype=torch.complex64, generator=gen, device=dev)
    return make_stream(plcf, tb, offs, T, noise, psdef)


def mc_sync_case(case, dev, gen, seed):
    """(a): one sharded search over MC_SHARDS shards of one card, counted;
    bit for bit the dense search (every window in one Sync call on the
    card, masked the same way); decisions equal to a CPU run of the port
    (cfo within 1e-5 where detected); dedup_reports finds exactly the
    offsets (+-2). Returns (its record, launches, the module, the stream)."""
    from dectnrp_tpu_torch.common.mesh import Mesh
    from dectnrp_tpu_torch.phy.sync import SyncParams
    from dectnrp_tpu_torch.phy.sync_sharded import (build_sync_sharded,
                                                    dedup_reports, sync_dense)

    label, u, b, chunk, n_chunks, psdef, rel, thr = case
    T = chunk * n_chunks
    offs = [c * chunk + s for c, s in rel]
    y = mc_stream(psdef, offs, T, gen, dev, seed)
    mesh = Mesh(np.array([dev] * MC_SHARDS, dtype=object), ("t",))
    pr = SyncParams(metric_threshold=thr)
    sh = build_sync_sharded(u, b, chunk, n_chunks, mesh, params=pr)
    torch.cuda.synchronize()
    zero_counts()
    secs, rep = host_ms(lambda: sh(y))
    d = counts()
    require(d["sync"] == MC_SHARDS and d["bcjr"] == d["bcjr_bf16"]
            == d["polyphase"] == 0,
            f"multichip (a) {label}: kernels not launched as expected ({d}; "
            f"sync {MC_SHARDS}, one a shard, nothing else)")
    dense = sync_dense(sh.syncs[dev], y, chunk, n_chunks, sh.overlap)
    for k in rep:
        require(torch.equal(rep[k], dense[k]),
                f"multichip (a) {label}: sharded {k} differs from the dense "
                f"search ({(rep[k] != dense[k]).sum().item()} of {n_chunks})")
    cpu = build_sync_sharded(u, b, chunk, n_chunks, Mesh(
        np.array(["cpu"] * MC_SHARDS, dtype=object), ("t",)), params=pr)(y.cpu())
    rc = {k: v.cpu() for k, v in rep.items()}
    det = cpu["detected"]
    cfo_err = (rc["cfo"][det] - cpu["cfo"][det]).abs().max().item()
    require(torch.equal(rc["detected"], det)
            and torch.equal(rc["t_global"][det], cpu["t_global"][det])
            and torch.equal(rc["n_eff_tx"][det], cpu["n_eff_tx"][det])
            and cfo_err <= 1e-5,
            f"multichip (a) {label}: card and CPU reports differ (cfo max "
            f"|err| {cfo_err})")
    found = sorted(h["t_global"] for h in dedup_reports(rc, u, b))
    require(len(found) == len(offs)
            and all(abs(f - o) <= 2 for f, o in zip(found, sorted(offs))),
            f"multichip (a) {label}: found {found}, sent {sorted(offs)}")
    at_default = None
    if thr != SyncParams().metric_threshold:
        rep0 = build_sync_sharded(u, b, chunk, n_chunks, mesh)(y)
        at_default = sorted(h["t_global"] for h in dedup_reports(
            {k: v.cpu() for k, v in rep0.items()}, u, b))
    return ({"shape": [1, T], "chunk": chunk, "n_chunks": n_chunks,
             "metric_threshold": thr, "found_at_default_threshold": at_default,
             "shards": MC_SHARDS, "window": [n_chunks // MC_SHARDS, 1,
                                             chunk + sh.overlap],
             "offsets": sorted(offs), "found": found, "sharded_ms": secs,
             "cfo_max_abs_err_cpu": cfo_err,
             "detected_chunks": int(det.sum())}, d, sh, y)


def phase_multichip(dev, card, report):
    """6g, the multichip path on one card listed MC_SHARDS times: (a) the
    time-sharded sync at b = 16 and b = 1 (mc_sync_case); (b)
    tick_sharded at N = 8 nodes, A = 4, spp 2,048 over 4 shards equal to
    the dense awgn tick on the same draws within 1e-5, no kernel; (c)
    multichip.dryrun_multichip on the 8-entry mesh (4 nodes x 2 dp): every
    phase-1 TB and PLCF, all three phase-2 packets found and decoded, B1
    in both phases, B2 once a shard in phase 2, B3 and B4 never. Counts
    set to 0 before each part and read after it. Returns (launches on the
    path, the kernels' inputs caught, the b = 16 sharded module and
    stream)."""
    from dectnrp_tpu_torch import multichip as M
    from dectnrp_tpu_torch.common.mesh import Mesh
    from dectnrp_tpu_torch.simulation import vspace

    t_path = time.perf_counter()
    res, launches = {"distinct_cards": 1, "shards": MC_SHARDS}, Counter()
    catch = RuntimeCatch()
    gen = torch.Generator(device=dev).manual_seed(41)
    try:
        for i, case in enumerate(MC_SYNC):
            res[f"sync_{case[0]}"], d, sh, y = mc_sync_case(case, dev, gen, 40 + i)
            launches.update(d)
            if case[0] == "b16":
                keep = (sh, y)

        # (b) the node-sharded vspace tick vs the dense tick
        N, A, S, nv = 8, 4, 2048, 0.1
        mesh4 = Mesh(np.array([dev] * 4, dtype=object), ("node",))
        tx = torch.randn((N, A, S), dtype=torch.complex64, generator=gen, device=dev)
        gain = torch.rand((N, N), generator=gen, device=dev)
        draws = vspace.draw_tick_sharded(gen, mesh4, N, A, S)
        zero_counts()
        got = torch.cat(vspace.tick_sharded(mesh4, tx, gain, nv, draws=draws))
        torch.cuda.synchronize()
        d = counts()
        want = vspace.apply_tick(tx, gain, None, {"noise": torch.cat(draws)},
                                 "awgn", 1_728_000.0, nv)
        err = (got - want).abs().max().item()
        require(err <= 1e-5 and not any(d.values()),
                f"multichip (b): tick_sharded vs dense max |err| {err} "
                f"(limit 1e-5), launches {d} (none)")
        res["tick_sharded"] = {"N": N, "A": A, "spp": S, "shards": 4,
                               "max_abs_err": err}

        # (c) the dry run, each phase's launches read around it
        per_phase = {}
        orig = {n: getattr(M, n) for n in ("cross_node_loopback",
                                           "sharded_sync_decode")}

        def counted(name):
            def run(*a, **k):
                c0 = counts()
                out = orig[name](*a, **k)
                torch.cuda.synchronize()
                per_phase[name] = launched_since(c0)
                return out
            return run
        try:
            for n in orig:
                setattr(M, n, counted(n))
            zero_counts()
            t0 = time.perf_counter()
            rec = M.dryrun_multichip([dev] * MC_SHARDS)
            torch.cuda.synchronize()
            dry_s = time.perf_counter() - t0
            d = counts()
        finally:
            for n, f in orig.items():
                setattr(M, n, f)
        p1, p2 = per_phase["cross_node_loopback"], per_phase["sharded_sync_decode"]
        require(rec["ok"] and (rec["n_node"], rec["n_dp"]) == (4, 2),
                f"multichip (c): dryrun_multichip failed: {M.summary(rec)}")
        require(p1["bcjr"] > 0 and p2["bcjr"] > 0 and p1["sync"] == 0
                and p2["sync"] == MC_SHARDS and d["bcjr_bf16"] == 0
                and d["polyphase"] == 0,
                f"multichip (c): kernels not launched as expected (phase 1 "
                f"{p1}, phase 2 {p2}, all {d})")
        launches.update(d)
        res["dryrun"] = {**M.summary(rec), "seconds": dry_s,
                         "launches_phase1": p1, "launches_phase2": p2}
    finally:
        catch.close()
    res["path_s"] = time.perf_counter() - t_path
    report["multichip"] = res
    s16, s1 = res["sync_b16"], res["sync_b1"]
    print(f"[{card}] multichip: {MC_SHARDS} shards on {res['distinct_cards']} "
          f"distinct card; (a) sharded sync b=16 {s16['shape']} in windows "
          f"{s16['window']} found {s16['found']} (sent {s16['offsets']}), b=1 "
          f"{s1['shape']} found {s1['found']}, each bit for bit the dense "
          f"search, = the CPU, B2 {MC_SHARDS} launches; (b) tick_sharded "
          f"[8, 4, 2048] over 4 shards max |err| {err:.3g} vs the dense tick; "
          f"(c) dryrun_multichip 4 nodes x 2 dp: phase 1 TBs "
          f"{int(rec['phase1']['tb_ok'].sum())}/{rec['phase1']['tb_ok'].size}, "
          f"phase 2 sent {rec['offsets']}, found {rec['phase2']['found']} "
          f"(false alarms {rec['phase2']['false_alarms']}), TBs decoded "
          f"{rec['phase2']['tb_ok'].tolist()} in {dry_s:.2f} s; the path "
          f"{res['path_s']:.1f} s; launches: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return dict(launches), catch, keep


def phase_multichip_kernels(dev, card, report, catch, keep):
    """7g: B2 on the windows (a)'s shards handed it at b = 16 [8, 1,
    39,936] and at b = 1 [8, 1, 8,640], held to its plain twin (off gate
    ties) and its tiled twin (`_sync_check`), then timed by graph replay
    beside its plain twin and bound; B1 on every (K, rows) the dry run
    handed it (one window), bit for bit its plain twin (`bcjr_caught`);
    the sharded search's host ms at 1, 2, 4 and 8 shards of the one card
    beside the dense single call (no gate: on one card a split adds host
    work and no speed)."""
    from dectnrp_tpu_torch.common.mesh import Mesh
    from dectnrp_tpu_torch.phy.sync_sharded import build_sync_sharded, sync_dense
    from dectnrp_tpu_torch.sections.part3.transmission_packet_structure import (
        get_N_samples_STF)

    out = {"sync": {}, "bcjr": bcjr_caught(catch, "multichip", dev)}
    for label, u, b, chunk, n_chunks, *_ in MC_SYNC:
        shape = (n_chunks // MC_SHARDS, 1, chunk + 4 * get_N_samples_STF(u, b))
        require(shape in catch.sync, f"multichip: B2 input {shape} not caught "
                f"({sorted(catch.sync)})")
        s, ys = catch.sync[shape]
        key = f"{list(shape)}_b{b}".replace(" ", "")
        out["sync"][key] = sync_entry(s, ys, f"multichip_{key}", report)
    # the sharded call's host time by shard count, beside the dense call
    sh8, y = keep
    u, b, chunk, n_chunks = 1, 16, sh8.chunk, sh8.n_chunks

    def med(fn, n=5):
        fn()
        return statistics.median(host_ms(fn)[0] for _ in range(n))
    host = {}
    for n in (1, 2, 4, 8):
        sh = build_sync_sharded(u, b, chunk, n_chunks, Mesh(
            np.array([dev] * n, dtype=object), ("t",)))
        host[f"{n}_shards"] = med(lambda: sh(y))
    host["dense"] = med(lambda: sync_dense(sh8.syncs[dev], y, chunk, n_chunks,
                                           sh8.overlap))
    report["multichip_host_ms"] = host
    print(f"[{card}] multichip: the sharded search of [1, {chunk * n_chunks}] "
          f"(b=16, {n_chunks} chunks) on one card, host ms (median of 5): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()), flush=True)
    return out


def phase_multiprocess(dev, card, report):
    """6h, the multiprocess path: dcn_dryrun's (a) ether tick, (b) four
    channels and (c) the process-spanning flagship-numerology search in two
    spawned processes joined by gloo (common/dist.py), each holding the
    card as its shards (2 a process in (a) and (b), 4 in (c)), every gate
    of dcn_dryrun held; then scaling at its full sizes in this process,
    every row held to the dense output. Each child counts its launches a
    part: none in (a), B1 in (b), B2 once a shard in (c), B3 and B4 never;
    each scaling row counts those of its one held sharded call (B2 once a
    shard in the sync rows, none in the tick rows; its dense oracle,
    warm-up and timed calls are not counted). The path's launches are
    those counts summed. The library is built here first, so the children
    only load it."""
    from dectnrp_tpu_torch import dcn_dryrun, kernels, scaling

    kernels.load()
    t_path = time.perf_counter()
    rec = dcn_dryrun.run("cuda", backend="gloo")
    dcn_s = time.perf_counter() - t_path
    require(rec["ok"] and rec["backend"] == "gloo"
            and rec["distinct_devices"] == 1 and len(rec["reports"]) == 2,
            f"multiprocess: dcn_dryrun failed its gates {rec['gates']} "
            f"(backend {rec['backend']}, {rec['distinct_devices']} card)")
    launches = Counter()
    for r in rec["reports"]:
        la, lb, lc = (r[k]["launches"] for k in ("ether", "channels", "sync"))
        require(not any(la.values())
                and lb["bcjr"] > 0 and lb["sync"] == 0
                and lc["sync"] == dcn_dryrun.SYNC_LOCAL and lc["bcjr"] == 0
                and lb["polyphase"] == lc["polyphase"] == 0
                and lb["bcjr_bf16"] == lc["bcjr_bf16"] == 0,
                f"multiprocess rank {r['rank']}: kernels not launched as "
                f"expected ((a) {la}, (b) {lb}, (c) {lc}; none in (a), B1 in "
                f"(b), B2 {dcn_dryrun.SYNC_LOCAL} in (c), B3 and B4 never)")
        for part in (la, lb, lc):
            launches.update(part)
    t0 = time.perf_counter()
    sc = scaling.run("cuda")
    torch.cuda.synchronize()
    sc_s = time.perf_counter() - t0
    for sec in ("sync_sharded_strong", "sync_sharded_weak", "vspace_sharded"):
        for row in sc[sec]:
            d = row["launches"]
            want_b2 = 0 if sec == "vspace_sharded" else row["n_dev"]
            require(d["sync"] == want_b2
                    and d["bcjr"] == d["bcjr_bf16"] == d["polyphase"] == 0,
                    f"multiprocess scaling {sec} at {row['n_dev']} shards: "
                    f"kernels not launched as expected ({d}; B2 {want_b2}, "
                    f"no other)")
            launches.update(d)
    res = {"dcn": rec, "dcn_s": dcn_s, "scaling": sc, "scaling_s": sc_s,
           "path_s": time.perf_counter() - t_path}
    report["multiprocess"] = res
    r0, r1 = rec["reports"]
    s0 = r0["sync"]
    print(f"[{card}] multiprocess: 2 processes over gloo, each holding the one "
          f"card; (a) tick_sharded N=4 over 2 x 2 shards max |err| "
          f"{max(r['ether']['ether_max_err'] for r in rec['reports']):.3g} vs the "
          f"host superposition (limit {dcn_dryrun.ETHER_TOL}), bit for bit the "
          f"one-process tick; (b) TBs {r0['channels']['channels_decoded_ok']}/4 "
          f"and {r1['channels']['channels_decoded_ok']}/4; (c) the search of "
          f"{s0['stream']} over 2 x {dcn_dryrun.SYNC_LOCAL} shards (windows "
          f"{s0['window']}) found {s0['found']} (sent {s0['offsets']}), bit for "
          f"bit the one-process 8-shard and dense searches; host ms a call "
          f"(mean of {dcn_dryrun.TIMED}): spanning {s0['spanning_ms']:.2f} / "
          f"{r1['sync']['spanning_ms']:.2f}, one process {s0['one_process_ms']:.2f}, "
          f"dense {s0['dense_ms']:.2f}; dcn_dryrun {dcn_s:.1f} s; scaling "
          f"{sc_s:.1f} s, sync strong ms by shards "
          + ", ".join(f"{r['n_dev']}: {r['ms_per_stream']:.2f}"
                      for r in sc["sync_sharded_strong"])
          + "; vspace ms by shards "
          + ", ".join(f"{r['n_dev']}: {r['ms_per_tick']:.3f}"
                      for r in sc["vspace_sharded"])
          + f"; the path {res['path_s']:.1f} s; launches: "
          + " ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return dict(launches)


def sync_entry(s, ys, label, report):
    """B2 on caught windows: held to its plain twin off gate ties and its
    tiled twin (`_sync_check`), then timed by graph replay beside its plain
    twin and bound."""
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.phy.ops import sync_detect

    err, err_t = _sync_check(s, ys, label, report)
    sargs = (s.P, s.w, s.sl, s.sr, s.params.metric_threshold, s.params.metric_max)
    b_ms, b_by = bound(*sync_work(*ys.shape, s.P, s.n_pat))
    return {"max_abs_err": err, "max_abs_err_tiled": err_t,
            "ms": 1e-3 * graph_us(lambda: sync_detect.detect_sm(ys, *sargs)),
            "eager_ms": cuda_ms(lambda: sync_detect.detect_sm(ys, *sargs)),
            "plain_ms": 1e-3 * graph_us(
                lambda: sync_detect.detect_sm_plain(ys, *sargs), reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_multiprocess_kernels(dev, report):
    """7h: the kernels on the multiprocess path's inputs, rebuilt in this
    process from the children's seeds and caught as they are handed over:
    B1 on every (K, rows) of (b)'s four channel steps (`bcjr_caught`), B2
    on rank 0's first shard's windows of (c) [8, 1, 39,936], each held to
    its twins, then timed."""
    from dectnrp_tpu_torch import dcn_dryrun as D
    from dectnrp_tpu_torch.common.mesh import Mesh
    from dectnrp_tpu_torch.phy.rx import build_rx
    from dectnrp_tpu_torch.phy.sync_sharded import build_sync_sharded
    from dectnrp_tpu_torch.phy.tx import build_tx
    from dectnrp_tpu_torch.sections.part3.packet_sizes import get_packet_sizes
    from dectnrp_tpu_torch.simulation.channels import draw_noise

    n = D.N_PROC * D.LOCAL
    catch = RuntimeCatch()
    try:
        _, _, rng = D.ether_inputs(n)
        plcf, tb = D.channel_bits(rng, n)
        ps = get_packet_sizes(D.PSDEF_CHAN)
        gen = torch.Generator(device=dev).manual_seed(D.SEEDS[1])
        noise = draw_noise(gen, (n, ps.tm_mode.N_TX, ps.N_samples_packet), dev)
        tx = build_tx(D.PSDEF_CHAN, D.NID, 1, device=dev)
        rx = build_rx(D.PSDEF_CHAN, D.NID, 1, device=dev)
        for i in range(n):
            D.channel_step(tx, rx, torch.from_numpy(plcf[i:i + 1]).to(dev),
                           torch.from_numpy(tb[i:i + 1]).to(dev), noise[i:i + 1])
        stream, _ = D.sync_stream(dev)
        n_sh = D.N_PROC * D.SYNC_LOCAL
        sh = build_sync_sharded(D.SYNC_U, D.SYNC_B, D.SYNC_CHUNK, D.SYNC_CHUNKS,
                                Mesh(np.array([dev] * n_sh, dtype=object), ("t",)))
        sh(stream)
        torch.cuda.synchronize()
    finally:
        catch.close()
    shape = (D.SYNC_CHUNKS // n_sh, 1, D.SYNC_CHUNK + sh.overlap)
    require(shape in catch.sync, f"multiprocess: B2 input {shape} not caught "
            f"({sorted(catch.sync)})")
    s, ys = catch.sync[shape]
    key = f"{list(shape)}_b{D.SYNC_B}".replace(" ", "")
    return {"sync": {key: sync_entry(s, ys, f"multiprocess_{key}", report)},
            "bcjr": bcjr_caught(catch, "multiprocess", dev)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU")
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef

    from dectnrp_tpu_torch import bcjr_bf16_turns as bf16_turns
    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.kernels import graph_us
    from dectnrp_tpu_torch.loopback import (FLAGSHIP_PSDEF, WALL_PSDEF, hw_rate,
                                            make_flagship_step, make_wall_step)
    from dectnrp_tpu_torch.phy.fec.bcjr_cuda import (
        bcjr_posterior_cm, bcjr_posterior_cm_bf16,
        bcjr_windowed_cm_bf16_plain, bcjr_windowed_cm_plain)
    from dectnrp_tpu_torch.phy.fec.turbo import _bcjr_posterior
    from dectnrp_tpu_torch.phy.ops import sync_detect
    from dectnrp_tpu_torch.phy.resampler import (ResamplerPlan, _design,
                                                 build_resampler,
                                                 build_resampler_stream)
    from dectnrp_tpu_torch.phy.sync import build_sync
    from dectnrp_tpu_torch.sections.part3.transmission_packet_structure import (
        get_N_samples_STF)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    OUT.mkdir(exist_ok=True)
    report = {}

    # ---- 1. device
    card = kernels.card_name()
    print(card, flush=True)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    # ---- 2. build
    lib = kernels.load()
    report["build_s"] = kernels.build_seconds
    report["ptxas"] = kernels.build_log
    # blocks of the float32 BCJR an SM holds at a time, at the windowed and
    # the one-window PCC shapes (the occupancy calculator's answer)
    report["bcjr_blocks_per_sm"] = {Lw: lib.bcjr_blocks_per_sm(Lw)
                                    for Lw in (128, 59, 99, 427)}
    require(min(report["bcjr_blocks_per_sm"].values()) >= 1,
            f"bcjr occupancy query failed: {report['bcjr_blocks_per_sm']}")
    # the bf16 BCJR: registers a thread (ptxas), blocks an SM at window 128
    report["bcjr_bf16_regs"] = ptxas_regs(kernels.build_log,
                                          "bcjr_bf16_kernel").get(())
    report["bcjr_bf16_blocks_per_sm"] = lib.bcjr_bf16_blocks_per_sm(128)
    require(report["bcjr_bf16_regs"] and report["bcjr_bf16_blocks_per_sm"] >= 1,
            f"bcjr_bf16 register or occupancy query failed: "
            f"{report['bcjr_bf16_regs']}, {report['bcjr_bf16_blocks_per_sm']}")
    # the sync kernel by b: registers a thread (ptxas), blocks an SM at
    # R = 1, at the wall's R = 4, b = 8, at u = 8 and with 8 antennas at b = 16
    # (two stages of 4)
    report["sync_regs"] = {v * q // 16: n for (v, q), n in ptxas_regs(
        kernels.build_log, "sync_sm_kernel").items()}

    def sync_occupancy(R, b, n_pat=7):
        pl = sync_detect.kernel_plan(R, 16 * b * 16, 16 * b, n_pat, 0, 0)
        return lib.sync_detect_blocks_per_sm(16 * b, n_pat, pl.RC)
    report["sync_blocks_per_sm"] = {b: sync_occupancy(1, b)
                                    for b in (1, 2, 4, 8, 12, 16)}
    report["sync_blocks_per_sm"]["8_R4"] = sync_occupancy(4, 8)
    report["sync_blocks_per_sm"]["16_u8"] = sync_occupancy(1, 16, 9)
    report["sync_blocks_per_sm"]["16_R8"] = sync_occupancy(8, 16)
    require(min(report["sync_blocks_per_sm"].values()) >= 1
            and sorted(report["sync_regs"]) == [1, 2, 4, 8, 12, 16],
            f"sync occupancy or register query failed: "
            f"{report['sync_blocks_per_sm']}, {report['sync_regs']}")
    # the polyphase kernel by phases a thread tile holds (LG); blocks an SM
    # at the ratios timed in phase 7 and 40/27
    report["poly_regs"] = {lg: n for (lg,), n in ptxas_regs(
        kernels.build_log, "polyphase_kernel").items()}
    report["poly_blocks_per_sm"] = {
        f"{L}/{M}": lib.polyphase_blocks_per_sm(L, M, _design(ResamplerPlan(L, M))[2])
        for L, M in ((10, 9), (9, 10), (80, 27), (27, 80), (40, 27))}
    require(min(report["poly_blocks_per_sm"].values()) >= 1
            and sorted(report["poly_regs"]) == [1, 2, 9, 10],
            f"polyphase occupancy or register query failed: "
            f"{report['poly_blocks_per_sm']}, {report['poly_regs']}")
    print(f"build: csrc/*.cu -> sm_90a shared library in "
          f"{kernels.build_seconds:.1f} s; bcjr blocks per SM by Lw: "
          f"{report['bcjr_blocks_per_sm']}; bcjr_bf16 "
          f"{report['bcjr_bf16_regs']} registers, "
          f"{report['bcjr_bf16_blocks_per_sm']} blocks per SM at Lw 128; "
          f"sync registers by b "
          f"{report['sync_regs']}, blocks per SM by b {report['sync_blocks_per_sm']}; "
          f"polyphase registers by LG {report['poly_regs']}, blocks per SM "
          f"{report['poly_blocks_per_sm']}", flush=True)

    # ---- 3. BCJR kernel vs plain twin, turbo round trip
    step = make_flagship_step(FLAGSHIP_PSDEF, n_pkts=N_PKTS, snr_db=SNR_DB)
    wall = make_wall_step(WALL_PSDEF, snr_db=SNR_WALL)
    # the PDC decode turbo-decodes each K group of all B rows in one call
    flag_shapes = {K: n * B_FLAG for K, n in Counter(step.rxs.rx.plan.cb_K).items()}
    wall_shapes = {K: n * B_WALL for K, n in Counter(wall.rxs.rx.plan.cb_K).items()}
    main_shapes = {**flag_shapes, **wall_shapes}
    bcjr_err = phase_bcjr(dev, report, main_shapes)
    # the blind PCC decode calls the kernel as one window on the B rows of
    # one packet per stream: K = 56 (PLCF type 1) and 96 (type 2)
    pcc_shapes = [(K, Bc) for Bc in (B_FLAG, B_WALL) for K in (56, 96)]
    phase_bcjr_one_window(dev, report, pcc_shapes + [
        (K, Bc) for K in (56, 96) for Bc in (128, FEC_N, 3)] + [(424, FEC_N)])
    bf16_err = phase_bcjr_bf16(dev, report, flag_shapes)

    # ---- 4. sync kernel vs plain twin at the flagship shape, b = 1, the wall
    gen = torch.Generator(device=dev).manual_seed(0)
    plcf, tb, offs = _inputs(step, B_FLAG, 7, dev)
    y = step.awgn(step.stream(plcf, tb, offs), gen)
    sync_errs = [_sync_check(step.sync, y, "b16", report)]
    step1 = make_flagship_step(PacketSizesDef(1, 1, 0, 2, 0, 4, 6144),
                               n_pkts=N_PKTS, snr_db=SNR_DB)
    p1, t1, o1 = _inputs(step1, B_FLAG, 8, dev)
    sync_errs.append(_sync_check(step1.sync, step1.awgn(step1.stream(p1, t1, o1),
                                                        gen), "b1", report))
    pw, tw, ow = _inputs(wall, B_WALL, 9, dev)
    yw = wall.resample_down(wall.awgn(wall.stream(pw, tw, ow), gen))
    sync_errs.append(_sync_check(wall.sync, yw, "wall_b8_R4", report))
    # the bench's u8b16 cell (bench.py:316-320: B = 128, T = 2 x 92,160 +
    # 8192) and the runtime's chunk (upper/runtime.py:139-140)
    s8 = build_sync(8, 16, 192512, device=dev)
    y8 = stf_stream(8, 16, 128, 192512, 2, gen, dev)
    sync_errs.append(_sync_check(s8, y8, "u8b16", report))
    t_rt = 2048 + 4 * get_N_samples_STF(1, 1)
    s_rt = build_sync(1, 1, t_rt, max_peaks=4, device=dev)
    y_rt = stf_stream(1, 1, 16, t_rt, 1, gen, dev)
    sync_errs.append(_sync_check(s_rt, y_rt, "runtime_u1b1", report))
    sync_err = max(e for e, _ in sync_errs)
    sync_err_tiled = max(e for _, e in sync_errs)
    # the RMS gate is skipped at rms_min = 0: B2 is then bit for bit its
    # tiled twin at the streams of the shapes phase 7 times
    for label in ("b16", "wall_b8_R4", "u8b16", "runtime_u1b1"):
        require(report[f"sync_check_{label}"]["bit_equal_tiled"] == 1.0,
                f"sync {label}: not bit for bit the tiled twin at rms_min = 0 "
                f"({report[f'sync_check_{label}']})")

    # ---- 5. polyphase kernel vs plain twin
    poly_err, poly_err_tiled = phase_polyphase(wall, dev, report)

    # ---- 6. small steps card == CPU, then the two main paths, counted
    small_step_check(step1, dev, gen, "flagship-shaped (u=1 b=1 SISO, K=960)")
    wall1 = make_wall_step(PacketSizesDef(1, 1, 0, 3, 5, 2, 6144), snr_db=SNR_WALL)
    small_step_check(wall1, dev, gen, "wall-shaped (u=1 b=1 N_TX=4 Alamouti, "
                     "10/9 resampler, K=768)")
    del step1, wall1
    launches = {"flagship": counted_step(step, B_FLAG, 7, dev, gen, "flagship",
                                         report),
                "wall": counted_step(wall, B_WALL, 17, dev, gen, "wall", report)}
    for name, st, n_poly in (("flagship", step, 0), ("wall", wall, 2)):
        got, rx = launches[name], st.rxs.rx
        # blind PCC decode: per packet 2 PLCF types x 2 constituent decoders
        # x n_iter one-window launches; PDC decode: per packet and codeblock
        # size 2 launches an iteration, 2 to n_iter iterations (CRC early stop)
        n_pcc = st.n_pkts * 2 * 2 * rx.n_iter
        n_k = st.n_pkts * len(set(rx.plan.cb_K))
        n_pdc = got["bcjr"] - got["bcjr_one_window"]
        require(got["bcjr_one_window"] == n_pcc
                and 2 * 2 * n_k <= n_pdc <= 2 * rx.n_iter * n_k
                and got["sync"] == 1 and got["polyphase"] == n_poly
                and got["bcjr_bf16"] == 0,
                f"{name}: kernels not launched as expected ({got}; one-window "
                f"{n_pcc}, windowed {4 * n_k}..{2 * rx.n_iter * n_k}, sync 1, "
                f"polyphase {n_poly}, bcjr_bf16 0)")

    # ---- 6b. the FEC oracle path, counted
    launches["fec_awgn"] = phase_fec_awgn(dev, card, report)

    # ---- 6c. the loopback sweep: card == CPU at one point per variant, then
    # the path itself, counted
    phase_loopback_card_vs_cpu(dev, card, report)
    launches["loopback_snr"] = phase_loopback(dev, card, report)

    # ---- 6d. the runtime path: the scenario runner over the committed
    # simulator configurations and the runtime exchanges, counted; then the
    # DECT-rate exchange on the card == on the CPU
    launches["runtime"], rt_catch = phase_runtime(dev, card, report)
    phase_runtime_card_vs_cpu(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 6e. the real-IQ radios: file and UDP ingress, the paced egress,
    # configurations/socket_radio and the application layer, counted
    launches["iq_ingress"], iq_catch = phase_iq(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 6f. the builder options at the flagship's width: TX windowing,
    # beamforming, beta / integer CFO and the RMS gate, the chestim
    # options, the MMIE round trip, counted
    launches["phy_options"], opt_catch, opt_sync = phase_options(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 6g. the multi-device code on the one card listed 8 times: the
    # time-sharded sync, the node-sharded vspace tick, dryrun_multichip,
    # counted
    launches["multichip"], mc_catch, mc_keep = phase_multichip(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 6h. the multi-process code: dcn_dryrun in two processes joined by
    # gloo on the one card, then scaling, counted
    launches["multiprocess"] = phase_multiprocess(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 7. times [card]
    order = ("tx", "resample_up", "scatter", "awgn", "resample_down", "sync",
             "rx_stream", "pcc_decode", "pdc_decode")
    for name, st, B, psdef, seed in (("flagship", step, B_FLAG, FLAGSHIP_PSDEF, 100),
                                     ("wall", wall, B_WALL, WALL_PSDEF, 300)):
        med, stages = time_stages(st, B, dev, gen, seed)
        rate = hw_rate(psdef, st.up is not None)
        rt = B * st.T / (med["step"] / 1e3) / rate
        report[f"{name}_times_ms"] = med
        report[f"{name}_times_ms_all"] = stages
        report[f"{name}_realtime_multiple"] = rt
        print(f"[{card}] {name} step median {med['step']:.1f} ms over 5 steps = "
              f"{rt:.3f}x realtime (B*T/step/{rate / 1e6:g}e6); stages (ms, "
              "medians): " + ", ".join(f"{k} {med[k]:.2f}" for k in order
                                       if k in med), flush=True)

    # kernels next to their plain twins, at the main paths' shapes
    K = next(iter(flag_shapes))
    g = torch.Generator(device=dev).manual_seed(1)
    bcjr_times = {}
    for Kc, Bc in ((K, 64), (K, flag_shapes[K]), *wall_shapes.items()):
        Lsys = torch.randn((Kc + 3, Bc), generator=g, device=dev) * 3
        Lp = torch.randn((Kc + 3, Bc), generator=g, device=dev) * 3
        bcjr_times[(Kc, Bc)] = (
            cuda_ms(lambda: bcjr_posterior_cm(Lsys, Lp, Kc)),
            cuda_ms(lambda: bcjr_windowed_cm_plain(Lsys, Lp, Kc), reps=3))
        if (Kc, Bc) == (K, flag_shapes[K]):
            # the bf16 kernel and its twin on the same inputs, in turns
            bf16_ms = cuda_ms(lambda: bcjr_posterior_cm_bf16(Lsys, Lp, Kc))
            bf16_plain_ms = cuda_ms(
                lambda: bcjr_windowed_cm_bf16_plain(Lsys, Lp, Kc), reps=3)
            bf16_ms_2 = cuda_ms(lambda: bcjr_posterior_cm_bf16(Lsys, Lp, Kc))
            f32_ms_2 = cuda_ms(lambda: bcjr_posterior_cm(Lsys, Lp, Kc))
            # device times without the wrapper's host gaps, in turns again
            bcjr_graph = {
                "bcjr_bf16": 1e-3 * graph_us(
                    lambda: bcjr_posterior_cm_bf16(Lsys, Lp, Kc)),
                "bcjr": 1e-3 * graph_us(lambda: bcjr_posterior_cm(Lsys, Lp, Kc)),
                "bcjr_bf16_again": 1e-3 * graph_us(
                    lambda: bcjr_posterior_cm_bf16(Lsys, Lp, Kc))}
    bcjr_eager_ms, bcjr_plain_ms = bcjr_times[(K, flag_shapes[K])]
    bcjr_ms = bcjr_graph["bcjr"]
    bcjr_bound = bound(*bcjr_work(K, flag_shapes[K]))
    # the kernel as one window at the shapes the unwindowed decodes call it,
    # beside the plain unwindowed BCJR on the same inputs
    one_window = {}
    for Kc, Bc in (*pcc_shapes, (424, FEC_N)):
        Lsys, Lp = bcjr_llrs(Kc, Bc, g, dev)
        Ls_r, Lp_r = Lsys.T.contiguous(), Lp.T.contiguous()
        La = torch.zeros((Bc, Kc), device=dev)
        b_ms, b_by = bound(*bcjr_work(Kc, Bc, windowed=False))
        one_window[f"K{Kc}_{Bc}rows"] = {
            "ms": 1e-3 * graph_us(
                lambda: bcjr_posterior_cm(Lsys, Lp, Kc, Kc + 3, 0)),
            "eager_ms": cuda_ms(lambda: bcjr_posterior_cm(Lsys, Lp, Kc, Kc + 3, 0)),
            "bcjr_posterior_ms": cuda_ms(
                lambda: _bcjr_posterior(Ls_r, Lp_r, La, Kc), reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by}
    # the same work counted at the bf16x2 rate (bytes bind either way)
    bf16_bound = bound(*bcjr_work(K, flag_shapes[K]), peak_ops=PEAK_BF16X2)
    # the bf16 kernel at every shape it serves (bcjr_bf16_turns.SHAPES), by
    # graph replay in turns with the float32 kernel on the same inputs,
    # window 128, D = 32
    bf16_shapes = {}
    for Kc, Bc in bf16_turns.SHAPES:
        Lsys, Lp = bcjr_llrs(Kc, Bc, g, dev)
        b_ms, b_by = bound(*bcjr_work(Kc, Bc), peak_ops=PEAK_BF16X2)
        t = [1e-3 * graph_us(lambda: fn(Lsys, Lp, Kc)) for fn in (
            bcjr_posterior_cm_bf16, bcjr_posterior_cm, bcjr_posterior_cm_bf16,
            bcjr_posterior_cm)]
        bf16_shapes[f"K{Kc}_{Bc}cb"] = {"ms": t[0], "ms_again": t[2],
                                        "bcjr_ms": t[1], "bcjr_ms_again": t[3],
                                        "bound_ms": b_ms, "bound_by": b_by}
    sync_times = {}
    for label, s, ys in (("flagship", step.sync, y), ("wall", wall.sync, yw),
                         ("u8b16", s8, y8), ("runtime_B1", s_rt, y_rt[:1])):
        sargs = (s.P, s.w, s.sl, s.sr, s.params.metric_threshold,
                 s.params.metric_max)
        b_ms, b_by = bound(*sync_work(*ys.shape, s.P, s.n_pat))
        sync_times[label] = {
            "shape": list(ys.shape), "u": 8 if s.n_pat == 9 else 1,
            "b": s.P // 16, "span_rows": sync_detect.default_span(ys, s.P, s.n_pat, s.sl, s.sr),
            "ms": 1e-3 * graph_us(lambda: sync_detect.detect_sm(ys, *sargs)),
            "ms_again": 1e-3 * graph_us(lambda: sync_detect.detect_sm(ys, *sargs)),
            "eager_ms": cuda_ms(lambda: sync_detect.detect_sm(ys, *sargs)),
            "plain_ms": 1e-3 * graph_us(
                lambda: sync_detect.detect_sm_plain(ys, *sargs), reps=5),
            "bound_ms": b_ms, "bound_by": b_by}
    sync_ms = sync_times["flagship"]["ms"]
    sync_plain_ms = sync_times["flagship"]["plain_ms"]
    sync_eager_ms = sync_times["flagship"]["eager_ms"]
    sync_bound = (sync_times["flagship"]["bound_ms"], sync_times["flagship"]["bound_by"])
    poly = {}
    # the packets and the noisy radio-rate stream the wall step resamples;
    # 80/27 up and 27/80 down, the resampler's widest pair (W = 49 and 143
    # taps a phase), on 64 rows of the wall's lengths; the runtime's RX step
    # (dectnrp_tpu/upper/runtime.py:165-167: 512 L hardware samples through
    # the M/L stream resampler, after its history) on 2 antennas
    x_up = wall.transmit(pw, tw).contiguous()
    x_down = wall.awgn(wall.scatter(wall.resample_up(x_up), ow), gen).contiguous()
    up80 = build_resampler(ResamplerPlan(80, 27), x_up.shape[-1])
    down80 = build_resampler(ResamplerPlan(27, 80), x_down.shape[-1])
    rt = build_resampler_stream(ResamplerPlan(27, 80), 512 * 80)

    def crand(rows, n):
        return torch.randn((rows, n), dtype=torch.complex64, generator=g,
                           device=dev)
    poly_shapes = (
        ("wall_up_10/9", x_up, wall.up, wall.up.m0, wall.up.n_out),
        ("wall_down_9/10", x_down, wall.down, wall.down.m0, wall.down.n_out),
        ("up_80/27", crand(B_WALL * 4, up80.n_in), up80, up80.m0, up80.n_out),
        ("down_27/80", crand(B_WALL * 4, down80.n_in), down80, down80.m0,
         down80.n_out),
        ("runtime_rx_27/80", crand(2, rt.H + rt.chunk_in), rt, rt.off, rt.n_out))
    for label, x, mod, m0, n_out in poly_shapes:
        G, L, M = mod.G, mod.plan.L, mod.plan.M
        rows = x.numel() // x.shape[-1]
        b_ms, b_by = bound(*poly_work(G, L, rows, x.shape[-1], n_out))
        poly[label] = {**poly_times(x, G, L, M, m0, n_out), "bound_ms": b_ms,
                       "bound_by": b_by, "shape": list(x.shape), "L": L, "M": M}
    # one wall step's work: the up and the down call
    wall_poly = [poly["wall_up_10/9"], poly["wall_down_9/10"]]
    poly_sum = {k: sum(v[k] for v in wall_poly)
                for k in ("ms", "plain_ms", "library_ms", "eager_ms")}
    poly_bound = (sum(v["bound_ms"] for v in wall_poly),
                  "bytes" if all(v["bound_by"] == "bytes" for v in wall_poly)
                  else "operations")
    report["kernel_ms"] = {
        **{f"bcjr_K{k}_{b}cb": t[0] for (k, b), t in bcjr_times.items()},
        **{f"bcjr_K{k}_{b}cb_plain": t[1] for (k, b), t in bcjr_times.items()},
        f"bcjr_bf16_K{K}_{flag_shapes[K]}cb": [bf16_ms, bf16_ms_2],
        f"bcjr_bf16_K{K}_{flag_shapes[K]}cb_plain": bf16_plain_ms,
        f"bcjr_K{K}_{flag_shapes[K]}cb_repeat": f32_ms_2,
        f"graph_replay_K{K}_{flag_shapes[K]}cb": bcjr_graph,
        "bcjr_one_window": one_window,
        "bcjr_bf16": bf16_shapes,
        "sync": sync_times,
        "polyphase": poly}
    print(f"[{card}] kernels (CUDA events): "
          + "; ".join(f"bcjr K={k} x {b} cb {t[0]:.3f} ms vs plain {t[1]:.3f} ms"
                      for (k, b), t in bcjr_times.items())
          + f" (bound {bcjr_bound[0]:.4f} ms, {bcjr_bound[1]}); bcjr_bf16 K={K} x "
          f"{flag_shapes[K]} cb {bf16_ms:.3f} / {bf16_ms_2:.3f} ms (float32 "
          f"kernel again {f32_ms_2:.3f} ms) vs plain {bf16_plain_ms:.3f} ms (bound "
          f"{bf16_bound[0]:.4f} ms, {bf16_bound[1]}); by graph replay at K={K} x "
          f"{flag_shapes[K]}, in turns: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bcjr_graph.items())
          + "; bcjr_bf16 by graph replay (again) vs bcjr in turns (again), "
          "bound: " + "; ".join(
              f"{k} {v['ms'] * 1e3:.1f} us ({v['ms_again'] * 1e3:.1f}) vs "
              f"{v['bcjr_ms'] * 1e3:.1f} us ({v['bcjr_ms_again'] * 1e3:.1f}), "
              f"{v['bound_ms'] * 1e3:.2f} us {v['bound_by']}"
              for k, v in bf16_shapes.items())
          + "; bcjr as one window, graph replay "
          "(eager) vs turbo._bcjr_posterior, bound: "
          + "; ".join(f"{k} {v['ms']:.4f} ms ({v['eager_ms']:.4f}) vs "
                      f"{v['bcjr_posterior_ms']:.2f} ms, {v['bound_ms'] * 1e3:.3f} us "
                      f"{v['bound_by']}" for k, v in one_window.items())
          + "; sync sm, graph replay (again; eager) vs plain, bound: " + "; ".join(
              f"{k} {v['shape']} u{v['u']} b{v['b']} {v['ms'] * 1e3:.1f} us "
              f"({v['ms_again'] * 1e3:.1f}; {v['eager_ms'] * 1e3:.1f}) vs {v['plain_ms']:.3f} ms, "
              f"{v['bound_ms'] * 1e3:.2f} us {v['bound_by']}"
              for k, v in sync_times.items()) + "; "
          + "; polyphase, graph replay (again; eager) vs plain, conv1d, bound: "
          + "; ".join(f"{k} {v['shape']} {v['ms'] * 1e3:.1f} us ({v['ms_again'] * 1e3:.1f}; "
                      f"{v['eager_ms'] * 1e3:.1f}) vs {v['plain_ms']:.3f} ms, "
                      f"{v['library_ms'] * 1e3:.1f} us, {v['bound_ms'] * 1e3:.2f} us "
                      f"{v['bound_by']}" for k, v in poly.items()), flush=True)

    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 7b. the kernels at the loopback path's shapes: held to their plain
    # twins, then timed
    lb_times = phase_loopback_kernels(dev, report)
    report["kernel_ms"]["loopback"] = lb_times
    print(f"[{card}] kernels at the loopback path's shapes, each equal to its "
          "plain twin (B1 bit for bit, B2 rtol 2e-3 atol 2e-4 off gate ties, B3 "
          "bit for bit its tiled twin and rtol 2e-5 atol 2e-5 its plain twin); "
          "max |err|, graph replay (eager) vs plain twin[, conv1d], bound: "
          + "; ".join(
              f"{kern} {k} {v['max_abs_err']:.3g}, {v['ms'] * 1e3:.1f} us "
              f"({v['eager_ms'] * 1e3:.1f}) vs "
              f"{v['plain_ms']:.3f} ms"
              + (f", {v['library_ms'] * 1e3:.1f} us" if v.get("library_ms") else "")
              + f", {v['bound_ms'] * 1e3:.3f} us {v['bound_by']}"
              for kern, by in lb_times.items() for k, v in by.items()), flush=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 7c. the kernels on the inputs the runtime path handed them
    rt_times = phase_runtime_kernels(dev, report, rt_catch)
    report["kernel_ms"]["runtime"] = rt_times
    print_path_times(card, "runtime", rt_times)
    # ---- 7d. where a runtime tick's host time goes, by layer
    phase_runtime_stages(dev, card, report)
    # ---- 7e. the kernels on the inputs the iq_ingress path handed them
    iq_times = phase_runtime_kernels(dev, report, iq_catch, "iq_ingress")
    report["kernel_ms"]["iq_ingress"] = iq_times
    print_path_times(card, "iq_ingress", iq_times)
    # ---- 7f. B1 and B2 on the inputs the phy_options path handed them, B2
    # with the RMS gate off and on
    opt_times = phase_options_kernels(dev, report, opt_catch, opt_sync)
    del opt_sync
    report["kernel_ms"]["phy_options"] = opt_times
    print_path_times(card, "phy_options", opt_times)
    # ---- 7g. B1 and B2 on the inputs the multichip path handed them; the
    # sharded search's host time by shard count
    mc_times = phase_multichip_kernels(dev, card, report, mc_catch, mc_keep)
    del mc_keep
    report["kernel_ms"]["multichip"] = mc_times
    print_path_times(card, "multichip", mc_times)
    # ---- 7h. B1 and B2 on the multiprocess path's inputs, rebuilt here
    mp_times = phase_multiprocess_kernels(dev, report)
    report["kernel_ms"]["multiprocess"] = mp_times
    print_path_times(card, "multiprocess", mp_times)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---- 8. profiles
    phase_profile(step, "flagship", B_FLAG, dev, gen, card, report)
    phase_profile(wall, "wall", B_WALL, dev, gen, card, report)
    phase_profile_loopback(dev, card, report)
    phase_profile_runtime(dev, card, report)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    def total(key):
        return sum(v[key] for v in launches.values())

    def by_path(key):
        return {k: v[key] for k, v in launches.items()}

    kernels_line = {"kernels": [
        {"name": "bcjr_posterior_cm", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/bcjr.cu",
         "replaces": "dectnrp_tpu/phy/fec/bcjr_pallas.py:87",
         "launches": total("bcjr"), "launches_by_path": by_path("bcjr"),
         "launches_one_window_by_path": by_path("bcjr_one_window"),
         "max_abs_err": bcjr_err, "ms": bcjr_ms, "eager_ms": bcjr_eager_ms,
         "plain_ms": bcjr_plain_ms,
         "bound_ms": bcjr_bound[0], "bound_by": bcjr_bound[1],
         "library_ms": None, "one_window": one_window,
         "loopback": path_entry(lb_times["bcjr"]),
         "runtime": path_entry(rt_times["bcjr"]),
         "iq_ingress": path_entry(iq_times["bcjr"]),
         "phy_options": path_entry(opt_times["bcjr"]),
         "multichip": path_entry(mc_times["bcjr"]),
         "multiprocess": path_entry(mp_times["bcjr"])},
        {"name": "bcjr_posterior_cm_bf16", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/bcjr_bf16.cu",
         "replaces": "dectnrp_tpu/phy/fec/bcjr_pallas.py:188",
         "launches": total("bcjr_bf16"), "launches_by_path": by_path("bcjr_bf16"),
         "max_abs_err": bf16_err, "ms": bf16_ms, "plain_ms": bf16_plain_ms,
         "bound_ms": bf16_bound[0], "bound_by": bf16_bound[1],
         "library_ms": None, "regs": report["bcjr_bf16_regs"],
         "blocks_per_sm": report["bcjr_bf16_blocks_per_sm"],
         "shapes": {k: {kk: v[kk] for kk in ("ms", "bcjr_ms", "bound_ms")}
                    for k, v in bf16_shapes.items()},
         "loopback": {}, "runtime": {}, "iq_ingress": {}, "phy_options": {},
         "multichip": {}, "multiprocess": {}},
        {"name": "sync_detect_sm", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/sync_detect.cu",
         "replaces": "dectnrp_tpu/phy/ops/sync_detect.py:62",
         "launches": total("sync"), "launches_by_path": by_path("sync"),
         "max_abs_err": sync_err, "max_abs_err_tiled": sync_err_tiled,
         "ms": sync_ms, "plain_ms": sync_plain_ms, "eager_ms": sync_eager_ms,
         "bound_ms": sync_bound[0], "bound_by": sync_bound[1],
         "library_ms": None, "regs_b16": report["sync_regs"][16],
         "blocks_per_sm_b16": report["sync_blocks_per_sm"][16],
         "shapes": {k: {kk: v[kk] for kk in ("ms", "eager_ms", "plain_ms",
                                             "bound_ms")}
                    for k, v in sync_times.items()},
         "loopback": path_entry(lb_times["sync"]),
         "runtime": path_entry(rt_times["sync"]),
         "iq_ingress": path_entry(iq_times["sync"]),
         "phy_options": path_entry(opt_times["sync"]),
         "multichip": path_entry(mc_times["sync"]),
         "multiprocess": path_entry(mp_times["sync"])},
        {"name": "polyphase_fir", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/polyphase.cu",
         "replaces": "dectnrp_tpu/phy/ops/polyphase.py:191",
         "launches": total("polyphase"), "launches_by_path": by_path("polyphase"),
         "max_abs_err": poly_err, "max_abs_err_tiled": poly_err_tiled,
         **poly_sum, "bound_ms": poly_bound[0], "bound_by": poly_bound[1],
         "regs": report["poly_regs"], "blocks_per_sm": report["poly_blocks_per_sm"],
         "shapes": {k: {kk: v[kk] for kk in ("ms", "eager_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
                    for k, v in poly.items()},
         "loopback": path_entry(lb_times["polyphase"]),
         "runtime": path_entry(rt_times["polyphase"]),
         "iq_ingress": path_entry(iq_times["polyphase"]), "phy_options": {},
         "multichip": {}, "multiprocess": {}}]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
