"""Drive the PyTorch + CUDA port's flagship stream loopback once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc-builds the kernels of dectnrp_tpu_torch/csrc for sm_90a;
  3. BCJR kernel vs its plain twin at K = 6016 and 6080, on 64 codeblocks
     and on as many as the flagship step decodes in one call (832 and 192),
     at rtol 1e-4, atol 1e-3; and a turbo_decode_early round trip of 64
     CRC-carrying codeblocks that must return the sent bits;
  4. sync-detection kernel vs its plain twin at the flagship shape (b = 16)
     and at b = 1: sm within rtol 2e-3 / atol 2e-4 away from gate ties, and
     the sync reports' t_fine, detected and n_eff_tx equal;
  5. a small stream step on the card equals the same step on the CPU (plain
     twins), then the flagship step (u=1 b=16 SISO MCS4, B = 64 streams of
     T = 192,512 samples, 2 packets each, 15 dB) with decode_ok >= 0.95,
     detected >= 0.95 and both kernels launched during the step;
  6. times with CUDA events / synchronized host clocks: the step's median,
     the realtime multiple B*T / step time / 27.648e6, per-stage times, and
     each kernel next to its plain twin;
  7. torch.profiler (device activity only) over one flagship step: device
     kernels launched, their busy time and the device's idle share under
     the profiler, the top kernels by time. Details go to
     chiprun_out/profile_flagship.json.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
B_FLAG, N_PKTS, SNR_DB = 64, 2, 15.0


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


def phase_bcjr(dev, report, main_shapes):
    """Kernel vs plain twin on 64 codeblocks and at `main_shapes` ({K:
    codeblocks per call}, as the flagship step's PDC decode calls it), then
    a 64-codeblock turbo round trip per K."""
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.chain import _crc_device
    from dectnrp_tpu_torch.phy.fec.crc import POLY_CRC24B, crc_matrix
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode_early, turbo_encode

    B = 64
    errs, res = [], {}
    for K, B_main in main_shapes.items():
        g = torch.Generator(device=dev).manual_seed(K)
        res[K] = {}
        for Bc in (B, B_main):
            Lp = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
            Lsys = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
            Lsys[:K] += torch.randn((K, Bc), generator=g, device=dev)
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
    shapes = ", ".join(f"K={K} x {B}/{Bm}" for K, Bm in main_shapes.items())
    iters = "/".join(str(r["round_trip_iters"]) for r in res.values())
    print(f"bcjr: kernel == plain twin at {shapes} codeblocks (max |err| "
          f"{max(errs):.3g}, rtol 1e-4 atol 1e-3); turbo round trip bits exact "
          f"in {iters} iterations", flush=True)
    return max(errs)


def _sync_check(step, y, label, report):
    """Kernel sm vs plain sm on the card; kernel report vs CPU report."""
    from dectnrp_tpu_torch.phy.ops.sync_detect import (detect_metric_plain,
                                                       detect_sm,
                                                       detect_sm_plain,
                                                       gate_tie_mask)

    s = step.sync
    pr = s.params
    args = (s.P, s.w, s.sl, s.sr, pr.metric_threshold, pr.metric_max)
    got = detect_sm(y, *args)
    want = detect_sm_plain(y, *args)
    metric, _, _ = detect_metric_plain(y, s.P, s.w)
    ok = gate_tie_mask(metric, pr.metric_threshold, pr.metric_max, s.sl, s.sr,
                       1e-3)
    require(torch.isfinite(got).all(), f"sync {label}: non-finite sm")
    masked = 1.0 - ok.float().mean().item()
    require(masked < 0.05, f"sync {label}: {masked:.3f} of sm near gate ties")
    err = (got - want).abs()[ok].max().item()
    require(torch.allclose(got[ok], want[ok], rtol=2e-3, atol=2e-4),
            f"sync {label}: kernel vs plain max |err| {err}")
    rep_k = s(y)
    rep_p = s.cpu()(y.cpu())
    s.to(y.device)
    for key in ("t_fine", "detected", "n_eff_tx"):
        require(torch.equal(rep_k[key].cpu(), rep_p[key]),
                f"sync {label}: report field {key} differs")
    report[f"sync_check_{label}"] = {"max_abs_err": err, "tie_masked": masked}
    print(f"sync {label}: kernel sm == plain twin (max |err| {err:.3g} over "
          f"{1 - masked:.4f} of samples off gate ties; rtol 2e-3 atol 2e-4); "
          f"t_fine/detected/n_eff_tx equal to the plain path", flush=True)
    return err


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


def phase_profile(step, dev, gen, card, report):
    """torch.profiler with device activity only over one flagship step."""
    from torch.profiler import ProfilerActivity, profile

    p, t, o = _inputs(step, B_FLAG, 200, dev)
    step(p, t, o, gen)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = host_ms(lambda: step(p, t, o, gen))
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    require(ev, "profile: no device activity traced")
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
    prof_rep = {"card": card, "wall_ms": wall_ms, "n_device_events": len(ev),
                "busy_union_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                "unprofiled_step_ms": report["times_ms_all"]["step"],
                "top": [[n, c, ms] for n, (c, ms) in top]}
    (ROOT / "chiprun_out" / "profile_flagship.json").write_text(
        json.dumps(prof_rep, indent=1))
    print(f"[{card}] profile (torch.profiler, device activity, one flagship "
          f"step): {len(ev)} device events, busy {busy_ms:.1f} ms in a "
          f"{wall_ms:.1f} ms step, idle share {1 - busy_ms / wall_ms:.3f}; "
          "top: " + "; ".join(f"{n[:48]} x{c} {ms:.1f} ms"
                              for n, (c, ms) in top[:5]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU")
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef

    from dectnrp_tpu_torch import kernels
    from dectnrp_tpu_torch.loopback import (FLAGSHIP_PSDEF, dect_rate,
                                            make_flagship_step)
    from dectnrp_tpu_torch.phy import rx as rx_mod
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.fec.bcjr_cuda import (bcjr_posterior_cm,
                                                     bcjr_windowed_cm_plain)
    from dectnrp_tpu_torch.phy.ops import sync_detect

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {}

    # ---- 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    # ---- 2. build
    kernels.load()
    report["build_s"] = kernels.build_seconds
    report["ptxas"] = kernels.build_log
    print(f"build: csrc/*.cu -> sm_90a shared library in "
          f"{kernels.build_seconds:.1f} s", flush=True)

    # ---- 3. BCJR kernel vs plain twin, turbo round trip
    step = make_flagship_step(FLAGSHIP_PSDEF, n_pkts=N_PKTS, snr_db=SNR_DB).to(dev)
    # the PDC decode turbo-decodes each K group of all B_FLAG rows in one call
    main_shapes = {K: n * B_FLAG
                   for K, n in Counter(step.rxs.rx.plan.cb_K).items()}
    bcjr_err = phase_bcjr(dev, report, main_shapes)

    # ---- 4. sync kernel vs plain twin at the flagship shape and at b = 1
    gen = torch.Generator(device=dev).manual_seed(0)
    plcf, tb, offs = _inputs(step, B_FLAG, 7, dev)
    y = step.awgn(step.stream(plcf, tb, offs), gen)
    sync_err = _sync_check(step, y, "b16", report)
    small = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)
    step1 = make_flagship_step(small, n_pkts=N_PKTS, snr_db=SNR_DB).to(dev)
    p1, t1, o1 = _inputs(step1, B_FLAG, 8, dev)
    y1 = step1.awgn(step1.stream(p1, t1, o1), gen)
    _sync_check(step1, y1, "b1", report)

    # ---- 5a. small step on the card == the same step on the CPU
    y1s = y1[:2].contiguous()
    ok_k, det_k, tf_k = step1.receive(y1s)
    ok_c, det_c, tf_c = step1.cpu().receive(y1s.cpu())
    step1.to(dev)
    require(torch.equal(tf_k.cpu(), tf_c) and torch.equal(det_k.cpu(), det_c)
            and torch.equal(ok_k.cpu(), ok_c),
            "small step: card and CPU decisions differ")
    require(bool(ok_c.all()), "small step: decode failed")
    print("reference: small step (u=1 b=1, K=960) on the card decodes the same "
          "t_fine/detected/tb_ok as on the CPU", flush=True)

    # ---- 5b. the flagship step, counted
    B, T = B_FLAG, step.T
    bcjr_cuda.launches = 0
    sync_detect.launches = 0
    ok, det, tf = step(plcf, tb, offs, gen)
    torch.cuda.synchronize()
    launches = {"bcjr": bcjr_cuda.launches, "sync": sync_detect.launches}
    ok_frac = ok.float().mean().item()
    det_frac = det.float().mean().item()
    report["flagship"] = {"B": B, "T": T, "n_pkts": N_PKTS, "snr_db": SNR_DB,
                          "decode_ok": ok_frac, "detected": det_frac,
                          "launches": launches}
    require(ok_frac >= 0.95 and det_frac >= 0.95,
            f"flagship gate: decode_ok {ok_frac:.3f} detected {det_frac:.3f}")
    require(launches["bcjr"] > 0 and launches["sync"] > 0,
            f"flagship: a kernel was not launched ({launches})")
    print(f"flagship: B={B} T={T} {N_PKTS} packets/stream {SNR_DB:g} dB: "
          f"decode_ok {ok_frac:.4f} detected {det_frac:.4f}; launches in the "
          f"step: bcjr {launches['bcjr']} sync {launches['sync']}", flush=True)

    # ---- 6. times [card]
    # PCC/PDC split: time the decoders where the RX calls them
    split = {"pcc": [], "pdc": []}

    def timed(fn, key):
        def wrap(*a, **kw):
            ms, out = host_ms(lambda: fn(*a, **kw))
            split[key].append(ms)
            return out
        return wrap

    pcc0, pdc0 = rx_mod.pcc_decode, rx_mod.pdc_decode
    stages = {"tx_scatter": [], "awgn": [], "sync": [], "rx_stream": [],
              "step": []}
    for i in range(5):
        p_i, t_i, o_i = _inputs(step, B, 100 + i, dev)
        ms_step, _ = host_ms(lambda: step(p_i, t_i, o_i, gen))
        stages["step"].append(ms_step)
        ms, s_i = host_ms(lambda: step.stream(p_i, t_i, o_i))
        stages["tx_scatter"].append(ms)
        ms, y_i = host_ms(lambda: step.awgn(s_i, gen))
        stages["awgn"].append(ms)
        ms, rep = host_ms(lambda: step.sync(y_i))
        stages["sync"].append(ms)
        rx_mod.pcc_decode, rx_mod.pdc_decode = timed(pcc0, "pcc"), timed(pdc0, "pdc")
        try:
            ms, _ = host_ms(lambda: [step.rxs(y_i, rep["t_fine"][:, k],
                                              rep["cfo"][:, k], step.noise_var)
                                     for k in range(N_PKTS)])
        finally:
            rx_mod.pcc_decode, rx_mod.pdc_decode = pcc0, pdc0
        stages["rx_stream"].append(ms)
    med = {k: statistics.median(v) for k, v in stages.items()}
    # per-step totals: median call time x calls per step (pcc_decode runs
    # twice per packet, once per PLCF type; pdc_decode once per packet)
    med["pcc_decode"] = statistics.median(split["pcc"]) * len(split["pcc"]) / 5
    med["pdc_decode"] = statistics.median(split["pdc"]) * len(split["pdc"]) / 5
    rt = B * T / (med["step"] / 1e3) / dect_rate(FLAGSHIP_PSDEF)
    report["times_ms"] = med
    report["times_ms_all"] = stages
    report["realtime_multiple"] = rt
    print(f"[{card}] flagship step median {med['step']:.1f} ms over 5 steps = "
          f"{rt:.3f}x realtime (B*T/step/27.648e6); stages (ms, medians): "
          + ", ".join(f"{k} {med[k]:.1f}" for k in
                      ("tx_scatter", "awgn", "sync", "rx_stream", "pcc_decode",
                       "pdc_decode")), flush=True)

    # kernels next to their plain twins, at the main path's shapes
    K = next(iter(main_shapes))
    g = torch.Generator(device=dev).manual_seed(1)
    bcjr_times = {}
    for Bc in (64, main_shapes[K]):
        Lsys = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
        Lp = torch.randn((K + 3, Bc), generator=g, device=dev) * 3
        bcjr_times[Bc] = (
            cuda_ms(lambda: bcjr_posterior_cm(Lsys, Lp, K)),
            cuda_ms(lambda: bcjr_windowed_cm_plain(Lsys, Lp, K), reps=3))
    bcjr_ms, bcjr_plain_ms = bcjr_times[main_shapes[K]]
    s = step.sync
    sargs = (s.P, s.w, s.sl, s.sr, s.params.metric_threshold, s.params.metric_max)
    sync_ms = cuda_ms(lambda: sync_detect.detect_sm(y, *sargs))
    sync_plain_ms = cuda_ms(lambda: sync_detect.detect_sm_plain(y, *sargs), reps=5)
    report["kernel_ms"] = {
        **{f"bcjr_K{K}_{Bc}cb": t[0] for Bc, t in bcjr_times.items()},
        **{f"bcjr_K{K}_{Bc}cb_plain": t[1] for Bc, t in bcjr_times.items()},
        "sync_flagship": sync_ms, "sync_flagship_plain": sync_plain_ms}
    print(f"[{card}] kernels (CUDA events): "
          + "; ".join(f"bcjr K={K} x {Bc} cb {t[0]:.3f} ms vs plain {t[1]:.3f} ms"
                      for Bc, t in bcjr_times.items())
          + f"; sync sm B={B} T={T} {sync_ms:.3f} ms vs plain "
          f"{sync_plain_ms:.3f} ms", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    phase_profile(step, dev, gen, card, report)

    kernels_line = {"kernels": [
        {"name": "bcjr_posterior_cm", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/bcjr.cu",
         "replaces": "dectnrp_tpu/phy/fec/bcjr_pallas.py:87",
         "launches": launches["bcjr"], "max_abs_err": bcjr_err,
         "ms": bcjr_ms, "plain_ms": bcjr_plain_ms},
        {"name": "sync_detect_sm", "route": "cuda",
         "source": "dectnrp_tpu_torch/csrc/sync_detect.cu",
         "replaces": "dectnrp_tpu/phy/ops/sync_detect.py:62",
         "launches": launches["sync"], "max_abs_err": sync_err,
         "ms": sync_ms, "plain_ms": sync_plain_ms}]}
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
