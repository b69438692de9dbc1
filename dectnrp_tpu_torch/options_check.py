"""The phy_options path: the builder options the port took last, driven
through `build_tx`, `build_sync`, `build_rx_stream` / `build_rx` and
`upper.loopback.loopback_mmie_roundtrip` at one configuration's width (the
flagship's, (1, 16, 1, 4, 0, 4, 6144), in `chip_smoke.py` phase 6f), each
part with its gates:

  windowing    TX `window_fraction` 0.25 and 0.5, aligned RX at 30 dB:
               every TB back; in-band power within 2 % of the unwindowed
               TX; the out-of-band skirt (|f| in 0.46..0.5 of the rate)
               more than 1 dB lower, and lower again from one fraction to
               the next (tests/test_tx_windowing.py asks 1 dB more at b = 2;
               at b = 16 the data field's skirt drops 16.6 and 20.0 dB,
               but the STF's, which windowing shapes only at its first
               samples, stays, and holds the packet's at ~10 dB for both);
  beamforming  a single-stream beamforming mode (tm 3: N_TS 1, N_TX 2),
               every codebook entry through one fixed random flat 2 x 1
               channel (numpy, |h|^2 = N_TX) at 20 dB: every TB back on
               the entries whose gain |h w|^2 is above the median; the
               same channel sounded by tm 1 (N_TS = N_TX = 2) packets and
               phy/mimo.py's codebook search run on their h_cells: every
               pick's gain at least the median;
  sync         build_sync(SyncParams(est_beta_icfo=True)) at b_max = the
               configuration's b: its own packets report beta = b and
               integer CFO 0; packets of b / 4, upsampled x4 by
               phy/resampler.py (2/1 twice, before the part: the input,
               not the path), with integer CFO 0, +2 and -1 bins, report beta =
               b / 4, and the estimator from their true STF start also the
               shift; the RMS gate with rms_min between the noise's and
               the packets' RMS detects as the ungated sync, above the
               packets' RMS nothing;
  chestim      every chestim option of build_rx through build_rx_stream
               on synced streams: at 20 dB AWGN decode_ok >= 0.95; through
               the loopback's doubly-selective channel (FADING) tb_ok
               recorded, not gated; then the first `n_cpu` fading streams
               on the CPU with the same inputs and sync report: equal
               tb_ok, equal tb where the CRC holds;
  mmie         three MMIEs (tests/test_loopback_experiments.py:62-69) in a
               MAC PDU over the AWGN loopback at 25 dB, back equal.

Each part raises AssertionError naming the gate it failed. Random numbers
come from numpy (bits, offsets, the beamforming channel) and from a
torch.Generator on the part's device (noise, fading draws).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .phy.mimo import search
from .phy.resampler import ResamplerPlan, build_resampler
from .phy.rx import build_rx
from .phy.sync import SyncParams, build_beta_icfo, build_rx_stream, build_sync
from .phy.tx import build_tx
from .sections.part3.beamforming import get_all_W
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .sections.part4.identity import Identity
from .sections.part4.ies import RouteInfoIE
from .sections.part4.ies2 import MeasurementReportIE, PowerTargetIE
from .simulation.channels import (apply_awgn, apply_doubly, draw_doubly,
                                  draw_noise, noise_var_for_snr, tap_table)
from .loopback_snr import FADING
from .upper.loopback import N_SIN, loopback_mmie_roundtrip, parse_channel

NID = 0x12345678
#: (name, build_rx options): every chestim option away from its default
CHESTIM_OPTIONS = (("lr_f", {"chestim_mode": "lr_f"}),
                   ("freq_linear", {"freq_kind": "linear"}),
                   ("time_wiener", {"time_kind": "wiener"}),
                   ("dd_passes_2", {"dd_passes": 2}),
                   ("no_est_sto", {"est_sto": False}),
                   ("no_est_cfo", {"est_cfo": False}))
ICFO_SHIFTS = (0, 2, -1)


def _require(cond, msg):
    if not cond:
        raise AssertionError(f"phy_options: {msg}")


def with_tm(psdef: PacketSizesDef, tm: int) -> PacketSizesDef:
    """psdef with another transmission mode."""
    return PacketSizesDef(psdef.u, psdef.b, psdef.PacketLengthType,
                          psdef.PacketLength, tm, psdef.mcs_index, psdef.Z)


def _bits(ps, B: int, seed: int, device):
    """(plcf [B, 40], tb [B, N_TB], flags [B]) on `device`, from numpy."""
    rng = np.random.default_rng(seed)
    plcf = torch.as_tensor(rng.integers(0, 2, (B, 40)), dtype=torch.uint8,
                           device=device)
    tb = torch.as_tensor(rng.integers(0, 2, (B, ps.N_TB_bits)),
                         dtype=torch.uint8, device=device)
    return plcf, tb, torch.zeros((B,), dtype=torch.bool, device=device)


def _decoded(out, tb) -> torch.Tensor:
    """[B] TB decoded with the bits sent."""
    return out["tb_ok"] & (out["tb"] == tb).all(-1)


def _oob_db(iq: torch.Tensor) -> float:
    """Mean PSD (dB) of the packets [B, R, n] at |f| in 0.46..0.5 of the
    sample rate, outside the occupied band (56 b of 64 b subcarriers)."""
    n = iq.shape[-1]
    psd = (torch.fft.fft(iq.reshape(-1, n), dim=-1).abs() ** 2).mean(0)
    f = torch.fft.fftfreq(n, device=iq.device).abs()
    return float(10 * torch.log10(psd[(f > 0.46) & (f < 0.5)].mean() + 1e-30))


def windowing(psdef: PacketSizesDef, B: int, device, snr_db: float = 30.0,
              fractions=(0.25, 0.5), seed: int = 0) -> dict:
    """TX windowing's gates (module docstring); per fraction the TBs back,
    the in-band power ratio and the skirt's gain in dB."""
    dev = torch.device(device)
    ps = get_packet_sizes(psdef)
    plcf, tb, fl = _bits(ps, B, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rx = build_rx(psdef, NID, 1, device=dev)
    iq0 = build_tx(psdef, NID, 1, device=dev)(plcf, tb, fl, fl)
    p0, oob0 = (iq0.abs() ** 2).mean(), _oob_db(iq0)
    out = {}
    for f in fractions:
        iq = build_tx(psdef, NID, 1, window_fraction=f, device=dev)(plcf, tb, fl, fl)
        nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
        o = rx(apply_awgn(iq, nv, draw_noise(gen, iq.shape, dev)), nv)
        r = {"tb_ok": int(_decoded(o, tb).sum()),
             "power_ratio": float((iq.abs() ** 2).mean() / p0),
             "oob_gain_db": oob0 - _oob_db(iq)}
        out[f] = r
        _require(r["tb_ok"] == B, f"window {f}: {r['tb_ok']}/{B} TBs back")
        _require(abs(r["power_ratio"] - 1.0) <= 0.02,
                 f"window {f}: in-band power ratio {r['power_ratio']:.4f}")
        _require(r["oob_gain_db"] > 1.0,
                 f"window {f}: skirt {r['oob_gain_db']:.2f} dB lower only")
    gains = [out[f]["oob_gain_db"] for f in fractions]
    _require(all(g1 > g0 for g0, g1 in zip(gains, gains[1:])),
             f"the skirt does not drop with the fraction: {gains}")
    return out


def beamforming(psdef: PacketSizesDef, sound_tm: int, B: int, device,
                snr_db: float = 20.0, seed: int = 1) -> dict:
    """Beamforming's gates (module docstring): per codebook entry its gain
    and TBs back; the search's picks on the sounding packets."""
    dev = torch.device(device)
    ps = get_packet_sizes(psdef)
    N_TS, N_TX = ps.tm_mode.N_TS, ps.tm_mode.N_TX
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(N_TX) + 1j * rng.standard_normal(N_TX)
    h *= np.sqrt(N_TX) / np.linalg.norm(h)
    W = get_all_W(N_TS, N_TX)                                 # [n_cb, N_TX, N_TS]
    gains = np.abs(np.einsum("t,nt->n", h, W[:, :, 0])) ** 2
    med = float(np.median(gains))
    ht = torch.as_tensor(h.astype(np.complex64), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    plcf, tb, fl = _bits(ps, B, seed, dev)
    rx = build_rx(psdef, NID, 1, device=dev)
    nv, entries = None, []
    for i in range(W.shape[0]):
        iq = build_tx(psdef, NID, 1, codebook_idx=i, device=dev)(plcf, tb, fl, fl)
        if nv is None:                    # the total TX power over a unit channel
            nv = noise_var_for_snr((iq.abs() ** 2).sum(1).mean(), snr_db)
        y = torch.einsum("t,btn->bn", ht, iq)[:, None]
        n_ok = int(_decoded(rx(apply_awgn(y, nv, draw_noise(gen, y.shape, dev)),
                                nv), tb).sum())
        entries.append({"gain": float(gains[i]), "tb_ok": n_ok})
        _require(gains[i] <= med or n_ok == B,
                 f"codebook entry {i} (gain {gains[i]:.3f} above the median "
                 f"{med:.3f}): {n_ok}/{B} TBs back")
    # the channel sounded with one stream a TX antenna, searched on h_cells
    sound = with_tm(psdef, sound_tm)
    ps_s = get_packet_sizes(sound)
    _require(ps_s.tm_mode.N_TS == N_TX, f"tm {sound_tm} does not sound {N_TX} antennas")
    plcf_s, tb_s, _ = _bits(ps_s, B, seed + 1, dev)
    iq = build_tx(sound, NID, 1, device=dev)(plcf_s, tb_s, fl, fl)
    y = torch.einsum("t,btn->bn", ht, iq)[:, None]
    o = build_rx(sound, NID, 1, device=dev)(
        apply_awgn(y, nv, draw_noise(gen, y.shape, dev)), nv)
    pick = search(o["h_cells"], N_TS)[0].cpu().numpy()
    counts = np.bincount(pick, minlength=W.shape[0])
    _require((gains[pick] >= med).all(),
             f"codebook search picked entries {counts.tolist()} (gains "
             f"{np.round(gains, 3).tolist()}, median {med:.3f})")
    return {"channel": [[float(v.real), float(v.imag)] for v in h],
            "entries": entries, "median_gain": med,
            "search_picks": counts.tolist(), "best_entry": int(gains.argmax())}


def _place(iq: torch.Tensor, T: int, offs: np.ndarray) -> torch.Tensor:
    """Packets [B, R, n] at offsets [B] in zero streams [B, R, T]."""
    B, R, n = iq.shape
    y = torch.zeros((B, R, T), dtype=torch.complex64, device=iq.device)
    for i, o in enumerate(offs.tolist()):
        y[i, :, o:o + n] = iq[i]
    return y


def sync_inputs(psdef: PacketSizesDef, B: int, T: int, device,
                snr_db: float = 15.0, seed: int = 2) -> dict:
    """The sync part's streams [B, 1, T]: one packet of `psdef` each, and
    one packet of b / 4 upsampled x4 to psdef's rate with integer CFO
    ICFO_SHIFTS[i % 3] bins each, at random offsets under AWGN."""
    dev = torch.device(device)
    b, b_small = psdef.b, psdef.b // 4
    ps = get_packet_sizes(psdef)
    small = PacketSizesDef(psdef.u, b_small, psdef.PacketLengthType,
                           psdef.PacketLength, 0, psdef.mcs_index, psdef.Z)
    ps_s = get_packet_sizes(small)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    plcf, tb, fl = _bits(ps, B, seed, dev)
    iq = build_tx(psdef, NID, 1, device=dev)(plcf, tb, fl, fl)
    nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
    offs = rng.integers(64, T - ps.N_samples_packet - 64, B)
    y = apply_awgn(_place(iq, T, offs), nv, draw_noise(gen, (B, 1, T), dev))
    plcf, tb, fl = _bits(ps_s, B, seed + 1, dev)
    iq_s = build_tx(small, NID, 1, device=dev)(plcf, tb, fl, fl)
    iq_up = iq_s
    for _ in range(2):                    # x4 as two 2/1 steps (the kernel's ratio)
        iq_up = build_resampler(ResamplerPlan(2, 1), iq_up.shape[-1], dev)(iq_up)
    shifts = np.array([ICFO_SHIFTS[i % 3] for i in range(B)])
    n = torch.arange(iq_up.shape[-1], device=dev, dtype=torch.float32)
    rot = torch.polar(torch.ones_like(n), 2 * np.pi * torch.as_tensor(
        shifts, dtype=torch.float32, device=dev)[:, None] * n / (64 * b))
    iq_up = iq_up * rot[:, None]
    nv_s = noise_var_for_snr((iq_up.abs() ** 2).mean(), snr_db)
    offs_s = rng.integers(64, T - iq_up.shape[-1] - 64, B)
    y_s = apply_awgn(_place(iq_up, T, offs_s), nv_s, draw_noise(gen, (B, 1, T), dev))
    return {"psdef": psdef, "T": T, "y": y, "offs": offs, "nv": float(nv),
            "y_small": y_s, "offs_small": offs_s, "shifts": shifts}


def sync(inp: dict, device) -> dict:
    """The sync part's gates (module docstring) on `sync_inputs`; four
    syncs, each one detection-kernel launch. Returns the report summary
    and the Sync modules with the streams they took (gated and not)."""
    dev = torch.device(device)
    psdef, T, y = inp["psdef"], inp["T"], inp["y"]
    u, b = psdef.u, psdef.b
    s = build_sync(u, b, T, params=SyncParams(est_beta_icfo=True), device=dev)
    rep = {k: v.cpu() for k, v in s(y).items()}
    off = torch.as_tensor(inp["offs"])
    _require(bool(rep["detected"].all()), "a b_max packet not detected")
    _require(bool((rep["beta"] == b).all() and (rep["cfo_int"] == 0).all()),
             f"b_max packets: beta {rep['beta'].unique().tolist()}, cfo_int "
             f"{rep['cfo_int'].unique().tolist()} (want {b}, 0)")
    dt = (rep["t_fine"] - off).abs().max().item()
    _require(dt <= 2, f"b_max packets: t_fine {dt} samples off")

    y_s, shifts = inp["y_small"], inp["shifts"]
    rep_s = {k: v.cpu() for k, v in s(y_s).items()}
    _require(bool(rep_s["detected"].all()), "an upsampled b/4 packet not detected")
    _require(bool((rep_s["beta"] == b // 4).all()),
             f"upsampled b/4 packets: beta {rep_s['beta'].tolist()}")
    Nfft = 64 * b
    seg = torch.stack([y_s[i, :, o:o + Nfft] for i, o in
                       enumerate(inp["offs_small"].tolist())])
    beta0, s0 = build_beta_icfo(u, b, device=dev)(seg)
    _require(bool((beta0.cpu() == b // 4).all())
             and np.array_equal(s0.cpu().numpy(), shifts),
             f"the estimator at the true STF start: beta "
             f"{beta0.unique().tolist()}, shifts {s0.tolist()} (want {shifts.tolist()})")

    rms_pkt = rep["rms"]
    rms_noise = inp["nv"] ** 0.5
    rmin = float((rms_noise * rms_pkt.min()) ** 0.5)
    s_gated = build_sync(u, b, T, params=SyncParams(rms_min=rmin), device=dev)
    rep_g = {k: v.cpu() for k, v in s_gated(y).items()}
    _require(torch.equal(rep_g["detected"], rep["detected"])
             and torch.equal(rep_g["t_fine"], rep["t_fine"]),
             f"rms_min {rmin:.4g} between noise {rms_noise:.4g} and packets "
             f"{float(rms_pkt.min()):.4g}: detections differ from the ungated sync")
    rmax_pkt = float(rms_pkt.max())
    s_above = build_sync(u, b, T, params=SyncParams(rms_min=10 * rmax_pkt),
                         device=dev)
    n_above = int(s_above(y)["detected"].sum())
    _require(n_above == 0, f"rms_min above the packets' RMS: {n_above} detected")
    return {"summary": {
        "b_max": {"beta": b, "cfo_int": 0, "t_fine_max_err": dt},
        "upsampled": {"beta": b // 4,
                      "cfo_int_from_report_equal": float(
                          (rep_s["cfo_int"].numpy() == shifts).mean()),
                      "shifts_at_true_start": "equal"},
        "rms": {"noise": rms_noise, "packets_min": float(rms_pkt.min()),
                "packets_max": rmax_pkt, "rms_min_between": rmin,
                "rms_min_above": 10 * rmax_pkt, "detected_above": n_above}},
        "ungated": (s, y), "gated": (s_gated, y)}


def _streams(iq: torch.Tensor, nv, T: int, offs, gen, dev) -> torch.Tensor:
    return apply_awgn(_place(iq, T, offs), nv,
                      draw_noise(gen, (iq.shape[0], iq.shape[1], T), dev))


def chestim(psdef: PacketSizesDef, B: int, B_fade: int, T: int, device,
            snr_db: float = 20.0, n_cpu: int = 4, seed: int = 3) -> dict:
    """The chestim part's gates (module docstring): per option decode_ok at
    AWGN and tb_ok over the fading channel; the host seconds of the AWGN
    runs, the fading runs and the CPU's runs."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    ps = get_packet_sizes(psdef)
    n_pkt = ps.N_samples_packet
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = build_sync(psdef.u, psdef.b, T, device=dev)
    rxs = {name: build_rx_stream(psdef, NID, 1, T, dev, **kw)
           for name, kw in CHESTIM_OPTIONS}
    out = {"awgn": {}, "fading": {}, "card_vs_cpu": {}, "seconds": {}}

    plcf, tb, fl = _bits(ps, B, seed, dev)
    iq = build_tx(psdef, NID, 1, device=dev)(plcf, tb, fl, fl)
    nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
    y = _streams(iq, nv, T, rng.integers(64, T - n_pkt - 64, B), gen, dev)
    rep = s(y)
    for name, rx in rxs.items():
        ok = _decoded(rx(y, rep["t_fine"], rep["cfo"], nv), tb) & rep["detected"]
        out["awgn"][name] = float(ok.float().mean())
        _require(out["awgn"][name] >= 0.95,
                 f"{name} at {snr_db} dB: decode_ok {out['awgn'][name]:.3f}")
    out["seconds"]["awgn"] = time.perf_counter() - t0

    # the loopback's doubly-selective channel (FADING), same power profile
    pdp, tau, fd = parse_channel(FADING)
    samp_rate = 1_728_000 * psdef.u * psdef.b
    plcf, tb, fl = _bits(ps, B_fade, seed + 1, dev)
    iq = build_tx(psdef, NID, 1, device=dev)(plcf, tb, fl, fl)
    nv = noise_var_for_snr((iq.abs() ** 2).mean(), snr_db)
    n_taps = tap_table(samp_rate, tau, pdp)[0].size
    theta, phi = draw_doubly(gen, B_fade, 1, 1, n_taps, N_SIN, dev)
    iq = apply_doubly(iq, theta, phi, samp_rate, tau, fd, pdp)
    y = _streams(iq, nv, T, rng.integers(64, T - n_pkt - 64, B_fade), gen, dev)
    rep = s(y)
    n = min(n_cpu, B_fade)
    card = {}
    for name, rx in rxs.items():
        o = rx(y, rep["t_fine"], rep["cfo"], nv)
        out["fading"][name] = float((_decoded(o, tb) & rep["detected"]).float().mean())
        card[name] = (o["tb_ok"][:n].cpu(), o["tb"][:n].cpu())
    t1 = time.perf_counter()
    out["seconds"]["fading"] = t1 - t0 - out["seconds"]["awgn"]

    # the first n fading streams on the CPU, with the card's sync report
    cpu_in = (y[:n].cpu(), rep["t_fine"][:n].cpu(), rep["cfo"][:n].cpu(),
              nv.cpu())
    for name, kw in CHESTIM_OPTIONS:
        o_c = build_rx_stream(psdef, NID, 1, T, "cpu", **kw)(*cpu_in)
        (ok_k, tb_k), ok_c = card[name], o_c["tb_ok"]
        _require(torch.equal(ok_k, ok_c) and torch.equal(tb_k[ok_c], o_c["tb"][ok_c]),
                 f"{name}: card tb_ok {ok_k.tolist()} vs CPU {ok_c.tolist()} "
                 "(or TBs differ where the CRC holds)")
        out["card_vs_cpu"][name] = ok_c.tolist()
    out["seconds"]["cpu"] = time.perf_counter() - t1
    return out


MMIES = (RouteInfoIE(sink_address=0xAABBCCDD, route_cost=2,
                     application_sequence_number=7),
         MeasurementReportIE(rach=1, snr=120),
         PowerTargetIE(power_target_dbm_coded=55))


def mmie(device) -> list:
    """The MMIE round trip at 25 dB: the three MMIEs back, equal."""
    got = loopback_mmie_roundtrip(list(MMIES), Identity(0x12345678, 0x2222, 0x3333),
                                  snr_db=25.0, device=device)
    _require([type(m).__name__ for m in got] == [type(m).__name__ for m in MMIES]
             and all(g == m for g, m in zip(got, MMIES)),
             f"MMIE round trip returned {got}")
    return [type(m).__name__ for m in got]
