"""The port's stream steps vs the JAX package, end to end.

The step of bench.py::_make_step (TX -> [10/9 resampler] -> scatter at
offsets -> AWGN -> [9/10 resampler] -> sync with multi-peak masking ->
per-packet stream RX) at small sizes:
- flagship-shaped: PacketSizesDef(1, 1, 0, 2, 0, 4, 6144) has K = 960, so
  its PDC runs the windowed BCJR (the CUDA kernel's plain twin here), and
  the sync runs the detection kernel's plain twin. B = 2 streams of 4
  packet lengths + 1024 samples with 2 packets each.
- wall-shaped: PacketSizesDef(1, 1, 0, 3, 5, 2, 6144), N_TX = 4 Alamouti
  with the resampler in both directions (the polyphase kernel's plain twin),
  K = 768; B = 2 streams with 1 packet each at 20 dB.
One numpy noise draw is added on both sides.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu_torch.sections.part3.packet_sizes import \
    PacketSizesDef as TPacketSizesDef

torch.set_num_threads(1)

NID = 0x12345678


def test_flagship_shaped_step_matches_jax():
    from dectnrp_tpu.phy.sync import build_rx_stream, build_sync
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.loopback import make_flagship_step, packet_offsets
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import sync_detect

    psdef = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)
    ps = get_packet_sizes(psdef)
    n_pkt = ps.N_samples_packet
    B, n_pkts, T = 2, 2, 4 * n_pkt + 1024
    nv = np.float32(10.0 ** (-15.0 / 10.0))
    rng = np.random.default_rng(7)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    offs = packet_offsets(rng, B, n_pkts, T, n_pkt)
    noise = (np.sqrt(nv / 2) * (rng.standard_normal((B, 1, T))
                                + 1j * rng.standard_normal((B, 1, T)))
             ).astype(np.complex64)

    # ---- JAX reference, stage by stage as in bench.py:63-90
    fl = jnp.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1)(jnp.asarray(plcf), jnp.asarray(tb),
                                              fl, fl))
    y = noise.copy()
    for i in range(B):
        for k in range(n_pkts):
            y[i, :, offs[i, k]:offs[i, k] + n_pkt] += iq_j[i]
    rep_j = build_sync(psdef.u, psdef.b, T, max_peaks=n_pkts)(jnp.asarray(y))
    rxs_j = build_rx_stream(psdef, NID, 1, T)
    out_j = [rxs_j(jnp.asarray(y), rep_j["t_fine"][:, k], rep_j["cfo"][:, k],
                   jnp.float32(nv)) for k in range(n_pkts)]

    # ---- the port, through its step's stages
    step = make_flagship_step(TPacketSizesDef(1, 1, 0, 2, 0, 4, 6144), T, n_pkts,
                              device="cpu")
    n_bcjr, n_sync = bcjr_cuda.launches, sync_detect.launches
    iq_t = step.tx(torch.as_tensor(plcf), torch.as_tensor(tb),
                   torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool))
    np.testing.assert_allclose(iq_t.numpy(), iq_j, rtol=1e-4, atol=1e-5)
    stream = step.stream(torch.as_tensor(plcf), torch.as_tensor(tb),
                         torch.as_tensor(offs))
    y_t = stream + torch.as_tensor(noise)
    np.testing.assert_allclose(y_t.numpy(), y, rtol=1e-4, atol=1e-5)
    ok, det, tf = step.receive(y_t)
    rep_t = step.sync(y_t)
    for k in ("t_fine", "detected", "n_eff_tx"):
        np.testing.assert_array_equal(rep_t[k].numpy(), np.asarray(rep_j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(rep_t["cfo"].numpy(), np.asarray(rep_j["cfo"]),
                               atol=1e-6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rep_j["t_fine"]))
    np.testing.assert_array_equal(det.numpy(), np.asarray(rep_j["detected"]))
    for k in range(n_pkts):
        o_t = step.rxs(y_t, tf[:, k], rep_t["cfo"][:, k], step.noise_var)
        for key in ("tb_ok", "tb", "plcf1", "plcf1_ok"):
            np.testing.assert_array_equal(o_t[key].numpy(),
                                          np.asarray(out_j[k][key]), err_msg=key)
        np.testing.assert_array_equal(ok[:, k].numpy(),
                                      np.asarray(out_j[k]["tb_ok"]))
    # operating SNR: everything decodes, and the decoded bits are the sent ones
    assert ok.numpy().all() and det.numpy().all()
    np.testing.assert_array_equal(o_t["tb"].numpy(), tb)
    np.testing.assert_array_equal(o_t["plcf1"].numpy(), plcf)
    # CPU tensors never launch a kernel
    assert (bcjr_cuda.launches, sync_detect.launches) == (n_bcjr, n_sync)


def test_wall_shaped_step_matches_jax():
    from dectnrp_tpu.phy.resampler import ResamplerPlan, build_resampler
    from dectnrp_tpu.phy.sync import build_rx_stream, build_sync
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.loopback import make_wall_step, packet_offsets
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect

    psdef = PacketSizesDef(1, 1, 0, 3, 5, 2, 6144)
    ps = get_packet_sizes(psdef)
    n_pkt = ps.N_samples_packet
    B, T = 2, 3 * n_pkt + 1024
    step = make_wall_step(TPacketSizesDef(1, 1, 0, 3, 5, 2, 6144), T,
                          device="cpu")
    # the bench's roundings (bench.py:52-58)
    n_pkt_hw, T_hw = -(-n_pkt * 10 // 9), -(-T * 10 // 9) // 10 * 10
    T_dect = -(-T_hw * 9 // 10)
    assert (step.n_pkt, step.T, step.T_dect) == (n_pkt_hw, T_hw, T_dect)
    nv = np.float32(10.0 ** (-20.0 / 10.0))
    rng = np.random.default_rng(11)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    offs = packet_offsets(rng, B, 1, T_hw, n_pkt_hw)
    noise = (np.sqrt(nv / 2) * (rng.standard_normal((B, 4, T_hw))
                                + 1j * rng.standard_normal((B, 4, T_hw)))
             ).astype(np.complex64)

    # ---- JAX reference, stage by stage as in bench.py:63-90
    fl = jnp.zeros((B,), bool)
    iq_j = build_tx(psdef, NID, 1)(jnp.asarray(plcf), jnp.asarray(tb), fl, fl)
    up_j = np.asarray(build_resampler(ResamplerPlan(10, 9), n_pkt)(iq_j))
    y = noise.copy()
    for i in range(B):
        y[i, :, offs[i, 0]:offs[i, 0] + n_pkt_hw] += up_j[i]
    down_j = np.asarray(build_resampler(ResamplerPlan(9, 10), T_hw)(jnp.asarray(y)))
    rep_j = build_sync(psdef.u, psdef.b, T_dect)(jnp.asarray(down_j))
    out_j = build_rx_stream(psdef, NID, 1, T_dect)(
        jnp.asarray(down_j), rep_j["t_fine"], rep_j["cfo"], jnp.float32(nv))

    # ---- the port, through its step's stages
    launches = (bcjr_cuda.launches, sync_detect.launches, polyphase.launches)
    pl_t, tb_t = torch.as_tensor(plcf), torch.as_tensor(tb)
    up_t = step.resample_up(step.transmit(pl_t, tb_t))
    np.testing.assert_allclose(up_t.numpy(), up_j, rtol=1e-4, atol=1e-5)
    y_t = step.scatter(up_t, torch.as_tensor(offs)) + torch.as_tensor(noise)
    down_t = step.resample_down(y_t)
    np.testing.assert_allclose(down_t.numpy(), down_j, rtol=1e-4, atol=1e-5)
    rep_t = step.sync(down_t)
    for k in ("t_fine", "detected", "n_eff_tx"):
        np.testing.assert_array_equal(rep_t[k].numpy(), np.asarray(rep_j[k]),
                                      err_msg=k)
    ok, det, tf = step.receive(down_t)
    np.testing.assert_array_equal(tf[:, 0].numpy(), np.asarray(rep_j["t_fine"]))
    o_t = step.rxs(down_t, tf[:, 0], rep_t["cfo"], step.noise_var)
    for key in ("tb_ok", "tb", "plcf1", "plcf1_ok"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(out_j[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(ok[:, 0].numpy(), np.asarray(out_j["tb_ok"]))
    # operating SNR: everything decodes, and the decoded bits are the sent ones
    assert ok.numpy().all() and det.numpy().all()
    np.testing.assert_array_equal(o_t["tb"].numpy(), tb)
    np.testing.assert_array_equal(o_t["plcf1"].numpy(), plcf)
    # CPU tensors never launch a kernel
    assert (bcjr_cuda.launches, sync_detect.launches,
            polyphase.launches) == launches


#: aligned-RX configurations by tm mode: SISO, N_TX = 2 through codebook
#: entry 0 (2 RX rows), Alamouti over 2 and over 4 transmit streams
ALIGNED = {0: (1, 2, 0, 2, 0, 3, 6144), 3: (1, 2, 0, 2, 3, 3, 6144),
           1: (1, 2, 0, 2, 1, 3, 6144), 5: (1, 1, 0, 3, 5, 2, 6144)}


@pytest.mark.parametrize("tm", [0, 3, 1, 5])
def test_aligned_rx_matches_jax(tm):
    """build_rx and build_tx at their defaults on aligned packets (no sync)
    against the JAX builders."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    psdef = PacketSizesDef(*ALIGNED[tm])
    psdef_t = TPacketSizesDef(*ALIGNED[tm])
    ps = get_packet_sizes(psdef)
    B = 3
    rng = np.random.default_rng(tm)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(psdef_t, NID, 1, device="cpu")(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq_j, rtol=1e-4, atol=1e-5)

    nv = np.float32(10.0 ** (-18.0 / 10.0))
    y = (iq_j + np.sqrt(nv / 2) * (rng.standard_normal(iq_j.shape)
                                   + 1j * rng.standard_normal(iq_j.shape))
         ).astype(np.complex64)
    y *= np.exp(1j * 1e-4 * np.arange(y.shape[-1])).astype(np.complex64)
    o_j = build_rx(psdef, NID, 1)(jnp.asarray(y), jnp.float32(nv))
    o_t = t_build_rx(psdef_t, NID, 1, device="cpu")(torch.as_tensor(y), float(nv))
    for key in ("plcf1", "plcf1_ok", "plcf2_ok", "plcf1_cl", "plcf1_bf"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(o_j[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(o_t["tb_ok"].numpy(), np.asarray(o_j["tb_ok"]))
    assert o_t["tb_ok"].numpy().all()
    np.testing.assert_array_equal(o_t["tb"].numpy(), tb)
    for key, tol in (("snr_db", 1e-3), ("cfo_res", 1e-6), ("sto_frac", 1e-4)):
        np.testing.assert_allclose(o_t[key].numpy(), np.asarray(o_j[key]),
                                   atol=tol, err_msg=key)
    np.testing.assert_allclose(o_t["h_cells"].numpy(), np.asarray(o_j["h_cells"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("builder,kw", [
    ("rx", {"chestim_mode": "lr_f"}),
    ("rx", {"freq_kind": "linear"}),
    ("rx", {"time_kind": "wiener"}),
    ("rx", {"dd_passes": 1}),
    ("rx", {"est_sto": False}),
    ("rx", {"est_cfo": False}),
    ("tx", {"codebook_idx": 3}),
    ("tx", {"codebook_idx": 1, "rv": 2}),
    ("tx", {"window_fraction": 0.1}),
    # genie and N_SS > 1 beside the chestim and TX options
    ("rx", {"genie": True, "dd_passes": 1}),
    ("rx", {"genie": True, "freq_kind": "linear"}),
    ("rx", {"tm": 2, "chestim_mode": "lr_f"}),
    ("tx", {"tm": 2, "codebook_idx": 1}),
    ("tx", {"tm": 2, "window_fraction": 0.1}),
])
def test_unported_options_raise(builder, kw):
    """Every option and mode of the JAX builders, once refused by the port,
    decides as JAX's on the same inputs: TX IQ within rtol 1e-5 / atol 1e-6;
    RX plcf1 / plcf*_ok / tb_ok equal, tb equal where the CRC holds,
    snr_db within 1e-3. A codebook index beyond the codebook raises
    ValueError in both packages (tm 0 has one entry)."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    kw = dict(kw)
    tm = kw.pop("tm", 0)
    args = (1, 2, 0, 2, tm, 3, 6144)
    psdef, ps = PacketSizesDef(*args), get_packet_sizes(PacketSizesDef(*args))
    B = 2
    rng = np.random.default_rng(60 + tm + len(str(kw)))
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    jin = (jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl))
    tin = (torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
           torch.as_tensor(fl))
    if builder == "tx":
        if tm == 0 and kw.get("codebook_idx", 0) > 0:
            with pytest.raises(ValueError, match="codebook index"):
                build_tx(psdef, NID, 1, **kw)
            with pytest.raises(ValueError, match="codebook index"):
                t_build_tx(TPacketSizesDef(*args), NID, 1, device="cpu", **kw)
            return
        iq_j = np.asarray(build_tx(psdef, NID, 1, **kw)(*jin))
        iq_t = t_build_tx(TPacketSizesDef(*args), NID, 1, device="cpu",
                          **kw)(*tin).numpy()
        np.testing.assert_allclose(iq_t, iq_j, rtol=1e-5, atol=1e-6)
        assert iq_t.shape == (B, ps.tm_mode.N_TX, ps.N_samples_packet)
        return
    iq = np.asarray(build_tx(psdef, NID, 1)(*jin))
    n_tx, n_rx = iq.shape[1], ps.tm_mode.N_SS
    H = ((rng.standard_normal((B, n_rx, n_tx)) + 1j * rng.standard_normal(
        (B, n_rx, n_tx))) / np.sqrt(2)).astype(np.complex64)
    nv = np.float32(10.0 ** (-22.0 / 10.0))
    y = np.einsum("brt,btn->brn", H, iq)
    y = (y + np.sqrt(nv / 2) * (rng.standard_normal(y.shape)
                                + 1j * rng.standard_normal(y.shape)))
    y = (y * np.exp(1j * 1e-4 * np.arange(y.shape[-1]))).astype(np.complex64)
    extra = ()
    if kw.get("genie"):
        q = ps.numerology
        extra = (np.broadcast_to(H[:, :, :, None, None], (
            B, n_rx, n_tx, ps.N_PACKET_symb, q.N_b_OCC)).copy(),)
    o_j = build_rx(psdef, NID, 1, **kw)(jnp.asarray(y), jnp.float32(nv),
                                       *map(jnp.asarray, extra))
    o_t = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu", **kw)(
        torch.as_tensor(y), torch.tensor(nv), *map(torch.as_tensor, extra))
    for key in ("plcf1", "plcf1_ok", "plcf2_ok", "tb_ok"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(o_j[key]),
                                      err_msg=key)
    ok = o_t["tb_ok"].numpy()
    np.testing.assert_array_equal(o_t["tb"].numpy()[ok], np.asarray(o_j["tb"])[ok])
    assert ok.any()
    np.testing.assert_allclose(o_t["snr_db"].numpy(), np.asarray(o_j["snr_db"]),
                               atol=1e-3)


@pytest.mark.parametrize("option", ["tx_tm2", "rx_tm2", "rx_genie"])
def test_formerly_refused_options_match_jax(option):
    """The options that were refused until ported: N_SS = 2 spatial
    multiplexing in TX (tm 2) and MMSE in RX, and the genie RX on a flat
    true channel (h_genie constant over symbols and subcarriers), each
    against the JAX builders on the same inputs."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    tm = 0 if option == "rx_genie" else 2
    args = (1, 1, 0, 2, tm, 3, 6144)
    psdef, ps = PacketSizesDef(*args), get_packet_sizes(PacketSizesDef(*args))
    B = 2
    rng = np.random.default_rng(50 + tm)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(TPacketSizesDef(*args), NID, 1, device="cpu")(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq_j, rtol=1e-5, atol=1e-6)
    if option == "tx_tm2":
        assert iq_t.shape[1] == 2
        return
    n_tx = iq_j.shape[1]
    H = ((rng.standard_normal((B, 2, n_tx)) + 1j * rng.standard_normal((B, 2, n_tx)))
         / np.sqrt(2)).astype(np.complex64)
    nv = np.float32(10.0 ** (-25.0 / 10.0))
    y = np.einsum("brt,btn->brn", H, iq_j)
    y = (y + np.sqrt(nv / 2) * (rng.standard_normal(y.shape)
                                + 1j * rng.standard_normal(y.shape))
         ).astype(np.complex64)
    kw, extra = {}, ()
    if option == "rx_genie":
        kw = {"genie": True}
        q = ps.numerology
        hg = np.broadcast_to(H[:, :, :, None, None], (B, 2, n_tx, ps.N_PACKET_symb,
                                                      q.N_b_OCC)).copy()
        extra = (hg,)
    o_j = build_rx(psdef, NID, 1, **kw)(jnp.asarray(y), jnp.float32(nv),
                                       *map(jnp.asarray, extra))
    o_t = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu", **kw)(
        torch.as_tensor(y), torch.tensor(nv), *map(torch.as_tensor, extra))
    for key in ("plcf1", "plcf1_ok", "plcf2_ok", "tb_ok", "tb"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(o_j[key]),
                                      err_msg=key)
    assert o_t["tb_ok"].all()
    np.testing.assert_array_equal(o_t["tb"].numpy(), tb)
    np.testing.assert_allclose(o_t["snr_db"].numpy(), np.asarray(o_j["snr_db"]),
                               atol=1e-3)


@pytest.mark.parametrize("tm,rv", [(0, 2), (5, 3)])
def test_tx_redundancy_version_matches_jax(tm, rv):
    """build_tx(rv > 0), the HARQ retransmissions' packets, against JAX's."""
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    psdef = PacketSizesDef(*ALIGNED[tm])
    ps = get_packet_sizes(psdef)
    B = 2
    rng = np.random.default_rng(20 + rv)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1, rv=rv)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(TPacketSizesDef(*ALIGNED[tm]), NID, 1, rv=rv, device="cpu")(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq_j, rtol=1e-4, atol=1e-5)
    iq_0 = np.asarray(build_tx(psdef, NID, 1)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    assert not np.allclose(iq_t, iq_0, atol=1e-3)    # rv moved the PDC bits


def test_builders_default_to_the_card():
    """Every builder and step factory builds on "cuda" unless asked, and
    device="cpu" puts every buffer of the module on the CPU."""
    from dectnrp_tpu_torch import loopback
    from dectnrp_tpu_torch.phy import resampler, rx, sync, tx
    from dectnrp_tpu_torch.upper import loopback as upper_loopback

    builders = [tx.build_tx, sync.build_sync, rx.build_rx, sync.build_rx_stream,
                resampler.build_resampler, resampler.build_resampler_stream,
                loopback.make_flagship_step, loopback.make_wall_step,
                upper_loopback.PointStep, upper_loopback.point_step,
                upper_loopback.LoopbackSnrExperiment,
                upper_loopback.LoopbackRatioExperiment]
    for f in builders:
        assert inspect.signature(f).parameters["device"].default == "cuda", f
    psdef = TPacketSizesDef(1, 1, 0, 3, 5, 2, 6144)
    plan = resampler.ResamplerPlan(10, 9)
    mods = [tx.build_tx(psdef, NID, 1, device="cpu"),
            sync.build_sync(1, 1, 4000, device="cpu"),
            rx.build_rx(psdef, NID, 1, device="cpu"),
            sync.build_rx_stream(psdef, NID, 1, 4000, device="cpu"),
            resampler.build_resampler(plan, 900, device="cpu"),
            resampler.build_resampler_stream(plan, 900, device="cpu"),
            loopback.make_flagship_step(TPacketSizesDef(1, 1, 0, 2, 0, 4, 6144),
                                        device="cpu"),
            loopback.make_wall_step(psdef, device="cpu"),
            upper_loopback.PointStep(TPacketSizesDef(1, 1, 0, 2, 2, 2, 6144), NID,
                                     True, None, "doubly_0_363_222", True,
                                     device="cpu")]
    for m in mods:
        bufs = list(m.buffers())
        assert bufs and all(b.device.type == "cpu" for b in bufs), type(m)
