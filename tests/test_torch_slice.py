"""The port's flagship-shaped stream step vs the JAX package, end to end.

The step of bench.py::_make_step (TX -> scatter at offsets -> AWGN -> sync
with multi-peak masking -> per-packet stream RX) at a small size:
PacketSizesDef(1, 1, 0, 2, 0, 4, 6144) has K = 960, so its PDC runs the
windowed BCJR (the CUDA kernel's plain twin here), and the sync runs the
detection kernel's plain twin. B = 2 streams of 4 packet lengths + 1024
samples with 2 packets each. One numpy noise draw is added on both sides.
"""
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
    step = make_flagship_step(TPacketSizesDef(1, 1, 0, 2, 0, 4, 6144), T, n_pkts)
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


@pytest.mark.parametrize("tm", [
    0,
    3,      # N_TX = 2 through codebook entry 0, 2 RX rows
])
def test_aligned_rx_matches_jax(tm):
    """build_rx and build_tx at their defaults on aligned packets (no sync)
    against the JAX builders."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    psdef = PacketSizesDef(1, 2, 0, 2, tm, 3, 6144)
    psdef_t = TPacketSizesDef(1, 2, 0, 2, tm, 3, 6144)
    ps = get_packet_sizes(psdef)
    B = 3
    rng = np.random.default_rng(tm)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(psdef_t, NID, 1)(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq_j, rtol=1e-4, atol=1e-5)

    nv = np.float32(10.0 ** (-18.0 / 10.0))
    y = (iq_j + np.sqrt(nv / 2) * (rng.standard_normal(iq_j.shape)
                                   + 1j * rng.standard_normal(iq_j.shape))
         ).astype(np.complex64)
    y *= np.exp(1j * 1e-4 * np.arange(y.shape[-1])).astype(np.complex64)
    o_j = build_rx(psdef, NID, 1)(jnp.asarray(y), jnp.float32(nv))
    o_t = t_build_rx(psdef_t, NID, 1)(torch.as_tensor(y), float(nv))
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
    ("rx", {"genie": True}),
    ("tx", {"codebook_idx": 3}),
    ("tx", {"rv": 2}),
    ("tx", {"window_fraction": 0.1}),
])
def test_unported_options_raise(builder, kw):
    """Options the JAX builders take beyond the slice's defaults are refused,
    not silently run at their defaults."""
    from dectnrp_tpu_torch.phy.rx import build_rx
    from dectnrp_tpu_torch.phy.tx import build_tx

    build = build_rx if builder == "rx" else build_tx
    with pytest.raises(NotImplementedError):
        build(TPacketSizesDef(1, 2, 0, 2, 0, 3, 6144), NID, 1, **kw)
