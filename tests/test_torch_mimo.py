"""N_SS > 1 spatial multiplexing (MMSE) and the genie RX: the port vs the
JAX package on the same inputs.

The cases of tests/test_mimo_mmse.py run through both packages on the same
numpy-drawn MIMO channel and noise: TX within 1e-6, equal PCC and TB
decisions, and equal decoded bits wherever the TB CRC holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu_torch.sections.part3.packet_sizes import \
    PacketSizesDef as TPacketSizesDef

torch.set_num_threads(1)

NID = 0x12345678


def _noise(rng, shape, nv):
    """JAX's convention: sqrt(nv / 2) (n1 + j n2)."""
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _both_tx(psdef_args, B, seed):
    from dectnrp_tpu.phy.tx import build_tx
    from dectnrp_tpu_torch.phy.tx import build_tx as t_build_tx

    psdef = PacketSizesDef(*psdef_args)
    ps = get_packet_sizes(psdef)
    rng = np.random.default_rng(seed)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq_j = np.asarray(build_tx(psdef, NID, 1)(jnp.asarray(plcf), jnp.asarray(tb),
                                              jnp.asarray(fl), jnp.asarray(fl)))
    iq_t = t_build_tx(TPacketSizesDef(*psdef_args), NID, 1, device="cpu")(
        torch.as_tensor(plcf), torch.as_tensor(tb), torch.as_tensor(fl),
        torch.as_tensor(fl)).numpy()
    np.testing.assert_allclose(iq_t, iq_j, rtol=1e-5, atol=1e-6)
    return iq_j, plcf, tb, rng


def _assert_decisions(o_t, o_j, tb):
    for key in ("plcf1_ok", "plcf2_ok", "tb_ok"):
        np.testing.assert_array_equal(o_t[key].numpy(), np.asarray(o_j[key]),
                                      err_msg=key)
    ok = np.asarray(o_j["tb_ok"])
    np.testing.assert_array_equal(o_t["tb"].numpy()[ok], np.asarray(o_j["tb"])[ok])
    np.testing.assert_array_equal(o_t["tb"].numpy()[ok], tb[ok])
    pok = np.asarray(o_j["plcf1_ok"])
    np.testing.assert_array_equal(o_t["plcf1"].numpy()[pok],
                                  np.asarray(o_j["plcf1"])[pok])
    np.testing.assert_allclose(o_t["snr_db"].numpy(), np.asarray(o_j["snr_db"]),
                               atol=1e-3)


# (tm mode, RX antennas, SNR dB, packets, PacketLength, all decode?) as
# tests/test_mimo_mmse.py: 2x2, 2x4, 4x4, 8x8 and the low-SNR failure
MMSE_CASES = [(2, 2, 30.0, 4, 2, True), (2, 4, 20.0, 4, 2, True),
              (6, 4, 35.0, 2, 4, True), (11, 8, 35.0, 2, 4, True),
              (2, 2, -10.0, 4, 2, False)]


@pytest.mark.parametrize("tm,n_rx,snr_db,B,plen,decodes", MMSE_CASES)
def test_mmse_loopback_matches_jax(tm, n_rx, snr_db, B, plen, decodes):
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx

    args = (1, 1, 0, plen, tm, 2, 6144)
    assert get_packet_sizes(PacketSizesDef(*args)).tm_mode.N_SS > 1
    iq, plcf, tb, rng = _both_tx(args, B, seed=tm + n_rx)
    H = (rng.standard_normal((B, n_rx, iq.shape[1]))
         + 1j * rng.standard_normal((B, n_rx, iq.shape[1]))) / np.sqrt(2)
    y = np.einsum("brt,btn->brn", H, iq).astype(np.complex64)
    nv = np.float32(np.mean(np.abs(y) ** 2) / 10 ** (snr_db / 10))
    y = y + _noise(rng, y.shape, nv)
    o_j = build_rx(PacketSizesDef(*args), NID, 1)(jnp.asarray(y), jnp.float32(nv))
    o_t = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu")(
        torch.as_tensor(y), torch.tensor(nv))
    _assert_decisions(o_t, o_j, tb)
    if decodes:
        assert o_t["tb_ok"].all() and o_t["plcf1_ok"].all()
    else:
        assert not o_t["tb_ok"].any()


@pytest.mark.parametrize("S,R", [(2, 2), (2, 4), (4, 4), (8, 8)])
def test_mmse_equalizer_matches_jax(S, R):
    """_mmse alone on random channels, cells and noise levels: the
    unbiased estimates and SINRs within rtol 1e-3 / atol 1e-2 (soft
    values), and within 1e-4 relative on well-conditioned cells."""
    from dectnrp_tpu.phy.rx import _mmse as j_mmse
    from dectnrp_tpu_torch.phy.rx import _mmse

    rng = np.random.default_rng(S * 10 + R)
    B, n = 3, 50
    h = ((rng.standard_normal((B, R, S, n)) + 1j * rng.standard_normal((B, R, S, n)))
         / np.sqrt(2)).astype(np.complex64)
    y = ((rng.standard_normal((B, R, n)) + 1j * rng.standard_normal((B, R, n)))
         ).astype(np.complex64)
    for nv in (np.float32(0.01), np.float32(0.5)):
        xj, sj = j_mmse(jnp.asarray(y), jnp.asarray(h), jnp.float32(nv), S)
        xt, st = _mmse(torch.as_tensor(y), torch.as_tensor(h), torch.tensor(nv), S)
        assert xt.shape == (B, S, n) and st.shape == (B, S, n)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-3, atol=1e-2)
        good = np.asarray(sj) < 1e3
        np.testing.assert_allclose(st.numpy()[good], np.asarray(sj)[good], rtol=1e-4)


@pytest.mark.parametrize("tm,snr_db", [(0, 14.0), (2, 24.0)])
def test_genie_rx_matches_jax(tm, snr_db):
    """build_rx(genie=True) on JAX's own doubly-selective channel and its
    true per-symbol response h_genie, as the fading_genie sweep feeds it."""
    from dectnrp_tpu.phy.rx import build_rx
    from dectnrp_tpu.sections.part3.phyres import k_b_OCC
    from dectnrp_tpu.simulation.channels import doubly_selective_genie
    from dectnrp_tpu_torch.phy.rx import build_rx as t_build_rx

    args = (1, 1, 0, 2, tm, 2, 6144)
    psdef = PacketSizesDef(*args)
    ps = get_packet_sizes(psdef)
    B = 4
    iq, plcf, tb, rng = _both_tx(args, B, seed=30 + tm)
    q = ps.numerology
    N, cp, n_pkt = q.N_b_DFT, q.N_b_CP, ps.N_samples_packet
    sym_centers = tuple(
        min(n_pkt - 1, ps.N_samples_STF // 2 if s == 0
            else ps.N_samples_STF + (s - 1) * (N + cp) + cp + N // 2)
        for s in range(ps.N_PACKET_symb))
    k_occ = tuple(int(k) for k in k_b_OCC(1))
    y, Hg = doubly_selective_genie(jax.random.PRNGKey(tm), jnp.asarray(iq),
                                   iq.shape[1], 1_728_000, sym_centers, k_occ, N)
    y, Hg = np.array(y), np.array(Hg)
    nv = np.float32(np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10))
    y = y + _noise(rng, y.shape, nv)
    o_j = build_rx(psdef, NID, 1, genie=True)(jnp.asarray(y), jnp.float32(nv),
                                              jnp.asarray(Hg))
    rx_t = t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu", genie=True)
    o_t = rx_t(torch.as_tensor(y), torch.tensor(nv), torch.as_tensor(Hg))
    _assert_decisions(o_t, o_j, tb)
    assert o_t["tb_ok"].any()
    for key in ("cfo_res", "sto_frac"):
        assert not o_t[key].any()
    np.testing.assert_allclose(o_t["h_cells"].numpy(), np.asarray(o_j["h_cells"]),
                               rtol=1e-5, atol=1e-6)
    # the genie receiver takes the true channel and only with genie=True
    with pytest.raises(ValueError):
        rx_t(torch.as_tensor(y), torch.tensor(nv))
    with pytest.raises(ValueError):
        t_build_rx(TPacketSizesDef(*args), NID, 1, device="cpu")(
            torch.as_tensor(y), torch.tensor(nv), torch.as_tensor(Hg))


def test_rx_stream_tm2_matches_jax():
    """build_sync + build_rx_stream at tm 2 (2 TX streams, 2 RX antennas,
    N_SS = 2), as the mimo sweep runs them: one packet per stream at a
    random offset, identity 2x2 mixing, AWGN."""
    from dectnrp_tpu.phy.sync import build_rx_stream, build_sync
    from dectnrp_tpu_torch.phy.sync import build_rx_stream as t_rxs
    from dectnrp_tpu_torch.phy.sync import build_sync as t_sync

    args = (1, 1, 0, 2, 2, 2, 6144)
    psdef = PacketSizesDef(*args)
    ps = get_packet_sizes(psdef)
    B, n_pkt = 3, ps.N_samples_packet
    T = int(2 ** np.ceil(np.log2(n_pkt + 512)))
    iq, plcf, tb, rng = _both_tx(args, B, seed=41)
    offs = rng.integers(64, T - n_pkt - 64, B)
    y = np.zeros((B, 2, T), np.complex64)
    for i in range(B):
        y[i, :, offs[i]:offs[i] + n_pkt] = iq[i]
    nv = np.float32(np.mean(np.abs(iq) ** 2) / 10 ** (12.0 / 10))
    y = y + _noise(rng, y.shape, nv)
    rep_j = build_sync(1, 1, T)(jnp.asarray(y))
    o_j = build_rx_stream(psdef, NID, 1, T)(jnp.asarray(y), rep_j["t_fine"],
                                            rep_j["cfo"], jnp.float32(nv))
    rep_t = t_sync(1, 1, T, device="cpu")(torch.as_tensor(y))
    for key in ("t_fine", "detected", "n_eff_tx"):
        np.testing.assert_array_equal(rep_t[key].numpy(), np.asarray(rep_j[key]),
                                      err_msg=key)
    o_t = t_rxs(TPacketSizesDef(*args), NID, 1, T, device="cpu")(
        torch.as_tensor(y), rep_t["t_fine"], rep_t["cfo"], torch.tensor(nv))
    _assert_decisions(o_t, o_j, tb)
    assert o_t["tb_ok"].all() and rep_t["detected"].all()
