"""TX raised-cosine OFDM windowing and the duration LUT, mirrored on the
port (tests/test_tx_windowing.py).

Oracles: reference tx.cpp:882-911 (PHY_TX_OFDM_WINDOWING overlap-add) and
sections_part3/derivative/duration_lut.hpp:31-73. The port's windowed IQ is
held to JAX's on the same bits (rtol 1e-5 / atol 1e-6), then checked as
the JAX test checks it, through the port's RX.
"""
import numpy as np
import torch

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef as JPacketSizesDef
from dectnrp_tpu_torch.sections.part3.packet_sizes import (PacketSizesDef,
                                                           get_packet_sizes)

torch.set_num_threads(1)

NID = 0x12345678
PSDEF = (1, 2, 0, 2, 0, 3, 6144)


def _tx_packet(window_fraction, B=4, seed=0):
    """The port's windowed TX (held to JAX's) -> (iq numpy, tb numpy)."""
    from dectnrp_tpu.phy.tx import build_tx as j_build_tx
    from dectnrp_tpu_torch.phy.tx import build_tx

    ps = get_packet_sizes(PacketSizesDef(*PSDEF))
    rng = np.random.default_rng(seed)
    plcf = rng.integers(0, 2, (B, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    fl = np.zeros((B,), bool)
    iq = build_tx(PacketSizesDef(*PSDEF), NID, 1, window_fraction=window_fraction,
                  device="cpu")(torch.as_tensor(plcf), torch.as_tensor(tb),
                                torch.as_tensor(fl), torch.as_tensor(fl)).numpy()
    iq_j = np.asarray(j_build_tx(JPacketSizesDef(*PSDEF), NID, 1,
                                 window_fraction=window_fraction)(
        jnp.asarray(plcf), jnp.asarray(tb), jnp.asarray(fl), jnp.asarray(fl)))
    np.testing.assert_allclose(iq, iq_j, rtol=1e-5, atol=1e-6)
    return iq, tb


def _oob_power_db(iq):
    """Mean PSD (dB) well outside the occupied band (|f| in 0.46..0.5 of fs)."""
    n = iq.shape[-1]
    psd = np.mean(np.abs(np.fft.fft(iq.reshape(-1, n), axis=-1)) ** 2, axis=0)
    f = np.abs(np.fft.fftfreq(n))
    return 10 * np.log10(np.mean(psd[(f > 0.46) & (f < 0.50)]) + 1e-30)


def test_windowed_tx_decodes_bit_exact():
    from dectnrp_tpu_torch.phy.rx import build_rx

    iq, tb = _tx_packet(0.25)
    nv = 1e-4 * float(np.mean(np.abs(iq) ** 2))
    out = build_rx(PacketSizesDef(*PSDEF), NID, 1, device="cpu")(
        torch.as_tensor(iq), nv)
    assert bool(out["tb_ok"].all())
    np.testing.assert_array_equal(out["tb"].numpy(), tb)


def test_windowing_reduces_oob_skirts():
    iq_hard, _ = _tx_packet(0.0)
    iq_win, _ = _tx_packet(0.25)
    # the same in-band energy (windowing shapes only CP heads / GI start)
    assert np.isclose(np.mean(np.abs(iq_hard) ** 2),
                      np.mean(np.abs(iq_win) ** 2), rtol=0.02)
    base = _oob_power_db(iq_hard)
    gain_db = base - _oob_power_db(iq_win)
    assert gain_db > 1.0, f"windowing gained only {gain_db:.1f} dB OOB"
    # longer transitions suppress the skirts further
    iq_w2, _ = _tx_packet(0.5)
    gain2_db = base - _oob_power_db(iq_w2)
    assert gain2_db > gain_db + 1.0, (gain_db, gain2_db)


def test_duration_lut():
    """The port's copy against the reference values, and equal to JAX's
    table at both rates."""
    from dectnrp_tpu.sections.part3 import duration_lut as J
    from dectnrp_tpu_torch.sections.part3.duration_lut import DurationEc, DurationLut

    lut = DurationLut(1_728_000)
    assert lut.get_N_samples_from_subslots(1) == 360
    assert lut.get_N_samples_from_duration(DurationEc.SLOT) == 720
    assert lut.get_N_samples_from_duration(DurationEc.MS, 10) == 17280
    lut2 = DurationLut(1_920_000)                 # SDR rate
    assert lut2.get_N_samples_from_subslots(1) == 400
    assert lut2.get_N_samples_at_next_full_second(1) == 1_920_000
    assert lut2.get_N_samples_at_last_full_second(1_920_001) == 1_920_000
    assert lut2.get_N_ns_from_samples(1_920_000) == 1_000_000_000
    assert lut2.get_N_ns_from_samples(192) == 100_000
    assert lut2.get_N_duration_in_second(DurationEc.SUBSLOT_U8) == 38400
    for rate in (1_728_000, 1_920_000):
        t, j = DurationLut(rate), J.DurationLut(rate)
        for ec in DurationEc:
            assert t.get_N_samples_from_duration(ec, 3) == \
                j.get_N_samples_from_duration(J.DurationEc[ec.name], 3)
