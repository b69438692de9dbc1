"""Port's PCC / PDC FEC chains vs dectnrp_tpu.phy.fec.chain.

Encoders must be bit-exact; decoders must return the same bits and CRC
verdicts on the same noisy LLRs. TWO_K has C = 2 codeblocks in two K
groups (5504, 5568), like the flagship's 13 x 6016 + 3 x 6080.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes

torch.set_num_threads(1)

NID = 0x12345678
SMALL = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)      # C = 1, K = 960
TWO_K = PacketSizesDef(1, 4, 1, 2, 0, 4, 6144)      # C = 2, K = 5504, 5568


def _noisy(bits, rng, sigma):
    """BPSK LLRs (L = log P1/P0) of coded bits through AWGN."""
    x = 2.0 * bits.astype(np.float32) - 1.0
    return ((x + sigma * rng.standard_normal(x.shape)) * 2.0 / sigma ** 2
            ).astype(np.float32)


@pytest.mark.parametrize("plcf_type", [1, 2])
def test_pcc_encode_decode_match_jax(plcf_type):
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu_torch.phy.fec import chain as T

    rng = np.random.default_rng(plcf_type)
    B, n = 8, 40 if plcf_type == 1 else 80
    a = rng.integers(0, 2, (B, n)).astype(np.uint8)
    cl = np.array([0, 1, 0, 1, 0, 1, 0, 1], bool)
    bf = np.array([0, 0, 1, 1, 0, 0, 1, 1], bool)
    e_j = np.asarray(J.pcc_encode(jnp.asarray(a), jnp.asarray(cl),
                                  jnp.asarray(bf), plcf_type))
    e_t = T.pcc_encode(torch.as_tensor(a), torch.as_tensor(cl),
                       torch.as_tensor(bf), plcf_type).numpy()
    np.testing.assert_array_equal(e_t, e_j)

    llr = _noisy(e_j, rng, 0.7)
    out_j = J.pcc_decode(jnp.asarray(llr), plcf_type, 6)
    out_t = T.pcc_decode(torch.as_tensor(llr), plcf_type, 6)
    for x_t, x_j in zip(out_t, out_j):
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    assert out_t[1].numpy().sum() >= B - 1
    np.testing.assert_array_equal(out_t[2].numpy()[out_t[1].numpy()],
                                  cl[out_t[1].numpy()])


@pytest.mark.parametrize("psdef", [SMALL, TWO_K])
def test_pdc_encode_decode_match_jax(psdef):
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu_torch.phy.fec import chain as T

    ps = get_packet_sizes(psdef)
    key = (ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    pj, pt = J.PdcPlan.get(*key), T.PdcPlan.get(*key)
    rng = np.random.default_rng(psdef.b)
    B = 3
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    e_j = np.asarray(J.pdc_encode(jnp.asarray(tb), pj, NID, 1))
    e_t = T.pdc_encode(torch.as_tensor(tb), pt, NID, 1).numpy()
    np.testing.assert_array_equal(e_t, e_j)

    llr = _noisy(e_j, rng, 0.55)
    llr[2] = _noisy(e_j[2], rng, 2.5)         # one undecodable row
    d_j = J.pdc_dematch(jnp.asarray(llr), pj, NID, 1)
    d_t = T.pdc_dematch(torch.as_tensor(llr), pt, NID, 1)
    assert d_t.keys() == d_j.keys()
    for K in d_j:
        np.testing.assert_array_equal(d_t[K].numpy(), np.asarray(d_j[K]))
    tb_j, ok_j = J.pdc_decode(jnp.asarray(llr), pj, NID, 1, n_iter=6)
    tb_t, ok_t = T.pdc_decode(torch.as_tensor(llr), pt, NID, 1, n_iter=6)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb_j))
    assert ok_t.numpy()[:2].all() and not ok_t.numpy()[2]
    np.testing.assert_array_equal(tb_t.numpy()[:2], tb[:2])


@pytest.mark.parametrize("psdef", [SMALL, TWO_K])
def test_pdc_decode_d_fixed_iterations_match_jax(psdef):
    """pdc_decode_d(early_stop=False): a fixed number of turbo iterations,
    then the same CRC checks, as the JAX function's branch."""
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu_torch.phy.fec import chain as T

    ps = get_packet_sizes(psdef)
    key = (ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    pj, pt = J.PdcPlan.get(*key), T.PdcPlan.get(*key)
    rng = np.random.default_rng(psdef.b + 10)
    B = 3
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    e = np.asarray(J.pdc_encode(jnp.asarray(tb), pj, NID, 1))
    llr = _noisy(e, rng, 0.55)
    llr[1] = _noisy(e[1], rng, 2.5)           # one undecodable row
    d_j = J.pdc_dematch(jnp.asarray(llr), pj, NID, 1)
    d_t = T.pdc_dematch(torch.as_tensor(llr), pt, NID, 1)
    tb_j, ok_j = J.pdc_decode_d(d_j, pj, 3, early_stop=False)
    tb_t, ok_t = T.pdc_decode_d(d_t, pt, 3, early_stop=False)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb_j))
    assert ok_t.numpy()[[0, 2]].all() and not ok_t.numpy()[1]
    np.testing.assert_array_equal(tb_t.numpy()[[0, 2]], tb[[0, 2]])


@pytest.mark.parametrize("plcf_type", [1, 2])
def test_pcc_one_window_route_matches_unwindowed(plcf_type):
    """The PCC's d-LLRs (K = 56 / 96) at an operating SNR through the route
    the card takes, the float32 BCJR kernel run as one window (on CPU
    tensors its plain twin: window = K+3, impl "cuda"): the bits and the
    posterior of the unwindowed decode bit for bit, and the JAX decoder's
    bits."""
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu.phy.fec.turbo_jax import turbo_decode as j_decode
    from dectnrp_tpu_torch.phy.fec import chain as T
    from dectnrp_tpu_torch.phy.fec.turbo import turbo_decode
    from dectnrp_tpu_torch.phy.plan import device_tables

    rng = np.random.default_rng(20 + plcf_type)
    B, n = 8, 40 if plcf_type == 1 else 80
    K = n + 16
    a = rng.integers(0, 2, (B, n)).astype(np.uint8)
    flag = np.zeros(B, bool)
    e = np.asarray(J.pcc_encode(jnp.asarray(a), jnp.asarray(flag),
                                jnp.asarray(flag), plcf_type))
    e_llr = torch.as_tensor(_noisy(e, rng, 0.7))
    tb = device_tables(T._pcc_tables, (plcf_type,), e_llr.device)
    d = torch.zeros((B, 3 * (K + 4)))
    d.index_add_(1, tb["sel"], e_llr * tb["sgn"])
    d = d.reshape(B, 3, K + 4)

    bits_u, post_u = turbo_decode(d, K, 8)
    bits_w, post_w = turbo_decode(d, K, 8, window=K + 3, impl="cuda")
    assert torch.equal(bits_w, bits_u) and torch.equal(post_w, post_u)
    bits_j, _ = j_decode(jnp.asarray(d.numpy()), K, 8)
    np.testing.assert_array_equal(bits_w.numpy(), np.asarray(bits_j))
    assert (bits_w.numpy()[:, :n] == a).all(1).sum() >= B - 1
