"""The port's HARQ processes vs dectnrp_tpu.phy.harq.

tests/test_harq.py mirrored on the port (combining gain, pool leasing, the
running-lease cycle), and `HarqProcessRx.combine` over the oracle's rv
sequence 0, 2, 3, 1 against JAX's: the same softbuffers (exact: the
de-rate-match is a gather and the combine an add of equal float32 values)
and the same tb / tb_ok.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dectnrp_tpu_torch.sections.part3.packet_sizes import (PacketSizesDef,
                                                            get_packet_sizes)

torch.set_num_threads(1)

NID = 0x12345678


def _llr_through_awgn(e_bits, snr_db, rng):
    """BPSK-ish channel on coded bits -> LLRs (convention L = log P(1)/P(0))."""
    x = 2.0 * np.asarray(e_bits, np.float32) - 1.0
    nv = 10 ** (-snr_db / 10)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * np.sqrt(nv)
    return (2.0 * y / nv).astype(np.float32)


def test_harq_combining_gain():
    from dectnrp_tpu_torch.phy.fec.chain import PdcPlan, pdc_encode
    from dectnrp_tpu_torch.phy.harq import FinalizeRx, HarqProcessPool

    psdef = PacketSizesDef(1, 1, 0, 4, 0, 4, 6144)
    ps = get_packet_sizes(psdef)
    plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    rng = np.random.default_rng(0)
    B = 4
    tb = torch.as_tensor(rng.integers(0, 2, (B, ps.N_TB_bits)), dtype=torch.uint8)

    pool = HarqProcessPool(n_tx=2, n_rx=2)
    proc = pool.get_process_rx(1, NID, psdef,
                               finalize=FinalizeRx.KEEP_FOR_RETRANSMISSION)
    assert proc is not None

    # SNR so low a single transmission fails for most packets
    snr = 1.0
    e0 = pdc_encode(tb, plan, NID, 1, rv=0)
    _, ok0 = proc.combine(torch.as_tensor(_llr_through_awgn(e0, snr, rng)))
    first_ok = int(ok0.sum())

    # rv=1 retransmission into the same softbuffer
    proc.rv = 1
    e1 = pdc_encode(tb, plan, NID, 1, rv=1)
    tb1, ok1 = proc.combine(torch.as_tensor(_llr_through_awgn(e1, snr, rng)))
    second_ok = int(ok1.sum())

    assert second_ok >= first_ok
    assert second_ok == B, (first_ok, second_ok)
    np.testing.assert_array_equal(tb1.numpy(), tb.numpy())


def test_pool_leasing():
    from dectnrp_tpu_torch.phy.harq import HarqProcessPool

    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    pool = HarqProcessPool(n_tx=1, n_rx=1)
    p = pool.get_process_tx(1, NID, psdef)
    assert p is not None and p.leased
    assert pool.get_process_tx(1, NID, psdef) is None   # exhausted
    p.finalize_now()
    assert pool.get_process_tx(1, NID, psdef) is not None


def test_running_lease_cycle():
    from dectnrp_tpu_torch.phy.harq import FinalizeRx, HarqProcessPool

    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    pool = HarqProcessPool(n_rx=1)
    p = pool.get_process_rx(1, NID, psdef,
                            finalize=FinalizeRx.KEEP_FOR_RETRANSMISSION)
    pid = p.id
    assert pool.get_process_rx_running(pid, 1, FinalizeRx.RESET_AND_TERMINATE) is None
    p.finalize_now()                 # kept leased, not running
    assert p.leased
    p2 = pool.get_process_rx_running(pid, 1, FinalizeRx.RESET_AND_TERMINATE)
    assert p2 is p and p2.rv == 1
    p2.finalize_now()
    assert not p2.leased and p2.softbuffer is None


@pytest.mark.parametrize("mcs,snr", [(1, 0.5), (4, 4.0)])
def test_combine_matches_jax(mcs, snr):
    """combine over rv 0, 2, 3, 1 at a low SNR: equal softbuffers after every
    transmission and equal decisions."""
    from dectnrp_tpu.phy.fec.chain import PdcPlan as JPlan, pdc_encode as j_encode
    from dectnrp_tpu.phy.harq import HarqProcessPool as JPool
    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef as JDef
    from dectnrp_tpu_torch.phy.harq import HarqProcessPool

    args = (1, 1, 0, 4, 0, mcs, 6144)
    ps = get_packet_sizes(PacketSizesDef(*args))
    plan_j = JPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, 6144)
    rng = np.random.default_rng(mcs)
    tb = rng.integers(0, 2, (3, ps.N_TB_bits)).astype(np.uint8)
    p_j = JPool(n_rx=1).get_process_rx(1, NID, JDef(*args))
    p_t = HarqProcessPool(n_rx=1).get_process_rx(1, NID, PacketSizesDef(*args))
    oks = []
    for rv in (0, 2, 3, 1):
        e = np.asarray(j_encode(jnp.asarray(tb), plan_j, NID, 1, rv=rv))
        llr = _llr_through_awgn(e, snr, rng)
        p_j.rv = p_t.rv = rv
        tb_j, ok_j = p_j.combine(jnp.asarray(llr))
        tb_t, ok_t = p_t.combine(torch.as_tensor(llr))
        assert p_t.softbuffer.keys() == p_j.softbuffer.keys()
        for K in p_j.softbuffer:
            np.testing.assert_array_equal(p_t.softbuffer[K].numpy(),
                                          np.asarray(p_j.softbuffer[K]))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb_j))
        oks.append(ok_t.numpy())
    # the combining has something to do: not every row decodes at once,
    # and every row decodes in the end
    assert not oks[0].all() and oks[-1].all()
