"""The port's MAC helpers against the JAX package's (tests/test_mac_helpers.py
mirrored): allocation grid, PLL drift, PPX pulses, contacts, CQI and AGC.
The port's `mac/` and `phy/agc.py` are copies; every case runs on both
packages' modules (`m`) with the JAX test's assertions.
"""
from types import SimpleNamespace

import numpy as np
import pytest


def _ns(root):
    import importlib
    mods = {k: importlib.import_module(f"{root}.{k}") for k in
            ("mac.allocation", "mac.contact_list", "mac.cqi", "mac.pll",
             "mac.ppx", "phy.agc", "sections.part4.identity")}
    ns = {}
    for mod in mods.values():
        ns.update({k: getattr(mod, k) for k in dir(mod) if not k.startswith("_")})
    return SimpleNamespace(**ns)


@pytest.fixture(params=["dectnrp_tpu", "dectnrp_tpu_torch"], ids=["jax", "torch"])
def m(request):
    return _ns(request.param)


def test_resource_orthogonality(m):
    a = m.Resource(0, 100)
    assert a.is_orthogonal(m.Resource(100, 50))
    assert not a.is_orthogonal(m.Resource(99, 50))


def test_allocation_pt_tx_opportunity(m):
    bp = 10_000
    al = m.AllocationPt(bp, validity_after_beacon=3 * bp,
                      validity_after_now=2 * bp, turnaround_time=100)
    al.add_resource_regular(m.Direction.UL, offset=1000, length=200,
                            stride=2000, n=4)
    # no beacon known yet -> invalid
    assert not al.get_tx_opportunity(m.Direction.UL, 0, 0).valid
    al.beacon_time_last_known = 100_000
    op = al.get_tx_opportunity(m.Direction.UL, 100_500, 100_500)
    assert op.valid
    assert op.tx_time == 101_000 and op.n_samples == 200
    # now already past the first slot (turnaround pushes to the next one)
    op2 = al.get_tx_opportunity(m.Direction.UL, 100_950, 100_950)
    assert op2.tx_time == 103_000
    # wraps into the next beacon period
    op3 = al.get_tx_opportunity(m.Direction.UL, 107_500, 107_500)
    assert op3.tx_time == 111_000


def test_allocation_pt_rejects_overlap(m):
    al = m.AllocationPt(10_000, 10_000, 10_000, 0)
    al.add_resource(m.Direction.UL, 0, 100)
    with pytest.raises(AssertionError):
        al.add_resource(m.Direction.UL, 50, 100)


def test_allocation_ft_grid(m):
    ft = m.AllocationFt(10_000)
    r1 = ft.allocate(1, m.Direction.DL, 0, 1000)
    off = ft.find_free(1000)
    assert off == 1000
    ft.allocate(2, m.Direction.DL, off, 1000)
    assert ft.find_free(9000) is None
    ft.release_pt(1)
    assert ft.find_free(1000) == 0


def test_pll_estimates_ppm(m):
    rate = 1_728_000
    bp = rate // 10                      # 100 ms beacon period
    pll = m.Pll(bp, rate)
    ppm_true = 20.0
    warp = 1.0 + ppm_true / 1e6
    for i in range(400):
        pll.provide_beacon_time(int(i * bp * warp))
    assert abs(pll.ppm - ppm_true) < 2.0, pll.ppm


def test_ppx_phase_lock(m):
    rate = 1_728_000
    bp = rate // 10
    ppx = m.Ppx(ppx_period=rate, ppx_length=rate // 100,
              ppx_time_advance=rate // 50, beacon_period=bp,
              time_deviation_max=rate // 1000)
    ppx.set_ppx_rising_edge(rate)
    # beacons drift slightly late; ppx follows
    ppx.provide_beacon_time(rate + 3 * bp + 40)
    assert ppx.rising_edge_estimation == rate + 40
    pc = ppx.get_ppx_imminent()
    assert pc.rising_edge == rate + 40 + ppx.ppx_period_warped
    assert pc.falling_edge - pc.rising_edge == rate // 100


def test_contact_list(m):
    cl = m.ContactList()
    c = cl.add(m.Identity(0x100, 500, 7))
    assert cl.by_short(7) is c and cl.by_long(500) is c
    c.associated = True
    assert cl.associated() == [c]
    assert c.next_sequence_number() == 0 and c.sequence_number == 1
    cl.remove(7)
    assert len(cl) == 0


def test_cqi_lut(m):
    lut = m.CqiLut(1, 6, snr_offset_db=0.0)
    assert lut.get_highest_mcs_possible(-5.0) == 1   # clamped to mcs_min
    assert lut.get_highest_mcs_possible(12.0) == 4
    assert lut.get_highest_mcs_possible(40.0) == 6   # clamped to mcs_max
    lut2 = m.CqiLut(0, 11, snr_offset_db=3.0)
    assert lut2.get_highest_mcs_possible(14.0) == 4  # 14-3=11 -> MCS4


def test_agc_rx_steps_toward_target(m):
    agc = m.AgcRx(m.AgcConfig(nof_antennas=2, gain_step_db_min=1.0,
                          gain_step_db_max=6.0), rms_target=0.316227766)
    power = np.array([-40.0, -40.0])
    # antenna 0 way too loud, antenna 1 silent (no peak)
    step = agc.get_gain_step_db(power, np.array([0.9, 0.0]))
    assert step[0] > 0                               # reduce sensitivity
    assert step[0] <= 6.0                            # slew-limited
    assert step[1] == 0.0                            # already at max sens.
    # quiet antenna: increase sensitivity (negative step)
    step2 = agc.get_gain_step_db(power, np.array([0.05, 0.05]))
    assert np.all(step2 < 0)
