"""The port's point-to-point FT <-> PT firmware (a copy of
dectnrp_tpu/upper/p2p.py) over the port's runtime (tests/test_p2p.py
mirrored): `psdef_for_bytes` through both packages, and the association
handshake with user data both ways over the virtual ether on the CPU, at
the DECT rate and with the radios at 1.92 Ms/s.
"""
import pytest
import torch

from dectnrp_tpu.upper import p2p as Jp
from dectnrp_tpu_torch.mac.allocation import Direction
from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator, SimDriver
from dectnrp_tpu_torch.sections.part4.identity import Identity
from dectnrp_tpu_torch.simulation.topology import Position, Trajectory
from dectnrp_tpu_torch.simulation.vspace import VNodeConfig, VSpaceConfig
from dectnrp_tpu_torch.upper import p2p as Tp
from dectnrp_tpu_torch.upper.runtime import NodeRuntime

torch.set_num_threads(1)
NET = 0x12345678


@pytest.mark.parametrize("p", [Jp, Tp], ids=["jax", "torch"])
def test_psdef_for_bytes(p):
    psdef = p.psdef_for_bytes(1, 1, 0, 2, 30)
    assert psdef is not None
    from dectnrp_tpu_torch.sections.part3.packet_sizes import get_packet_sizes
    assert get_packet_sizes(psdef).N_TB_bits >= 240
    assert p.subslot_samples(1, 1) == 360
    for n in (1, 30, 200, 900):
        a, b = Tp.psdef_for_bytes(1, 1, 0, 2, n), Jp.psdef_for_bytes(1, 1, 0, 2, n)
        assert (a is None) == (b is None) and (a is None or vars(a) == vars(b))


@pytest.mark.parametrize("samp_rate,n_ticks", [(1_728_000, 160), (1_920_000, 180)])
def test_p2p_association_and_data(samp_rate, n_ticks):
    cfg = Tp.P2pConfig(ft_identity=Identity(NET, 0x00ABCDEF, 0x0ABC))
    ft = Tp.TfwP2pFt(cfg)
    pt = Tp.TfwP2pPt(cfg, Identity(NET, 0x00111111, 0x1111))
    hws = [HwSimulator(1), HwSimulator(1)]
    vcfg = VSpaceConfig(samp_rate=float(samp_rate), spp_len=2048, freq_hz=1.9e9,
                        noise_var=1e-8)
    nodes = [VNodeConfig(1, Trajectory(Position(0, 0, 0))),
             VNodeConfig(1, Trajectory(Position(1.0, 0, 0)))]
    drv = SimDriver(vcfg, hws, nodes, "cpu")
    rt_ft = NodeRuntime(hws[0], ft, NET, device="cpu")
    rt_pt = NodeRuntime(hws[1], pt, NET, device="cpu")
    assert (ft.lower is hws[0]) == (samp_rate == 1_728_000)

    ul_msgs = [bytes([i] * 24) for i in range(1, 4)]
    dl_msgs = [bytes([0x80 + i] * 24) for i in range(1, 4)]
    pt.work_application(ul_msgs)
    ft.work_application(dl_msgs)
    for _ in range(n_ticks):
        drv.tick()
        rt_ft.process()
        rt_pt.process()

    assert pt.stats["beacons"] >= 3, (pt.stats, rt_pt.stats)
    assert pt.state is Tp.AssocState.ASSOCIATED, (pt.state, pt.stats, ft.stats)
    assert ft.stats["assoc_req"] >= 1 and pt.stats["assoc_resp"] >= 1
    contact = ft.contacts.by_short(0x1111)
    assert contact is not None and contact.associated
    assert len(pt.alloc.resources(Direction.UL)) == 1
    assert len(pt.alloc.resources(Direction.DL)) == 1
    assert pt.alloc.resources(Direction.UL)[0].length == \
        cfg.alloc_length_subslots * cfg.subslot
    assert any(m in ft.app_rx for m in ul_msgs), (ft.app_rx, pt.stats)
    assert any(m in pt.app_rx for m in dl_msgs), (pt.app_rx, ft.stats)
    assert contact.mcs_dl >= cfg.mcs_min
    assert rt_pt.stats.pdc_err == 0 or rt_pt.stats.pdc_ok > rt_pt.stats.pdc_err
