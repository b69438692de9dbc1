"""The port at radio device class 2.12.4.A (TS 103 636-3 Annex C: u = 2,
b = 12, N_TX = 4, 41.472 Ms/s) on the CPU: the padding IE's 16-bit length
form, which the TB of a beacon at b >= 12 needs (the JAX package's padding
IE stops at 257 bytes), held to the JAX package's bytes at and below 257;
the FT's beacon at the class decoded back to its IEs; the p2p scenario at
the class (`configurations/p2p_simulator_2.12.4.A`: three 4-antenna radios,
tm-5 beacons): both PTs associate and hear every beacon after, each PDC's
codebook search in its `runtime.mimo` span; and the benchmark's plain
codebook search (`benchmark/reference/mimo.py`) equal to `phy/mimo.search`
on seeded random cells."""
import numpy as np
import pytest
import torch

from dectnrp_tpu.sections.part4.ies import PaddingIE as JPaddingIE
from dectnrp_tpu_torch import config as C
from dectnrp_tpu_torch.common import trace
from dectnrp_tpu_torch.sections.part4.ies import PaddingIE, RandomAccessResourceIE
from dectnrp_tpu_torch.sections.part4.mac_pdu import (IeType, MacExt,
                                                      MuxHeader)
from dectnrp_tpu_torch.sections.part4.mac_pdu_decoder import decode_mac_pdu
from dectnrp_tpu_torch.sections.part4.mmie import ClusterBeaconMessage

torch.set_num_threads(1)
SCENARIO = "configurations/p2p_simulator_2.12.4.A"
#: the padding a beacon needs at u = b = 1 (38), the 8-bit form's last
#: (257) and the 16-bit form's first sizes, a 2.12.4.A beacon's (1,212) and
#: the 16-bit form's last (65,538)
SIZES = (1, 2, 3, 38, 257, 258, 259, 1212, 65538)


def _pack(ie, n: int) -> bytes:
    buf = bytearray(n + 4)
    end = ie.pack_mmh_sdu_into(buf, 2)
    assert end == 2 + n
    return bytes(buf[2:end])


@pytest.mark.parametrize("n", SIZES)
def test_padding_round_trip(n):
    """n bytes of padding: the mux header read back says n bytes in all,
    zeros after it, and the form is the smallest that holds n."""
    got = _pack(PaddingIE(n), n)
    h = MuxHeader()
    assert h.unpack_from(got, 0)
    size = h.packed_size()
    assert size == (1 if n <= 2 else 2 if n <= 257 else 3)
    assert h.mac_ext == {1: MacExt.LENGTH_1BIT, 2: MacExt.LENGTH_8BIT,
                         3: MacExt.LENGTH_16BIT}[size]
    if size == 1:
        assert h.length == n - 1            # the 1-bit form: 0 or 1 byte more
    else:
        assert size + h.length == n and h.ie_type == int(IeType.PADDING_IE)
    assert got[size:] == bytes(n - size)


def test_padding_equals_jax_at_and_below_257():
    """Every size the JAX package's padding IE takes gives its bytes."""
    for n in range(1, 258):
        assert _pack(PaddingIE(n), n) == _pack(JPaddingIE(n), n), n


def test_padding_beyond_the_16_bit_form_raises():
    with pytest.raises(AssertionError, match="invalid mux header"):
        _pack(PaddingIE(65539), 65539)


@pytest.mark.parametrize("u,b,tb_bytes", [(1, 1, 57), (2, 12, 1231)])
def test_beacon_pdu_decodes_to_its_ies(u, b, tb_bytes):
    """The FT's beacon at u = b = 1 (38 bytes of padding, the 8-bit form)
    and at 2.12.4.A (1,212 bytes, the 16-bit form): the PT's decode ends at
    the padding and returns the cluster beacon and the RACH resource."""
    from dectnrp_tpu_torch.sections.part4.plcf import bits_to_bytes
    from dectnrp_tpu_torch.upper.p2p import P2pConfig, TfwP2pFt

    ft = TfwP2pFt(P2pConfig(u=u, b=b, tm_mode_index=5 if b == 12 else 0))
    td = ft._beacon_td()
    pdu = bits_to_bytes(td.tb_bits)
    assert len(pdu) == tb_bytes
    dec = decode_mac_pdu(pdu, u)
    assert dec.finished and not dec.aborted
    assert [type(m) for m in dec.mmies] == [ClusterBeaconMessage,
                                            RandomAccessResourceIE]
    assert dec.mmies[0].mu == u


def test_mimo_reference_equals_the_program_on_random_cells():
    """benchmark/reference/mimo.py on seeded random 4-TX cells (and on the
    1- and 2-TX codebooks, and a TX count with none) equals
    phy/mimo.search: the same index, the metric within float32 rounding."""
    from benchmark.reference.mimo import MimoReference
    from dectnrp_tpu_torch.phy.mimo import search

    ref = MimoReference("cpu")
    g = torch.Generator().manual_seed(7)
    for B, R, T in ((64, 4, 4), (16, 2, 4), (16, 1, 4), (8, 2, 2), (4, 1, 1),
                    (2, 2, 3)):
        cells = torch.complex(torch.randn(B, R, T, 4, generator=g),
                              torch.randn(B, R, T, 4, generator=g))
        got, want = search(cells), ref.search(cells)
        if T == 3:
            assert got is None and want is None
            continue
        assert torch.equal(got[0], want[0]), (B, R, T)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
        found = ref.compare([((cells,), {}, got)])
        assert found["cb_index_differ"] == 0 and found["cb_metric_gap"] < 1e-6


def test_p2p_scenario_at_class_2124a():
    """Both PTs associate within 100 ticks and hear every beacon of the
    next period; each PDC ran one codebook search (4-TX, 28 matrices) in a
    `runtime.mimo` span."""
    from dectnrp_tpu_torch.upper.p2p import AssocState

    sc = C.load_scenario(SCENARIO)
    assert (sc.phy.units[0]["u"], sc.phy.units[0]["b"]) == (2, 12)
    assert all(h["n_ant"] == 4 for h in sc.radio.hws)
    run = C.build_scenario(sc, "cpu")
    ft, pts = run.firmwares[0], run.firmwares[1:]
    for _ in range(100):
        run.tick()
        if all(p.state is AssocState.ASSOCIATED for p in pts):
            break
    assert all(p.state is AssocState.ASSOCIATED for p in pts), \
        [p.state for p in pts]
    c0 = trace.counters()
    b0, h0 = ft.stats["beacons"], [p.stats["beacons"] for p in pts]
    pdc0 = sum(rt.stats.pdc_ok + rt.stats.pdc_err for rt in run.runtimes)
    run.run_ticks(12)                     # a beacon period is 11.25 ticks
    sent = ft.stats["beacons"] - b0
    assert sent >= 1
    # the FT counts a beacon a prepare time ahead of its air time
    assert [p.stats["beacons"] - h for p, h in zip(pts, h0)] in \
        ([sent] * 2, [sent - 1] * 2)
    assert all(rt.stats.tx_late == 0 for rt in run.runtimes)
    pdcs = sum(rt.stats.pdc_ok + rt.stats.pdc_err for rt in run.runtimes) - pdc0
    d = {k: v - c0[k] for k, v in trace.counters().items()}
    assert pdcs >= 2 and d["span.runtime.mimo.calls"] == pdcs
    assert 0 < d["span.runtime.mimo.ns"] <= d["span.runtime.pdc.ns"]


def test_scenario_loads_in_both_packages():
    """The JAX package reads the configuration alike (it cannot run it: its
    padding IE has no 16-bit form)."""
    import dataclasses

    from dectnrp_tpu import config as J

    sc, sj = C.load_scenario(SCENARIO), J.load_scenario(SCENARIO)
    for part in ("radio", "phy", "upper"):
        assert dataclasses.asdict(getattr(sc, part)) == \
            dataclasses.asdict(getattr(sj, part))
    assert np.isclose(sc.radio.samp_rate, 1_728_000 * 2 * 12)
