"""The port's constant tables equal the JAX package's, array for array.

The PHY has no trained weights: its parameters are per-configuration tables
built with numpy. The port carries copies of the builders (the JAX modules
that hold them import jax); these tests hold every copy to its original and
check that `tables_to_device` keeps the values. The last test proves that the
port runs without jax.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes

torch.set_num_threads(1)

FLAGSHIP = PacketSizesDef(1, 16, 1, 4, 0, 4, 6144)
SMALL = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)
TWO_K = PacketSizesDef(1, 4, 1, 2, 0, 4, 6144)
PSDEFS = [FLAGSHIP, SMALL, TWO_K, PacketSizesDef(1, 8, 0, 1, 0, 1, 6144),
          PacketSizesDef(8, 16, 1, 1, 0, 4, 6144)]
ROOT = pathlib.Path(__file__).resolve().parents[1]
# numpy-only modules the port copies (every dectnrp_tpu.phy module loads jax)
COPIES = sorted(f"sections/part3/{p.name}" for p in
                (ROOT / "dectnrp_tpu_torch/sections/part3").glob("*.py")) + [
    "phy/packet_config.py", "phy/chestim.py", "phy/filters.py",
    "phy/fec/qpp.py", "phy/fec/crc.py", "phy/fec/rate_match.py",
    "phy/fec/turbo_np.py", "sections/part4/identity.py",
    "sections/part4/feedback_info.py", "sections/part4/plcf.py",
    # the runtime slice's numpy layers: MAC codecs, radio, topology, AGC,
    # the tpoint interface, the firmwares and the MAC helpers
    "sections/part2.py", "sections/part4/__init__.py",
    "sections/part4/mac_pdu.py", "sections/part4/mmie.py",
    "sections/part4/ies.py", "sections/part4/ies2.py",
    "sections/part4/association.py", "sections/part4/mac_pdu_decoder.py",
    "common/json_export.py", "radio/gain_lut.py", "radio/hw.py",
    "radio/antenna_array.py", "simulation/topology.py", "phy/agc.py",
    "upper/tpoint.py", "upper/p2p.py", "upper/misc.py",
    "mac/allocation.py", "mac/contact_list.py", "mac/cqi.py", "mac/pll.py",
    "mac/ppx.py",
    # the real-IQ radios and the application layer (native.py is a port:
    # its build goes to the package's _build/, tests/test_torch_native_rt.py)
    "application/__init__.py", "application/queue.py",
    "application/socket_app.py", "application/vnic.py", "apps/rtt.py",
    "apps/sync_gen.py", "common/tcp_scope.py", "radio/hw_iq.py",
    # the pure-Python leftovers: DLC / CVG codecs, clocks, logging
    "sections/part5.py", "common/watch.py", "common/logging.py"]
# the resampler's ratios: get_resampler_fraction's set and the inverses
RATIOS = [(10, 9), (40, 27), (20, 9), (80, 27), (2, 1),
          (9, 10), (27, 40), (9, 20), (27, 80), (1, 2)]


def _port_psdef(psdef):
    """The same psdef as the port's own PacketSizesDef."""
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef as T

    return T(**dataclasses.asdict(psdef))


#: functions of a copy that depart from the JAX package's on purpose, taken
#: out of both modules before they are compared ({path: {class: [method]}}),
#: each held by a test of its own: PaddingIE.mux_header takes the 16-bit
#: length form above 257 bytes, which a TB of a wide band needs (the JAX
#: package's asserts; tests/test_torch_wideband.py holds the port's to the
#: JAX package's bytes at and below 257)
DEPARTURES = {"sections/part4/ies.py": {"PaddingIE": ["mux_header"]}}


def _code(pkg, path):
    """AST of the module pkg/path without its docstring and its DEPARTURES."""
    body = ast.parse((ROOT / pkg / path).read_text()).body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    drop = DEPARTURES.get(path, {})
    for node in body:
        if isinstance(node, ast.ClassDef) and node.name in drop:
            node.body = [n for n in node.body
                         if getattr(n, "name", None) not in drop[node.name]]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def _eq(a, b):
    """Recursive array/tuple/dict/dataclass equality."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _eq(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", COPIES)
def test_numpy_copies_are_verbatim(path):
    """The port's copied numpy modules are the JAX package's, code for code
    (only the module docstrings differ), helpers the slice does not call
    included."""
    assert _code("dectnrp_tpu_torch", path) == _code("dectnrp_tpu", path)


def test_verified_hw_rates():
    """radio/hw.py (a copy) takes its rate table from the port's resampler,
    which keeps its own copy of the JAX resampler's."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu_torch.phy import resampler as T

    assert T.VERIFIED_HW_RATES == J.VERIFIED_HW_RATES


def test_packet_sizes_lattice():
    from dectnrp_tpu.sections.part3 import packet_sizes as J
    from dectnrp_tpu_torch.sections.part3 import packet_sizes as T

    n_valid = 0
    for u in (1, 2, 4, 8):
        for b in (1, 2, 4, 8, 12, 16):
            for plt, pl in ((0, 2), (1, 1), (1, 4)):
                for tm in (0, 1, 5):
                    for mcs in (0, 2, 4, 6):
                        psdef = J.PacketSizesDef(u, b, plt, pl, tm, mcs, 6144)
                        pj = J.get_packet_sizes(psdef)
                        pt = T.get_packet_sizes(_port_psdef(psdef))
                        assert (pj is None) == (pt is None)
                        if pj is not None:
                            _eq(pt, pj)
                            n_valid += 1
    assert n_valid > 100


def test_trellis_luts():
    from dectnrp_tpu.phy.fec import turbo_jax as J
    from dectnrp_tpu_torch.phy.fec import turbo as T

    _eq(T._build_trellis(), J._build_trellis())
    for name in ("NEXT", "OUT_Z", "PRED_S", "PRED_C"):
        _eq(getattr(T, name), getattr(J, name))


@pytest.mark.parametrize("K", [56, 96, 960, 5504, 5568, 6016, 6080])
def test_rsc_linear_and_tail_luts(K):
    from dectnrp_tpu.phy.fec import turbo_jax as J
    from dectnrp_tpu_torch.phy.fec import turbo as T

    _eq(T._rsc_linear_luts(K), J._rsc_linear_luts(K))
    _eq(T._tail_maps(K), J._tail_maps(K))


@pytest.mark.parametrize("K", [56, 96, 960, 6016, 6080, 6144])
def test_qpp_and_rate_match(K):
    from dectnrp_tpu.phy.fec import qpp as Jq, rate_match as Jr
    from dectnrp_tpu_torch.phy.fec import qpp as Tq, rate_match as Tr

    _eq(Tq.interleaver(K), Jq.interleaver(K))
    _eq(Tq.deinterleaver(K), Jq.deinterleaver(K))
    for E, rv in ((196, 0), (3 * K + 5, 0), (K, 2), (4 * K, 1)):
        _eq(Tr.sel_indices(K, E, rv), Jr.sel_indices(K, E, rv))
    _eq(Tr.cb_e_sizes(128632, 4, 16), Jr.cb_e_sizes(128632, 4, 16))


@pytest.mark.parametrize("n,poly", [(40, 0x1021), (80, 0x1021),
                                    (5992, 0x1864CFB), (6056, 0x1800063),
                                    (96040, 0x1864CFB)])
def test_crc_matrices(n, poly):
    from dectnrp_tpu.phy.fec import crc as J
    from dectnrp_tpu_torch.phy.fec import crc as T

    _eq(T.crc_matrix(n, poly), J.crc_matrix(n, poly))
    bits = np.random.default_rng(n).integers(0, 2, min(n, 300))
    _eq(T.crc_bits(bits, poly), J.crc_bits(bits, poly))


@pytest.mark.parametrize("plcf_type", [1, 2])
def test_pcc_luts(plcf_type):
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu_torch.phy.fec import chain as T

    _eq(T._pcc_luts(plcf_type), J._pcc_luts(plcf_type))


@pytest.mark.parametrize("psdef", [FLAGSHIP, SMALL, TWO_K])
def test_pdc_luts(psdef):
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu_torch.phy.fec import chain as T

    ps = get_packet_sizes(psdef)
    key = (ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
    pj, pt = J.PdcPlan.get(*key), T.PdcPlan.get(*key)
    _eq(pt, pj)
    for rv in (0, 2):
        for f in ("_pdc_luts", "_pdc_global_inv", "_pdc_global_sel"):
            _eq(getattr(T, f)(pt, 0x12345678, 1, rv),
                getattr(J, f)(pj, 0x12345678, 1, rv))


def test_modulation_levels():
    from dectnrp_tpu.phy import modulation as J
    from dectnrp_tpu_torch.phy import modulation as T

    assert T._NORM == J._NORM
    for m in range(1, 6):
        _eq(T._axis_levels(m), J._axis_levels(m))


@pytest.mark.parametrize("u,b", [(1, 1), (1, 2), (1, 16), (8, 16)])
def test_stf_templates(u, b):
    from dectnrp_tpu.phy import sync as J
    from dectnrp_tpu_torch.phy import sync as T

    for neff in (1, 2, 4, 8):
        _eq(T.stf_time_template(u, b, neff), J.stf_time_template(u, b, neff))


@pytest.mark.parametrize("psdef", PSDEFS)
def test_packet_luts(psdef):
    from dectnrp_tpu.phy import chestim as Jc, packet_config as Jp
    from dectnrp_tpu_torch.phy import chestim as Tc, packet_config as Tp

    _eq(Tp.get_packet_luts(_port_psdef(psdef)), Jp.get_packet_luts(psdef))
    ps = get_packet_sizes(psdef)
    S, N_TS = ps.N_PACKET_symb, ps.tm_mode.N_TS
    _eq(Tc.comb_offsets(psdef.u, psdef.b, S, N_TS),
        Jc.comb_offsets(psdef.u, psdef.b, S, N_TS))
    for mode in ("lr_t", "lr_f"):
        _eq(Tc.time_interp_matrix(psdef.u, psdef.b, S, N_TS, mode),
            Jc.time_interp_matrix(psdef.u, psdef.b, S, N_TS, mode))


@pytest.mark.parametrize("u,b", [(1, 1), (1, 4), (8, 2)])
def test_wiener_banks(u, b):
    """The frequency interpolators of build_rx's bank (one code path for
    every b; small b keep the dense solves cheap)."""
    from dectnrp_tpu.phy import chestim as Jc
    from dectnrp_tpu_torch.phy import chestim as Tc

    for tau, snr in Jc.WIENER_PRESETS + ((1000e-9, -5.0),):
        _eq(Tc.freq_interp_matrices(b, "wiener", tau, snr, True, u),
            Jc.freq_interp_matrices(b, "wiener", tau, snr, True, u))
    _eq(Tc.freq_interp_matrices(b, "linear"), Jc.freq_interp_matrices(b, "linear"))


@pytest.mark.parametrize("LM", RATIOS)
def test_resampler_designs(LM):
    """The polyphase banks (G, m0, W) for every ratio and oversampling
    factor: the float64 Kaiser design cast to float32 must match bit for
    bit."""
    from dectnrp_tpu.phy import resampler as J
    from dectnrp_tpu_torch.phy import resampler as T
    from dectnrp_tpu_torch.phy.ops.polyphase import RATIOS as KERNEL_RATIOS

    assert set(RATIOS) == KERNEL_RATIOS
    for os in (1, 2, 4, 8):
        _eq(T._design(T.ResamplerPlan(*LM, os)), J._design(J.ResamplerPlan(*LM, os)))
    for k in J.F_PASS_NORM:
        assert T.F_PASS_NORM[k] == J.F_PASS_NORM[k]
        assert T.F_STOP_ATT_DB[k] == J.F_STOP_ATT_DB[k]
    assert T.F_STOP_NORM == J.F_STOP_NORM


def test_tables_to_device_keeps_values():
    from dectnrp_tpu_torch.phy.plan import tables_to_device

    rng = np.random.default_rng(0)
    tabs = {"f": rng.standard_normal(5), "c": rng.standard_normal(3) + 1j,
            "i": np.arange(4, dtype=np.int32), "u": np.ones(2, np.uint8),
            "b": np.array([True, False]), "n": {"k": (np.zeros(2), 7)}}
    out = tables_to_device(tabs, "cpu")
    assert out["f"].dtype == torch.float32 and out["c"].dtype == torch.complex64
    assert out["i"].dtype == torch.int64 and out["u"].dtype == torch.uint8
    assert out["b"].dtype == torch.bool and out["n"]["k"][1] == 7
    np.testing.assert_array_equal(out["f"].numpy(), tabs["f"].astype(np.float32))
    np.testing.assert_array_equal(out["c"].numpy(), tabs["c"].astype(np.complex64))
    np.testing.assert_array_equal(out["i"].numpy(), tabs["i"])


def test_port_runs_without_jax():
    """A fresh interpreter imports the port, runs the small flagship- and
    wall-shaped steps, one point of the FEC oracle (HARQ combining), one
    loopback point (upper/loopback.py: tm 2 through the doubly-selective
    channel, sync and MMSE) and the scenario runner (apps/dectnrp_main over
    config and upper/runtime: one rtt_simulator round trip) end to end and
    loads neither jax (the card's machine has none) nor the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, torch
        torch.set_num_threads(1)
        import dectnrp_tpu_torch
        from dectnrp_tpu_torch.loopback import make_flagship_step, packet_offsets
        from dectnrp_tpu_torch.sections.part3.packet_sizes import (
            PacketSizesDef, get_packet_sizes)
        psdef = PacketSizesDef(1, 1, 0, 2, 0, 4, 6144)
        ps = get_packet_sizes(psdef)
        T = 4 * ps.N_samples_packet + 1024
        step = make_flagship_step(psdef, T, 2, device="cpu")
        rng = np.random.default_rng(7)
        plcf = torch.as_tensor(rng.integers(0, 2, (2, 40)), dtype=torch.uint8)
        tb = torch.as_tensor(rng.integers(0, 2, (2, ps.N_TB_bits)),
                             dtype=torch.uint8)
        offs = torch.as_tensor(packet_offsets(rng, 2, 2, T, ps.N_samples_packet))
        ok, det, tf = step(plcf, tb, offs, torch.Generator().manual_seed(0))
        assert bool(ok.all()) and bool(det.all()), (ok, det)
        # the wall-shaped step: Alamouti over 4 streams, 10/9 resampler
        from dectnrp_tpu_torch.loopback import make_wall_step
        psdef = PacketSizesDef(1, 1, 0, 3, 5, 2, 6144)
        ps = get_packet_sizes(psdef)
        step = make_wall_step(psdef, 3 * ps.N_samples_packet + 1024,
                              device="cpu")
        plcf = torch.as_tensor(rng.integers(0, 2, (2, 40)), dtype=torch.uint8)
        tb = torch.as_tensor(rng.integers(0, 2, (2, ps.N_TB_bits)),
                             dtype=torch.uint8)
        offs = torch.as_tensor(packet_offsets(rng, 2, 1, step.T, step.n_pkt))
        ok, det, tf = step(plcf, tb, offs, torch.Generator().manual_seed(1))
        assert bool(ok.all()) and bool(det.all()), (ok, det)
        # the FEC oracle through its HARQ process, one point at 20 dB
        from dectnrp_tpu_torch import fec_awgn
        from dectnrp_tpu_torch.phy import harq  # noqa: F401
        st = fec_awgn.build_fec_awgn_step(fec_awgn.fec_psdef(1), 1, device="cpu")
        tb = torch.as_tensor(rng.integers(0, 2, (2, st.ps.N_TB_bits)),
                             dtype=torch.uint8)
        oks, errs, _ = st(tb, 20.0, torch.Generator().manual_seed(2))
        assert bool(oks.all()) and int(errs) == 0, (oks, errs)
        # one loopback point of the mimo_fading variant, 4 packets at 30 dB
        from dectnrp_tpu_torch import loopback_snr
        from dectnrp_tpu_torch.upper import loopback as upper_loopback  # noqa: F401
        exp = loopback_snr.experiment("mimo_fading", 4, "cpu", mcs=(1,),
                                      snr_db=(30.0,))
        pt = exp.run_point(1, 0, 30.0)
        assert pt.n == 4 and pt.n_pdc >= 2, pt
        # the runtime slice: the scenario runner over the committed
        # rtt_simulator, one datagram echoed over the air
        from dectnrp_tpu_torch import config, runtime_check  # noqa: F401
        from dectnrp_tpu_torch.apps import dectnrp_main
        from dectnrp_tpu_torch.upper import runtime  # noqa: F401
        _, recs = dectnrp_main.run(["configurations/rtt_simulator", "--ticks",
                                    "12", "--device", "cpu", "--datagrams", "1"])
        assert recs[0]["firmware"] == {"tx": 1, "rx": 1}, recs
        # the builder options' modules and the pure-Python leftovers
        from dectnrp_tpu_torch import options_check  # noqa: F401
        from dectnrp_tpu_torch.common import logging, watch  # noqa: F401
        from dectnrp_tpu_torch.sections import part5  # noqa: F401
        from dectnrp_tpu_torch.sections.part3 import duration_lut  # noqa: F401
        # the multi-device and multi-process modules
        from dectnrp_tpu_torch import dcn_dryrun, multichip, scaling  # noqa: F401
        from dectnrp_tpu_torch.common import benchtime, dist  # noqa: F401
        assert "jax" not in sys.modules, "the port loaded jax"
        assert "dectnrp_tpu" not in sys.modules, "the port loaded the JAX package"
        print("JAX_FREE_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "JAX_FREE_OK" in res.stdout
