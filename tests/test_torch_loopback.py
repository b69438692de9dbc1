"""The port's loopback experiments (upper/loopback.py, loopback_snr.py) vs
the JAX package's.

`PointStep` against JAX's `_point_step` on the same inputs: the same numpy
TB bits and offsets, and JAX's own random draws (jax.random cannot be
reproduced in torch) re-derived from the point's key in JAX's split order,
`kc, key = split(key)` for the channel (`k_th, k_ph = split(kc)` inside
`_doubly_impl`), then awgn's `k1, k2 = split(key)`; the port adds unit
noise, so JAX's n1 + j n2 is handed over divided by sqrt(2).
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef
from dectnrp_tpu_torch.sections.part3.packet_sizes import \
    PacketSizesDef as TPacketSizesDef

torch.set_num_threads(1)

REF = pathlib.Path(__file__).resolve().parents[1] / "results" / "loopback_snr"
NID = 0x12345678
FADING = "doubly_0_363_222"
# (use_sync, channel, resampler_loop, genie, tm, quantize_bits, SNR dB,
# amplitude): the eight variants of tools/run_loopback_snr.py at MCS 2 (tm 2
# for the mimo ones), and the ratio experiment's clip and quantize
POINTS = {
    "sync": (True, "awgn", False, False, 0, None, 6.0, 1.0),
    "aligned": (False, "awgn", False, False, 0, None, 6.0, 1.0),
    "fading": (True, FADING, False, False, 0, None, 14.0, 1.0),
    "fading_aligned": (False, FADING, False, False, 0, None, 14.0, 1.0),
    "fading_genie": (False, FADING, False, True, 0, None, 14.0, 1.0),
    "resampled": (True, "awgn", True, False, 0, None, 6.0, 1.0),
    "mimo": (True, "awgn", False, False, 2, None, 7.0, 1.0),
    "mimo_fading": (True, FADING, False, False, 2, None, 16.0, 1.0),
    "ratio_clip_quantize": (False, "awgn", False, False, 0, 12, 30.0, 4.0),
}


def _jax_draws(step, key, B):
    """The port's draws dict from JAX's key, in _point_step's split order."""
    draws = {}
    if step.fading is not None:
        kc, key = jax.random.split(key)
        k_th, k_ph = jax.random.split(kc)
        shape = (B, step.n_tx, step.n_tx, step.n_taps, 8)
        for name, k in (("theta", k_th), ("phi", k_ph)):
            draws[name] = torch.as_tensor(np.array(
                jax.random.uniform(k, shape, maxval=2 * np.pi)))
    k1, k2 = jax.random.split(key)
    shape = step.noise_shape(B)
    n = (np.asarray(jax.random.normal(k1, shape, dtype=jnp.float32))
         + 1j * np.asarray(jax.random.normal(k2, shape, dtype=jnp.float32)))
    draws["noise"] = torch.as_tensor((n / np.sqrt(2)).astype(np.complex64))
    return draws


@pytest.mark.parametrize("variant", list(POINTS))
def test_point_step_matches_jax(variant):
    from dectnrp_tpu.common.cplx import decode_host
    from dectnrp_tpu.upper.loopback import _point_step
    from dectnrp_tpu_torch.phy.fec import bcjr_cuda
    from dectnrp_tpu_torch.phy.ops import polyphase, sync_detect
    from dectnrp_tpu_torch.upper.loopback import Identity, PointStep, point_inputs

    use_sync, channel, rl, genie, tm, qb, snr, amp = POINTS[variant]
    args = (1, 1, 0, 2, tm, 2, 6144)
    B, seed = 8, 11
    step_j, T, n_pkt = _point_step(PacketSizesDef(*args), NID, use_sync, qb,
                                   channel, rl, genie)
    step = PointStep(TPacketSizesDef(*args), NID, use_sync, qb, channel, rl,
                     genie, device="cpu")
    assert (step.T, step.n_pkt) == (T, n_pkt)
    plcf, tb, offs = point_inputs(TPacketSizesDef(*args),
                                  Identity(NID, 0x2222, 0x3333), B, seed, T, n_pkt)
    key = jax.random.PRNGKey(seed)
    out_j = decode_host(step_j(jnp.asarray(plcf), jnp.asarray(tb), jnp.float32(snr),
                               key, jnp.asarray(offs, jnp.int32), jnp.float32(amp)))
    launches = (bcjr_cuda.launches, sync_detect.launches, polyphase.launches)
    out_t = step(torch.as_tensor(plcf), torch.as_tensor(tb),
                 torch.tensor(snr, dtype=torch.float32), torch.as_tensor(offs),
                 amp, _jax_draws(step, key, B))
    assert (bcjr_cuda.launches, sync_detect.launches,
            polyphase.launches) == launches          # CPU tensors: plain twins
    for k in ("detected", "plcf1_ok", "plcf2_ok", "tb_ok"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]),
                                      err_msg=k)
    ok = np.asarray(out_j["tb_ok"])
    np.testing.assert_array_equal(out_t["tb"].numpy()[ok], np.asarray(out_j["tb"])[ok])
    np.testing.assert_array_equal(out_t["tb"].numpy()[ok], tb[ok])
    # the 12-bit quantizer is discontinuous: TX values a few 1e-7 apart can
    # round to neighbouring levels, which moves the SNR estimate by ~1e-4
    np.testing.assert_allclose(out_t["snr_db"].numpy(), np.asarray(out_j["snr_db"]),
                               atol=1e-3 if qb else 1e-4)
    # each point mixes decoded and failed packets (or all detected and all
    # decoded at the operating SNR), so the decisions above carry weight
    assert out_t["detected"].any() and out_t["tb_ok"].any()


IDENT = (0x12345678, 0x2222, 0x3333)


def test_snr_point_extremes():
    from dectnrp_tpu_torch.sections.part3.packet_sizes import PacketSizesDef as P
    from dectnrp_tpu_torch.upper.loopback import Identity, _run_point

    psdef = P(1, 1, 0, 2, 0, 2, 6144)
    lo = _run_point(psdef, Identity(*IDENT), -10.0, 20, seed=1, use_sync=True,
                    device="cpu")
    hi = _run_point(psdef, Identity(*IDENT), 25.0, 20, seed=1, use_sync=True,
                    device="cpu")
    assert lo.per_pdc > 0.8, lo
    assert hi.per_pdc == 0.0, hi
    assert hi.per_pcc == 0.0 and hi.per_pcc_and_plcf == 0.0
    assert 18.0 < hi.snr_min < 32.0, hi


def test_snr_experiment_small_sweep():
    from dectnrp_tpu_torch.upper.loopback import Identity, LoopbackSnrExperiment

    exp = LoopbackSnrExperiment(identity=Identity(*IDENT), mcs_list=(2,),
                                snr_db=(-5.0, 5.0, 15.0), n_per_snr=20,
                                use_sync=False, device="cpu")
    res = exp.run()
    per = res[2]["result"]["PER_pdc_crc"]
    assert per[0] > per[2]
    assert per[2] < 0.1
    assert res[2]["result"]["PER_pcc_crc"][2] <= per[0]


def test_snr_experiment_json(tmp_path):
    from dectnrp_tpu_torch.upper.loopback import Identity, LoopbackSnrExperiment

    exp = LoopbackSnrExperiment(identity=Identity(*IDENT), mcs_list=(1,),
                                snr_db=(10.0,), n_per_snr=8, use_sync=False,
                                device="cpu")
    paths = exp.save_json(str(tmp_path))
    assert len(paths) == 1
    rec = json.load(open(paths[0]))
    ref = json.load(open(REF / "aligned" / "rx_loopback_MCS_0001.json"))
    assert rec.keys() == ref.keys()
    for k in rec:
        assert rec[k].keys() == ref[k].keys(), k
    assert "PER_pdc_crc" in rec["result"]


def test_ratio_experiment_clipping_hurts():
    from dectnrp_tpu_torch.upper.loopback import Identity, LoopbackRatioExperiment

    exp = LoopbackRatioExperiment(identity=Identity(*IDENT), ratios=(0.5, 16.0),
                                  n_per_ratio=10, quantize_bits=12, snr_db=30.0,
                                  device="cpu")
    pts = exp.run()
    assert pts[0.5].per_pdc == 0.0
    assert pts[16.0].per_pdc > pts[0.5].per_pdc


def test_cli_on_cpu(tmp_path):
    """The sweep's CLI on the CPU, cut to MCS 1 on a 2-point grid at 2
    packets: the reference schema, a meta record, and the comparison."""
    from dectnrp_tpu_torch import loopback_snr

    out = tmp_path / "sweep"
    loopback_snr.main(["--n", "2", "--variants", "aligned", "--device", "cpu",
                       "--mcs", "1", "--snr-db", "-2", "20", "--out", str(out),
                       "--ref", str(REF)])
    rec = json.load(open(out / "aligned" / "rx_loopback_MCS_0001.json"))
    assert rec["experiment_range"] == {"snr_vec": [-2.0, 20.0],
                                       "nof_experiment_per_snr": 2}
    assert rec["result"]["PER_pdc_crc"] == [1.0, 0.0]
    meta = json.load(open(out / "meta.json"))
    assert meta["platform"] == "cpu" and meta["aligned"]["n_per_snr"] == 2
    cmp = json.load(open(out / "compare.json"))
    assert cmp["variants"]["aligned"]["1"]["max_abs_z"] < 4.0
    with pytest.raises(SystemExit):
        loopback_snr.main(["--n", "2", "--variants", "aligned", "--device", "cpu",
                           "--mcs", "1", "--snr-db", "20",
                           "--out", str(REF / "x")])
    # a reference 22 dB away on the same grid: the comparison fails and the
    # CLI exits non-zero
    _write(tmp_path / "ref", "aligned", 1, [-2.0, 20.0], [0.0, 0.0], 2)
    with pytest.raises(SystemExit) as e:
        loopback_snr.main(["--n", "2", "--variants", "aligned", "--device", "cpu",
                           "--mcs", "1", "--snr-db", "-2", "20", "--out", str(out),
                           "--ref", str(tmp_path / "ref")])
    assert e.value.code not in (0, None)
    assert not json.load(open(out / "compare.json"))["ok"]


def _write(d, variant, mcs, snrs, per, n, pcc=None):
    p = d / variant
    p.mkdir(parents=True, exist_ok=True)
    rec = {"experiment_range": {"snr_vec": snrs, "nof_experiment_per_snr": n},
           "parameter": {"mcs": mcs}, "result": {
               "PER_pdc_crc": per, "PER_pcc_crc": pcc or per}}
    (p / f"rx_loopback_MCS_{mcs:04d}.json").write_text(json.dumps(rec))


def test_compare_curves_synthetic(tmp_path):
    from dectnrp_tpu_torch.loopback_snr import binomial_z, compare_curves

    snrs = [0.0, 2.0, 4.0, 6.0]
    ref, got = tmp_path / "ref", tmp_path / "got"
    _write(ref, "sync", 1, snrs, [1.0, 0.5, 0.08, 0.0], 500)
    _write(got, "sync", 1, snrs, [1.0, 0.4, 0.12, 0.0], 500)
    _write(ref, "aligned", 1, snrs, [0.9, 0.2, 0.0, 0.0], 500)
    _write(got, "aligned", 1, snrs, [0.9, 0.3, 0.0, 0.0], 500)
    # a port curve that rises by more than 0.12, and whose PCC is worse
    _write(ref, "mimo", 2, snrs, [1.0, 0.6, 0.1, 0.0], 500)
    _write(got, "mimo", 2, snrs, [1.0, 0.4, 0.6, 0.0], 500,
           pcc=[1.0, 0.5, 0.7, 0.1])
    # fading curves ending at 0.06 and 0.1 where the reference ends below
    # 0.05: outside STRICT_TOP the top PER may lie 3 sigma above 0.05
    # (0.079 at 500 packets), so the first passes and the second fails
    _write(ref, "fading", 4, snrs, [1.0, 0.5, 0.09, 0.048], 500)
    _write(got, "fading", 4, snrs, [1.0, 0.45, 0.1, 0.06], 500)
    _write(ref, "fading", 5, snrs, [1.0, 0.5, 0.09, 0.04], 500)
    _write(got, "fading", 5, snrs, [1.0, 0.45, 0.1, 0.1], 500)
    # a sync curve ending at 0.06: STRICT_TOP holds it to < 0.05
    _write(ref, "sync", 2, snrs, [1.0, 0.5, 0.08, 0.0], 500)
    _write(got, "sync", 2, snrs, [1.0, 0.5, 0.08, 0.06], 500)
    cmp = compare_curves(got, ref)
    s = cmp["variants"]["sync"][1]
    assert s["first_snr_per_le_0.1"] == {"port": 6.0, "ref": 4.0}
    assert s["diff_db"] == 2.0 and s["within_2db"]
    assert s["max_abs_z"] == pytest.approx(abs(binomial_z(0.4, 500, 0.5, 500)))
    assert all(s["checks"].values())
    assert cmp["cross"] == {"sync_minus_aligned_mcs1": True}
    m = cmp["variants"]["mimo"][2]
    assert m["checks"] == {"monotone": False, "pcc_le_pdc": False,
                           "success_at_top": True}
    assert not cmp["ok"]
    assert cmp["variants"]["sync"][2]["checks"]["success_at_top"] is False
    assert cmp["variants"]["fading"][4]["checks"]["success_at_top"] is True
    assert cmp["variants"]["fading"][5]["checks"]["success_at_top"] is False
    (got / "sync" / "rx_loopback_MCS_0002.json").unlink()
    assert compare_curves(got, ref, ["sync", "aligned"])["ok"]
    assert not compare_curves(got, ref, ["fading"])["ok"]
    (got / "fading" / "rx_loopback_MCS_0005.json").unlink()
    assert compare_curves(got, ref, ["sync", "aligned", "fading"])["ok"]
    # the z of two binomial estimates at the pooled p
    assert binomial_z(0.0, 500, 0.0, 500) == 0.0
    p = 0.15
    assert binomial_z(0.2, 500, 0.1, 500) == pytest.approx(
        0.1 / np.sqrt(p * (1 - p) * 2 / 500))
