"""The port's FEC AWGN oracle (dectnrp_tpu_torch.fec_awgn) vs the JAX package.

The oracle step with injected numpy noise against the same pipeline
composed from the JAX package's own modules (tools/run_fec_awgn.py's
_build_step draws its noise from jax.random, so it is rebuilt here with the
noise as an input): pdc_encode(rv) -> map_bits -> AWGN -> demap_llr ->
pdc_dematch(rv) -> softbuffer add -> pdc_decode_d, over rv 0, 2, 3, 1 at
one SNR near the committed retx-0 waterfall (results/fec_awgn/). tb_ok per
transmission and the uncoded bit-error count must be equal. The CLI on the
CPU writes the committed records' keys.
"""
import inspect
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _keys(rec):
    """Nested key structure of a record (values dropped)."""
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in rec.items()}


@pytest.mark.parametrize("mcs,snr", [(1, 3.0), (4, 11.0)])
def test_oracle_step_matches_jax_composition(mcs, snr):
    from dectnrp_tpu.phy.fec import chain as J
    from dectnrp_tpu.phy.modulation import demap_llr, map_bits
    from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef as JDef
    from dectnrp_tpu_torch import fec_awgn

    step = fec_awgn.build_fec_awgn_step(fec_awgn.fec_psdef(mcs), 3, device="cpu")
    ps = step.ps
    plan = J.PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps,
                         JDef(1, 1, 0, 4, 0, mcs, 6144).Z)
    B, n_bps = 4, ps.mcs.N_bps
    rng = np.random.default_rng(10 + mcs)
    tb = rng.integers(0, 2, (B, ps.N_TB_bits)).astype(np.uint8)
    noise = [(rng.standard_normal((B, ps.G // n_bps))
              + 1j * rng.standard_normal((B, ps.G // n_bps))).astype(np.complex64)
             for _ in range(4)]
    nv, amp = fec_awgn.noise_scale(snr)

    oks_j, errs_j, soft = [], 0, None
    for t, rv in enumerate(fec_awgn.RV_SEQ):
        e = J.pdc_encode(jnp.asarray(tb), plan, fec_awgn.NID, 1, rv=rv)
        sym = map_bits(e, n_bps)
        y = sym + jnp.float32(amp) * jnp.asarray(noise[t])
        llr = demap_llr(y, jnp.ones_like(sym.real), n_bps, jnp.float32(nv))
        errs_j += int(jnp.sum((llr > 0).astype(jnp.uint8) != e))
        d_new = J.pdc_dematch(llr, plan, fec_awgn.NID, 1, rv=rv)
        soft = d_new if soft is None else {k: soft[k] + d_new[k] for k in d_new}
        oks_j.append(np.asarray(J.pdc_decode_d(soft, plan)[1]))
        if t == 0:
            soft0_j = soft

    oks_t, errs_t, soft0_t = step(torch.as_tensor(tb), snr,
                                  noise=[torch.as_tensor(n) for n in noise])
    np.testing.assert_array_equal(oks_t.numpy(), np.stack(oks_j, -1))
    assert int(errs_t) == errs_j
    for K in soft0_j:
        np.testing.assert_allclose(soft0_t[K].numpy(), np.asarray(soft0_j[K]),
                                   rtol=1e-5, atol=1e-4)
    # the PER never rises over the retransmissions; all decode in the end
    per = 1.0 - oks_t.numpy().mean(0)
    assert np.all(np.diff(per) <= 0) and per[-1] == 0.0
    assert step.pool.rx[0].leased is False      # released after the last retx


def test_cli_writes_committed_schema(tmp_path):
    """`python -m dectnrp_tpu_torch.fec_awgn --n 2 --mcs-max 1` on the CPU,
    at three high SNR points: the records carry the committed keys, and
    every packet decodes."""
    from dectnrp_tpu_torch import fec_awgn

    fec_awgn.main(["--n", "2", "--mcs-max", "1", "--snr", "21", "25", "2",
                   "--device", "cpu", "--out", str(tmp_path)])
    for mcs in (0, 1):
        got = json.loads((tmp_path / f"fec_awgn_MCS_{mcs:02d}.json").read_text())
        ref = json.loads((ROOT / f"results/fec_awgn/fec_awgn_MCS_{mcs:02d}.json")
                         .read_text())
        assert _keys(got) == _keys(ref)
        assert got["parameter"] == ref["parameter"]
        assert got["experiment_range"]["snr_vec"] == [21.0, 23.0, 25.0]
        assert got["experiment_range"]["rv_sequence"] == [0, 2, 3, 1]
        assert got["platform"] == "cpu"
        for t in range(4):
            assert got["result"][f"PER_retx{t}"] == [0.0, 0.0, 0.0]
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["platform"] == "cpu" and meta["total_wall_s"] > 0


def test_oracle_step_defaults_to_the_card():
    from dectnrp_tpu_torch import fec_awgn

    for f in (fec_awgn.build_fec_awgn_step, fec_awgn.sweep):
        assert inspect.signature(f).parameters["device"].default == "cuda"


def test_compare_curves_on_the_committed_records(tmp_path):
    """The committed curves against themselves: every threshold equal, every
    BER gap 0; records over other SNR points are refused."""
    from dectnrp_tpu_torch import fec_awgn

    ref = str(ROOT / "results/fec_awgn")
    cmp = fec_awgn.compare_curves(ref, ref)
    assert sorted(cmp) == list(range(10))
    for c in cmp.values():
        assert all(v["diff_db"] == 0 for v in c["first_snr_per_le_0.1"].values())
        assert c["max_abs_ber_z"] == 0.0 and len(c["ber_z"]) > 3
    assert cmp[4]["first_snr_per_le_0.1"][0]["ref"] == 11.0
    assert cmp[8]["first_snr_per_le_0.1"][3]["ref"] == 7.0
    rec = json.loads((ROOT / "results/fec_awgn/fec_awgn_MCS_01.json").read_text())
    rec["experiment_range"]["snr_vec"] = rec["experiment_range"]["snr_vec"][1:]
    (tmp_path / "fec_awgn_MCS_01.json").write_text(json.dumps(rec))
    assert fec_awgn.compare_curves(str(tmp_path), ref, [0]) == {}
    with pytest.raises(ValueError):
        fec_awgn.compare_curves(str(tmp_path), ref, [1])
