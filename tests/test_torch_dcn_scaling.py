"""The ports of tools/run_dcn_dryrun.py and tools/run_scaling.py
(dectnrp_tpu_torch/dcn_dryrun.py, scaling.py) and of
dectnrp_tpu/common/benchtime.py.

The dry run's (b) step gets JAX's PRNGKey(3) normals, re-derived here as
the JAX tool draws them, and is held to JAX's build_tx / build_rx on the
same bits: TX IQ within 1e-5, tb_ok equal, tb equal where ok. The CLI on
the CPU runs its two gloo processes and decodes 4 of 4 in each. `scaling`
cut in depth to 1 and 2 shards carries the JAX tool's row keys (minus its
TPU ones), and its hold of each row to the dense output fails a row that
differs. `synced_ms` / `synced_ms_marginal` on the CPU.
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dectnrp_tpu.phy.rx import build_rx as jax_build_rx
from dectnrp_tpu.phy.tx import build_tx as jax_build_tx
from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu_torch import dcn_dryrun as D
from dectnrp_tpu_torch import scaling as S
from dectnrp_tpu_torch.common import benchtime as B
from dectnrp_tpu_torch.phy.rx import build_rx
from dectnrp_tpu_torch.phy.tx import build_tx

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
NID = 0x12345678


# ---- dcn_dryrun

def test_channel_step_decides_as_jax_on_its_noise():
    """tools/run_dcn_dryrun.py:83-111 (its bits after (a)'s draws, noise
    from PRNGKey(3) and fold_in(key, 1)) through JAX's TX and RX on the
    global batch, and through the port's `channel_step` one channel a
    call, as each shard runs it."""
    psdef = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
    assert repr(psdef) == repr(D.PSDEF_CHAN)
    ps = get_packet_sizes(psdef)
    n_dev = 4
    rng = np.random.default_rng(0)
    rng.uniform(0.5, 1.0, (n_dev, n_dev))
    rng.standard_normal((n_dev, 1, 2048))
    rng.standard_normal((n_dev, 1, 2048))
    plcf = rng.integers(0, 2, (n_dev, 40)).astype(np.uint8)
    tb = rng.integers(0, 2, (n_dev, ps.N_TB_bits)).astype(np.uint8)
    pp, tp = D.channel_bits(D.ether_inputs(n_dev)[2], n_dev)
    np.testing.assert_array_equal(pp, plcf)
    np.testing.assert_array_equal(tp, tb)

    flags = jnp.zeros((n_dev,), bool)
    iq_j = jax_build_tx(psdef, NID, 1)(jnp.asarray(plcf), jnp.asarray(tb),
                                        flags, flags)
    nv = jnp.float32(10.0 ** (-15.0 / 10.0))
    assert float(nv) == D.NOISE_VAR
    key = jax.random.PRNGKey(3)
    n = (jax.random.normal(key, iq_j.shape)
         + 1j * jax.random.normal(jax.random.fold_in(key, 1), iq_j.shape))
    out_j = jax_build_rx(psdef, NID, 1)(
        iq_j + jnp.sqrt(nv / 2.0) * n.astype(jnp.complex64), nv)

    noise = torch.from_numpy((np.asarray(n) / np.sqrt(2.0)).astype(np.complex64))
    tx = build_tx(psdef, NID, 1, device="cpu")
    rx = build_rx(psdef, NID, 1, device="cpu")
    for i in range(n_dev):
        rows = slice(i, i + 1)
        iq, out = D.channel_step(tx, rx, torch.from_numpy(plcf[rows]),
                                 torch.from_numpy(tb[rows]), noise[rows])
        np.testing.assert_allclose(iq.numpy(), np.asarray(iq_j)[rows],
                                   atol=1e-5, rtol=0)
        ok = np.asarray(out_j["tb_ok"])[rows]
        np.testing.assert_array_equal(out["tb_ok"].numpy(), ok)
        assert ok.all()
        np.testing.assert_array_equal(out["tb"].numpy()[ok],
                                      np.asarray(out_j["tb"])[rows][ok])


def test_dcn_dryrun_cli_on_the_cpu(tmp_path):
    """Two gloo processes x 2 CPU shards: (a) within 0.02 of the host
    superposition and bit for bit the one-process tick, (b) 4/4 in both,
    (c) the flagship-numerology search over 2 x 4 shards finds its 4
    packets, equal to the one-process and dense searches; one JSON line,
    also written to --out."""
    out = tmp_path / "dcn.json"
    res = subprocess.run([sys.executable, "-m", "dectnrp_tpu_torch.dcn_dryrun",
                          "--device", "cpu", "--out", str(out)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec == json.loads(out.read_text())
    assert rec["ok"] and all(rec["gates"].values()), rec["gates"]
    assert (rec["backend"], rec["card"], rec["n_processes"]) == ("gloo", "cpu", 2)
    reps = rec["reports"]
    assert [r["rank"] for r in reps] == [0, 1]
    for r in reps:
        assert r["backend"] == "gloo"
        assert r["ether"]["global_shards"] == 4 and r["ether"]["local_shards"] == 2
        assert r["ether"]["ether_max_err"] < 0.02
        assert r["channels"]["channels_decoded_ok"] == 4
        assert r["sync"]["window"] == [8, 1, 39936]
        assert r["sync"]["local_shards"] == 4
    s0 = reps[0]["sync"]
    assert s0["stream"] == [1, 2097152]
    assert s0["found"] == s0["offsets"] and len(s0["found"]) == 4
    assert s0["mismatch_one_process"] == [] == s0["mismatch_dense"]
    assert "offsets" not in reps[1]["sync"]


# ---- scaling

# the row keys of tools/run_scaling.py (:83-86, :104-110, :115-124, :137-140)
JAX_ROWS = {
    "sync_sharded_strong": {"n_dev", "ms_per_stream", "samples_per_s",
                            "chunks_per_dev"},
    "sync_sharded_weak": {"n_dev", "total_chunks", "ms_per_stream",
                          "ms_per_chunk_per_dev", "control_unsharded_1dev_ms",
                          "sharded_over_control", "samples_per_s"},
    "vspace_sharded": {"n_dev", "ms_per_tick", "control_unsharded_1dev_ms",
                       "sharded_over_control", "nodes_per_dev"},
}
JAX_HALO = {"overlap_samples", "chunk_samples", "window_redundancy",
            "ici_halo_fraction_8dev", "comment"}
JAX_TPU_ONLY = {"real_chip_projection", "tpu_single_chip"}


def test_scaling_rows_on_the_cpu():
    res = S.run("cpu", (1, 2), iters=1)
    assert res["device"] == "cpu" and not JAX_TPU_ONLY & set(res)
    for sec, keys in JAX_ROWS.items():
        rows = res[sec]
        assert [r["n_dev"] for r in rows] == [1, 2], sec
        for r in rows:
            assert keys <= set(r), (sec, keys - set(r))
            assert r["distinct_devices"] == 1
            # the held sharded call's launches: none on the CPU
            assert set(r["launches"]) >= {"sync", "bcjr", "polyphase"}
            assert not any(r["launches"].values())
            assert all(np.isfinite(v) and v > 0 for k, v in r.items()
                       if k.endswith(("ms", "_s", "ms_per_stream", "ms_per_tick")))
    assert [r["chunks_per_dev"] for r in res["sync_sharded_strong"]] == [32, 16]
    assert [r["total_chunks"] for r in res["sync_sharded_weak"]] == [4, 8]
    halo = res["sync_halo_overhead"]
    assert JAX_HALO <= set(halo)
    assert halo["overlap_samples"] == 448 and halo["chunk_samples"] == 8192
    assert halo["ici_halo_fraction_8dev"] == 448 / (4 * 8192)


def test_scaling_holds_each_row_to_the_dense_output(monkeypatch):
    """A sync row whose dense search differs in one chunk's cfo, or a tick
    whose dense output is off by 1e-4, stops the run before it is timed."""
    dense = S.sync_dense

    def off_by_a_bit(*a, **k):
        rep = dense(*a, **k)
        rep["cfo"] = rep["cfo"].clone()
        rep["cfo"][0] = torch.nextafter(rep["cfo"][0], torch.tensor(1.0)) * 1.01
        return rep
    with monkeypatch.context() as m:
        m.setattr(S, "sync_dense", off_by_a_bit)
        with pytest.raises(RuntimeError, match=r"sync strong 2: .*\['cfo'\]"):
            S.run("cpu", (2,), iters=1)
    apply = S.apply_tick
    with monkeypatch.context() as m:
        m.setattr(S, "apply_tick", lambda *a, **k: apply(*a, **k) + 1e-4)
        with pytest.raises(RuntimeError, match="vspace control: sharded tick"):
            S.run("cpu", (2,), iters=1)


# ---- benchtime

def test_synced_ms_times_each_call():
    calls = []

    def f(x):
        calls.append(x)
        time.sleep(0.002)
    ms = B.synced_ms(f, (1,), iters=5, warmup=2)
    assert calls == [1] * 7
    assert 1.9 <= ms < 50


def test_synced_ms_marginal_cancels_a_fixed_cost(monkeypatch):
    """A closing synchronisation of 20 ms is spread over iters by
    synced_ms and cancels in synced_ms_marginal."""
    calls = []
    monkeypatch.setattr(B, "_sync", lambda devices: time.sleep(0.02))

    def f():
        calls.append(1)
        time.sleep(0.002)
    whole = B.synced_ms(f, iters=5, warmup=1)
    n = len(calls)
    marginal = B.synced_ms_marginal(f, iters=5, warmup=1)
    assert n == 6 and len(calls) - n == 1 + 5 + 15
    assert whole >= 5.9                   # 2 ms a call + 20 ms / 5 calls
    assert 1.9 <= marginal <= whole - 2.5
