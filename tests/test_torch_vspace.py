"""The port's virtual ether against the JAX package's (tests/test_vspace.py
mirrored).

Superposition, path loss, leakage, noise and the flat channel's
reciprocity run through both packages. The port draws with torch, so the
tick parity cases hand it JAX's own draws, re-derived from the tick's key
as `_tick_jit` splits it (`jax_tick_draws`), and hold its tick to JAX's
within 1e-6 abs / 1e-5 rel. The mesh-sharded tick is not ported (A13).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dectnrp_tpu.simulation import topology as Jtop
from dectnrp_tpu.simulation import vspace as J
from dectnrp_tpu.simulation.topology import fspl_db
from dectnrp_tpu_torch.simulation import topology as Ttop
from dectnrp_tpu_torch.simulation import vspace as T

torch.set_num_threads(1)


def jax_tick_draws(seed, now, N, A, S, channel="awgn", samp_rate=1_728_000.0,
                   noise_var=1.0):
    """The random numbers JAX's VSpace.tick draws at time `now`, in the
    port's draw_tick layout: the noise (JAX scales two unit normals by
    sqrt(nv / 2); the port's noise has unit variance) and, per directed
    edge (i, j), the doubly-selective channel's Jakes angles and phases
    from fold_in(fold_in(key, i * 131 + j), 7) split as _doubly_impl does."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), now & 0x7FFFFFFF)
    out = {}
    if channel.startswith("doubly"):
        L = T.doubly_taps(channel, samp_rate)
        th = np.zeros((N, N, A, A, L, T.N_SIN), np.float32)
        ph = np.zeros_like(th)
        for i in range(N):
            for j in range(N):
                k = jax.random.fold_in(jax.random.fold_in(key, i * 131 + j), 7)
                k_th, k_ph = jax.random.split(k)
                shape = (1, A, A, L, T.N_SIN)
                th[i, j] = np.asarray(jax.random.uniform(k_th, shape, maxval=2 * np.pi))[0]
                ph[i, j] = np.asarray(jax.random.uniform(k_ph, shape, maxval=2 * np.pi))[0]
        out["theta"], out["phi"] = torch.from_numpy(th), torch.from_numpy(ph)
    if noise_var > 0.0:
        k1, k2 = jax.random.split(key)
        n = np.asarray(jax.random.normal(k1, (N, A, S))) \
            + 1j * np.asarray(jax.random.normal(k2, (N, A, S)))
        out["noise"] = torch.from_numpy((n / np.sqrt(2.0)).astype(np.complex64))
    return out


def _nodes(pkg, n_nodes, leak_db, d, n_ant=1):
    top = Ttop if pkg is T else Jtop
    return [pkg.VNodeConfig(n_ant=n_ant,
                            trajectory=top.Trajectory(top.Position(d * i, 0, 0)),
                            tx_leakage_db=leak_db)
            for i in range(n_nodes)]


def _mk(pkg, n_nodes=3, channel="awgn", noise=0.0, leak_db=float("inf"),
        d=10.0, n_ant=1, spp=256):
    cfg = pkg.VSpaceConfig(samp_rate=1_728_000.0, spp_len=spp, freq_hz=1.9e9,
                           channel_inter=channel, noise_var=noise)
    nodes = _nodes(pkg, n_nodes, leak_db, d, n_ant)
    return pkg.VSpace(cfg, nodes, "cpu") if pkg is T else pkg.VSpace(cfg, nodes)


def _tick(vs, tx):
    if isinstance(vs, T.VSpace):
        return vs.tick(torch.from_numpy(tx)).numpy()
    return np.asarray(vs.tick(jnp.asarray(tx)))


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_superposition_and_pathloss(pkg):
    vs = _mk(pkg, 3)
    tx = np.zeros((3, 1, 256), np.complex64)
    tx[0, 0, :] = 1.0                      # only node 0 transmits
    rx = _tick(vs, tx)
    assert np.allclose(rx[0], 0.0)
    g01 = 10 ** (-fspl_db(10.0, 1.9e9) / 20)
    g02 = 10 ** (-fspl_db(20.0, 1.9e9) / 20)
    assert np.allclose(np.abs(rx[1]), g01, rtol=1e-4)
    assert np.allclose(np.abs(rx[2]), g02, rtol=1e-4)
    assert vs.now == 256


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_leakage(pkg):
    vs = _mk(pkg, 2, leak_db=40.0)
    tx = np.zeros((2, 1, 256), np.complex64)
    tx[0, 0, :] = 1.0
    rx = _tick(vs, tx)
    assert np.allclose(np.abs(rx[0]), 10 ** (-40 / 20), rtol=1e-4)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_noise_variance(pkg):
    nv = pkg.noise_var_from_snr_net_bw(10.0, 0.875)
    assert nv == J.noise_var_from_snr_net_bw(10.0, 0.875)
    vs = _mk(pkg, 2, noise=nv)
    rx = _tick(vs, np.zeros((2, 1, 256), np.complex64))
    meas = np.mean(np.abs(rx) ** 2)
    assert 0.5 * nv < meas < 2.0 * nv


def test_flat_channel_reciprocity():
    """The edge matrices are numpy draws from the seed: equal in both."""
    vs = _mk(T, 2, channel="flat", d=1.0, n_ant=2)
    H = vs._edge_H.numpy()
    assert np.allclose(H[0, 1], H[1, 0].T)
    np.testing.assert_array_equal(H, _mk(J, 2, channel="flat", d=1.0,
                                         n_ant=2)._edge_H)


def test_doubly_channel_runs():
    vs = _mk(T, 2, channel="doubly_0_363_222", d=1.0)
    rng = np.random.default_rng(0)
    tx = (rng.standard_normal((2, 1, 256)) + 1j * rng.standard_normal((2, 1, 256))
          ).astype(np.complex64)
    rx = _tick(vs, tx)
    assert rx.shape == (2, 1, 256)
    assert np.all(np.isfinite(rx))


def test_tick_sharded_not_ported():
    with pytest.raises(NotImplementedError, match="A13"):
        T.tick_sharded(None, None, None, 0.0, None)


@pytest.mark.parametrize("channel,n_ant", [("awgn", 1), ("flat", 2),
                                           ("doubly_0_363_222", 2)])
def test_tick_matches_jax_on_its_draws(channel, n_ant):
    """Three nodes, noise on, 30 dB leakage at every node, two ticks: the
    port's tick on JAX's draws equals JAX's VSpace.tick (_tick_jit)."""
    N, S, nv, seed = 3, 256, 1e-3, 5
    args = dict(n_nodes=N, channel=channel, noise=nv, d=2.0, n_ant=n_ant, spp=S)
    vj = _mk(J, leak_db=30.0, **args)
    vt = _mk(T, leak_db=30.0, **args)
    vj.cfg.sim_seed = vt.cfg.sim_seed = seed
    vj._key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(3)
    for _ in range(2):
        tx = (rng.standard_normal((N, n_ant, S))
              + 1j * rng.standard_normal((N, n_ant, S))).astype(np.complex64)
        draws = jax_tick_draws(seed, vt.now, N, n_ant, S, channel, noise_var=nv)
        want = np.asarray(vj.tick(jnp.asarray(tx)))
        got = vt.tick(torch.from_numpy(tx), draws).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
        assert vt.now == vj.now
