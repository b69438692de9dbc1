"""The process-spanning mesh (common/dist.py, common/mesh.py) against the
one-process mesh and the JAX package.

Two gloo processes, each holding two CPU shards, are joined through a
FileStore (no fixed port) by `dist.spawn`. Each child gets its inputs as
pickled numpy arrays and returns its own shards' results as JSON lists
(float32 values survive the trip exactly), so the parent holds them to
the one-process mesh bit for bit: `ppermute` and `psum` (with and without
scatter_dim, with perms that cross the process boundary and a shard that
receives nothing), `tick_sharded` (also within 1e-5 of JAX's on its 4-device
CPU mesh, on JAX's draws) and `build_sync_sharded` at u = b = 1 over 2 x 2
shards (also equal to JAX's sharded search as
tests/test_torch_sync_sharded.py compares them). A child that raises, or a
run that outlasts its timeout, makes `spawn` raise, quoting the child.
"""
import time

import numpy as np
import pytest
import torch

from dectnrp_tpu_torch.common import dist
from dectnrp_tpu_torch.common.mesh import Mesh, ppermute, psum
from dectnrp_tpu_torch.phy import sync_sharded as T
from dectnrp_tpu_torch.simulation import vspace as V

torch.set_num_threads(1)
WORLD, LOCAL = 2, 2
N_SH = WORLD * LOCAL
CPUS = ["cpu"] * WORLD


def _as_list(t: torch.Tensor):
    t = t.cpu()
    return (torch.view_as_real(t) if t.is_complex() else t).tolist()


def _from_list(x, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(torch.tensor(x, dtype=torch.float32))
    return torch.tensor(x, dtype=like.dtype)


# ---- ppermute and psum

PERMS = {
    "ring": [(i, (i + 1) % N_SH) for i in range(N_SH)],
    # shard 2 receives nothing; 0 <- 2 and 3 <- 0 cross the boundary
    "partial": [(0, 3), (3, 1), (2, 0)],
    "within": [(0, 1), (1, 0), (3, 2)],
}


def _blocks():
    """Every shard's block, complex64 [4, 3, 5] and float32 [8, 2]."""
    rng = np.random.default_rng(5)
    c = (rng.standard_normal((N_SH, 4, 3, 5))
         + 1j * rng.standard_normal((N_SH, 4, 3, 5))).astype(np.complex64)
    f = rng.standard_normal((N_SH, 8, 2)).astype(np.float32)
    return ([torch.from_numpy(b) for b in c], [torch.from_numpy(b) for b in f])


def _collectives(rank, world, device):
    mesh = Mesh.over_group([device] * LOCAL, "x")
    own = mesh.local_along("x")
    out = {}
    for kind, blocks in zip(("c64", "f32"), _blocks()):
        mine = [blocks[i] for i in own]
        for name, perm in PERMS.items():
            out[f"ppermute_{name}_{kind}"] = [
                _as_list(t) for t in mesh.ppermute(mine, perm, "x")]
        out[f"psum_{kind}"] = [_as_list(t) for t in mesh.psum(mine, "x")]
        out[f"psum_scatter_{kind}"] = [
            _as_list(t) for t in mesh.psum(mine, "x", scatter_dim=0)]
    return {"owners": mesh.owners.tolist(), "own": own, "out": out}


@pytest.fixture(scope="module")
def collectives():
    return dist.spawn(_collectives, WORLD, "gloo", CPUS, timeout_s=120)


CASES = [f"{op}_{kind}" for kind in ("c64", "f32")
         for op in [f"ppermute_{p}" for p in PERMS] + ["psum", "psum_scatter"]]


@pytest.mark.parametrize("case", CASES)
def test_spanning_collective_is_the_one_process_one(collectives, case):
    blocks = _blocks()[0 if case.endswith("c64") else 1]
    op = case.rsplit("_", 1)[0]
    if op.startswith("ppermute"):
        want = ppermute(blocks, PERMS[op.split("_", 1)[1]])
    else:
        want = psum(blocks, 0 if op == "psum_scatter" else None)
    got = {}
    for rep in collectives:
        assert rep["owners"] == [0, 0, 1, 1] and rep["backend"] == "gloo"
        assert rep["own"] == [2 * rep["rank"], 2 * rep["rank"] + 1]
        for g, i in zip(rep["out"][case], rep["own"]):
            got[i] = _from_list(g, want[i])
    assert sorted(got) == list(range(N_SH))
    for i in range(N_SH):
        assert got[i].dtype == want[i].dtype and torch.equal(got[i], want[i]), i


# ---- the node-sharded tick

def _tick(rank, world, device, tx, gain, nv, draws):
    mesh = Mesh.over_group([device] * LOCAL, "node")
    own = mesh.local_along("node")
    n_per = tx.shape[0] // N_SH
    rows = np.concatenate([tx[i * n_per:(i + 1) * n_per] for i in own])
    got = V.tick_sharded(mesh, torch.from_numpy(rows), gain, nv,
                         draws=[torch.from_numpy(draws[i]) for i in own])
    return {"own": own, "rx": [_as_list(g) for g in got]}


@pytest.mark.parametrize("N,nv", [(4, 0.1), (8, 0.0)])
def test_spanning_tick_matches_jax_and_the_one_process_tick(N, nv):
    """On JAX's draws: within 1e-5 of JAX's tick_sharded on its 4-device
    mesh, and bit for bit the port's one-process 4-shard tick."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from test_torch_vspace import jax_sharded_draws

    from dectnrp_tpu.simulation import vspace as J

    A, S = 2, 128
    rng = np.random.default_rng(N)
    tx = (rng.standard_normal((N, A, S)) + 1j * rng.standard_normal((N, A, S))
          ).astype(np.complex64)
    gain = rng.random((N, N)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draws = jax_sharded_draws(key, N_SH, N // N_SH, A, S)
    want = np.asarray(J.tick_sharded(JMesh(np.array(jax.devices()[:N_SH]),
                                           ("node",)),
                                     jnp.asarray(tx), jnp.asarray(gain), nv, key))
    one = V.tick_sharded(Mesh(np.array(["cpu"] * N_SH, dtype=object), ("node",)),
                         torch.from_numpy(tx), gain, nv, draws=draws)
    reps = dist.spawn(_tick, WORLD, "gloo", CPUS, args=(
        tx, gain, nv, [d.numpy() for d in draws]), timeout_s=120)
    got = {}
    for rep in reps:
        for g, i in zip(rep["rx"], rep["own"]):
            got[i] = _from_list(g, one[i])
    assert sorted(got) == list(range(N_SH))
    for i in range(N_SH):
        assert torch.equal(got[i], one[i]), i
    np.testing.assert_allclose(torch.cat([got[i] for i in range(N_SH)]).numpy(),
                               want, atol=1e-5, rtol=0)


# ---- the time-sharded sync

def _sync(rank, world, device, stream, chunk, n_chunks):
    mesh = Mesh.over_group([device] * LOCAL, "t")
    sh = T.build_sync_sharded(1, 1, chunk, n_chunks, mesh)
    span = sh.c_loc * chunk
    rep = sh(torch.from_numpy(stream[:, sh.local[0] * span:
                                     (sh.local[-1] + 1) * span]))
    full = sh.gather_report(rep)
    return {"local": sh.local, "chunks": int(rep["detected"].shape[0]),
            "report": None if full is None else
            {k: [_as_list(v), str(v.dtype)] for k, v in full.items()}}


def test_spanning_sync_is_the_one_process_search_and_jax():
    """u = b = 1, 8 chunks of 2,048 over 2 x 2 shards, packets inside a
    chunk, across a chunk boundary, across the process boundary (chunk 3 ->
    4) and in the last shard: the report gathered on rank 0 is bit for bit
    the one-process 4-shard search, and agrees with JAX's sharded search
    on its 4-device mesh (detected equal; t_global, n_eff_tx equal and cfo,
    metric, rms within 1e-5 where detected), with equal dedup hits."""
    from test_torch_sync_sharded import (assert_reports_agree, run_both,
                                         stream_with_packets)

    chunk, n_chunks = 2048, 8
    offsets = [700, 2 * chunk - 150, 4 * chunk - 300, 6 * chunk + 90]
    stream = stream_with_packets(offsets, chunk * n_chunks)
    rj, rt, _ = run_both(stream, 1, 1, chunk, n_chunks, N_SH)
    reps = dist.spawn(_sync, WORLD, "gloo", CPUS, args=(stream, chunk, n_chunks),
                      timeout_s=120)
    assert [r["local"] for r in reps] == [[0, 1], [2, 3]]
    assert [r["chunks"] for r in reps] == [n_chunks // 2] * 2
    assert reps[1]["report"] is None
    got = {}
    for k, (v, dtype) in reps[0]["report"].items():
        got[k] = torch.tensor(v, dtype=getattr(torch, dtype.split(".")[1]))
        assert torch.equal(got[k], torch.from_numpy(rt[k])), k
    gn = {k: v.numpy() for k, v in got.items()}
    assert_reports_agree(rj, gn)
    found = [h["t_global"] for h in T.dedup_reports(gn, 1, 1)]
    assert len(found) == len(offsets)
    assert np.all(np.abs(np.array(found) - np.array(offsets)) <= 2)


# ---- the launcher's failures

def _raises_on_rank_1(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()          # rank 0 waits for a peer that died
    return {}


def _sleeps(rank, world, device):
    time.sleep(600)
    return {}


def test_a_child_that_raises_fails_spawn_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 of 2 \(gloo\) exited "
                                           r"with code 1.*The tail of rank 1's "
                                           r"output:.*rank 1 gives up"):
        dist.spawn(_raises_on_rank_1, WORLD, "gloo", CPUS, timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_a_run_past_its_timeout_is_killed():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0, 1\] of 2 \(gloo\) "
                                           r"had not finished after 4"):
        dist.spawn(_sleeps, WORLD, "gloo", CPUS, timeout_s=4)
    assert time.monotonic() - t0 < 30


def test_spawn_refuses_a_device_list_of_another_length():
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        dist.spawn(_sleeps, WORLD, "gloo", ["cpu"] * 3)


def test_a_spanning_mesh_needs_its_group_and_owners():
    with pytest.raises(ValueError, match="owners and group go together"):
        Mesh(np.array(["cpu"] * 4, dtype=object), ("t",), owners=[0, 0, 1, 1])
