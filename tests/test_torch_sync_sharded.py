"""The port's time-sharded sync against the JAX package's
(tests/test_sync_sharded.py mirrored, and more cases).

The same numpy stream (packets from JAX's build_tx, numpy noise) goes
through JAX's build_sync_sharded on its 8-device CPU mesh and the port's on
a mesh of the CPU listed as often: detected, t_global and n_eff_tx equal,
cfo, metric and rms within 1e-5 where detected, and dedup_reports' hits
equal. The cases: tests/test_sync_sharded.py's three (a packet straddling a
device boundary, chunk 8192, noise at threshold 0.35), b = 16, two
antennas, and a packet in the stream's last 4 N_STF samples, which the
wrapped halo's mask drops in both.
"""
import ast
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from dectnrp_tpu.phy import sync_sharded as J
from dectnrp_tpu.phy.sync import SyncParams as JSyncParams
from dectnrp_tpu.phy.tx import build_tx as jax_build_tx
from dectnrp_tpu.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from dectnrp_tpu_torch.common.mesh import Mesh
from dectnrp_tpu_torch.phy import sync_sharded as T
from dectnrp_tpu_torch.phy.sync import SyncParams, build_sync
from dectnrp_tpu_torch.sections.part3.transmission_packet_structure import (
    get_N_samples_STF)

torch.set_num_threads(1)

NID = 0x12345678


def stream_with_packets(offsets, T_len, u=1, b=1, R=1, snr_db=12.0, seed=0):
    """[R, T_len] complex64: JAX TX packets of (u, b, 0, 2, 0, 2) at
    offsets (a packet past the end is cut) plus numpy AWGN at snr_db;
    tests/test_sync_sharded.py's stream, drawn in its order (at R = 1 the
    same array), with R > 1 antennas each seeing a packet at its own
    random phase."""
    psdef = PacketSizesDef(u, b, 0, 2, 0, 2, 6144)
    ps = get_packet_sizes(psdef)
    rng = np.random.default_rng(seed)
    n = len(offsets)
    plcf = jnp.asarray(rng.integers(0, 2, (n, 40)), jnp.uint8)
    tb = jnp.asarray(rng.integers(0, 2, (n, ps.N_TB_bits)), jnp.uint8)
    fl = jnp.zeros((n,), bool)
    iq = np.asarray(jax_build_tx(psdef, NID, 1)(plcf, tb, fl, fl))
    nv = np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10)
    stream = (rng.standard_normal((R, T_len)) + 1j * rng.standard_normal((R, T_len)))
    stream *= np.sqrt(nv / 2)
    for i, off in enumerate(offsets):
        ph = np.exp(2j * np.pi * rng.random((R, 1))) if R > 1 else 1.0
        stream[:, off:off + iq.shape[-1]] += ph * iq[i][:, :T_len - off]
    return stream.astype(np.complex64)


def run_both(stream, u, b, chunk, n_chunks, n_dev, params=None):
    """(JAX report as numpy, port report as numpy, the port's module)."""
    jmesh = JMesh(np.array(jax.devices()[:n_dev]), ("t",))
    kw = {} if params is None else {"params": JSyncParams(**params)}
    fj = J.build_sync_sharded(u, b, chunk, n_chunks, jmesh, **kw)
    rj = {k: np.asarray(v) for k, v in fj(jnp.asarray(stream)).items()}
    mesh = Mesh(np.array([torch.device("cpu")] * n_dev, dtype=object), ("t",))
    kw = {} if params is None else {"params": SyncParams(**params)}
    ft = T.build_sync_sharded(u, b, chunk, n_chunks, mesh, **kw)
    rt = {k: v.numpy() for k, v in ft(torch.from_numpy(stream)).items()}
    return rj, rt, ft


def assert_reports_agree(rj, rt):
    """detected equal; where detected, t_global and n_eff_tx equal, cfo,
    metric and rms within 1e-5. (An undetected chunk's times are the argmax
    of what the gate let through on noise, where a metric within float32
    rounding of the gate may pass in one package and not the other.)"""
    assert rj.keys() == rt.keys()
    for k in rj:
        assert rt[k].dtype == rj[k].dtype, k
    np.testing.assert_array_equal(rt["detected"], rj["detected"])
    det = rj["detected"]
    for k in ("t_global", "n_eff_tx"):
        np.testing.assert_array_equal(rt[k][det], rj[k][det], err_msg=k)
    for k in ("cfo", "metric", "rms"):
        np.testing.assert_allclose(rt[k][det], rj[k][det], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def hit_times(rep, u, b, dedup):
    return [h["t_global"] for h in dedup(rep, u, b)]


# (name, u, b, R, chunk, n_chunks, n_dev, offsets as fractions of a chunk:
# (chunk index, sample in it))
CASES = [
    # tests/test_sync_sharded.py::test_sharded_sync_matches_serial: inside a
    # chunk, straddling a chunk boundary, straddling a DEVICE boundary
    # (chunk 7 -> 8 with 8 devices x 2 chunks), inside a later chunk
    ("serial_b1", 1, 1, 1, 2048, 16, 8, [(0, 1000), (3, -300), (8, -400), (12, 500)]),
    # tests/test_sync_sharded.py::test_sharded_sync_large_chunk
    ("chunk8192_b1", 1, 1, 1, 8192, 8, 4, [(1, 100), (4, -240), (7, 500)]),
    # b = 16 (N_STF = 1792, overlap 7168): across the shard 1 -> 2 boundary
    ("chunk8192_b16", 1, 16, 1, 8192, 8, 4, [(0, 1000), (4, -3000), (5, 2000)]),
    # two antennas at b = 1
    ("R2_b1", 1, 1, 2, 2048, 8, 4, [(0, 700), (4, -200), (6, 100)]),
]


@pytest.mark.parametrize("name,u,b,R,chunk,n_chunks,n_dev,offs", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_sync_matches_jax(name, u, b, R, chunk, n_chunks, n_dev, offs):
    offsets = [c * chunk + s for c, s in offs]
    stream = stream_with_packets(offsets, chunk * n_chunks, u=u, b=b, R=R)
    rj, rt, _ = run_both(stream, u, b, chunk, n_chunks, n_dev)
    assert_reports_agree(rj, rt)
    found = hit_times(rt, u, b, T.dedup_reports)
    assert found == hit_times(rj, u, b, J.dedup_reports)
    assert len(found) == len(offsets), (found, offsets)
    assert np.all(np.abs(np.array(found) - np.array(sorted(offsets))) <= 2)


def test_wrapped_halo_masks_the_stream_tail():
    """A packet starting in the last 4 N_STF samples of the stream is found
    by the last chunk's own search, but its window's halo wraps to the
    stream's head: both packages mask it, and keep the other packet."""
    chunk, n_chunks, n_dev = 2048, 8, 4
    T_len = chunk * n_chunks
    ov = 4 * get_N_samples_STF(1, 1)
    tail = T_len - 300                      # t_fine 1748 > chunk - overlap
    stream = stream_with_packets([3000, tail], T_len)
    rj, rt, ft = run_both(stream, 1, 1, chunk, n_chunks, n_dev)
    assert_reports_agree(rj, rt)
    # unmasked, the last chunk's window detects the tail packet
    win = np.concatenate([stream[:, -chunk:], stream[:, :ov]], -1)[None]
    raw = build_sync(1, 1, chunk + ov, device="cpu")(torch.from_numpy(win))
    assert bool(raw["detected"][0])
    assert chunk - ov < int(raw["t_fine"][0]) < chunk
    assert abs((n_chunks - 1) * chunk + int(raw["t_fine"][0]) - tail) <= 2
    assert not rt["detected"][-1] and not rj["detected"][-1]
    found = hit_times(rt, 1, 1, T.dedup_reports)
    assert found == hit_times(rj, 1, 1, J.dedup_reports)
    assert len(found) == 1 and abs(found[0] - 3000) <= 2


def test_sharded_sync_no_false_alarms():
    """tests/test_sync_sharded.py::test_sharded_sync_no_false_alarms on
    both packages: pure noise at threshold 0.35 gives no hit."""
    n_chunks = 8
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal((1, n_chunks * 2048))
             + 1j * rng.standard_normal((1, n_chunks * 2048))).astype(np.complex64)
    rj, rt, _ = run_both(noise, 1, 1, 2048, n_chunks, 8,
                         params={"metric_threshold": 0.35})
    assert_reports_agree(rj, rt)
    assert not T.dedup_reports(rt, 1, 1) and not J.dedup_reports(rj, 1, 1)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_equals_dense_search(n_dev):
    """The sharded report is the dense search's (sync_dense: every window
    in one call, masked as the shards mask) at any shard count: the
    chunks' reports come back in chunk order, bit for bit but cfo, which on
    the CPU is within 1e-6 relative: torch.angle takes a vectorized atan2
    on full vector lanes and a scalar one on the rest, and the two differ
    in the last bit (on the card it is bit for bit too,
    tests/test_torch_cuda.py::test_sharded_sync_card_matches_dense)."""
    chunk, n_chunks = 2048, 8
    offsets = [500, 2 * chunk - 200, 5 * chunk + 40, n_chunks * chunk - 100]
    stream = torch.from_numpy(stream_with_packets(offsets, chunk * n_chunks))
    mesh = Mesh(np.array(["cpu"] * n_dev, dtype=object), ("t",))
    sh = T.build_sync_sharded(1, 1, chunk, n_chunks, mesh)
    got = sh(stream)
    want = T.sync_dense(sh.syncs[torch.device("cpu")], stream, chunk, n_chunks,
                        sh.overlap)
    for k in want:
        if k == "cfo":
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6)
        else:
            assert torch.equal(got[k], want[k]), k
    assert got["detected"].sum() >= 3


def test_sharded_sync_on_a_2d_mesh():
    """On a ("t", "dp") mesh the shards along "t" at dp 0 compute the
    report (JAX replicates it over dp): the same as on the 1-d mesh."""
    chunk, n_chunks = 2048, 8
    stream = torch.from_numpy(stream_with_packets([900, 4 * chunk - 150],
                                                  chunk * n_chunks))
    m2 = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(4, 2), ("t", "dp"))
    m1 = Mesh(np.array(["cpu"] * 4, dtype=object), ("t",))
    a = T.build_sync_sharded(1, 1, chunk, n_chunks, m2)(stream)
    b = T.build_sync_sharded(1, 1, chunk, n_chunks, m1)(stream)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sharded_sync_refuses_bad_shapes():
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("t",))
    with pytest.raises(AssertionError):
        T.build_sync_sharded(1, 1, 2048, 6, mesh)       # 6 chunks over 4
    with pytest.raises(AssertionError, match="overlap"):
        T.build_sync_sharded(1, 16, 4096, 8, mesh)      # overlap 7168
    sh = T.build_sync_sharded(1, 1, 2048, 8, mesh)
    with pytest.raises(ValueError, match="iq must be"):
        sh(torch.zeros((1, 2048 * 8 - 1), dtype=torch.complex64))


def _body(fn):
    """A function's AST without its docstring."""
    f = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    if isinstance(f.body[0], ast.Expr) and isinstance(f.body[0].value, ast.Constant):
        f.body = f.body[1:]
    return ast.dump(f)


def test_dedup_reports_is_a_copy():
    """The port's dedup_reports is the JAX function code for code (the JAX
    module loads jax, so the port keeps a copy); only the docstring is
    free."""
    assert _body(T.dedup_reports) == _body(J.dedup_reports)


def test_dedup_reports_keeps_one_hit_an_stf():
    """Detections closer than one STF collapse to the earliest; CPU
    tensors and numpy arrays give the same hits."""
    rep = {"detected": np.array([True, True, False, True, True]),
           "t_global": np.array([5000, 100, 300, 140, 100 + 112], np.int32),
           "cfo": np.arange(5, dtype=np.float32)}
    want = [{"detected": True, "t_global": 100, "cfo": 1.0},
            {"detected": True, "t_global": 212, "cfo": 4.0},
            {"detected": True, "t_global": 5000, "cfo": 0.0}]
    assert T.dedup_reports(rep, 1, 1) == want == J.dedup_reports(rep, 1, 1)
    as_tensors = {k: torch.from_numpy(v) for k, v in rep.items()}
    assert T.dedup_reports(as_tensors, 1, 1) == want
