"""The port's native host runtime (tests/test_native_rt.py mirrored on
dectnrp_tpu_torch/common/native.py): ring buffer, job queue, token, datagram
queue through the ctypes bindings, with real producer/consumer threads; and
the port's own build: the library goes to dectnrp_tpu_torch/_build/ and
nothing is written into native/, and the real-IQ radios and the application
layer import without jax or the JAX package.
"""
from __future__ import annotations

import importlib.util
import pathlib
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from dectnrp_tpu_torch.common import native
from dectnrp_tpu_torch.common.native import (NativeDatagramQueue, NativeJobQueue,
                                             NativeRingBuffer, NativeToken,
                                             native_available)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _toolchain():
    if not native_available():
        pytest.skip("no native toolchain (g++)")


def test_ring_buffer_time_is_sample_counter():
    rb = NativeRingBuffer(capacity=1024, n_ant=2)
    assert rb.time == 0
    iq = (np.arange(2 * 100) + 1j * np.arange(2 * 100)[::-1]) \
        .reshape(2, 100).astype(np.complex64)
    rb.write(iq)
    assert rb.time == 100
    got = rb.read(0, 100)
    np.testing.assert_array_equal(got, iq)
    # wrap-around: write 10 more bursts then read a window crossing the seam
    for k in range(12):
        rb.write(iq * (k + 2))
    assert rb.time == 1300
    got = rb.read(1290, 10)
    np.testing.assert_array_equal(got, iq[:, 90:] * 13)
    # stale reads fail
    with pytest.raises(ValueError):
        rb.read(0, 10)
    # future reads fail
    with pytest.raises(ValueError):
        rb.read(1295, 10)


def test_ring_buffer_blocking_reader_thread():
    rb = NativeRingBuffer(capacity=4096, n_ant=1)
    got = {}

    def reader():
        t = rb.wait_until_nto(300)
        got["time"] = t
        got["data"] = rb.read(200, 100)

    th = threading.Thread(target=reader)
    th.start()
    time.sleep(0.05)
    assert th.is_alive()  # blocked: ring time still 0
    burst = np.full((1, 150), 1 + 1j, np.complex64)
    rb.write(burst)
    rb.write(burst * 2)
    th.join(timeout=2)
    assert not th.is_alive()
    assert got["time"] >= 300
    # [200, 300) lies entirely in the second burst (samples 150..299)
    np.testing.assert_array_equal(got["data"][0], burst[0, :100] * 2)
    rb.shutdown()
    assert rb.wait_until_nto(10_000) == -1


def test_job_queue_fifo_and_permeable():
    jq = NativeJobQueue(capacity=4)
    assert jq.enqueue(1, 10, 1000) == 0
    assert jq.enqueue(2, 20, 2000) == 1
    j = jq.dequeue()
    assert (j["fifo_cnt"], j["type"], j["handle"], j["time64"]) == (0, 1, 10, 1000)
    jq.set_permeable(False)
    assert jq.enqueue(3, 30) == -1          # gate closed
    jq.set_permeable(True)
    assert jq.enqueue(3, 30) == 2
    for _ in range(3):
        jq.enqueue(9, 9)
    assert jq.enqueue(9, 9) == -1           # full (capacity 4)
    assert jq.dequeue(timeout_us=0) is not None


def test_job_queue_mpmc_threads():
    jq = NativeJobQueue(capacity=10_000)
    N, NPROD = 500, 4
    seen = []
    lock = threading.Lock()

    def producer(pid):
        for i in range(N):
            while jq.enqueue(pid, i) < 0:
                time.sleep(0)

    def consumer():
        while True:
            j = jq.dequeue(timeout_us=200_000)
            if j is None:
                return
            with lock:
                seen.append((j["type"], j["handle"], j["fifo_cnt"]))

    prods = [threading.Thread(target=producer, args=(p,)) for p in range(NPROD)]
    cons = [threading.Thread(target=consumer) for _ in range(3)]
    for t in prods + cons:
        t.start()
    for t in prods:
        t.join()
    for t in cons:
        t.join()
    assert len(seen) == N * NPROD
    assert sorted(c for _, _, c in seen) == list(range(N * NPROD))
    per_pid = {p: [h for q, h, _ in seen if q == p] for p in range(NPROD)}
    for hs in per_pid.values():
        assert sorted(hs) == list(range(N))


def test_token_fifo_ordering():
    tok = NativeToken()
    order = []
    lock = threading.Lock()

    def worker(fifo_cnt):
        assert tok.lock_fifo(fifo_cnt, fifo_cnt, timeout_us=2_000_000)
        with lock:
            order.append(fifo_cnt)
        time.sleep(0.002)
        tok.unlock()

    # start out of order: 2, 0, 1 — token must admit 0, 1, 2
    threads = [threading.Thread(target=worker, args=(c,)) for c in (2, 0, 1)]
    for t in threads:
        t.start()
        time.sleep(0.01)
    for t in threads:
        t.join()
    assert order == [0, 1, 2]
    # plain lock still works after the fifo sequence
    assert tok.lock(7, timeout_us=100_000)
    tok.unlock()


def test_datagram_queue_drop_on_overflow():
    dq = NativeDatagramQueue(max_datagrams=2, max_bytes=64)
    assert dq.push(b"hello")
    assert dq.push(b"world")
    assert not dq.push(b"drop me")       # over datagram cap
    assert dq.dropped == 1
    assert dq.pop() == b"hello"
    assert not dq.push(b"x" * 60)        # over byte cap (5 bytes queued)
    assert dq.push(b"x" * 59)
    assert dq.pop() == b"world"
    assert dq.pop() == b"x" * 59
    assert dq.pop(timeout_us=0) is None


def test_datagram_queue_blocking_pop():
    dq = NativeDatagramQueue()
    res = {}

    def popper():
        res["d"] = dq.pop(timeout_us=2_000_000)

    th = threading.Thread(target=popper)
    th.start()
    time.sleep(0.02)
    dq.push(b"payload")
    th.join(timeout=2)
    assert res["d"] == b"payload"


def _listing(d: pathlib.Path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in sorted(d.iterdir())}


def test_library_builds_under_build_dir_not_native(tmp_path):
    """The bindings build the library into the package's _build/ under a
    name carrying the source's hash (temporary name, then os.replace) and
    write nothing into native/: checked on a copy of the source and of
    native.py laid out as in the repo (the JAX package's tests may build
    native/dectnrp_rt.so in the repo itself at the same time)."""
    assert native.library_path().parent == ROOT / "dectnrp_tpu_torch" / "_build"
    assert native.library_path().exists()
    (tmp_path / "native").mkdir()
    shutil.copy2(ROOT / "native" / "dectnrp_rt.cc", tmp_path / "native")
    pkg = tmp_path / "pkg" / "common"
    pkg.mkdir(parents=True)
    shutil.copy2(native.__file__, pkg / "native.py")
    before = _listing(tmp_path / "native")
    spec = importlib.util.spec_from_file_location("native_copy", pkg / "native.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.native_available()
    lib = mod.library_path()
    assert lib.parent == tmp_path / "pkg" / "_build" and lib.exists()
    assert lib.name == native.library_path().name      # same source, same hash
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]   # no temporaries
    assert _listing(tmp_path / "native") == before
    rb = mod.NativeRingBuffer(64, 1)                   # the copy's library works
    rb.write(np.ones((1, 8), np.complex64))
    assert rb.time == 8
    rb.close()


def test_iq_modules_import_without_jax():
    """A fresh interpreter imports the real-IQ radios, the application
    layer, the apps and the TCP scope, and loads neither jax nor the JAX
    package."""
    code = textwrap.dedent("""
        import sys
        import dectnrp_tpu_torch.radio.hw_iq
        import dectnrp_tpu_torch.application
        import dectnrp_tpu_torch.application.vnic
        import dectnrp_tpu_torch.apps.rtt
        import dectnrp_tpu_torch.apps.sync_gen
        import dectnrp_tpu_torch.common.tcp_scope
        import dectnrp_tpu_torch.config
        from dectnrp_tpu_torch.application.queue import make_datagram_queue
        from dectnrp_tpu_torch.common.native import native_available
        assert native_available()
        q = make_datagram_queue(4, 64)
        assert type(q).__name__ == "NativeBackedDatagramQueue"
        assert q.write(b"x") and q.read() == b"x"
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "dectnrp_tpu")]
        assert not bad, bad
        print("JAX_FREE_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "JAX_FREE_OK" in res.stdout


def test_closed_handles_are_safe(tmp_path):
    """Closing a ring closes the producers writing into it first; a closed
    producer or TX consumer keeps its counters at their values when it was
    closed, and a closed ring or consumer raises instead of handing the
    library a null handle."""
    from dectnrp_tpu_torch.common.native import NativeIqProducer, NativeTxConsumer

    n = 4 * 2048
    path = tmp_path / "iq.cf32"
    (np.arange(2 * n, dtype=np.float32)).tofile(path)
    ring = NativeRingBuffer(1 << 16, 1)
    prod = NativeIqProducer(ring, str(path), spp=2048)
    deadline = time.time() + 10.0
    while not prod.eof and time.time() < deadline:
        time.sleep(0.005)
    assert prod.eof and prod.samples == n
    ring.close()                            # closes the producer first
    assert prod._h is None and prod.eof and prod.samples == n
    with pytest.raises(RuntimeError, match="closed"):
        ring.read(0, 16)
    txc = NativeTxConsumer(str(tmp_path / "tx.cf32"), n_ant=1, spp=2048,
                           rate_hz=1_000_000.0, deferred_start=True)
    txc.close()
    assert txc.late_bursts == 0 and txc.send_errors == 0
    with pytest.raises(RuntimeError, match="closed"):
        txc.schedule(0, 0, np.zeros((1, 8), np.complex64))


def test_port_in_use_is_the_only_retried_error():
    """A UDP ingress on a port another socket holds raises PortInUse;
    on_free_port retries that on a new port and nothing else: any other
    error leaves on its first occurrence."""
    import socket

    from dectnrp_tpu_torch.common.native import NativeIqSocketProducer, PortInUse
    from dectnrp_tpu_torch.iq_check import on_free_port

    held = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    held.bind(("127.0.0.1", 0))
    ring = NativeRingBuffer(1 << 12, 1)
    try:
        with pytest.raises(PortInUse):
            NativeIqSocketProducer(ring, held.getsockname()[1])
        ports = []

        def busy_once(port):
            ports.append(port)
            if len(ports) == 1:
                return NativeIqSocketProducer(ring, held.getsockname()[1])
            return NativeIqSocketProducer(ring, port)

        prod = on_free_port(busy_once)
        assert len(ports) == 2 and prod.datagrams == 0
        prod.close()
        tries = []

        def fails(port):
            tries.append(port)
            raise RuntimeError("a failure that is not the bind")

        with pytest.raises(RuntimeError, match="not the bind"):
            on_free_port(fails)
        assert len(tries) == 1
    finally:
        ring.close()
        held.close()
