"""The yardstick's arithmetic against hand counts: the busy union, the
idle share and the span readers, the percentile, the tick rate, and the
profile reduction's attribution of device time to spans."""
import statistics

import numpy as np
import pytest
import torch

from benchmark.core.stats import percentile, spread
from benchmark.core.trace import Trace, reduce_profile
from benchmark.core.spec import reader
from benchmark.metrics.frozen import busy_union, tick_rate


def test_busy_union_by_hand():
    assert busy_union([]) == 0
    assert busy_union([(0, 10), (5, 20), (30, 40)]) == 30
    assert busy_union([(30, 40), (0, 10), (10, 12)]) == 22
    assert busy_union([(0, 100), (10, 20)]) == 100


def test_idle_and_host_readers():
    tr = Trace(units=4, profile={"busy_s": 0.25, "window_s": 1.0},
               spans_ms={"sync": 8.0, "rx": 4.0, "tx": 2.0, "vspace": 2.0},
               unit_ms=[10.0, 10.0, 10.0, 10.0])
    assert reader("node.idle_pct")(tr) == pytest.approx(75.0)
    assert reader("node.sync_ms")(tr) == pytest.approx(2.0)
    assert reader("node.rx_ms")(tr) == pytest.approx(1.0)
    assert reader("node.tx_ms")(tr) == pytest.approx(0.5)
    assert reader("node.vspace_ms")(tr) == pytest.approx(0.5)
    assert reader("node.host_ms")(tr) == pytest.approx((40 - 16) / 4)
    ticks = Trace(units=20, unit_ms=[float(i) for i in range(1, 21)])
    assert reader("node.tick_p95_ms")(ticks) == pytest.approx(19.05)
    assert reader("node.tick_p95_ms")(Trace(units=0)) is None
    assert reader("node.idle_pct")(Trace(units=1)) is None


def test_percentile_and_spread():
    xs = list(np.random.default_rng(1).random(101))
    assert percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == pytest.approx((q3 - q1) / med)
    assert tick_rate(1000, 2048, 1.728e6, 2.0) == pytest.approx(
        1000 * 2048 / 1.728e6 / 2.0)


class _Ev:
    def __init__(self, name, start, dur, dev, corr=0):
        self._n, self._s, self._d, self._dev = name, start, dur, dev
        self._c = corr

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)


class _Prof:
    def __init__(self, events):
        class K:
            def events(self_inner):
                return events

        class P:
            kineto_results = K()
        self.profiler = P()


def test_reduce_profile_by_hand():
    ev = [_Ev("bench.sync", 0, 100, False),       # host span [0, 100)
          _Ev("bench.sync", 0, 100, True),        # its device annotation
          _Ev("k_a", 10, 20, True), _Ev("k_b", 40, 30, True),
          _Ev("bench.rx", 200, 200, False),
          _Ev("k_c", 250, 40, True),
          _Ev("k_d", 400, 50, True),              # outside every span
          _Ev("host_op", 300, 200, False),
          _Ev("cudaLaunchKernel", 90, 5, False, corr=7),   # in bench.sync
          _Ev("k_e", 600, 10, True, corr=7)]       # runs after the span
    out = reduce_profile(_Prof(ev), 1e-6)
    assert out["busy_s"] == pytest.approx(150e-9)
    assert out["span_device_s"]["sync"] == pytest.approx(60e-9)
    assert out["span_device_s"]["rx"] == pytest.approx(40e-9)
    assert [n for n, _ in out["device_ops"]][0] == "k_d"
    gaps = dict((round(s * 1e9), n) for n, s in out["idle_gaps"])
    assert gaps[180] == "host"               # (70, 250): no span, no op
    assert gaps[110] == "bench.rx"           # (290, 400): the span, not the op


def test_ether_reference_by_hand():
    from benchmark.reference.ether import EtherReference
    radio = {"freq_hz": 1.9e9, "noise_var": 1e-8,
             "hws": [{"n_ant": 1, "position": [0.0, 0.0, 0.0]},
                     {"n_ant": 1, "position": [2.0, 0.0, 0.0]}]}
    ref = EtherReference(radio, "cpu")
    pl = 20 * np.log10(2.0) + 20 * np.log10(1.9e9) - 147.55
    g = 10 ** (-pl / 20)
    tx = torch.zeros(2, 1, 4, dtype=torch.complex64)
    tx[0, 0] = torch.tensor([1, 1j, -1, -1j])
    noise = torch.ones(2, 1, 4, dtype=torch.complex64)
    rx = ref.rx(tx, noise)
    assert torch.allclose(rx[1, 0], g * tx[0, 0].to(torch.complex128) + 1e-4)
    assert torch.allclose(rx[0, 0], torch.full((4,), 1e-4, dtype=torch.complex128))
    exact = [(tx, rx.to(torch.complex64), {"noise": noise})]
    assert ref.compare(exact)["vspace_bad_draws"] == 0
    assert ref.compare(exact)["vspace_gap"] < 1e-7
    assert ref.compare([(tx, rx, {})])["vspace_bad_draws"] == 1
    assert ref.compare([(tx, rx, {"noise": 2 * noise})])["vspace_bad_draws"] == 1
    low = EtherReference(radio, "cpu", "bfloat16")
    assert ref.compare(exact, against=low)["vspace_gap"] > 1e-4
    with pytest.raises(ValueError):
        EtherReference(dict(radio, channel_inter="flat"), "cpu")
