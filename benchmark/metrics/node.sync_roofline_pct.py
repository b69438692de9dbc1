"""node.sync_roofline_pct: the sync layer's share of its roofline, in %: the
least time an H100 needs for the profiled window's `Sync` calls, over the
device seconds of the operations launched inside the `sync` span (B2, the
detection metric, then the sync report kernel).

The least time of a call is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)
over both kernels' compulsory bytes and operations at the loop's chunk
[1, A, T] (the arithmetic of chip_smoke.py's `sync_work` and
`report_work`, PERF.md section 6). None where the loop hands no sync sizes
or the profile holds no such span."""

HBM_BYTES_S = 3.35e12       # one H100's HBM, NVIDIA's data sheet (SXM)
FP32_OPS_S = 67e12          # its float32 rate outside the tensor cores
SPAN = "sync"


def sync_work(A: int, T: int, P: int, L: int, **_) -> tuple[int, int]:
    """(bytes, ops) of B2: the chunk read once, the metric row written
    once; per output sample and antenna 12 ops for the lag product, power
    and their prefix sums, 6 per further pattern lag, 2 for P2; per output
    8 for the gated metric and 3 for the box smoothing."""
    n_pat, n_t = L // P, T - L - P
    return A * T * 8 + n_t * 4, n_t * (A * (14 + 6 * (n_pat - 1)) + 11)


def report_work(A: int, T: int, K: int, P: int, L: int, half: int, M: int,
                **_) -> tuple[int, int]:
    """(bytes, ops) of the sync report: the metric row, each peak's fine
    segment of the chunk, the M templates and the weights read once, 25
    bytes a peak written; a peak's sums 8 flops a lag product and 3 a
    power, its segment 6 a sample, its direct fine search 4 flops a sample
    a lag for the window energy and 8 a template sample a lag."""
    n_t, seg, D = T - L - P, L + 2 * half, 2 * half + 1
    return (n_t * 4 + K * A * seg * 8 + M * L * 8 + (L - P) * 4 + K * 25,
            K * A * ((L - P) * 8 + L * 3 + seg * 6 + D * L * 4 + D * M * L * 8))


def least_s(s: dict) -> float:
    """The least time of one call on an H100, in seconds."""
    (b1, o1), (b2, o2) = sync_work(**s), report_work(**s)
    return max((b1 + b2) / HBM_BYTES_S, (o1 + o2) / FP32_OPS_S)


def read(trace):
    s = trace.shape or {}
    dev_s = trace.profile.get("span_device_s", {}).get(SPAN)
    if not s.get("calls") or not dev_s:
        return None
    return 100.0 * s["calls"] * least_s(s) / dev_s
