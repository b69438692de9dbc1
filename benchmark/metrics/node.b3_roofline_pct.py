"""node.b3_roofline_pct: the resampler front end's share of its roofline,
in %: the least time an H100 needs for the compulsory bytes of the
profiled window's front-end steps (3.35 TB/s), over the device seconds of
the operations launched inside the `resample_rx` span (the history joined
to the step's samples, then the 9/10 FIR, B3). None where the loop hands
no front-end sizes or the profile holds no such span."""

HBM_BYTES_S = 3.35e12       # one H100's HBM, NVIDIA's data sheet (SXM)
SPAN = "resample_rx"


def step_bytes(A: int, chunk_in: int, H: int, L: int, W: int, n_out: int,
               **_) -> int:
    """Compulsory bytes of one step: the history and the step's complex64
    samples read once, the outputs written once (the history handed on is
    a view of the input), the float32 taps [L, W] read once."""
    return A * (H + chunk_in) * 8 + A * n_out * 8 + L * W * 4


def read(trace):
    s = trace.shape or {}
    dev_s = trace.profile.get("span_device_s", {}).get(SPAN)
    if not s.get("steps") or not dev_s:
        return None
    return 100.0 * s["steps"] * step_bytes(**s) / HBM_BYTES_S / dev_s
