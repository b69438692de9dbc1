"""node.dbuf_slide_mb: MB a tick that the program's DECT-rate buffers move
when they slide to take a front-end step's samples (its counter
`runtime.dbuf_slide_bytes`), over the traced run's window. None where the
program has no such counter."""

KEY = "runtime.dbuf_slide_bytes"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / 1e6 / trace.units
