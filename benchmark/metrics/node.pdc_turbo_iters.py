"""node.pdc_turbo_iters: turbo iterations a PDC decode call of the program
(its counters `fec.pdc_iters` / `fec.pdc_blocks`, each call of the decoder
in `pdc_decode_d`), over the traced run's window. None where the program
has no such counters or decoded nothing."""


def read(trace):
    c = trace.counts
    if not c.get("fec.pdc_blocks") or "fec.pdc_iters" not in c:
        return None
    return c["fec.pdc_iters"] / c["fec.pdc_blocks"]
