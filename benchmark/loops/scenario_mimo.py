"""The scenario loop (loops/scenario.py, imported, not edited) on radios of
several antennas at a wide band, whose nodes send transmit-diversity
packets: every PDC's channel estimates [1, N_RX, N_TX, 4] go through the
runtime's codebook search (`upper.runtime.mimo_search`) on a codebook of
more than one matrix.

Beside everything the scenario loop keeps and checks, this loop keeps:
- a reservoir sample of the window's codebook searches, drawn from the
  seed and caught by wrapping the runtime module's `mimo_search` (each
  call's cells and output), which `reference/mimo.py` re-runs on the same
  cells (`cb_index_differ`, `cb_metric_gap`; `cb_index_ties` is read, not
  limited); the search has to be seen `sample` times (`cb_calls_missing`):
  a search that does not go through the module attribute fails;
- `tx_late`: bursts any node scheduled behind its radio's write head, from
  the start of the run to the end of the drain. Set-up stops with an error
  on the first: a program that cannot send on time cannot be measured here.

`shape()` hands the readers the sync chunk's sizes (antennas A, samples T,
peaks K, u, b and the module's P, L, half, M) and the number of `Sync`
calls in the last window, which is the profiled one when the readers read.
"""
from __future__ import annotations

from . import scenario as base
from ..reference.mimo import MimoReference

SPANS = base.SPANS
#: this loop's checks; every other limit is the scenario loop's
OWN = ("cb_index_differ", "cb_metric_gap", "cb_calls_missing", "tx_late")

attach, end_to_end = base.attach, base.end_to_end


def _keep(state, rec) -> None:
    """A reservoir sample of the window's searches (as the scenario loop
    keeps its own calls)."""
    state.cb_seen += 1
    if len(state.cb_kept) < state.sample:
        state.cb_kept.append(rec())
    else:
        i = state.rng.randrange(state.cb_seen)
        if i < state.sample:
            state.cb_kept[i] = rec()


def _catch(state) -> None:
    import dectnrp_tpu_torch.upper.runtime as R

    search = R.mimo_search

    def wrapped(cells, *a, **kw):
        out = search(cells, *a, **kw)
        if state.recording:
            _keep(state, lambda: ((cells.clone(), *a), dict(kw), None
                                  if out is None else tuple(x.clone()
                                                            for x in out)))
        return out
    R.mimo_search = wrapped
    state.cb_restore = (R, search)


def _release(state) -> None:
    R, search = state.cb_restore
    R.mimo_search = search


def setup(cell, seed: int, device):
    state = base.setup(cell, seed, device)
    late = sum(rt.stats.tx_late for rt in state.sc.runtimes)
    if late:
        raise RuntimeError(f"set-up: {late} burst(s) scheduled behind the "
                           "radio's write head")
    rt = state.sc.runtimes[0]
    s = rt._sync
    state.sync_shape = {"A": rt.hw.n_ant, "T": s.T, "K": s.max_peaks,
                        "u": rt.u, "b": rt.b, "P": s.P, "L": s.L,
                        "half": s.half, "M": int(s.tconj.shape[1]),
                        "calls": 0}
    state.cb_kept, state.cb_seen = [], 0
    _catch(state)
    return state


def window(state, seconds: float | None = None, units: int | None = None) -> dict:
    n0 = state.seen["sync"]
    out = base.window(state, seconds=seconds, units=units)
    state.sync_shape["calls"] = state.seen["sync"] - n0
    return out


def shape(state) -> dict:
    """The sync chunk's sizes and the Sync calls of the last window: the
    dict is the loop's own, so a reader reads the window run after this
    call."""
    return state.sync_shape


def check(state) -> tuple[list, int, int]:
    cfg = state.cell.config
    rts = state.sc.runtimes
    state.cell.config = dict(cfg, limits={k: v for k, v in cfg["limits"].items()
                                          if k not in OWN})
    try:
        _, attempted, failed = base.check(state)
    finally:
        state.cell.config = cfg
        _release(state)
    found = MimoReference(state.device).compare(state.cb_kept)
    found["cb_calls_missing"] = max(0, state.sample - state.cb_seen)
    found["tx_late"] = sum(rt.stats.tx_late for rt in rts)
    state.readings.update(found)
    return [(k, state.readings[k], v) for k, v in cfg["limits"].items()], \
        attempted, failed


def control(state) -> dict:
    """The scenario loop's control, and the codebook reference in bf16 put
    in the program's place on the kept searches."""
    out = base.control(state)
    _release(state)
    out.update(MimoReference(state.device).compare(
        state.cb_kept, against=MimoReference(state.device, "bfloat16")))
    return out
