"""The scenario loop (loops/scenario.py, imported, not edited) on radios
off the DECT rate, where every node's runtime resamples what its radio
receives to the DECT rate (`ResamplerStream`, the front end) and every
burst it sends back to the radio's rate (`Resampler`).

Beside everything the scenario loop keeps and checks, this loop keeps:
- a sample of the window's front-end steps (`rs_rx`) and TX resampler
  calls (`rs_tx`), drawn from the seed by forward hooks on the port's two
  resampler classes, which `reference/resampler.py` re-runs on the same
  input (`rs_rx_gap`, `rs_tx_gap`); each kind has to be seen `sample` times
  (`rs_rx_calls_missing`, `rs_tx_calls_missing`);
- a chain: the first CHAIN front-end steps of one node (drawn from the
  seed) in the first window, which the reference re-runs as one stream
  from the first step's history over the samples of the node's RX ring
  that the steps cover (`rs_rx_chain_gap`; a step missing from the chain
  counts in `rs_rx_calls_missing`);
- `tx_late`: bursts any node scheduled behind its radio's write head (the
  radio loses their head), from the start of the run to the end of the
  drain. Set-up stops with an error on the first: a program that cannot
  send on time cannot be measured here.

A traced run adds the spans `resample_rx` and `resample_tx` around the two
classes' calls, and `shape()` hands the readers the front end's sizes and
the number of its steps in the last window, which is the profiled one when
the readers read.
"""
from __future__ import annotations

import torch

from . import scenario as base
from ..reference.resampler import ResamplerReference

SPANS = {**base.SPANS,
         "dectnrp_tpu_torch.phy.resampler.ResamplerStream": "resample_rx",
         "dectnrp_tpu_torch.phy.resampler.Resampler": "resample_tx"}
#: consecutive front-end steps of one node in the chain
CHAIN = 8
#: this loop's checks; every other limit is the scenario loop's
OWN = ("rs_rx_gap", "rs_tx_gap", "rs_rx_chain_gap", "rs_rx_calls_missing",
       "rs_tx_calls_missing", "tx_late")
KINDS = {"ResamplerStream": "rs_rx", "Resampler": "rs_tx"}

attach, end_to_end = base.attach, base.end_to_end


def _keep(state, kind: str, rec) -> None:
    """A reservoir sample of the window's calls of `kind` (as the
    scenario loop keeps its own)."""
    state.rs_seen[kind] += 1
    kept = state.rs_kept[kind]
    if len(kept) < state.sample:
        kept.append(rec())
    else:
        i = state.rng.randrange(state.rs_seen[kind])
        if i < state.sample:
            kept[i] = rec()


def _catch(state) -> None:
    def hook(module, args, out):
        t = type(module)
        kind = KINDS.get(t.__qualname__) if state.recording and \
            t.__module__.startswith("dectnrp_tpu_torch.") else None
        if kind is not None:
            _keep(state, kind, lambda: (module, args, out))
    state.hooks.append(torch.nn.modules.module.register_module_forward_hook(hook))


def _front_end(state, i: int, rt) -> None:
    """Node i's front-end step, wrapped to count the window's steps and to
    keep the chain (the step itself is still a module call)."""
    step = rt._rx_step

    def wrapped(x, hist):
        t0 = rt._hw_consumed
        y, h = step(x, hist)
        if state.recording:
            state.fe_steps += 1
            c = state.chain
            if c["node"] == i and c["x"] is None:
                if not c["y"]:
                    c.update(t0=t0, hist=hist.clone(), plan=step.plan,
                             chunk_in=step.chunk_in)
                c["y"].append(y.clone())
                if len(c["y"]) == CHAIN:
                    c["x"] = rt.hw.get_rx_stream(c["t0"],
                                                 CHAIN * c["chunk_in"]).copy()
        return y, h
    rt._rx_step = wrapped


def setup(cell, seed: int, device):
    state = base.setup(cell, seed, device)
    late = sum(rt.stats.tx_late for rt in state.sc.runtimes)
    if late:
        raise RuntimeError(f"set-up: {late} burst(s) scheduled behind the "
                           "radio's write head")
    rts = state.sc.runtimes
    if any(rt.plan_tx.identity for rt in rts):
        raise RuntimeError("set-up: a radio runs at the DECT rate; this loop "
                           "measures the resampler front end")
    state.rs_kept = {k: [] for k in KINDS.values()}
    state.rs_seen = {k: 0 for k in KINDS.values()}
    state.chain = {"node": state.rng.randrange(len(rts)), "y": [], "x": None}
    state.fe_steps = 0
    step = rts[0]._rx_step
    state.fe_shape = {"A": rts[0].hw.n_ant, "chunk_in": step.chunk_in,
                      "H": step.H, "L": step.plan.L, "M": step.plan.M,
                      "W": int(step.G.shape[1]), "n_out": step.n_out,
                      "steps": 0}
    for i, rt in enumerate(rts):
        _front_end(state, i, rt)
    _catch(state)
    return state


def window(state, seconds: float | None = None, units: int | None = None) -> dict:
    state.fe_steps = 0
    out = base.window(state, seconds=seconds, units=units)
    state.fe_shape["steps"] = state.fe_steps
    return out


def shape(state) -> dict:
    """The front end's sizes and its steps in the last window: the dict
    is the loop's own, so a reader reads the window run after this call."""
    return state.fe_shape


def _found(state, against=None) -> dict:
    ref = ResamplerReference(state.device)
    return ref.compare(state.rs_kept["rs_rx"], state.rs_kept["rs_tx"],
                       state.chain, against=against)


def check(state) -> tuple[list, int, int]:
    cfg = state.cell.config
    rts = state.sc.runtimes
    state.cell.config = dict(cfg, limits={k: v for k, v in cfg["limits"].items()
                                          if k not in OWN})
    try:
        _, attempted, failed = base.check(state)
    finally:
        state.cell.config = cfg
    found = _found(state)
    found["tx_late"] = sum(rt.stats.tx_late for rt in rts)
    chain_missing = CHAIN - len(state.chain["y"])
    for kind in KINDS.values():
        found[f"{kind}_calls_missing"] = max(0, state.sample
                                             - state.rs_seen[kind])
    found["rs_rx_calls_missing"] += chain_missing
    state.readings.update(found)
    return [(k, state.readings[k], v) for k, v in cfg["limits"].items()], \
        attempted, failed


def control(state) -> dict:
    """The scenario loop's control, and the resampler reference in bf16 put
    in the program's place on the kept calls and the chain."""
    out = base.control(state)
    out.update(_found(state, against=ResamplerReference(state.device,
                                                        "bfloat16")))
    return out
