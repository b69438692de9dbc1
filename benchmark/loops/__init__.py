"""Loops that drive the port: one module per kind of configuration.

A loop module gives:
  SPANS                  {"pkg.module.Class": span name} of the traced run
  setup(cell, seed, device) -> state   build, make the traffic, warm up
  attach(state, spans)   wrap what module hooks cannot reach
  window(state, seconds=None, units=None) -> {"unit_ms", "window_s", ...}
  end_to_end(state, win) -> {metric name: value}
  shape(state) -> the sizes the per-layer readers need
  check(state) -> (checks [(name, value, limit)], attempted, failed)
"""
