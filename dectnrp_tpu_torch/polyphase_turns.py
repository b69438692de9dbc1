"""Time this tree's polyphase FIR kernel against an earlier one, in turns.

    python -m dectnrp_tpu_torch.polyphase_turns OTHER_CHECKOUT

Builds OTHER_CHECKOUT/dectnrp_tpu_torch/csrc/polyphase.cu into a library of
its own and calls it through its C entry of that form,
polyphase_fir(x, taps, y, rows, n_in, n_out, L, M, W, m0, stream) (no tap
ranges, no block count); this tree's kernel is called through its wrapper.
Both run at the polyphase shapes chip_smoke.py times (the wall step's 10/9
and 9/10 calls, 80/27 up and 27/80 down on 64 rows of the wall's lengths,
the runtime's RX chunk at 27/80 on 2 rows), on the same random inputs, in
the order other, this, this, other; each output is held to the plain twin
(rtol/atol 2e-5) and each kernel is timed by CUDA events around CUDA-graph
replays. Prints the card's name and power limit and one JSON line, also
written to chiprun_out/polyphase_turns.json. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

import torch

from . import kernels
from .kernels import graph_us
from .phy.ops import polyphase
from .phy.resampler import (ResamplerPlan, _design, build_resampler,
                            build_resampler_stream)

OUT = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out"


def other_library(checkout: pathlib.Path):
    lib = kernels.build_one(checkout / "dectnrp_tpu_torch" / "csrc" / "polyphase.cu",
                            "polyphase_other")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.polyphase_fir.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.polyphase_fir.restype = i
    return lib


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("polyphase_turns: no CUDA device")
    dev = torch.device("cuda", 0)
    card = kernels.card_name()
    print(card, flush=True)
    other = other_library(pathlib.Path(argv[0]).resolve())
    g = torch.Generator(device=dev).manual_seed(3)
    rt = build_resampler_stream(ResamplerPlan(27, 80), 512 * 80, device=dev)
    shapes = [("wall_up_10/9", ResamplerPlan(10, 9), (16, 4, 23040), None),
              ("wall_down_9/10", ResamplerPlan(9, 10), (16, 4, 85900), None),
              ("up_80/27", ResamplerPlan(80, 27), (64, 23040), None),
              ("down_27/80", ResamplerPlan(27, 80), (64, 85900), None),
              ("runtime_rx_27/80", ResamplerPlan(27, 80),
               (2, rt.H + rt.chunk_in), rt)]
    report = {"card": card, "order": ["other", "this", "this", "other"],
              "shapes": {}}
    for label, plan, shape, st in shapes:
        G, m0, W = _design(plan)
        L, M = plan.L, plan.M
        if st is None:
            n_out = build_resampler(plan, shape[-1], device="cpu").n_out
        else:
            m0, n_out = st.off, st.n_out
        taps = torch.as_tensor(G, device=dev)
        x = torch.randn(shape, dtype=torch.complex64, generator=g, device=dev)
        rows = x.numel() // shape[-1]
        want = polyphase.polyphase_fir_plain(x, taps, L, M, m0, n_out)
        y_other = torch.empty_like(want)

        def run_other():
            err = other.polyphase_fir(
                torch.view_as_real(x).data_ptr(), taps.data_ptr(),
                torch.view_as_real(y_other).data_ptr(), rows, shape[-1], n_out,
                L, M, W, m0, kernels.stream_ptr(dev))
            kernels.check(err, "other polyphase_fir")

        def run_this():
            return polyphase.polyphase_fir(x, taps, L, M, m0, n_out)

        run_other()
        got = run_this()
        torch.cuda.synchronize()
        for name, y in (("other", y_other), ("this", got)):
            if not torch.allclose(y, want, rtol=2e-5, atol=2e-5):
                raise SystemExit(f"polyphase_turns: {name} kernel vs plain twin "
                                 f"at {label}: max |err| "
                                 f"{(y - want).abs().max().item()}")
        times = [graph_us(run_other), graph_us(run_this), graph_us(run_this),
                 graph_us(run_other)]
        report["shapes"][label] = {"shape": list(shape), "us": times,
                                   "this_bit_equal_other":
                                   (got == y_other).float().mean().item()}
        print(f"{label} {list(shape)}: other {times[0]:.1f} / {times[3]:.1f} us, "
              f"this {times[1]:.1f} / {times[2]:.1f} us; this == other bit for "
              f"bit on {report['shapes'][label]['this_bit_equal_other']:.6f} of "
              "outputs", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "polyphase_turns.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
