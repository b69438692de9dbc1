"""Time this tree's bf16 BCJR kernel against an earlier one, in turns.

    python -m dectnrp_tpu_torch.bcjr_bf16_turns OTHER_CHECKOUT

Builds OTHER_CHECKOUT/dectnrp_tpu_torch/csrc/bcjr_bf16.cu into a library of
its own and calls both kernels through the same C entry,
bcjr_posterior_cm_bf16(lsys, lp, post, K, B, Lw, D, stream), at window 128
and D = 32, at every shape the kernel is timed at (`SHAPES`: the flagship's
two decodes, 64 codeblocks at four K, the FEC oracle's ten
first-transmission decodes of 50 codeblocks; chip_smoke and the card tests
take them from here), on the same random inputs, in
the order other, this, this, other. Each output is held to the plain twin
bit for bit; each call is timed by CUDA events around CUDA-graph replays.
Also counts the SASS instructions of each tree's bcjr_bf16_kernel by opcode
(`cuobjdump -sass` on the built libraries; static counts, the loops
unrolled by chunk). Prints the card's name and power limit and one JSON
line, also written to chiprun_out/bcjr_bf16_turns.json. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
from collections import Counter

import torch

from . import fec_awgn, kernels
from .kernels import graph_us
from .phy.fec import bcjr_cuda

OUT = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out"
# (K, codeblocks) at which the kernel is checked and timed (window 128,
# D = 32): the flagship's PDC decodes (16 codeblocks a packet, 13 of
# K = 6016 and 3 of 6080, B = 64 streams), 64 codeblocks at the K of both
# steps and the oracle's largest, and the FEC oracle's first-transmission
# decodes of 50 packets at MCS 0-9
SHAPES = ([(6016, 832), (6080, 192)] + [(K, 64) for K in (1056, 5632, 6016, 6080)]
          + [(fec_awgn.codeblock_K(mcs), 50) for mcs in range(10)])


def other_library(checkout: pathlib.Path):
    lib = kernels.build_one(checkout / "dectnrp_tpu_torch" / "csrc" / "bcjr_bf16.cu",
                            "bcjr_bf16_other")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bcjr_posterior_cm_bf16.argtypes = [p, p, p, i, i, i, i, p]
    lib.bcjr_posterior_cm_bf16.restype = i
    return lib


def sass_counts(lib) -> dict:
    """{opcode: count} of bcjr_bf16_kernel's SASS in a loaded library, with
    "total"; opcode modifiers dropped (HFMA2.BF16_V2 counts as HFMA2)."""
    tool = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f.split("\n", 1)[0].find("bcjr_bf16_kernel") >= 0)
    ops = Counter(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9]*)",
                             body))
    return {"total": sum(ops.values()), **dict(ops.most_common())}


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("bcjr_bf16_turns: no CUDA device")
    dev = torch.device("cuda", 0)
    card = kernels.card_name()
    print(card, flush=True)
    libs = {"other": other_library(pathlib.Path(argv[0]).resolve()),
            "this": kernels.load()}
    g = torch.Generator(device=dev).manual_seed(4)
    report = {"card": card, "order": ["other", "this", "this", "other"],
              "window": [128, 32],
              "sass": {name: sass_counts(lib) for name, lib in libs.items()},
              "shapes": {}}
    for name, ops in report["sass"].items():
        print(f"{name} bcjr_bf16_kernel SASS: " + ", ".join(
            f"{k} {v}" for k, v in list(ops.items())[:16]), flush=True)
    for K, B in SHAPES:
        Lsys = torch.randn((K + 3, B), generator=g, device=dev) * 3
        Lp = torch.randn((K + 3, B), generator=g, device=dev) * 3
        want = bcjr_cuda.bcjr_windowed_cm_bf16_plain(Lsys, Lp, K)
        outs = {name: torch.empty_like(want) for name in libs}

        def call(name):
            err = libs[name].bcjr_posterior_cm_bf16(
                Lsys.data_ptr(), Lp.data_ptr(), outs[name].data_ptr(), K, B, 128,
                32, kernels.stream_ptr(dev))
            kernels.check(err, f"{name} bcjr_posterior_cm_bf16")

        for name in libs:
            call(name)
        torch.cuda.synchronize()
        for name, y in outs.items():
            if not torch.equal(y, want):
                raise SystemExit(f"bcjr_bf16_turns: {name} kernel vs plain twin at "
                                 f"K={K} x {B}: max |err| "
                                 f"{(y - want).abs().max().item()}")
        times = [graph_us(lambda: call(name)) for name in report["order"]]
        report["shapes"][f"K{K}_{B}cb"] = {"us": times}
        print(f"K={K} x {B}: other {times[0]:.1f} / {times[3]:.1f} us, this "
              f"{times[1]:.1f} / {times[2]:.1f} us; both == plain twin bit for bit",
              flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "bcjr_bf16_turns.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
