#!/usr/bin/env python3
"""The Transformer-base MT phases of `chip_smoke.py` alone, on one card.

    python3 tools/torch_mt_probe.py [--cuts [PHASE ...]]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), then runs mt_train, mt_generate and mt_e2e, every gate as
in `chip_smoke.py`, and prints each one's wall seconds.  `--cuts` then
runs each named phase (all four when none is named: weight_only, lora,
generate, router_drill) at its model's full depth and at the depth the
whole script runs it at (`chip_smoke.WEIGHT_ONLY_LAYERS`, `LORA_LAYERS`,
`GENERATE_LAYERS`, `ROUTER_DRILL_LAYERS`), one after the other, and
prints each run's seconds: what the cut gives back.  Ends with the
card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def seconds(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


# phase: (function, full depth, the script's depth, extra arguments);
# router_drill's spawn grace is its floor, 120 s
CUTS = {"weight_only": (cs.phase_weight_only, 32, cs.WEIGHT_ONLY_LAYERS, ()),
        "lora": (cs.phase_lora, 32, cs.LORA_LAYERS, ()),
        "generate": (cs.phase_generate, 32, cs.GENERATE_LAYERS, ()),
        "router_drill": (cs.phase_router_drill, 24, cs.ROUTER_DRILL_LAYERS,
                         (0.0,))}


def main(args):
    if not torch.cuda.is_available():
        print("torch_mt_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    rec = {}
    (_, model, src), rec["mt_train"] = seconds(cs.phase_mt_train)
    _, rec["mt_generate"] = seconds(cs.phase_mt_generate, model, src)
    del model, src
    cs.release()
    _, rec["mt_e2e"] = seconds(cs.phase_mt_e2e)
    cs.emit({"phase": "mt_probe_seconds", "seconds": rec})
    if "--cuts" in args:
        names = args[args.index("--cuts") + 1:] or list(CUTS)
        turns = []
        for name in names:
            fn, full, cut, extra = CUTS[name]
            for layers in (None, cut):
                _, s = seconds(fn, *extra, layers=layers)
                turns.append([name, layers or full, s])
                cs.release()
        cs.emit({"phase": "cut_seconds", "turns": turns})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
