#!/usr/bin/env python3
"""The serving-tier phases of `chip_smoke.py` alone, on one card.

    python3 tools/torch_router_probe.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), serves GPT-3 1.3B bf16 with one in-process engine
(`phase_serve`, whose figures and streams `serve_router` is printed
beside), then runs `phase_serve_router` (the same traffic through a
Router over two worker processes) and `phase_router_drill` (the
`tools/torch_chaos_check.py --router --proc` drill at GPT-3 1.3B width in
float32); every gate as in `chip_smoke.py`.  Prints the phases' JSON
lines and the card's name and power limit.
"""
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_router_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    _, _, serve = cs.phase_serve()
    router = cs.phase_serve_router(serve)
    cs.phase_router_drill(router["spawn_to_ready_s"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
