#!/usr/bin/env python3
"""The GPT-MoE phases of `chip_smoke.py` alone, on one card.

    python3 tools/torch_moe_probe.py [PHASE ...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), then runs the named phases of `chip_smoke.py`, every gate
as there: moe_train, moe_generate, moe_serve, moe_e2e (all four when
none is named).  Prints each phase's JSON line and the card's name and
power limit.
"""
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PHASES = {"moe_train": cs.phase_moe_train,
          "moe_generate": cs.phase_moe_generate,
          "moe_serve": cs.phase_moe_serve, "moe_e2e": cs.phase_moe_e2e}


def main(names):
    if not torch.cuda.is_available():
        print("torch_moe_probe: no CUDA device", file=sys.stderr)
        return 1
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        print(f"torch_moe_probe: unknown phases {unknown}", file=sys.stderr)
        return 2
    cs.phase_build()
    for name in names or PHASES:
        PHASES[name]()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
