#!/usr/bin/env python3
"""The high-level API phases of `chip_smoke.py` alone, on one card.

    python3 tools/torch_hapi_probe.py [--baselines] [--only PHASE]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), then runs hapi_bert and hapi_resnet, every gate as in
`chip_smoke.py`, and prints each one's wall seconds.  `--baselines`
runs the bert and resnet phases first, so that the two print their
step p50 and images/s beside the high-level API's (and hapi_resnet
finds cuDNN's autotuning done); `--only hapi_bert` (or hapi_resnet)
runs that one alone.  Ends with the card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(args):
    if not torch.cuda.is_available():
        print("torch_hapi_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    seconds = {}
    phases = [("hapi_bert", cs.phase_hapi_bert),
              ("hapi_resnet", cs.phase_hapi_resnet)]
    if "--only" in args:
        only = args[args.index("--only") + 1]
        phases = [p for p in phases if p[0] == only]
    if "--baselines" in args:
        phases = [("bert", cs.phase_bert), ("resnet", cs.phase_resnet)] \
            + phases
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        cs.release()
    cs.emit({"phase": "hapi_probe_seconds", "seconds": seconds})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
