#!/usr/bin/env python3
"""The training-state phase of `chip_smoke.py` (`bert_resume`) alone, on
one card.

    python3 tools/torch_resume_probe.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), then runs `chip_smoke.phase_bert_resume`: BERT-base under
AMP O1 resumed from a checkpoint (float16 with a GradScaler), guarded
with a rollback (bfloat16 through TrainStep), restored past torn
checkpoints, and the eleven optimizers the port added held card against
CPU; every gate as in `chip_smoke.py`.  The float32 step it is printed
beside is `chip_smoke.py`'s `bert_fp32_train`, which this probe does not
run ("bert_fp32_train_*" print as null).  Prints the phase's JSON line and
the card's name and power limit.
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
        print("torch_resume_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    cs.phase_bert_resume(None, None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
