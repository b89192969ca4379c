#!/usr/bin/env python3
"""The tensor functions and the training step's C10 check and profiler,
alone on one card.

    python3 tools/torch_tensor_api_probe.py [--no-train]

Builds the kernels (as `chip_smoke.py` does), then runs
`chip_smoke.py`'s `tensor_api` phase (every public function of the
port's tensor_api, linalg, fft and signal, card against CPU) and, unless
`--no-train`, its `train` phase (GPT-3 1.3B, seq 1024, batch 4, pure
bf16, Adafactor), whose `train_check_numerics` and `train_profile`
lines hold the `check_numerics` flag's cost a step, the poisoned step
and the port's `profiler.Profiler` against a bare torch.profiler
window.  Prints `chip_smoke.py`'s JSON lines, each phase's seconds and
the card's name and power limit.
"""
import sys
import time

import torch

sys.path.insert(0, ".")


def main():
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("torch_tensor_api_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.timed("build", cs.phase_build)
    cs.timed("tensor_api", cs.phase_tensor_api)
    if "--no-train" not in sys.argv[1:]:
        cs.timed("train", cs.phase_train)
    cs.emit({"phase": "phase_seconds", "seconds": cs.PHASE_SECONDS,
             "total_s": sum(cs.PHASE_SECONDS.values()),
             "at": time.strftime("%H:%M:%S")})
    print(cs.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
