#!/usr/bin/env python3
"""The vision and quantization phases of `chip_smoke.py` alone, on one
card.

    python3 tools/torch_vision_probe.py [--only PHASE ...] [--card-tests]

Run from the root of a checkout on a machine with a CUDA card.  It runs
mobilenet_train, vision_e2e, vision_ops and quantization (none of them
launches a kernel of `paddle_tpu_torch/csrc/`, so nothing is built),
every gate as in `chip_smoke.py`, and prints each one's wall seconds;
`--only` names the phases to run.  `--card-tests` then runs the
`cuda`-marked test of a guarded pure-bf16 step
(`tests/test_torch_guard_bf16.py`, without the JAX conftest).  Ends with
the card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PHASES = {"mobilenet_train": cs.phase_mobilenet_train,
          "vision_e2e": cs.phase_vision_e2e,
          "vision_ops": cs.phase_vision_ops,
          "quantization": cs.phase_quantization}


def main(args):
    if not torch.cuda.is_available():
        print("torch_vision_probe: no CUDA device", file=sys.stderr)
        return 1
    names = list(PHASES)
    if "--only" in args:
        names = [a for a in args[args.index("--only") + 1:]
                 if not a.startswith("--")]
    seconds, failed = {}, []
    for name in names:
        t0 = time.perf_counter()
        try:
            PHASES[name]()
        except Exception as e:          # report every phase, then fail
            failed.append(name)
            print(f"{name} FAILED: {type(e).__name__}: {e}", flush=True)
        seconds[name] = time.perf_counter() - t0
        cs.release()
    rc = 0
    if "--card-tests" in args:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m",
             "cuda", "-p", "no:cacheprovider",
             str(ROOT / "tests" / "test_torch_guard_bf16.py")],
            cwd=ROOT).returncode
    cs.emit({"phase": "vision_probe_seconds", "seconds": seconds,
             "failed": failed, "card_tests_rc": rc})
    print(cs.card_name_power(), flush=True)
    return 1 if failed or rc else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
