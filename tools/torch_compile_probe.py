#!/usr/bin/env python3
"""The compile-path phases of `chip_smoke.py` alone, on one card.

    python3 tools/torch_compile_probe.py [--only PHASE] [--layers N]
                                         [--broken]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), then runs to_static_train (GPT-3 1.3B at full width
through `jit.to_static`, `--layers` of its 24, default
`chip_smoke.TO_STATIC_LAYERS`), dy2static and static_graph, every gate
as in `chip_smoke.py`, and prints each one's wall seconds; `--only
to_static_train` (or dy2static, static_graph) runs that one alone.
`--broken` then runs to_static_train twice more with its compiled step
broken, each of which the phase's gates must refuse: the compiled
model's optimizer step skipped (a model that does not learn), and dQ
zeroed after its kernel in the compiled steps (a gradient left out); it
exits 1 if a broken step passes.  Ends with the card's name and power limit.
"""
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(args):
    if not torch.cuda.is_available():
        print("torch_compile_probe: no CUDA device", file=sys.stderr)
        return 1
    layers = int(args[args.index("--layers") + 1]) if "--layers" in args \
        else cs.TO_STATIC_LAYERS
    cs.phase_build()
    phases = [("to_static_train",
               lambda: cs.phase_to_static_train(layers=layers)),
              ("dy2static", cs.phase_dy2static),
              ("static_graph", cs.phase_static_graph)]
    if "--only" in args:
        only = args[args.index("--only") + 1]
        phases = [p for p in phases if p[0] == only]
    seconds = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        cs.release()
    passed = broken_steps(layers) if "--broken" in args else []
    cs.emit({"phase": "compile_probe_seconds", "seconds": seconds})
    print(cs.card_name_power(), flush=True)
    return 1 if passed else 0


def broken_steps(layers):
    """to_static_train with its compiled step broken two ways; the eager
    copy, which runs after the compiled steps, stays sound.  Prints which
    gate refused each -> the names of those that passed."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adafactor

    made, dq_calls = [], []
    init, step, dq = Adafactor.__init__, Adafactor.step, \
        fa.flash_bwd_dq_cuda
    steps, warmup = 10, 3
    compiled_calls = layers * (warmup + steps)

    def track(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def frozen(self, *a, **k):
        # the first Adafactor made is the compiled model's
        return None if self is made[0] else step(self, *a, **k)

    def dq_zero(*a, **k):
        # the first layers x steps backward calls are the compiled run's
        dq_calls.append(1)
        out = dq(*a, **k)
        return torch.zeros_like(out) if len(dq_calls) <= compiled_calls \
            else out

    broken = {
        "frozen_step": [mock.patch.object(Adafactor, "__init__", track),
                        mock.patch.object(Adafactor, "step", frozen)],
        "dq_zero": [mock.patch.object(fa, "flash_bwd_dq_cuda", dq_zero)],
    }
    passed = []
    for name, patches in broken.items():
        made.clear()
        dq_calls.clear()
        refused = None
        try:
            for p in patches:
                p.start()
            cs.phase_to_static_train(layers=layers, steps=steps,
                                     warmup=warmup)
        except AssertionError as e:
            refused = str(e)[:300]
        finally:
            for p in patches:
                p.stop()
            cs.release()
        cs.emit({"phase": "broken_step", "broken": name,
                 "refused_by": refused})
        if refused is None:
            passed.append(name)
    return passed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
