#!/usr/bin/env python3
"""The persistent compile cache's phases of `chip_smoke.py`
(`to_static_train` publishing to a store, then `compile_cache`, its
restart in a fresh interpreter) alone, on one card.

    python3 tools/torch_cache_probe.py [--cold-start]
    python3 tools/torch_cache_probe.py --ab N

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources into `build/kernels/` (`chip_smoke.
phase_build`), runs `chip_smoke.phase_to_static_train` with the store in
a temporary directory and `chip_smoke.phase_compile_cache` on it, every
gate as in `chip_smoke.py`, and prints their JSON lines, each phase's
wall seconds and the card's name and power limit.  `--cold-start` then
runs `tools/torch_chaos_check.py --cold-start` on the card.

`--ab N` instead times what the store costs a cold compile: N pairs of
fresh processes, each with empty Inductor and Triton caches, compile
to_static_train's model (first step, Dynamo's share, the backend's)
without a store and with an empty one (which compiles the backward with
the forward, then publishes), in turns (none, store, store, none, ...).
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def cold_child(store):
    """One process of --ab: to_static_train's model compiled on `store`
    ("none": no store), 3 steps; prints the first step's wall and the
    compile split as JSON."""
    from torch._dynamo.utils import compilation_time_metrics, counters
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.jit import compile_cache as cc
    from paddle_tpu_torch.text import gpt_loss_fn
    model, _, ids, labels = cs.to_static_gpt(cs.TO_STATIC_LAYERS, 4, 1024)
    model, opt = cs.bf16_adafactor(model)
    cc.configure(None if store == "none" else store)
    st = jit.to_static(model)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = gpt_loss_fn(st, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        loss.item()
        walls.append(time.perf_counter() - t0)

    def took(name):
        return sum(compilation_time_metrics.get(name, []))

    print(json.dumps({
        "store": store != "none", "first_step_s": walls[0],
        "compile_s": walls[0] - walls[-1],
        "dynamo_s": took("_compile.compile_inner")
        - took("OutputGraph.call_user_compiler"),
        "backend_s": took("OutputGraph.call_user_compiler"),
        "fxgraph_cache_miss": counters["inductor"]["fxgraph_cache_miss"],
        "store_stats": cc.stats()}), flush=True)
    return 0


def ab(pairs):
    """--ab: the cold compile without and with the store, in turns."""
    import os
    runs = []
    for i in range(pairs):
        for store in (("none", "store") if i % 2 == 0 else
                      ("store", "none")):
            with tempfile.TemporaryDirectory(prefix="ab_") as tmp:
                env = dict(os.environ,
                           TORCHINDUCTOR_CACHE_DIR=os.path.join(tmp, "i"),
                           TRITON_CACHE_DIR=os.path.join(tmp, "t"))
                arg = "none" if store == "none" else os.path.join(tmp, "s")
                out = subprocess.run(
                    [sys.executable, __file__, "--ab-child", arg], env=env,
                    capture_output=True, text=True, timeout=900)
                assert out.returncode == 0, out.stderr[-3000:]
                runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
                print(json.dumps(runs[-1]), flush=True)
    for flag in (False, True):
        xs = sorted(r["compile_s"] for r in runs if r["store"] is flag)
        print(json.dumps({"store": flag, "compile_s": xs}), flush=True)


def main():
    if sys.argv[1:2] == ["--ab-child"]:
        return cold_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("torch_cache_probe: no CUDA device", file=sys.stderr)
        return 1
    seconds = {}
    t0 = time.perf_counter()
    cs.phase_build()
    seconds["build"] = time.perf_counter() - t0
    if sys.argv[1:2] == ["--ab"]:
        ab(int(sys.argv[2]))
        print(cs.card_name_power(), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="compile_store_") as store:
        t0 = time.perf_counter()
        _, cold = cs.phase_to_static_train(store=store)
        seconds["to_static_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.phase_compile_cache(store, cold)
        seconds["compile_cache"] = time.perf_counter() - t0
    if "--cold-start" in sys.argv[1:]:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "torch_chaos_check.py"),
                        "--cold-start", "--device", "cuda"], check=True)
        seconds["cold_start_drill"] = time.perf_counter() - t0
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(cs.card_name_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
