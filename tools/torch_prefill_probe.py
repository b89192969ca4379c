#!/usr/bin/env python3
"""Time the port's generation prefill and decode in a fresh process, with
the caching allocator's cudaMalloc count around each call.

    python3 tools/torch_prefill_probe.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Mistral-7B (full width and depth, bf16, random weights from seed 0),
batch 4, 512-token prompts, 64 new tokens: a dense forward, the first
`generate` (which captures the decode step), two more `generate` calls
(replays only), three standalone prefills of the built program, each
with its wall time and the number of cudaMalloc calls the allocator made
during it.  chip_smoke.py's `generate` phase runs after other phases in
one process; this gives the same calls in a process that ran nothing
else.  Prints one JSON line per call.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM  # noqa: E402


def timed(name, fn, n):
    for i in range(n):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["num_device_alloc"]
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        print(json.dumps({
            "call": name, "i": i, "ms": (time.perf_counter() - t0) * 1e3,
            "cuda_mallocs": torch.cuda.memory_stats()["num_device_alloc"]
            - before}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("torch_prefill_probe: no CUDA device", file=sys.stderr)
        return 1
    cfg = LlamaConfig.from_preset("mistral-7b")
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (4, 512), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    timed("dense forward", lambda: model(ids), 2)
    timed("generate, capturing", lambda: model.generate(
        ids, max_new_tokens=64), 1)
    timed("generate, replays", lambda: model.generate(
        ids, max_new_tokens=64), 2)
    prog = model._jit_decode_cache[(512, 64, False, 1.0, None, None, None, 4)]
    timed("prefill", lambda: prog.prefill(ids), 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
