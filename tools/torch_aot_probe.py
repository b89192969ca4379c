#!/usr/bin/env python3
"""What an AOTInductor serving program costs and buys on one card.

    python3 tools/torch_aot_probe.py [--no-worker]
    python3 tools/torch_aot_probe.py --eager-ab

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA sources (`chip_smoke.phase_build`), then for
GPT-3 1.3B in bf16 with `serve`'s engine (2,048 blocks of 16, 16 rows,
prefill chunk 512):

1. exports the engine's inventory (`serving.export_serving_artifacts`:
   decode and prefill buckets 32-512, the weights and the pools as
   inputs) and compiles the six programs at once in child processes,
   then prints each program's export and compile seconds, its bytes and
   their share of the weights;
2. loads the packages into the engine, prefills `serve`'s 16 prompts and
   holds one AOT decode step's logits against the eager step's on the
   same pool, then runs decode steps eagerly and through the package in
   turns: step p50 / p99 of each, the paged kernel's launches a step
   (one a layer), and a torch.profiler busy share of each;
3. splits a worker's start (`serving.worker`'s path: interpreter,
   imports, CUDA context, model build, probe forward, pool, first steps)
   in a fresh process, cold and, with the probe's packages, warm.

With `--eager-ab` it compiles nothing: it prefills `serve`'s 16 prompts
and times the eager decode step with the paged kernel called through its
wrapper (`ops.paged_attention`'s eager route) and through the operator
`paddle_tpu_torch::paged_decode` (the route a traced program takes), in
turns, with the paged kernel's launches a step and a profiler busy share
of each; then the host's microseconds a call of each route at the step's
shape (`calls` back-to-back calls, one synchronize at the end).

Prints one JSON line a part and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ENGINE = dict(num_blocks=2048, block_size=16, max_running=16,
              prefill_chunk=512)


def _model(device="cuda"):
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.from_preset("gpt3-1.3B", hidden_dropout=0.0,
                                attention_dropout=0.0)
    return GPTForCausalLM(
        cfg, device=device, dtype=torch.bfloat16,
        generator=torch.Generator(device=device).manual_seed(0)).eval()


def decode_turns(eng, prompts, layers, rounds=4, steps=5):
    """The 16 prompts prefilled, one AOT decode step's logits against the
    eager step's on the same inputs, then `rounds` turns of `steps`
    eager and `steps` AOT decode steps."""
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.serving.engine import _decode_fn

    loaded = dict(eng._aot_execs)
    reqs = [eng.add_request(p, max_new_tokens=2 * rounds * steps + 12)
            for p in prompts]
    while any(r.state == "waiting" or r.needs_prefill for r in reqs):
        eng.step()
    ready = [r for r in reqs if r.decode_ready and eng.scheduler.grow(r)]
    pos = np.asarray([r.ctx for r in ready], np.int32)
    table, pos_t = eng._inputs(eng._tables(ready, pos + 1), pos)
    tokens = torch.tensor([[r.feed_tokens()[r.ctx]] for r in ready],
                          device="cuda")
    args = (eng.pool.k, eng.pool.v, table, pos_t, tokens)
    with torch.no_grad():
        eager = _decode_fn(eng.model, *args)
    aot = loaded[("decode",)](eng._weights, *args)
    diff = float((aot - eager).abs().max())
    same_argmax = bool(torch.equal(aot.argmax(-1), eager.argmax(-1)))
    times = {"eager": [], "aot": []}
    launches = {"eager": 0, "aot": 0}
    for _ in range(rounds):
        for mode in ("eager", "aot"):
            eng._aot_execs.clear()
            if mode == "aot":
                eng._aot_execs.update(loaded)
            before = pd.paged_decode_attention.launches
            times[mode] += cs.step_ms(eng.step, steps)
            launches[mode] += pd.paged_decode_attention.launches - before
    prof = {}
    for mode in ("eager", "aot"):
        eng._aot_execs.clear()
        if mode == "aot":
            eng._aot_execs.update(loaded)
        prof[mode] = cs.busy(eng.step, 3, cs.pct(times[mode])["p50"])
    for r in reqs:
        eng.cancel(r)
    n = rounds * steps
    return {"rows": len(ready), "aot_vs_eager_logits_max_abs": diff,
            "argmax_equal": same_argmax,
            "eager_step_ms": cs.pct(times["eager"]),
            "aot_step_ms": cs.pct(times["aot"]),
            "paged_launches_per_step": {k: v / n for k, v in
                                        launches.items()},
            "layers": layers, "profile": prof,
            "leaks": eng.pool.check_leaks()}


def eager_ab(eng, prompts, layers, rounds=6, steps=5, calls=500):
    """`--eager-ab`: the eager decode step with the paged kernel called
    through its wrapper and through the operator, in `rounds` turns of
    `steps` steps each, then each route's host cost a call."""
    import chip_smoke as cs
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import paged_decode as pd

    wrapper = ops.paged_decode_attention

    def through_op(q, k, v, tables, lens, scale=None):
        return pd.paged_decode_op(q, k, v, tables, lens,
                                  pd._scale(scale, q.shape[-1]))

    routes = {"wrapper": wrapper, "operator": through_op}
    reqs = [eng.add_request(p, max_new_tokens=2 * rounds * steps + 40)
            for p in prompts]
    while any(r.state == "waiting" or r.needs_prefill for r in reqs):
        eng.step()
    times = {k: [] for k in routes}
    launches = dict.fromkeys(routes, 0)
    prof = {}
    try:
        for _ in range(rounds):
            for name, fn in routes.items():
                ops.paged_decode_attention = fn
                before = pd.paged_decode_attention.launches
                times[name] += cs.step_ms(eng.step, steps)
                launches[name] += pd.paged_decode_attention.launches - before
        for name, fn in routes.items():
            ops.paged_decode_attention = fn
            prof[name] = cs.busy(eng.step, 3, cs.pct(times[name])["p50"])
    finally:
        ops.paged_decode_attention = wrapper
    ready = [r for r in reqs if r.decode_ready]
    ctx = np.asarray([r.ctx for r in ready], np.int32)
    table, lens = eng._inputs(eng._tables(ready, ctx), ctx)
    cfg = eng.model.cfg
    q = torch.randn(len(ready), 1, cfg.num_heads,
                    cfg.hidden_size // cfg.num_heads, device="cuda",
                    dtype=eng.pool.k[0].dtype)
    host_us = {}
    for _ in range(2):
        for name, fn in routes.items():
            fn(q, eng.pool.k[0], eng.pool.v[0], table, lens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(q, eng.pool.k[0], eng.pool.v[0], table, lens)
            host_us.setdefault(name, []).append(
                (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    for r in reqs:
        eng.cancel(r)
    n = rounds * steps
    return {"rows": len(ready), "layers": layers,
            "step_ms": {k: cs.pct(v) for k, v in times.items()},
            "step_ms_all": times,
            "paged_launches_per_step": {k: v / n
                                        for k, v in launches.items()},
            "profile": prof, "host_us_per_call": host_us,
            "calls": calls, "leaks": eng.pool.check_leaks()}


def child_start(t_spawn, aot_dir):
    """A worker's start, part by part, in this fresh process."""
    t = {"interpreter": time.time() - t_spawn}
    t0 = time.perf_counter()
    from paddle_tpu_torch.serving import LLMEngine, load_serving_artifacts
    from paddle_tpu_torch.text import GPTForCausalLM  # noqa: F401
    t["imports"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t["cuda_context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = _model()
    torch.cuda.synchronize()
    t["model_build"] = time.perf_counter() - t0
    from tools import torch_chaos_check as tcc
    t0 = time.perf_counter()
    tcc.probe_digest(model)
    t["probe_forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = LLMEngine(model, **ENGINE)
    torch.cuda.synchronize()
    t["pool"] = time.perf_counter() - t0
    if aot_dir:
        t0 = time.perf_counter()
        n = len(load_serving_artifacts(eng, aot_dir, strict=True))
        t["aot_load"] = time.perf_counter() - t0
        t["aot_loaded"] = n
    t0 = time.perf_counter()
    eng.generate_batch([[1, 2, 3, 4]], max_new_tokens=2)
    torch.cuda.synchronize()
    t["first_steps"] = time.perf_counter() - t0
    t["total"] = time.time() - t_spawn
    print(json.dumps(t), flush=True)


def worker_split(aot_dir=None):
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, __file__, "--child-start", str(t0),
         "--aot-dir", aot_dir or ""], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def aot_parts(eng, prompts, layers, weight_bytes, no_worker):
    """Parts 1-3 of the module note."""
    import chip_smoke as cs
    from paddle_tpu_torch.serving import (export_serving_artifacts,
                                          load_serving_artifacts)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        programs = export_serving_artifacts(eng, tmp)["programs"]
        cs.emit({"part": "compile", "seconds": time.perf_counter() - t0,
                 "weight_bytes": weight_bytes,
                 "programs": {k: {f: v[f] for f in ("bytes", "export_s",
                                                     "compile_s")}
                              | {"weight_share": v["bytes"] / weight_bytes}
                              for k, v in programs.items()}})
        t0 = time.perf_counter()
        keys = load_serving_artifacts(eng, tmp, strict=True)
        load_s = time.perf_counter() - t0
        rec = decode_turns(eng, prompts, layers)
        cs.emit({"part": "decode", "load_s": load_s,
                 "loaded": [list(k) for k in keys], **rec})
        eng.close()
        del eng
        cs.release()
        if not no_worker:
            cs.emit({"part": "worker_start",
                     "cold": worker_split(),
                     "warm": worker_split(tmp)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-worker", action="store_true")
    ap.add_argument("--eager-ab", action="store_true")
    ap.add_argument("--child-start", type=float)
    ap.add_argument("--aot-dir", default="")
    a = ap.parse_args()
    if a.child_start is not None:
        return child_start(a.child_start, a.aot_dir)
    if not torch.cuda.is_available():
        print("torch_aot_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.serving import LLMEngine
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    cs.phase_build()
    model = _model()
    layers = model.cfg.num_layers
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    eng = LLMEngine(model, **ENGINE)
    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, size=16)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n) for n in plens]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)     # warm-up
    if a.eager_ab:
        cs.emit({"part": "eager_ab", **eager_ab(eng, prompts, layers)})
        eng.close()
    else:
        aot_parts(eng, prompts, layers, weight_bytes, a.no_worker)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
