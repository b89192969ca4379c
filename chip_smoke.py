#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from `paddle_tpu_torch/csrc/` into
`build/kernels/`, then:

1. build      — times the nvcc build (one nvcc per source, in parallel);
2. kernels    — holds each kernel against its plain PyTorch version on the
                card at the serving path's shapes, with stated tolerances;
3. serve      — GPT-3 1.3B (full width, 24 layers, bf16, random weights
                from a seed) served by LLMEngine: 16 requests, 32 greedy
                tokens each; every request must finish, the pool must be
                leak-free, and the paged kernel must have launched once
                per layer per decode step; then a profile of a few
                steady decode steps (device time by kernel);
4. e2e        — the same width at 2 layers in float32: the engine's tokens
                are checked against a dense teacher-forced forward of the
                same weights on the CPU;
5. timings    — kernel, plain version, library yardstick and the memory
                bound at the phase-3 decode shapes.

Each phase prints one JSON line.  Then one {"kernels": [...]} line, the
card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}.  Any failure raises and exits nonzero
before the last line; without a CUDA device it exits 1 at once.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain: both accumulate in float32 in another order, then round
# once to the working type (2 units in the last place of a bfloat16 or
# float16 output; a few float32 roundings otherwise)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-3),
       torch.float16: (2e-3, 1e-4)}


def emit(rec):
    print(json.dumps(rec), flush=True)


def paged_inputs(lens, H, Hkv, D, bs, dtype, seed):
    """Random q and pools on the card; each row's blocks are distinct
    random ids, table columns past a row's length are block 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(lens)
    need = [-(-n // bs) for n in lens]
    M, N = max(max(need), 1), sum(need) + 1
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    ids = (torch.randperm(N - 1, generator=g, device="cuda") + 1).tolist()
    tables = torch.zeros(B, M, dtype=torch.int32)
    at = 0
    for b, c in enumerate(need):
        tables[b, :c] = torch.tensor(ids[at:at + c], dtype=torch.int32)
        at += c
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.cuda(), lens_t


def compare(pd, args, dtype):
    out = pd.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pd.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    rtol, atol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    return float(diff.max()), not bool(bad.any())


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    regs = [int(line.split("Used ")[1].split()[0])
            for log in logs.values() for line in log.splitlines()
            if "registers" in line and "Used " in line]
    spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                 for log in logs.values() for line in log.splitlines()
                 if "bytes spill stores" in line)
    emit({"phase": "build", "seconds": secs, "sources": _build.sources(),
          "compiled": sorted(logs), "kernels_compiled": len(regs),
          "max_registers": max(regs, default=None),
          "spill_store_bytes": spills})


def phase_kernels():
    from paddle_tpu_torch.ops import paged_decode as pd
    ragged = [1, 16, 17, 33, 100, 255, 256, 257, 500, 640, 777, 800, 900,
              1000, 1024, 1056]
    cases = [  # name, lens, H, Hkv, D, bs, dtype
        ("mha_d128_bf16", ragged, 16, 16, 128, 16, torch.bfloat16),
        ("mha_d128_fp32", ragged, 16, 16, 128, 16, torch.float32),
        ("mha_d128_fp16", ragged, 16, 16, 128, 16, torch.float16),
        ("gqa_h16_hkv4_bf16", [0] + ragged[1:], 16, 4, 128, 16,
         torch.bfloat16),
        ("d64_bf16", ragged, 16, 16, 64, 16, torch.bfloat16),
    ]
    results = []
    for i, (name, lens, H, Hkv, D, bs, dtype) in enumerate(cases):
        args = paged_inputs(lens, H, Hkv, D, bs, dtype, seed=100 + i)
        err, ok = compare(pd, args, dtype)
        rtol, atol = TOL[dtype]
        results.append({"case": name, "max_abs_err": err, "rtol": rtol,
                        "atol": atol, "ok": ok})
    emit({"phase": "kernels", "kernel": "paged_decode_attention",
          "cases": results})
    failed = [r["case"] for r in results if not r["ok"]]
    assert not failed, f"kernel disagrees with its plain version: {failed}"


def phase_serve():
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.from_preset("gpt3-1.3B", hidden_dropout=0.0,
                                attention_dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = LLMEngine(model, num_blocks=2048, block_size=16, max_running=16,
                    prefill_chunk=512)
    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1025, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in plens]
    eng.generate_batch([prompts[0][:64]], max_new_tokens=2)    # warm-up

    reg = metrics.registry()
    reg.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pd.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd.paged_decode_attention.launches

    steps = reg.counter("serving_decode_steps_total").value
    step_s = reg.histogram("serving_decode_step_seconds")
    ttft = reg.histogram("serving_ttft_seconds")
    tokens = sum(len(r.generated) for r in reqs)
    reasons = sorted({r.finish_reason for r in reqs})
    leaks = eng.pool.check_leaks()
    emit({"phase": "serve", "model": "gpt3-1.3B", "dtype": "bfloat16",
          "layers": cfg.num_layers, "requests": len(reqs),
          "prompt_tokens": int(plens.sum()), "output_tokens": tokens,
          "wall_s": wall, "output_tokens_per_s": tokens / wall,
          "decode_steps": steps,
          "decode_step_p50_ms": step_s.percentile(50) * 1e3,
          "decode_step_p99_ms": step_s.percentile(99) * 1e3,
          "ttft_p50_s": ttft.percentile(50), "ttft_p99_s": ttft.percentile(99),
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
          "paged_kernel_launches": launches,
          "finish_reasons": reasons, "leaks": leaks})
    assert reasons == ["length"], f"requests finished with {reasons}"
    assert leaks == ([], []), f"pool leaks {leaks}"
    assert launches == steps * cfg.num_layers and steps > 0, \
        f"{launches} paged kernel launches for {steps} decode steps"
    # the last decode step of each request attends prompt + 31 tokens
    last_lens = [int(n) + 31 for n in plens]
    phase_profile(eng, prompts, step_s.percentile(50))
    eng.close()
    del eng, model
    torch.cuda.empty_cache()
    return launches, last_lens


def phase_profile(eng, prompts, step_p50_s, steps=4):
    """Where a steady decode step's time goes: the same 16 prompts are
    prefilled again, then `steps` decode steps of 16 rows run under
    torch.profiler (CUPTI kernel records).  The profiler's own host cost
    stretches the wall time, so the busy share is taken against
    `step_p50_s`, the unprofiled decode step p50 of the serve phase; the
    share against the profiled wall is printed beside it.  The requests
    are cancelled after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.add_request(p, max_new_tokens=40) for p in prompts]
    while any(r.state == "waiting" or r.needs_prefill for r in reqs):
        eng.step()
    assert all(r.state == "running" for r in reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for r in reqs:
        eng.cancel(r)
    assert eng.pool.check_leaks() == ([], [])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy, edge = {}, 0.0, float("-inf")
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))     # union of intervals
        edge = max(edge, end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    paged = sum(us for name, us in by_name.items() if "paged_decode" in name)
    busy_ms = busy / steps / 1e3
    emit({"phase": "profile", "decode_steps": steps, "rows": len(reqs),
          "device_events": len(spans),
          "profiled_wall_ms_per_step": wall_us / steps / 1e3,
          "unprofiled_step_p50_ms": step_p50_s * 1e3,
          "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / (step_p50_s * 1e3),
          "device_busy_share_of_profiled_wall": busy / wall_us,
          "paged_kernel_ms_per_step": paged / steps / 1e3,
          "top_device_ms_per_step": [[name[:90], us / steps / 1e3]
                                     for name, us in top]})


def phase_e2e():
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM

    # full float32 products on the card (the model has no convolution;
    # cuDNN's TF32 default is turned off all the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.from_preset("gpt3-1.3B", num_layers=2,
                                hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(1))
    eng = LLMEngine(model, num_blocks=256, block_size=16, max_running=4,
                    prefill_chunk=128)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 90, 200, 301)]
    outs = eng.generate_batch(prompts, max_new_tokens=8)
    assert eng.pool.check_leaks() == ([], [])

    cpu = GPTForCausalLM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cpu.eval()
    worst = 0.0
    for prompt, gen in zip(prompts, outs):
        ids = torch.tensor([prompt + gen[:-1]])
        with torch.no_grad():
            logits = cpu(ids)[0, len(prompt) - 1:]      # one row per token
        chosen = logits[torch.arange(len(gen)), torch.tensor(gen)]
        gap = float((logits.max(dim=-1).values - chosen).max())
        worst = max(worst, gap)
    emit({"phase": "e2e", "model": "gpt3-1.3B width, 2 layers",
          "dtype": "float32", "requests": len(prompts),
          "tokens_checked": sum(len(g) for g in outs),
          "max_logit_gap": worst, "tol": 1e-4})
    assert worst <= 1e-4, \
        f"an engine token sits {worst} below the CPU maximum logit"


def cuda_ms(fn, flush, iters=50):
    """Mean device time of fn() over `iters` launches, CUDA events around
    each launch; the L2 cache is overwritten before every launch, as a
    decode step finds each layer's K/V cold."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_timings(launches, lens):
    from paddle_tpu_torch.ops import paged_decode as pd
    H = Hkv = 16
    D, bs, dtype = 128, 16, torch.bfloat16
    q, kp, vp, tables, lens_t = args = paged_inputs(lens, H, Hkv, D, bs,
                                                    dtype, seed=7)
    err, ok = compare(pd, args, dtype)
    assert ok, f"kernel vs plain at the serving shape: max error {err}"
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    # yardstick: torch SDPA over K/V gathered beforehand into contiguous
    # [B, H, Lmax, D] tensors with a boolean length mask (not paged)
    B, L = len(lens), max(lens)
    K = torch.zeros(B, H, L, D, dtype=dtype, device="cuda")
    V = torch.zeros_like(K)
    for b, n in enumerate(lens):
        idx = tables[b, :-(-n // bs)].long()
        K[b, :, :n] = kp[idx].reshape(-1, Hkv, D)[:n].transpose(0, 1)
        V[b, :, :n] = vp[idx].reshape(-1, Hkv, D)[:n].transpose(0, 1)
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens_t[:, None].long())[:, None, None, :]
    qs = q.transpose(1, 2)                                   # [B, H, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    kernel_ms = cuda_ms(lambda: pd.paged_decode_attention(*args), flush)
    plain_ms = cuda_ms(lambda: pd.paged_decode_attention_plain(*args), flush)
    library_ms = cuda_ms(lambda: sdpa(qs, K, V, attn_mask=mask), flush)

    ctx = sum(lens)
    esize = torch.finfo(dtype).bits // 8
    bytes_moved = (2 * ctx * Hkv * D * esize          # K and V rows read
                   + 2 * q.numel() * esize            # q read, out written
                   + tables.numel() * 4 + B * 4)      # tables and lens
    flops = 4 * ctx * H * D                           # q.k and p.v
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    rtol, atol = TOL[dtype]
    emit({"phase": "timings", "kernel": "paged_decode_attention",
          "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "bs": bs,
                    "dtype": "bfloat16", "context_tokens": ctx,
                    "table_cols": tables.shape[1]},
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bytes": bytes_moved, "flops": flops,
          "bound_ms": max(bytes_ms, ops_ms),
          "achieved_bytes_per_s": bytes_moved / (kernel_ms * 1e-3)})
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:41",
            "launches": launches, "max_abs_err": err,
            "tol": {"rtol": rtol, "atol": atol, "dtype": "bfloat16"},
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library": "torch SDPA on K/V pre-gathered to contiguous "
                       "[B, H, Lmax, D] with a boolean length mask"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "an NVIDIA card", file=sys.stderr)
        return 1
    phase_build()
    phase_kernels()
    launches, lens = phase_serve()
    phase_e2e()
    kernel = phase_timings(launches, lens)
    emit({"kernels": [kernel]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
