#!/usr/bin/env python3
"""Device time by kernel of the port's flash forward at generation's two
shapes, from torch.profiler, beside chip_smoke.py's event timings.

    python3 tools/torch_flash_probe.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Mistral-7B's decode shape (B 4, Lq 1, Lk 576, GQA 32/8, D 128, bf16, a
[4, 1, 1, 576] bool mask): the decode forward with the bool mask (its
conversion to an additive mask included), with that mask already
additive, without a mask, at forced split counts; the sm80 forward; SDPA
with the same bool mask.  Generation's masked prefill (B 4, Lq 512, Lk
576, the `prefill_buffer` mask): the sm90 forward with and without the
mask, the sm80 forward, SDPA.  Each variant runs 10 times after a write
of 256 MB (the L2 cold, as chip_smoke.py's timings find it) under the
profiler; one JSON line per variant gives each kernel's device
microseconds a call, and `clean_ms`, the CUDA-event time of a call after
a read flush (`chip_smoke.cuda_ms(..., clean=True)`).  Then the card's
name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def kernels_us(fn, flush, n=10):
    """{kernel name: device microseconds a call} over n calls, each after
    a 256 MB write; the flush's own kernel left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        if us and e.count and "FillFunctor<unsigned char>" not in e.key:
            out[e.key[:100]] = us / n
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_flash_probe: no CUDA device", file=sys.stderr)
        return 1
    _build.build(["flash_decode", "flash_attention", "flash_attention_sm90"])
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    B, Lk, H, Hkv, D = 4, 576, 32, 8, 128
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    q, k, v = rnd(B, 1, H, D), rnd(B, Lk, Hkv, D), rnd(B, Lk, Hkv, D)
    lens = torch.tensor([576, 560, 544, 530], device="cuda")
    mask = (torch.arange(Lk, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    m4 = fa._normalize_mask(mask)
    q2 = rnd(B, 512, H, D)
    m2 = cs.generation_mask("prefill_buffer", B, 512, Lk, g)
    m24 = fa._normalize_mask(m2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, q2h = (x.transpose(1, 2).contiguous() for x in (q, k, v, q2))
    variants = {
        "decode_bool_mask": lambda: fa.flash_fwd_cuda(q, k, v, mask),
        "decode_additive_mask": lambda: fa.flash_fwd_cuda(q, k, v, m4),
        "decode_no_mask": lambda: fa.flash_fwd_cuda(q, k, v),
        **{f"decode_splits_{n}": (lambda n=n: fa.flash_fwd_cuda(
            q, k, v, m4, _splits=n)) for n in (1, 5, 18, 36)},
        "decode_shape_sm80": lambda: fa.flash_fwd_cuda(q, k, v, m4,
                                                       _impl="sm80"),
        "decode_shape_sdpa": lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                          enable_gqa=True),
        "prefill_sm90": lambda: fa.flash_fwd_cuda(q2, k, v, m24,
                                                  _impl="sm90"),
        "prefill_sm90_no_mask": lambda: fa.flash_fwd_cuda(q2, k, v,
                                                          _impl="sm90"),
        "prefill_sm80": lambda: fa.flash_fwd_cuda(q2, k, v, m24,
                                                  _impl="sm80"),
        "prefill_sdpa": lambda: sdpa(q2h, kh, vh, attn_mask=m2,
                                     enable_gqa=True),
    }
    with torch.no_grad():
        for name, fn in variants.items():
            print(json.dumps({
                "variant": name, "kernels_us": kernels_us(fn, flush),
                "clean_ms": cs.cuda_ms(fn, flush, iters=20, clean=True)}),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
