#!/usr/bin/env python3
"""The float32 flash forward (`csrc/flash_fwd_fp32.cu`) on one card.

    python3 tools/torch_fp32_fwd_probe.py [--no-timing] [--ernie]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the flash sources into `build/kernels/` and prints ptxas's
registers, shared memory and spills of each fp32 instantiation (head-dim
tile 64 / 128, mask none / key vector / full rows), then:

- every case of `tests/test_torch_flash_kernel.py` (`CASES`) and every
  float32 case of `chip_smoke.FLASH_CASES`, in float32, through the fp32
  family and the sm80 family against `flash_fwd_plain`, with the forward
  tolerance (1e-5, 1e-5) for o and lse; the fp32 kernel twice, which
  must give equal bits;
- unless `--no-timing`, `chip_smoke.fp32_fwd_timing` (fp32, sm80 and
  float32 SDPA in turns at ERNIE's shape, unmasked and masked, and at the
  `train_fp32` shape) and `chip_smoke.fp32_bwd_timing` (the sm80 float32
  dK/dV and dQ beside SDPA's backward at `bert_e2e`'s and ERNIE's shape);
- with `--ernie`, `run_ernie_infer`'s float32 deployment (ERNIE-3.0-medium,
  batch 32, seq 128, the exported program, as `chip_smoke.py`'s
  `ernie_infer` builds it) with its flash forward on the fp32 family and
  on sm80 (the route with "fp32" left out) in turns (fp32, sm80, sm80,
  fp32): run p50 / p99 of 30 synchronized runs, the device busy time and
  the flash forward's device time a run (torch.profiler, 3 runs), the
  launches by family, and the logits of the two families against each
  other.

One JSON line per part, then the card's name and power limit.  Exits
nonzero on any disagreement.
"""
import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def test_cases():
    """`CASES` and `make_inputs` of tests/test_torch_flash_kernel.py."""
    spec = importlib.util.spec_from_file_location(
        "flash_kernel_cases", ROOT / "tests" / "test_torch_flash_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES, mod.make_inputs


def check(name, q, k, v, mask, causal, window):
    """fp32 and sm80 against the plain version -> a record; raises on a
    disagreement or on unequal bits over two fp32 launches."""
    rtol, atol = cs.FLASH_FWD_TOL[torch.float32]
    kw = dict(is_causal=causal, window=window)
    ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    fin = torch.isfinite(ref_lse)
    rec = {"case": name, "shape": list(q.shape) + [k.shape[1], k.shape[2]],
           "causal": causal, "window": window,
           "mask": None if mask is None else list(mask.shape),
           "route": fa._fwd_route(q, k, v, fa._normalize_mask(mask),
                                  q.dtype)}
    for impl in ("fp32", "sm80"):
        o, lse = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=impl)
        torch.cuda.synchronize()
        d = (o - ref_o).abs()
        ok = bool((d <= atol + rtol * ref_o.abs()).all())
        ok = ok and bool(torch.equal(fin, torch.isfinite(lse)))
        ld = (lse - ref_lse).abs()[fin]
        ok = ok and bool((ld <= 1e-5 + 1e-5 * ref_lse.abs()[fin]).all())
        rec[f"{impl}_max_abs_err"] = float(d.max())
        rec[f"{impl}_lse_max_abs_err"] = float(ld.max()) if ld.numel() \
            else 0.0
        rec[f"{impl}_ok"] = ok
        if impl == "fp32":
            o2, lse2 = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=impl)
            rec["fp32_repeat_equal"] = bool(torch.equal(o, o2)) and bool(
                torch.equal(lse, lse2))
    return rec


def ernie_ab(runs=30, warmup=5):
    """ERNIE's float32 exported program with the flash forward on fp32
    and on sm80 in turns -> a record per turn."""
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.text import (ErnieForSequenceClassification,
                                       ernie_config_from_preset)
    cfg = ernie_config_from_preset("ernie-3.0-medium-zh",
                                   hidden_dropout_prob=0.0)
    model = ErnieForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (32, 128)).astype("int64")
    predictor, _ = cs.export_predictor(
        model, [InputSpec([32, 128], "int64", "input_ids")])
    predictor.get_input_handle(predictor.get_input_names()[0]) \
        .copy_from_cpu(ids)
    out = predictor.get_output_handle(predictor.get_output_names()[0])
    families = fa._families

    def without_fp32(*args):
        return tuple(f for f in families(*args) if f != "fp32")

    turns, logits = [], {}
    try:
        for fam in ("fp32", "sm80", "sm80", "fp32"):
            fa._families = families if fam == "fp32" else without_fp32
            for _ in range(warmup):
                predictor.run()
            torch.cuda.synchronize()
            cs.zero_counts()
            run_ms = cs.step_ms(predictor.run, runs)
            counts = cs.read_counts()
            logits[fam] = out.copy_to_cpu()
            prof = cs.busy(predictor.run, 3, cs.pct(run_ms)["p50"])
            turns.append({"family": fam, **cs.pct(run_ms),
                          "device_busy_ms": prof["device_busy_ms_per_step"],
                          "flash_fwd_device_ms":
                          prof["flash_ms_per_step"],
                          "launches": cs.flash_part(counts)})
            fl = turns[-1]["launches"]
            assert fl["fwd"] == 6 * runs and fl["fwd_fp32"] == (
                6 * runs if fam == "fp32" else 0), fl
    finally:
        fa._families = families
    mean = {f: {k: float(np.mean([t[k] for t in turns if t["family"] == f]))
                for k in ("p50", "p99", "device_busy_ms",
                          "flash_fwd_device_ms")}
            for f in ("fp32", "sm80")}
    return {"turns": turns, "mean": mean,
            "p50_gain_ms": mean["sm80"]["p50"] - mean["fp32"]["p50"],
            "busy_gain_ms": mean["sm80"]["device_busy_ms"]
            - mean["fp32"]["device_busy_ms"],
            "fp32_vs_sm80_logits_max_abs": float(np.abs(
                logits["fp32"] - logits["sm80"]).max())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--ernie", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logs = _build.build(["flash_fwd_fp32", "flash_attention"])
    kernels = {}
    for log in logs.values():
        for name, k in cs.ptxas_kernels(log).items():
            m = cs.FP32_KERNEL.search(name)
            if m:
                kernels[f"fp32_d{m[1]}{cs.SM90_MASK_MODES[int(m[2])]}"] = k
    cs.emit({"part": "build", "fp32_kernels": kernels,
             "warnings": sorted({ln.strip() for log in logs.values()
                                 for ln in log.splitlines()
                                 if "warning" in ln.lower()})})

    bad = []
    cases, make_inputs = test_cases()
    for name in sorted(cases):
        q, k, v, _, mask, kw = make_inputs(name, device="cuda")
        rec = check(name, q, k, v, mask, kw["is_causal"], kw["window"])
        cs.emit(dict(rec, part="tests_case"))
        if not (rec["fp32_ok"] and rec["sm80_ok"]
                and rec["fp32_repeat_equal"]):
            bad.append(name)
    for i, (name, B, Lq, Lk, H, Hkv, D, causal, window, kind,
            dtype) in enumerate(cs.FLASH_CASES):
        if dtype != torch.float32:
            continue
        q, k, v, _, mask = cs.flash_inputs(B, Lq, Lk, H, Hkv, D, kind, dtype,
                                           seed=200 + i)
        rec = check(name, q, k, v, mask, causal, window)
        cs.emit(dict(rec, part="chip_smoke_case"))
        if not (rec["fp32_ok"] and rec["sm80_ok"]
                and rec["fp32_repeat_equal"]):
            bad.append(name)
        del q, k, v, mask
    torch.cuda.empty_cache()
    cs.emit({"part": "cases", "failed": bad})

    if not args.no_timing:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        cs.emit({"part": "fp32_fwd", **cs.fp32_fwd_timing(fa, flush)})
        cs.emit({"part": "fp32_bwd", **cs.fp32_bwd_timing(fa, flush)})
    if args.ernie:
        cs.emit({"part": "ernie_ab", **ernie_ab()})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
