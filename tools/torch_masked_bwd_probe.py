#!/usr/bin/env python3
"""The sm90 flash backward (dK/dV and dQ) with and without a mask, beside
another checkout's build of the same source.

    python3 tools/torch_masked_bwd_probe.py [--parent DIR]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
DIR is the root of another checkout (say, the parent commit unpacked with
`git archive` into a directory that .gitignore lists): its
`paddle_tpu_torch/csrc/flash_attention_sm90.cu` is built with the same
nvcc flags into `build/kernels/`, and ptxas's registers and spills of
each sm90 kernel are printed beside this checkout's.  Then, on one card:

- the masked backward at BERT's shape (B 32, L 128, H 12, D 64, bf16,
  the [32, 1, 1, 128] additive padding mask) against `flash_bwd_plain`:
  this tree's sm90 dK/dV and dQ and the sm80 ones, largest error over
  the largest gradient element;
- times (CUDA events, the L2 flushed before each launch, as
  `chip_smoke.cuda_ms`) in turns: the masked pair at BERT's shape on
  sm80, sm90, sm90, sm80, then SDPA's backward under the same mask (dq,
  dk, dv in one call); the unmasked sm90 pair at BERT's shape and at the
  training shape (B 4, L 1024, H 16, D 128, causal, bf16) as built from
  DIR and from this tree: parent, change, change, parent.

One JSON line per part, then the card's name and power limit.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_sm90"


def sm90_kernels(log):
    """{short name: {registers, spills}} of the sm90 kernels in a ptxas
    log (`chip_smoke.SM90_KERNEL_NAMES`; a build whose backward kernels
    have no mask instantiation names them as the unmasked ones)."""
    out = {}
    for name, k in cs.ptxas_kernels(log).items():
        for tail, short in cs.SM90_KERNEL_NAMES.items():
            if tail in name or ("Li0EE" in tail
                                and tail.replace("Li0EE", "E") in name):
                out[short] = k
    return out


def build_parent(parent):
    """Build DIR's sm90 source -> (loaded library, ptxas log)."""
    src = Path(parent) / "paddle_tpu_torch" / "csrc" / f"{SOURCE}.cu"
    out = _build.BUILD_DIR / f"{SOURCE}-parent.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the parent's source:\n{log}")
    return ctypes.CDLL(str(out)), log


def use(lib):
    """Point the wrappers' sm90 entries at `lib` (typed as `_kernel`
    types them)."""
    for name, argtypes in fa._ENTRIES[SOURCE].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{SOURCE}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    fa._libs[SOURCE] = lib


def pair(q, k, v, do, lse, delta, mask, causal, impl):
    """One dK/dV and one dQ launch of family `impl`."""
    def run():
        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask,
                              is_causal=causal, _impl=impl)
        fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask,
                             is_causal=causal, _impl=impl)
    return run


def inputs(B, L, H, D, causal, masked, seed):
    q, k, v, do, _ = cs.flash_inputs(B, L, L, H, H, D, None, torch.bfloat16,
                                     seed)
    mask = None
    if masked:
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        mask = cs.bert_padding_mask(B, L, torch.bfloat16, g)
    o, lse = fa.flash_fwd_plain(q, k, v, mask, is_causal=causal)
    return q, k, v, do, mask, lse, fa._delta(do, o)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_masked_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    logs = _build.build(["flash_attention", SOURCE])
    mine = fa._kernel(SOURCE)
    regs = {"change": sm90_kernels(logs.get(SOURCE, ""))}
    parent = None
    if args.parent:
        parent, log = build_parent(args.parent)
        regs["parent"] = sm90_kernels(log)
    print(json.dumps({"part": "ptxas", "sm90_kernels": regs}), flush=True)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    # the masked pair at BERT's shape: error, then sm80 / sm90 in turns
    # (the kernels take the mask as the training path hands it to them,
    # float32 from `_normalize_mask`; SDPA takes it in bf16)
    q, k, v, do, mask, lse, delta = inputs(32, 128, 12, 64, False, True, 21)
    m4 = fa._normalize_mask(mask)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, m4)
    errs = {}
    for impl in ("sm90", "sm80"):
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, m4,
                                       _impl=impl)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, m4, _impl=impl)
        errs[impl] = cs.bwd_error(tuple(zip((dq, dk, dv), want)))[1]
    turns = [(impl, cs.cuda_ms(pair(q, k, v, do, lse, delta, m4, False,
                                    impl), flush, iters=25))
             for impl in ("sm80", "sm90", "sm90", "sm80")]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = sdpa(qh, kh, vh, attn_mask=mask)
    doh = do.transpose(1, 2).contiguous()
    lib_ms = cs.cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True), flush, iters=25)
    print(json.dumps({"part": "bert_masked", "max_err": errs,
                      "turns_ms": turns, "sdpa_bwd_ms": lib_ms}), flush=True)

    # the unmasked sm90 pair, parent's build and this tree's in turns
    for name, shape in (("bert_unmasked", (32, 128, 12, 64, False)),
                        ("train_unmasked", (4, 1024, 16, 128, True))):
        B, L, H, D, causal = shape
        q, k, v, do, _, lse, delta = inputs(B, L, H, D, causal, False, 23)
        turns = []
        for who in (("parent", "change", "change", "parent") if parent
                    else ("change", "change")):
            use(parent if who == "parent" else mine)
            dkv_ms = cs.cuda_ms(lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, is_causal=causal, _impl="sm90"),
                flush, iters=25)
            dq_ms = cs.cuda_ms(lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, is_causal=causal, _impl="sm90"),
                flush, iters=25)
            turns.append((who, dkv_ms, dq_ms))
        use(mine)
        print(json.dumps({"part": name, "turns_ms_dkv_dq": turns}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
