#!/usr/bin/env python3
"""Where an AOTInductor compile of `chip_smoke.py`'s programs spends its
time, one program at a time on an otherwise idle host.

    python3 tools/torch_aot_compile_probe.py [--variants default,threads1,o0]
                                             [--programs e2e_decode,ernie_fp32]

Run from the root of a checkout on a machine with a CUDA card.  It
exports each program the way `chip_smoke.py`'s `aot_compile` phase does
(`e2e_decode`: `serve_aot_e2e`'s decode program, GPT-3 1.3B's width at 2
layers in float32; `serve_decode`: `serve_aot`'s, SERVE_LAYERS in bf16;
`ernie_fp32` / `ernie_bf16`: ERNIE-3.0-medium's forward as
`save_inference(aot=True)` compiles it), then compiles it with
AOTInductor in a fresh child process with empty Inductor and Triton
caches, once for each variant:

- `default`: the settings `jit.aoti` compiles with;
- `threads1`: with `TORCHINDUCTOR_COMPILE_THREADS=1` (no pool of compile
  workers);
- `o0`: with the C++ wrapper built at -O0
  (`aot_inductor.compile_wrapper_opt_level`);
- `no_pointwise_tuning`: one configuration a pointwise kernel
  (`triton.autotune_pointwise`).

Prints one JSON line a compile: its wall seconds, the CPU seconds of the
child and of its own children, and the 25 functions of the child's
Python profile with the most cumulative seconds; then the card's name
and power limit.
"""
import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "default": ({}, {}),
    "threads1": ({"TORCHINDUCTOR_COMPILE_THREADS": "1"}, {}),
    "o0": ({}, {"aot_inductor.compile_wrapper_opt_level": "O0"}),
    "no_pointwise_tuning": ({}, {"triton.autotune_pointwise": False}),
}


def export(name, out):
    """Export program `name` into `out` (.pt2 and .json), as
    `jit.aoti.compile_packages` hands a program to its compile child."""
    import chip_smoke as cs
    from paddle_tpu_torch.jit.aoti import FunctionalProgram, export_program
    from torch.utils import _pytree as pytree
    if name.startswith("ernie_"):
        from paddle_tpu_torch import amp
        from paddle_tpu_torch.jit.aoti import module_weights
        from paddle_tpu_torch.jit.save_load import _call
        model = cs.ernie_medium()
        if name == "ernie_bf16":
            amp.decorate(models=model, dtype="bfloat16")
        names, weights = module_weights(model)
        ids = torch.zeros(32, 128, dtype=torch.int64, device="cuda")
        program, args, dynamic = (FunctionalProgram(model, _call, names),
                                  (weights, ids), None)
    else:
        from paddle_tpu_torch.serving import LLMEngine
        kw, eng_kw = {
            "e2e_decode": (dict(dtype=torch.float32, seed=1, num_layers=2),
                           cs.E2E_AOT_ENGINE),
            "serve_decode": ({}, cs.SERVE_AOT_ENGINE)}[name]
        eng = LLMEngine(cs.gpt13(**kw), **eng_kw)
        key = next(k for k in eng.program_keys() if "decode" in str(k))
        builder, args, dynamic = eng.program_structs(key)
        program = builder()
    ep, _, export_s = export_program(program, args, dynamic)
    ep.example_inputs = None
    path = os.path.join(out, f"{name}.pt2")
    torch.export.save(ep, path)
    with open(path + ".json", "w") as f:
        json.dump({"inputs": [[list(t.shape), str(t.dtype).split(".")[1],
                               str(t.device)]
                              for t in pytree.tree_leaves(args)],
                   "package": os.path.join(out, f"{name}_pkg.pt2")}, f)
    return path, export_s


def child(ep_path, config_json):
    """Compile the exported program under cProfile; print the record."""
    import cProfile
    import pstats
    import io
    import torch._inductor.config as ic
    from paddle_tpu_torch.jit import aoti
    for k, v in json.loads(config_json).items():
        obj = ic
        *parts, last = k.split(".")
        for p in parts:
            obj = getattr(obj, p)
        if not hasattr(obj, last):
            print(json.dumps({"skipped": f"no inductor setting {k}"}))
            return 0
        setattr(obj, last, v)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    aoti._compile_main(ep_path)
    prof.disable()
    wall = time.perf_counter() - t0
    s = io.StringIO()
    st = pstats.Stats(prof, stream=s)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][3])[:25]
    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(json.dumps({
        "wall_s": wall, "self_cpu_s": me.ru_utime + me.ru_stime,
        "children_cpu_s": kids.ru_utime + kids.ru_stime,
        "top_cumulative_s": [[f"{fn[0].split('site-packages/')[-1]}:"
                              f"{fn[1]}({fn[2]})", round(v[3], 2)]
                             for fn, v in top]}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="default,threads1,o0")
    ap.add_argument("--programs", default="e2e_decode,ernie_fp32")
    ap.add_argument("--child", nargs=2)
    a = ap.parse_args()
    if a.child:
        return child(*a.child)
    if not torch.cuda.is_available():
        print("torch_aot_compile_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "cpus": os.cpu_count()}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in a.programs.split(","):
            ep_path, export_s = export(name, tmp)
            for variant in a.variants.split(","):
                env_over, cfg = VARIANTS[variant]
                cache = tempfile.mkdtemp(dir=tmp)
                env = dict(os.environ, PYTHONPATH=str(ROOT),
                           TORCHINDUCTOR_CACHE_DIR=os.path.join(cache, "i"),
                           TRITON_CACHE_DIR=os.path.join(cache, "t"),
                           **env_over)
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     ep_path, json.dumps(cfg)], env=env,
                    capture_output=True, text=True, timeout=900)
                rec = {"program": name, "variant": variant,
                       "export_s": export_s, "rc": r.returncode,
                       "process_wall_s": time.perf_counter() - t0}
                lines = r.stdout.strip().splitlines()
                if r.returncode == 0 and lines:
                    rec.update(json.loads(lines[-1]))
                else:
                    rec["stderr"] = r.stderr[-3000:]
                print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
