#!/usr/bin/env python3
"""Where the DataLoader's time goes when it feeds ResNet-50 on one card.

    python3 tools/torch_loader_probe.py [--steps N] [--workers W]

Run from the root of a checkout on a machine with a CUDA card.  It
drains `chip_smoke.py`'s hapi_resnet loader (uint8 224 x 224 x 3 images
made from the index through the fused ToTensor + Normalize pass, batch
256, W worker processes, rings of two batches) with no model behind it,
staged on the card and not staged, and times each batch the trainer
waits for, the ring reads, the pinned allocations and the
host-to-device copies (wrapping those calls; nothing of the loader
changes).  A worker's own time a batch is timed in this process on the
same data.  One JSON line a run, then the card's name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def timed_calls(obj, name, log):
    """Wrap obj.name so that each call's wall seconds go to log."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        log.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)
    return fn


def drain(steps, workers, batch, staged):
    from paddle_tpu_torch import io
    from paddle_tpu_torch.io import shm_loader
    from paddle_tpu_torch.vision import transforms as T
    transform = T.Compose([T.RandomHorizontalFlip(), T.ToTensor(),
                           T.Normalize(cs.IMAGENET_MEAN, cs.IMAGENET_STD)])
    reads, allocs = [], []
    orig_read = timed_calls(shm_loader._RingBase, "read", reads)
    orig_alloc = timed_calls(io, "_pinned_bytes", allocs)
    batch_bytes = batch * 3 * 224 * 224 * 4 + batch * 8
    loader = io.DataLoader(cs.HapiImages(steps * batch, transform=transform),
                           batch_size=batch, num_workers=workers,
                           ring_bytes=2 * batch_bytes + (1 << 20),
                           use_buffer_reader=staged)
    waits = []
    t = time.perf_counter()
    try:
        for x, y in loader:
            if staged:
                torch.cuda.current_stream().synchronize()
            now = time.perf_counter()
            waits.append(now - t)
            t = now
    finally:
        shm_loader._RingBase.read = orig_read
        io._pinned_bytes = orig_alloc
    rest = waits[1:]
    return {"staged": staged, "workers": workers, "batch": batch,
            "batches": len(waits), "first_batch_s": waits[0],
            "wait_ms": [w * 1e3 for w in rest],
            "wait_p50_ms": float(np.percentile(rest, 50)) * 1e3,
            "images_per_s_after_first": len(rest) * batch / sum(rest),
            "ring_read_ms": [r * 1e3 for r in reads],
            "pinned_alloc_ms": [a * 1e3 for a in allocs]}


def worker_batch_seconds(batch):
    """One worker's work for one batch, in this process: the samples,
    the collate and the message."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.io import shm_loader
    from paddle_tpu_torch.vision import transforms as T
    torch.set_num_threads(1)
    transform = T.Compose([T.RandomHorizontalFlip(), T.ToTensor(),
                           T.Normalize(cs.IMAGENET_MEAN, cs.IMAGENET_STD)])
    ds = cs.HapiImages(batch, transform=transform)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(batch)]
    t1 = time.perf_counter()
    coll = io._numpy_collate(samples)
    t2 = time.perf_counter()
    msg = shm_loader.encode_batch(shm_loader._to_numpy_tree(coll))
    t3 = time.perf_counter()
    torch.set_num_threads(8)
    return {"samples_s": t1 - t0, "collate_s": t2 - t1,
            "encode_s": t3 - t2, "message_bytes": len(msg)}


def main(args):
    if not torch.cuda.is_available():
        print("torch_loader_probe: no CUDA device", file=sys.stderr)
        return 1
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args \
        else 24
    workers = int(args[args.index("--workers") + 1]) \
        if "--workers" in args else 8
    torch.zeros(1, device="cuda")
    print(json.dumps({"phase": "worker_batch",
                      **worker_batch_seconds(256)}), flush=True)
    for staged in (True, False, True):
        print(json.dumps({"phase": "loader_drain",
                          **drain(steps, workers, 256, staged)}),
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
