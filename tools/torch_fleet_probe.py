#!/usr/bin/env python3
"""The fleet step against TrainStep on one card, in turns.

    python3 tools/torch_fleet_probe.py [--profile]

Builds the kernels (as `chip_smoke.py` does), then `chip_smoke.py`'s
`train` model (GPT-3 1.3B, seq 1024, batch 4, pure bf16, Adafactor) and
times one step function at a time on it, each call ended by `.item()`:
TrainStep before any process group exists, then, after
`init_parallel_env()` (NCCL, one rank) and `fleet.init` (dp 1, mp 1,
ZeRO stage 2), TrainStep and `fleet.build_train_step`'s step in turns
(T, F, F, T, T, F), 8 steps a turn, the first of each turn dropped.
With `--profile`, one `torch.profiler` window of 2 steps first (as
`chip_smoke.py`'s `train_profile` takes one), to see whether a profiled
window slows what follows.  Prints one JSON line: each turn's step p50
and the card's name.
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")


def main():
    import chip_smoke as cs
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adafactor
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn

    if not torch.cuda.is_available():
        print("torch_fleet_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_build()
    cfg = GPTConfig.from_preset("gpt3-1.3B", vocab_size=50304,
                                max_position_embeddings=1024,
                                hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = Adafactor(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids, labels = (torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                                 device="cuda") for _ in range(2))

    def turn(step, n=8):
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            step(ids, labels).item()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(ms[1:], 50))

    plain = TrainStep(model, gpt_loss_fn, opt)
    turns = [("T, no process group", turn(plain))]
    if "--profile" in sys.argv:
        cs.phase_train_profile(plain, ids, labels, turns[0][1] / 1e3)
        turns.append(("T, after a profiled window", turn(plain)))
    dist.init_parallel_env()
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, mp_degree=1, sharding_stage=2)
    fleet.init(is_collective=True, strategy=s)
    fl = fleet.build_train_step(model, gpt_loss_fn, opt)
    for name in "TFFTTF":
        turns.append((name, turn(plain if name == "T" else fl)))
    dist.destroy_process_group()
    print(json.dumps({"probe": "fleet_vs_train_step",
                      "device": torch.cuda.get_device_name(0),
                      "step_p50_ms": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
