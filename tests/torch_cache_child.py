"""One interpreter of `test_torch_compile_cache.py`'s cold / warm pair
(torch, numpy and the port only).

    python tests/torch_cache_child.py STORE_DIR

runs, on the CPU, with the persistent compile cache at STORE_DIR and
Inductor's cache wherever TORCHINDUCTOR_CACHE_DIR points:

* a 2-layer GPT of width 64 under `jit.to_static` (Inductor), 3 SGD
  steps on one seeded batch;
* the static Executor's program (8-4-3 MLP, mean cross entropy, SGD), 2
  runs on seeded batches;
* a function with a tensor `if` (dy2static: `torch.cond`, which
  Inductor's FX-graph cache does not take), once;

and prints one JSON line: the losses, the compile cache's stats and
uncacheable reasons, Inductor's and AOTAutograd's cache counters, and
the compile tracker's events.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import jit, nn, optimizer, static  # noqa: E402
from paddle_tpu_torch.jit import compile_cache as cc  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.observability import compile_tracker as ct  # noqa: E402
from paddle_tpu_torch.observability import metrics  # noqa: E402
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn  # noqa: E402

GPT = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=64, hidden_dropout=0.0,
           attention_dropout=0.0)


def gpt_losses(steps=3):
    model = GPTForCausalLM(GPTConfig(**GPT), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 64, (2, 16), generator=g)
    labels = torch.randint(0, 64, (2, 16), generator=g)
    st = jit.to_static(model)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = gpt_loss_fn(st, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def executor_losses(runs=2):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 4), nn.ReLU(), nn.Linear(4, 3))
    rng = np.random.RandomState(0)
    paddle.enable_static()
    try:
        x = static.data("x", [None, 8], "float32")
        y = static.data("y", [None], "int64")
        loss = F.cross_entropy(net(x), y, reduction="mean")
        optimizer.SGD(learning_rate=0.1,
                      parameters=net.parameters()).minimize(loss)
        exe = static.Executor()
        exe.run(static.default_startup_program())
        return [float(exe.run(
            feed={"x": rng.randn(4, 8).astype("float32"),
                  "y": rng.randint(0, 3, 4)}, fetch_list=[loss])[0])
            for _ in range(runs)]
    finally:
        paddle.disable_static()


def gate(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def main(store):
    from torch._dynamo.utils import counters
    torch.set_num_threads(2)
    paddle.set_device("cpu")
    cc.configure(store)
    report = {"gpt": gpt_losses(), "executor": executor_losses(),
              "gate": jit.to_static(gate)(torch.ones(4)).tolist()}
    report.update(
        stats=cc.stats(),
        uncacheable=[r["labels"]["reason"]
                     for r in metrics.registry().snapshot()
                     if r["name"] == "compile_cache_uncacheable_total"],
        inductor={k: v for k, v in counters["inductor"].items()
                  if k.startswith("fxgraph_cache")},
        aot={k: v for k, v in counters["aot_autograd"].items()
             if k.startswith("autograd_cache")},
        events=[[e.label, e.cause] for e in ct.events()],
        compiles={lb: ct.compile_count(lb)
                  for lb in {e.label for e in ct.events()}})
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
