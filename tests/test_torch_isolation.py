"""The port stands alone: no JAX, no JAX package, no silent CPU runs.

An AST scan shows that no module of `paddle_tpu_torch/`, and not
`chip_smoke.py` and not a `tools/torch_*.py` script, imports `jax`,
`paddle_tpu` or `paddle`; a fresh interpreter importing the whole port
(the training, serving-tier, AOT, incubate, high-level API and
compile-path modules included) loads none of them,
and neither does a serving worker process after it has served, nor a
rank the distributed launcher started after its collectives, nor a
DataLoader worker process (`test_torch_io.py`); and the port's entry
points raise, rather than run on the CPU, when no device is named and
there is no CUDA device.
"""
import ast
import os
import subprocess
import sys
import time

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.device import generator, resolve_device
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.nn.quant import WeightOnlyLinear, convert_to_weight_only
from paddle_tpu_torch.optimizer import Adafactor, Momentum
from paddle_tpu_torch.serving import BlockPool
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                   LlamaForCausalLM, Qwen2Config,
                                   Qwen2ForCausalLM, gpt_loss_fn)
from paddle_tpu_torch.text.peft import LoRAConfig, get_peft_model
from paddle_tpu_torch.text import (BertConfig, BertForPretraining,
                                   BertForSequenceClassification, BertModel,
                                   ErnieConfig, ErnieForMaskedLM,
                                   ErnieForQuestionAnswering,
                                   ErnieForSequenceClassification, ErnieModel)
from paddle_tpu_torch.vision.models import resnet18, resnet50

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "paddle"}


def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tools", n)
        for n in os.listdir(os.path.join(REPO, "tools"))
        if n.startswith("torch_") and n.endswith(".py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_module_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    rel = {os.path.relpath(p, REPO) for p in files}
    assert {"paddle_tpu_torch/framework/checkpoint.py",
            "paddle_tpu_torch/resilience/guard.py",
            "paddle_tpu_torch/resilience/manager.py",
            "paddle_tpu_torch/resilience/chaos.py",
            "paddle_tpu_torch/resilience/backoff.py",
            "paddle_tpu_torch/distributed/launch/heartbeat.py",
            "paddle_tpu_torch/serving/router.py",
            "paddle_tpu_torch/serving/transport.py",
            "paddle_tpu_torch/serving/worker.py",
            "paddle_tpu_torch/serving/aot.py",
            "paddle_tpu_torch/jit/aoti.py",
            "paddle_tpu_torch/incubate/__init__.py",
            "paddle_tpu_torch/incubate/optimizer.py",
            "paddle_tpu_torch/incubate/nn/__init__.py",
            "paddle_tpu_torch/incubate/nn/moe.py",
            "paddle_tpu_torch/incubate/nn/functional.py",
            "paddle_tpu_torch/incubate/nn/fused_transformer.py",
            "paddle_tpu_torch/distributed/collective.py",
            "paddle_tpu_torch/distributed/mesh.py",
            "paddle_tpu_torch/distributed/parallel_layers.py",
            "paddle_tpu_torch/distributed/parallel.py",
            "paddle_tpu_torch/distributed/fleet/__init__.py",
            "paddle_tpu_torch/distributed/fleet_engine.py",
            "paddle_tpu_torch/distributed/sharding.py",
            "paddle_tpu_torch/distributed/ring_attention.py",
            "paddle_tpu_torch/distributed/launch/__init__.py",
            "paddle_tpu_torch/distributed/launch/__main__.py",
            "tools/torch_chaos_check.py",
            "tools/torch_aot_probe.py",
            "paddle_tpu_torch/api.py",
            "paddle_tpu_torch/dtypes.py",
            "paddle_tpu_torch/metric.py",
            "paddle_tpu_torch/callbacks.py",
            "paddle_tpu_torch/framework/lazy.py",
            "paddle_tpu_torch/observability/trace.py",
            "paddle_tpu_torch/io/__init__.py",
            "paddle_tpu_torch/io/shm_loader.py",
            "paddle_tpu_torch/io/native/__init__.py",
            "paddle_tpu_torch/io/native/imgproc.py",
            "paddle_tpu_torch/hapi/__init__.py",
            "paddle_tpu_torch/hapi/callbacks.py",
            "paddle_tpu_torch/vision/datasets.py",
            "paddle_tpu_torch/vision/transforms.py",
            "tools/torch_hapi_probe.py",
            "tools/torch_loader_probe.py",
            "paddle_tpu_torch/jit/dy2static.py",
            "paddle_tpu_torch/observability/compile_tracker.py",
            "paddle_tpu_torch/framework/static_graph.py",
            "paddle_tpu_torch/framework/flags.py",
            "paddle_tpu_torch/static/__init__.py",
            "paddle_tpu_torch/autograd/__init__.py",
            "paddle_tpu_torch/autograd/functional.py",
            "paddle_tpu_torch/autograd/py_layer.py",
            "paddle_tpu_torch/tensor.py",
            "paddle_tpu_torch/base.py",
            "tools/torch_compile_probe.py",
            "paddle_tpu_torch/jit/compile_cache.py",
            "paddle_tpu_torch/analysis/__init__.py",
            "paddle_tpu_torch/analysis/__main__.py",
            "paddle_tpu_torch/analysis/cli.py",
            "paddle_tpu_torch/analysis/core.py",
            "paddle_tpu_torch/analysis/registry_audit.py",
            "paddle_tpu_torch/analysis/rules.py",
            "paddle_tpu_torch/analysis/taint.py"} <= rel
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.text, paddle_tpu_torch.weights, "
            "paddle_tpu_torch.ops, paddle_tpu_torch.observability, "
            "paddle_tpu_torch.ops.flash_attention, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.nn.functional, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.amp, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.text.decode, paddle_tpu_torch.text.generation, "
            "paddle_tpu_torch.text.llama, paddle_tpu_torch.text.qwen, "
            "paddle_tpu_torch.text.peft, paddle_tpu_torch.text.convert, "
            "paddle_tpu_torch.nn.quant, paddle_tpu_torch.nn.conv, "
            "paddle_tpu_torch.nn.norm, paddle_tpu_torch.nn.pooling, "
            "paddle_tpu_torch.vision, paddle_tpu_torch.vision.models, "
            "paddle_tpu_torch.nn.transformer, paddle_tpu_torch.text.bert, "
            "paddle_tpu_torch.text.ernie, paddle_tpu_torch.optimizer.lr, "
            "paddle_tpu_torch.amp.grad_scaler, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.jit.save_load, paddle_tpu_torch.framework, "
            "paddle_tpu_torch.framework.checkpoint, "
            "paddle_tpu_torch.framework.random, "
            "paddle_tpu_torch.framework.param_attr, "
            "paddle_tpu_torch.resilience, paddle_tpu_torch.resilience.chaos, "
            "paddle_tpu_torch.resilience.guard, "
            "paddle_tpu_torch.resilience.manager, "
            "paddle_tpu_torch.resilience.backoff, "
            "paddle_tpu_torch.distributed.launch, "
            "paddle_tpu_torch.distributed.launch.heartbeat, "
            "paddle_tpu_torch.serving.router, "
            "paddle_tpu_torch.serving.transport, "
            "paddle_tpu_torch.serving.worker, paddle_tpu_torch.serving.aot, "
            "paddle_tpu_torch.jit.aoti, paddle_tpu_torch.incubate, "
            "paddle_tpu_torch.incubate.nn, paddle_tpu_torch.incubate.nn.moe, "
            "paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.incubate.nn.fused_transformer, "
            "paddle_tpu_torch.incubate.optimizer, tools.torch_chaos_check, "
            "paddle_tpu_torch.distributed.collective, "
            "paddle_tpu_torch.distributed.mesh, "
            "paddle_tpu_torch.distributed.parallel_layers, "
            "paddle_tpu_torch.distributed.parallel, "
            "paddle_tpu_torch.distributed.fleet, "
            "paddle_tpu_torch.distributed.fleet_engine, "
            "paddle_tpu_torch.distributed.sharding, "
            "paddle_tpu_torch.distributed.ring_attention, "
            "paddle_tpu_torch.api, paddle_tpu_torch.dtypes, "
            "paddle_tpu_torch.metric, paddle_tpu_torch.callbacks, "
            "paddle_tpu_torch.framework.lazy, "
            "paddle_tpu_torch.observability.trace, paddle_tpu_torch.io, "
            "paddle_tpu_torch.io.shm_loader, paddle_tpu_torch.io.native, "
            "paddle_tpu_torch.io.native.imgproc, paddle_tpu_torch.hapi, "
            "paddle_tpu_torch.hapi.callbacks, "
            "paddle_tpu_torch.vision.datasets, "
            "paddle_tpu_torch.vision.transforms, "
            "paddle_tpu_torch.jit.dy2static, "
            "paddle_tpu_torch.observability.compile_tracker, "
            "paddle_tpu_torch.framework.static_graph, "
            "paddle_tpu_torch.framework.flags, paddle_tpu_torch.static, "
            "paddle_tpu_torch.autograd, paddle_tpu_torch.autograd.functional, "
            "paddle_tpu_torch.autograd.py_layer, paddle_tpu_torch.tensor, "
            "paddle_tpu_torch.base, paddle_tpu_torch.fluid, "
            "paddle_tpu_torch.jit.compile_cache, paddle_tpu_torch.analysis, "
            "paddle_tpu_torch.analysis.cli, paddle_tpu_torch.analysis.core, "
            "paddle_tpu_torch.analysis.registry_audit, "
            "paddle_tpu_torch.analysis.rules, "
            "paddle_tpu_torch.analysis.taint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {'transformers'})!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, hidden_size=8, num_layers=1, num_heads=2,
                    max_position_embeddings=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    tiny = dict(vocab_size=16, hidden_size=8, num_layers=1, num_heads=2,
                num_kv_heads=1, intermediate_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig(**tiny))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen2ForCausalLM(Qwen2Config(**tiny))
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        generator(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockPool(num_layers=1, num_blocks=4, block_size=4, num_kv_heads=2,
                  head_dim=8)
    # naming the CPU is the way to run there
    assert next(GPTForCausalLM(cfg, device="cpu").parameters()).device \
        == torch.device("cpu")
    assert BlockPool(1, 4, 4, 2, 8, device="cpu").k[0].device \
        == torch.device("cpu")
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_stay_on_the_named_device(monkeypatch):
    """The training model raises without a card unless the CPU is named;
    flash attention runs on CPU or CUDA tensors and raises on any other
    device; the optimizer's slots, the train step's loss and its grads
    stay on the parameters' device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, hidden_size=8, num_layers=1, num_heads=2,
                    max_position_embeddings=8, use_recompute=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q, is_causal=True)
    model = GPTForCausalLM(cfg, device="cpu")
    opt = Adafactor(parameters=model.parameters())
    step = train_step(model, gpt_loss_fn, opt)
    ids = torch.zeros(1, 8, dtype=torch.long)
    loss = step(ids, ids)
    assert loss.device == torch.device("cpu")
    assert {t.device for slots in opt._state for t in slots.values()} == \
        {torch.device("cpu")}


def test_training_family_entry_points_stay_on_the_named_device(monkeypatch):
    """resnet50 raises without a card unless the CPU is named; LoRA
    adapters, weight-only layers and Momentum's slots land on the device
    of the model they were given, so a model built on the CPU stays
    there and nothing reaches for a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50()
    model = resnet18(num_classes=4, device="cpu")
    opt = Momentum(learning_rate=0.1, parameters=model.parameters())
    x = torch.zeros(2, 3, 16, 16)
    step = train_step(model, lambda m, a, b: (m(a).float() ** 2).mean(), opt)
    assert step(x, None).device == torch.device("cpu")
    assert {t.device for slots in opt._state for t in slots.values()} == \
        {torch.device("cpu")}
    cfg = LlamaConfig(vocab_size=16, hidden_size=8, num_layers=1,
                      num_heads=2, intermediate_size=16)
    lora = get_peft_model(LlamaForCausalLM(cfg, device="cpu"),
                          LoRAConfig(r=2))
    assert {p.device for p in lora.parameters()} == {torch.device("cpu")}
    wo = convert_to_weight_only(LlamaForCausalLM(cfg, device="cpu"))
    layers = [m for m in wo.modules() if isinstance(m, WeightOnlyLinear)]
    assert layers and {m.quant_weight.device for m in layers} == \
        {torch.device("cpu")}


def test_encoder_family_entry_points_raise_without_a_device(monkeypatch):
    """Every BERT and ERNIE model raises without a card unless the CPU is
    named; named, its parameters and its export stay on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = dict(vocab_size=16, hidden_size=8, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=16,
                max_position_embeddings=8)
    for cls, cfg in ((BertModel, BertConfig), (BertForPretraining,
                                                BertConfig),
                     (BertForSequenceClassification, BertConfig),
                     (ErnieModel, ErnieConfig), (ErnieForMaskedLM,
                                                 ErnieConfig),
                     (ErnieForQuestionAnswering, ErnieConfig),
                     (ErnieForSequenceClassification, ErnieConfig)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg(**tiny))
        model = cls(cfg(**tiny), device="cpu")
        assert {p.device for p in model.parameters()} == \
            {torch.device("cpu")}


def test_training_state_entry_points_stay_on_the_named_device(monkeypatch,
                                                             tmp_path):
    """Without a card the model raises unless the CPU is named; named,
    a guarded TrainStep, `save_state` / `load_state` and
    `CheckpointManager.restore` keep every parameter, slot and loss on
    the CPU, and reach for no card."""
    from paddle_tpu_torch.framework import load_state, save_state
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import (CheckpointManager,
                                             NonfiniteGuard)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = dict(vocab_size=16, hidden_size=8, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=16,
                max_position_embeddings=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForSequenceClassification(BertConfig(**tiny))
    cpu = torch.device("cpu")

    def build():
        model = BertForSequenceClassification(BertConfig(**tiny),
                                              device="cpu")
        return model, AdamW(parameters=model.parameters())

    model, opt = build()
    mgr = CheckpointManager(str(tmp_path / "m"))
    step = train_step(model, lambda m, i, y: PF.cross_entropy(m(i), y), opt,
                      guard=NonfiniteGuard(manager=mgr))
    ids = torch.zeros(2, 8, dtype=torch.long)
    assert step(ids, torch.zeros(2, dtype=torch.long)).device == cpu
    save_state(str(tmp_path / "ck"), model=model, optimizer=opt, step=1)
    mgr.save(1, train_step=step)
    fresh, fopt = build()
    load_state(str(tmp_path / "ck"), model=fresh, optimizer=fopt)
    mgr.restore(model=fresh, optimizer=fopt)
    for m, o in ((model, opt), (fresh, fopt)):
        assert {p.device for p in m.parameters()} == {cpu}
        assert {t.device for slots in o._state for t in slots.values()} \
            == {cpu}


def test_moe_and_incubate_entry_points_stay_on_the_named_device(
        monkeypatch):
    """A GPT-MoE raises without a card unless the CPU is named; named,
    its experts, its aux loss, a TrainStep's loss and the LookAhead and
    ModelAverage copies stay on the CPU."""
    from paddle_tpu_torch.incubate import LookAhead, ModelAverage
    from paddle_tpu_torch.optimizer import SGD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, hidden_size=8, num_layers=2, num_heads=2,
                    max_position_embeddings=8, num_experts=4,
                    use_recompute=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    cpu = torch.device("cpu")
    model = GPTForCausalLM(cfg, device="cpu")
    assert {p.device for p in model.parameters()} == {cpu}
    ids = torch.zeros(1, 8, dtype=torch.long)
    step = train_step(model, gpt_loss_fn, Adafactor(
        parameters=model.parameters()))
    assert step(ids, ids).device == cpu
    assert model.gpt.h[0].mlp.aux_loss.device == cpu
    la = LookAhead(SGD(parameters=model.parameters()), k=1)
    ma = ModelAverage(parameters=model.parameters())
    gpt_loss_fn(model, ids, ids).backward()
    la.step()
    ma.step()
    assert {t.device for t in la._slow + ma._avg} == {cpu}


def test_a_spawned_worker_loads_no_jax(monkeypatch, tmp_path):
    """A serving worker process (the drills' builder, on the CPU) serves
    a request and closes; its interpreter then holds no JAX module and
    nothing of the JAX package.  The worker's `-c` program is wrapped so
    that it exits 7 when it finds one after `main()` returns."""
    from paddle_tpu_torch.serving import worker as sw
    from paddle_tpu_torch.serving.transport import TransportPolicy
    from tools import torch_chaos_check as tcc

    check = ("import sys\n{main}\nrc = main()\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{sorted(FORBIDDEN)!r})\n"
             "print('forbidden modules:', bad, file=sys.stderr)\n"
             "sys.exit(7 if bad else rc)\n")
    real = subprocess.Popen

    def popen(cmd, **kw):
        assert cmd[1] == "-c" and "worker import main" in cmd[2]
        main = "from paddle_tpu_torch.serving.worker import main"
        return real([cmd[0], "-c", check.format(main=main), *cmd[3:]], **kw)

    monkeypatch.setattr(sw.subprocess, "Popen", popen)
    spec = tcc.drill_spec(device="cpu", config=tcc.TINY,
                          engine=tcc.TINY_ENGINE)
    h = sw.ProcReplica(spec, "iso", str(tmp_path / "hb"),
                       policy=TransportPolicy(timeout=120.0, retries=0))
    try:
        assert h.wait_ready(timeout=120.0)
        rq = h.add_request([1, 2, 3], max_new_tokens=4)
        deadline = time.monotonic() + 120.0
        while rq.finish_reason is None:
            assert time.monotonic() < deadline, "the worker stalled"
            h.step()
            time.sleep(0.002)
        assert h.close() == ([], [])
    finally:
        h.abort()
    assert rq.finish_reason == "length" and len(rq.generated) == 4
    assert h.proc.returncode == 0


def test_launched_ranks_load_no_jax(tmp_path):
    """Two ranks of the distributed launcher join a gloo group, reduce,
    and hold no JAX module and nothing of the JAX package (exit 7 if
    they do)."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from paddle_tpu_torch import distributed as dist\n"
        "dist.init_parallel_env(backend='gloo', timeout=60)\n"
        "t = torch.ones(2)\n"
        "dist.all_reduce(t)\n"
        "assert t.tolist() == [2.0, 2.0]\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print('forbidden modules:', bad, file=sys.stderr)\n"
        "sys.exit(7 if bad else 0)\n")
    from torch_gloo import _free_port
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master",
         f"127.0.0.1:{_free_port()}", str(script)],
        cwd=REPO, env=env, timeout=120, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_high_level_api_entry_points_raise_without_a_device(monkeypatch):
    """`to_tensor`, `create_parameter`, `Model`, the DataLoader's device
    staging and a LazyGuard build on the default device raise without a
    card unless the CPU is named; named (`place=`, `places=`,
    `device=`), each stays on the CPU."""
    from paddle_tpu_torch import LazyGuard, create_parameter, io, to_tensor
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import Linear

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    rows = io.TensorDataset([torch.zeros(4, 2)])
    for call in (lambda: to_tensor([1.0]), lambda: create_parameter([2]),
                 lambda: Model(torch.nn.Identity()),
                 lambda: next(iter(io.DataLoader(rows, batch_size=2)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with LazyGuard():
            Linear(2, 2)
    cpu = torch.device("cpu")
    assert to_tensor([1.0], place="cpu").device == cpu
    assert create_parameter([2], device="cpu").device == cpu
    assert next(iter(io.DataLoader(rows, batch_size=2, places="cpu")))[
        0].device == cpu
    with LazyGuard():
        lin = Linear(2, 2, device="cpu")
    assert lin.weight.device == cpu
    assert Model(lin)._device == cpu


def test_compile_cache_and_tracelint_entry_points_raise_without_a_device(
        monkeypatch, tmp_path):
    """The compile cache's environment key and the registry audit name
    the device they describe: without a card they raise unless the CPU
    is named; named, they describe the CPU.  The store itself and the
    lint of source hold no device."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.jit import compile_cache as cc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    fc = cc.FunctionCache("f", fingerprint=("src",))
    args = ((torch.ones(2),), {})
    for call in (cc.env_fingerprint, lambda: fc.digest(args),
                 lambda: analysis.audit_registry()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert cc.env_fingerprint("cpu")["platform"] == "cpu"
    assert len(fc.digest(args, device="cpu")) == 64
    assert analysis.audit_registry(device="cpu") == []
    store = cc.CompileCache(str(tmp_path))
    store.put("d" * 64, b"payload")
    assert store.get("d" * 64) == b"payload"
    assert analysis.lint_source("def forward(x):\n    return x.item()\n")
