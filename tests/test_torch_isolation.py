"""The port stands alone: no JAX, no JAX package, no silent CPU runs.

An AST scan shows that no module of `paddle_tpu_torch/`, and not
`chip_smoke.py`, imports `jax`, `paddle_tpu` or `paddle`; a fresh
interpreter importing the whole port (the training modules included)
loads none of them; and the port's entry points raise, rather than run on
the CPU, when no device is named and there is no CUDA device.
"""
import ast
import os
import subprocess
import sys

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
    files = [os.path.join(REPO, "chip_smoke.py")]
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
            "paddle_tpu_torch/resilience/chaos.py"} <= rel
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
            "paddle_tpu_torch.resilience.manager\n"
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
