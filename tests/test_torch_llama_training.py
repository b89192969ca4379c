"""The port's LLaMA training step against the JAX package's, on the CPU.

A TINY LLaMA with GQA (4 query heads over 2 kv heads) is built in the
JAX package and its weights carried into the port
(`load_paddle_tpu_state`).  The loss is `bench.py::run_llama`'s: cross
entropy of the logits, mean over the batch.  With the same batch made
with numpy:

* the loss and every parameter gradient against `jax.value_and_grad`
  through the JAX package's functional bridge, float32;
* a 5-step `TrainStep` loss series with recompute on (as `run_llama`
  trains) against `pt.jit.train_step`, for Adafactor and for AdamW,
  float32, and the parameters after it — once more with the JAX side on
  its Pallas flash kernels in interpret mode (`PADDLE_TPU_PALLAS=
  interpret`);
* pure bf16 (`amp.decorate(master_weight=False)` + Adafactor) against the
  same in JAX, with a looser tolerance;
* recompute on against recompute off: the same loss and gradients.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import functional_bridge as FB
from paddle_tpu.text.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_paddle_tpu_state

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=48, max_position_embeddings=64)
STEPS, LR = 5, 1e-2
# float32 on both sides, summed in another order: the losses agree to a
# few float32 roundings; gradients to 1e-4 relative, 1e-6 absolute
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# pure bfloat16 on both sides, rounded at other places (the port's rope,
# SiLU and residual stream round once where JAX runs bf16 ops; ROADMAP.md
# C): as for GPT (tests/test_torch_gpt_training.py), 1e-2 on the loss
BF16_LOSS_ATOL = 1e-2


def loss_fn(model, ids, labels):
    return PF.cross_entropy(model(ids), labels)


def jax_loss_fn(model, ids, labels):
    return JF.cross_entropy(model(ids), labels, reduction="mean")


def _batch(seed=0, b=2, s=12):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 64, size=(b, s)), rng.randint(0, 64, size=(b, s))


def _pair(**over):
    cfg = dict(TINY, **over)
    pt.seed(0)
    jm = JaxLlama(JaxLlamaConfig(tensor_parallel=False, **cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _linear(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def test_loss_and_every_gradient_match_jax():
    jm, tm = _pair()
    ids, labels = _batch()
    pn, pa, _, ba = FB.split_state(jm)

    def f(params):
        out, _ = FB.call_functional(
            jm, params, ba, (ids.astype("int64"), labels.astype("int64")),
            fn=lambda *ts: jax_loss_fn(jm, *ts))
        return out

    jloss, jgrads = jax.jit(jax.value_and_grad(f))(pa)
    loss = loss_fn(tm, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    linear = _linear(tm)
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(pn)
    for name, jg in zip(pn, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   jg.T if name in linear else jg,
                                   err_msg=name, **GRAD_TOL)


def _opt(mod, name, params):
    if name == "adamw":
        return mod.AdamW(learning_rate=LR, weight_decay=0.01,
                         parameters=params)
    return mod.Adafactor(learning_rate=LR, parameters=params)


def _jax_run(opt_name, bf16=False, interpret=False):
    jm, _ = _pair(use_recompute=True)
    jopt = _opt(pt.optimizer, opt_name, jm.parameters())
    if bf16:
        jm, jopt = pt.amp.decorate(models=jm, optimizers=jopt,
                                   dtype="bfloat16", master_weight=False)
    ids, labels = (pt.to_tensor(x.astype("int64")) for x in _batch())
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        step = pt.jit.train_step(jm, jax_loss_fn, jopt)
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
    return losses, {n: np.asarray(p.astype("float32"))
                    for n, p in jm.state_dict().items()}


def _port_run(opt_name, bf16=False, recompute=True):
    _, tm = _pair(use_recompute=recompute)
    opt = _opt(optimizer, opt_name, tm.parameters())
    if bf16:
        tm, opt = amp.decorate(models=tm, optimizers=opt, dtype="bfloat16",
                               master_weight=False)
    step = train_step(tm, loss_fn, opt)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    return [float(step(ids, labels)) for _ in range(STEPS)], tm


@pytest.mark.parametrize("run", ["adafactor", "adamw", "adamw-interpret"])
def test_train_step_series_matches_jax(run):
    name = run.split("-")[0]
    jlosses, final = _jax_run(name, interpret=run.endswith("interpret"))
    losses, tm = _port_run(name)
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    linear = _linear(tm)
    # Adam and Adafactor normalise each update to about the learning
    # rate, so a parameter's error scales with how far it can move
    for n, p in tm.named_parameters():
        want = final[n].T if n in linear else final[n]
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=n,
                                   rtol=1e-4, atol=1e-3 * LR * STEPS)


def test_pure_bf16_adafactor_matches_jax():
    jlosses, _ = _jax_run("adafactor", bf16=True)
    losses, tm = _port_run("adafactor", bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=BF16_LOSS_ATOL)
    assert losses[-1] < losses[0]


def test_recompute_gives_the_same_loss_and_gradients():
    ids, labels = (torch.from_numpy(x) for x in _batch(1))
    results = []
    for use in (False, True):
        _, tm = _pair(use_recompute=use)
        tm.train()
        loss = loss_fn(tm, ids, labels)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in tm.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
    losses, _ = _port_run("adamw", recompute=False)
    np.testing.assert_allclose(losses, _port_run("adamw")[0], rtol=1e-6,
                               atol=1e-7)
