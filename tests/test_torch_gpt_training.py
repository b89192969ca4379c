"""The port's GPT training step against the JAX package's, on the CPU.

A TINY GPT is built in the JAX package and its weights carried into the
port (`load_paddle_tpu_state`).  Then, with the same batch made with
numpy:

* the loss and every parameter gradient against `jax.value_and_grad`
  through the JAX package's functional bridge, float32;
* a 5-step `TrainStep` loss series against `pt.jit.train_step`, for AdamW
  and for Adafactor, float32 — once more with the JAX side on its Pallas
  flash kernels in interpret mode (`PADDLE_TPU_PALLAS=interpret`);
* pure bf16 (`amp.decorate(master_weight=False)` + Adafactor) against
  the same in JAX, with a looser tolerance;
* the JAX optimizer state after step 4 carried across by
  `load_paddle_tpu_optimizer_state`, then one more step on each side;
* recompute against no recompute, train-mode dropout and its generator,
  the pretraining criterion, and the TrainStep's contract.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import functional_bridge as FB
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.text import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import TrainStep, train_step
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM,
                                   GPTPretrainingCriterion, gpt_loss_fn)
from paddle_tpu_torch.weights import (load_paddle_tpu_optimizer_state,
                                      load_paddle_tpu_state)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
STEPS = 5
# float32 on both sides, summed in another order: the losses agree to a
# few float32 roundings; gradients (and parameters after an update) to
# 1e-4 relative, 1e-6 absolute
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
# pure bfloat16 on both sides, which round at other places (torch's
# LayerNorm computes in float32 inside one kernel and rounds once; JAX's
# runs as bf16 ops): one bf16 rounding (2**-8 relative) of logits of
# spread ~1 moves a token's loss by up to ~4e-3, and the mean over the
# batch, carried through 5 updates, stays within 1e-2 (measured on the
# CPU: 3.7e-4)
BF16_LOSS_ATOL = 1e-2


def _batch(seed=0, b=2, s=12):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 64, size=(b, s)), rng.randint(0, 64, size=(b, s))


def _pair(**over):
    """A JAX GPT from seed 0 and the port's GPT with its weights."""
    cfg = dict(TINY, **over)
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **cfg))
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _jt(x):
    return pt.to_tensor(np.asarray(x).astype("int64"))


def _assert_params_match(tm, arrays, steps):
    """The port's parameters against the JAX ones (Linear weights
    transposed) after `steps` updates.  Adam and Adafactor normalise each
    update to about the learning rate, which is ill-conditioned wherever a
    gradient's history nearly cancels, so the error of a parameter scales
    with how far it can move: atol is 0.1 % of LR * steps.  The key third
    of each qkv bias is left out: its gradient is zero in exact arithmetic
    (it shifts every score of a row by the same amount, which the softmax
    ignores), so each side updates it from rounding noise alone."""
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    hidden = tm.cfg.hidden_size
    for n, p in tm.named_parameters():
        got = p.detach().float().numpy()
        want = arrays[n].T if n in linear else arrays[n]
        if n.endswith("qkv_proj.bias"):
            keep = np.r_[0:hidden, 2 * hidden:3 * hidden]
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, err_msg=n, rtol=1e-4,
                                   atol=1e-3 * LR * steps)


def _jax_opt(name, params):
    return {"adamw": lambda: pt.optimizer.AdamW(
                learning_rate=LR, weight_decay=0.01, parameters=params),
            "adafactor": lambda: pt.optimizer.Adafactor(
                learning_rate=LR, parameters=params)}[name]()


def _port_opt(name, params):
    return {"adamw": lambda: optimizer.AdamW(
                learning_rate=LR, weight_decay=0.01, parameters=params),
            "adafactor": lambda: optimizer.Adafactor(
                learning_rate=LR, parameters=params)}[name]()


# ------------------------------------------------------------- gradients
def test_loss_and_every_gradient_match_jax():
    jm, tm = _pair()
    ids, labels = _batch()
    pn, pa, _, ba = FB.split_state(jm)

    def f(params):
        out, _ = FB.call_functional(
            jm, params, ba, (ids.astype("int64"), labels.astype("int64")),
            fn=lambda *ts: jax_gpt_loss_fn(jm, *ts))
        return out

    jloss, jgrads = jax.jit(jax.value_and_grad(f))(pa)
    loss = gpt_loss_fn(tm, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    params = dict(tm.named_parameters())
    assert sorted(params) == sorted(pn)
    for name, jg in zip(pn, jgrads):
        jg = np.asarray(jg)
        g = params[name].grad.numpy()
        np.testing.assert_allclose(g, jg.T if name in linear else jg,
                                   err_msg=name, **GRAD_TOL)


# ------------------------------------------------------------ train steps
def _jax_run(opt_name, bf16=False, interpret=False):
    """5 JAX TrainStep steps; the weights and optimizer state after step 4
    (as numpy) and the parameters after step 5."""
    jm, _ = _pair()
    jopt = _jax_opt(opt_name, jm.parameters())
    if bf16:
        jm, jopt = pt.amp.decorate(models=jm, optimizers=jopt,
                                   dtype="bfloat16", master_weight=False)
    ids, labels = _batch()
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            mp.setenv("PADDLE_TPU_PALLAS", "interpret")
        step = pt.jit.train_step(jm, jax_gpt_loss_fn, jopt)
        losses, snap = [], None
        for i in range(STEPS):
            if i == STEPS - 1:
                names = [n for n, _ in jm.named_parameters()]
                snap = ({k: np.asarray(v.astype("float32"))
                         for k, v in jm.state_dict().items()},
                        {n: {s: np.asarray(a) for s, a in slots.items()}
                         for n, slots in zip(names, step._opt_state)},
                        step._step)
            losses.append(float(step(_jt(ids), _jt(labels))))
    final = {n: np.asarray(p.astype("float32"))
             for n, p in jm.state_dict().items()}
    return losses, snap, final


@pytest.fixture(scope="module", params=["adamw", "adafactor",
                                        "adamw-interpret"])
def jax_run(request):
    name = request.param.split("-")[0]
    return name, _jax_run(name, interpret=request.param.endswith(
        "interpret"))


def _port_series(opt_name, bf16=False):
    _, tm = _pair()
    opt = _port_opt(opt_name, tm.parameters())
    if bf16:
        tm, opt = amp.decorate(models=tm, optimizers=opt, dtype="bfloat16",
                               master_weight=False)
    step = train_step(tm, gpt_loss_fn, opt)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    return [float(step(ids, labels)) for _ in range(STEPS)], tm


def test_train_step_loss_series_matches_jax(jax_run):
    name, (jlosses, _, final) = jax_run
    losses, tm = _port_series(name)
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    _assert_params_match(tm, final, STEPS)


def test_pure_bf16_adafactor_matches_jax():
    jlosses, _, _ = _jax_run("adafactor", bf16=True)
    losses, tm = _port_series("adafactor", bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=BF16_LOSS_ATOL)
    assert losses[-1] < losses[0]


def test_optimizer_state_carried_across_then_one_more_step(jax_run):
    """The JAX weights and optimizer state after step 4, carried into the
    port, take step 5 to the JAX parameters after step 5."""
    name, (_, (weights, state, step_no), final) = jax_run
    _, tm = _pair()
    load_paddle_tpu_state(tm, weights)
    opt = _port_opt(name, tm.parameters())
    step = train_step(tm, gpt_loss_fn, opt)
    load_paddle_tpu_optimizer_state(opt, tm, dict(state, step=step_no))
    assert step.step_count == STEPS - 1
    ids, labels = (torch.from_numpy(x) for x in _batch())
    step(ids, labels)
    _assert_params_match(tm, final, 1)


def test_load_optimizer_state_rejects_missing_names_and_bad_shapes():
    _, tm = _pair()
    opt = optimizer.AdamW(parameters=tm.parameters())
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    state = {n: {"moment1": np.zeros(p.shape[::-1] if n in linear
                                     else p.shape, np.float32),
                 "moment2": np.zeros(1)} for n, p in tm.named_parameters()}
    with pytest.raises(KeyError):     # a parameter missing
        load_paddle_tpu_optimizer_state(
            opt, tm, {k: v for k, v in state.items() if k != "gpt.wpe.weight"})
    with pytest.raises(ValueError):   # moment2 of the wrong shape
        load_paddle_tpu_optimizer_state(opt, tm, state)
    with pytest.raises(KeyError):     # a slot missing
        load_paddle_tpu_optimizer_state(
            opt, tm, {n: {"moment1": v["moment1"]} for n, v in state.items()})


# ------------------------------------------------- recompute and dropout
def _grads(model, ids, labels):
    model.zero_grad(set_to_none=True)
    loss = gpt_loss_fn(model, ids, labels)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def test_recompute_gives_the_same_gradients_with_dropout():
    """Blocks re-run in the backward draw the same dropout masks from the
    model's generator, so the gradients equal those without recompute."""
    over = dict(hidden_dropout=0.2, attention_dropout=0.2)
    ids, labels = (torch.from_numpy(x) for x in _batch())
    results = []
    for use in (False, True):
        tm = GPTForCausalLM(GPTConfig(**dict(TINY, **over,
                                             use_recompute=use)),
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))
        tm.set_dropout_generator(torch.Generator().manual_seed(11))
        results.append(_grads(tm, ids, labels))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7,
                                   msg=n)


def test_dropout_is_reproducible_with_one_generator_and_off_in_eval():
    cfg = GPTConfig(**dict(TINY, hidden_dropout=0.3, attention_dropout=0.3))
    tm = GPTForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(_batch()[0])

    def run(seed):
        tm.set_dropout_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm(ids)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    plain.load_state_dict(tm.state_dict())
    tm.eval()
    with torch.no_grad():
        assert torch.equal(tm(ids), plain.eval()(ids))


def test_attention_dropout_applies_to_the_output():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    out = PF.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=0.5,
        generator=torch.Generator().manual_seed(1))
    ref = PF.dropout(PF.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True),
                     0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(out, ref)
    kept = (out != 0).float().mean()
    assert 0.3 < float(kept) < 0.7
    with pytest.raises(ValueError):
        PF.scaled_dot_product_attention(q, k, v, sliding_window=4)


# ------------------------------------------------------------ loss, amp
def test_cross_entropy_and_pretraining_criterion_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 6, 64)).astype(np.float32)
    labels = rng.integers(0, 64, size=(2, 6))
    labels[0, :2] = -100                       # ignored
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32)
    jl, tl = pt.to_tensor(logits), torch.from_numpy(logits)
    jy, ty = pt.to_tensor(labels.astype("int64")), torch.from_numpy(labels)
    for got, want in (
            (PF.cross_entropy(tl, ty), pt.nn.functional.cross_entropy(jl,
                                                                     jy)),
            (GPTPretrainingCriterion()(tl, ty),
             JaxCriterion()(jl, jy)),
            (GPTPretrainingCriterion()(tl, ty, torch.from_numpy(mask)),
             JaxCriterion()(jl, jy, pt.to_tensor(mask)))):
        np.testing.assert_allclose(float(got), float(want.numpy()),
                                   **LOSS_TOL)
    none = torch.full((2, 6), -100)
    assert float(PF.cross_entropy(tl, none)) == 0.0


@pytest.mark.parametrize("master", [None, True, False])
def test_amp_decorate_casts_in_place_and_sets_master_weights(master):
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    before = list(tm.parameters())
    opt = optimizer.Adafactor(parameters=tm.parameters())
    m2, opt2 = amp.decorate(tm, opt, dtype="bfloat16", master_weight=master)
    assert m2 is tm and opt2 is opt
    assert all(a is b for a, b in zip(before, tm.parameters()))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert opt._use_master_weights == (master is not False)
    slots = opt.init_state()
    assert ("master" in slots[0]) == (master is not False)


def test_train_step_contract():
    _, tm = _pair()
    opt = optimizer.AdamW(learning_rate=1e-3,
                          apply_decay_param_fun=lambda n: "ln" not in n,
                          parameters=tm.parameters())
    step = TrainStep(tm, gpt_loss_fn, opt)
    assert opt._param_names[0] == "gpt.wte.weight"   # the model's names
    ids, labels = (torch.from_numpy(x) for x in _batch())
    loss = step(ids, labels)
    assert loss.dim() == 0 and not loss.requires_grad
    assert loss.device == torch.device("cpu")
    assert all(p.grad is None for p in tm.parameters())
    assert step.step_count == 1 == step.state_dict()["step"]
    assert opt._state[0]["moment1"].device == torch.device("cpu")
