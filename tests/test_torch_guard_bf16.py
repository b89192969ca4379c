"""The nonfinite verdicts of the port's guard and GradScaler on every
floating dtype, bfloat16 included (ROADMAP.md C11).

`torch._amp_foreach_non_finite_check_and_unscale_` has no BFloat16
kernel on CUDA; its CPU kernel takes bfloat16, so on the CPU it is
patched here to raise on BFloat16 as the card's does.  Under that patch:

* `resilience.guard.all_finite` gives the JAX package's verdict
  (`paddle_tpu.resilience.guard.all_finite`) for finite, NaN and inf
  values in bf16, fp16 and fp32 groups, None gradients among them, and
  a non-finite loss;
* `amp.GradScaler.unscale_` gives the JAX scaler's verdict and the same
  unscaled gradients on the same groups, and `step` skips the
  optimizer exactly when the JAX scaler does.

On the card (`cuda` marker; `python -m pytest --noconftest
tests/test_torch_guard_bf16.py -m cuda`): a pure-bf16 model
(`amp.decorate(master_weight=False)`) under `TrainStep(...,
guard=NonfiniteGuard())` takes a finite step and skips a poisoned one
with every parameter bit-equal, and a GradScaler unscales its bf16
gradients.  This module imports JAX only inside the CPU tests.

Tolerances: verdicts equal; unscaled gradients bit-equal (the scale is
a power of two).
"""
import types

import numpy as np
import pytest
import torch

import torch_cpu_threads

from paddle_tpu_torch.amp.grad_scaler import GradScaler
from paddle_tpu_torch.resilience import guard

torch_cpu_threads.limit()

_FUSED = torch._amp_foreach_non_finite_check_and_unscale_


def _no_bf16(grads, found, inv):
    if any(g.dtype == torch.bfloat16 for g in grads):
        raise NotImplementedError(
            "_amp_foreach_non_finite_check_and_unscale_cuda not "
            "implemented for 'BFloat16'")
    return _FUSED(grads, found, inv)


@pytest.fixture
def cuda_like(monkeypatch):
    monkeypatch.setattr(torch, "_amp_foreach_non_finite_check_and_unscale_",
                        _no_bf16)


def test_the_patch_refuses_bf16_as_the_card_does(cuda_like):
    with pytest.raises(NotImplementedError, match="BFloat16"):
        torch._amp_foreach_non_finite_check_and_unscale_(
            [torch.ones(2, dtype=torch.bfloat16)], torch.zeros(1),
            torch.ones(1))


# (dtype of each gradient or None, index of the poisoned one, poison)
CASES = {
    "finite": (["bf16", "fp16", "fp32", None, "bf16"], None, None),
    "bf16_nan": (["bf16", "fp16", "fp32", None, "bf16"], 4, np.nan),
    "bf16_inf": (["fp32", "bf16", None, "bf16"], 1, np.inf),
    "fp16_ninf": (["bf16", "fp16", "fp32"], 1, -np.inf),
    "fp32_nan": (["bf16", None, "fp32", "fp16"], 2, np.nan),
    "only_none": ([None, None], None, None),
    "bf16_only_finite": (["bf16", "bf16"], None, None),
}
TORCH_DT = {"bf16": torch.bfloat16, "fp16": torch.float16,
            "fp32": torch.float32}


def _grads(case, seed=0):
    dtypes, bad, poison = CASES[case]
    rng = np.random.RandomState(seed)
    out = []
    for i, dt in enumerate(dtypes):
        if dt is None:
            out.append(None)
            continue
        a = rng.randn(3, 5).astype(np.float32)
        if i == bad:
            a[1, 2] = poison
        out.append((a, dt))
    return out


def _torch_grads(grads):
    return [None if g is None else torch.from_numpy(g[0]).to(TORCH_DT[g[1]])
            for g in grads]


def _jax_grads(grads):
    import jax.numpy as jnp
    jdt = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}
    return [None if g is None else jnp.asarray(g[0], jdt[g[1]])
            for g in grads]


@pytest.mark.parametrize("loss", [0.5, float("nan")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_all_finite_gives_the_jax_verdict_on_every_dtype(cuda_like, case,
                                                         loss):
    import jax.numpy as jnp
    from paddle_tpu.resilience import guard as jguard
    grads = _grads(case)
    got = guard.all_finite(torch.tensor(loss), _torch_grads(grads))
    want = bool(jguard.all_finite(jnp.asarray(loss), _jax_grads(grads)))
    assert got.dim() == 0 and got.dtype == torch.bool
    assert bool(got) == want


def _stub_optimizer(grads):
    opt = types.SimpleNamespace(steps=0)
    opt._parameters = [types.SimpleNamespace(grad=g) for g in grads]

    def step():
        opt.steps += 1
    opt.step = step
    return opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_scaler_unscales_every_dtype_as_the_jax_scaler(cuda_like, case):
    import paddle_tpu as pt
    from paddle_tpu.amp.grad_scaler import GradScaler as JScaler
    grads = _grads(case, seed=1)
    scale = 2.0 ** 10
    tg = _torch_grads(grads)
    tscaled = [None if g is None else g * scale for g in tg]
    jscaled = [None if g is None else pt.to_tensor(g.float().numpy().copy())
               .astype({torch.bfloat16: "bfloat16", torch.float16: "float16",
                        torch.float32: "float32"}[g.dtype])
               for g in tscaled]
    tscaler = GradScaler(init_loss_scaling=scale)
    jscaler = JScaler(init_loss_scaling=scale)
    topt, jopt = _stub_optimizer(tscaled), _stub_optimizer(jscaled)
    tscaler.step(topt)
    jscaler.step(jopt)
    assert topt.steps == jopt.steps
    assert tscaler._found_inf == jscaler._found_inf
    for t, j, g in zip(topt._parameters, jopt._parameters, tg):
        if t.grad is None:
            assert j.grad is None
            continue
        assert t.grad.dtype == g.dtype
        got = t.grad.float().numpy()
        want = np.asarray(j.grad._array).astype(np.float32)
        np.testing.assert_array_equal(got, want)
    tscaler.update()
    jscaler.update()
    assert tscaler.get_loss_scaling() == jscaler.get_loss_scaling()


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fault is in a CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_guarded_pure_bf16_step_on_card(card):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.resilience import NonfiniteGuard
    g = torch.Generator(card).manual_seed(0)
    model = tnn.Sequential(tnn.Linear(16, 32, device=card, generator=g),
                           tnn.ReLU(),
                           tnn.Linear(32, 4, device=card, generator=g))
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt,
                              dtype="bfloat16", master_weight=False)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    gd = NonfiniteGuard()
    step = train_step(model, lambda m, a, b: TF.cross_entropy(m(a), b), opt,
                      guard=gd)
    x = torch.randn(8, 16, device=card, dtype=torch.bfloat16)
    y = torch.randint(0, 4, (8,), device=card)
    before = [p.detach().clone() for p in model.parameters()]
    assert torch.isfinite(step(x, y)).item()
    assert gd.total_skipped == 0
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    before = [p.detach().clone() for p in model.parameters()]
    bad = x.clone()
    bad[0, 0] = float("nan")
    with pytest.warns(RuntimeWarning, match="skipped"):
        step(bad, y)
    assert gd.total_skipped == 1
    for a, p in zip(before, model.parameters()):
        assert torch.equal(a, p)
    grads = [torch.full((5,), 2.0 ** 12, device=card, dtype=torch.bfloat16),
             None, torch.ones(3, device=card, dtype=torch.float32)]
    scaler = GradScaler(init_loss_scaling=2.0 ** 12)
    sopt = _stub_optimizer(grads)
    scaler.step(sopt)
    assert sopt.steps == 1 and not scaler._found_inf
    assert torch.equal(grads[0], torch.ones(5, device=card,
                                            dtype=torch.bfloat16))
    grads[0][2] = float("inf")
    scaler.step(_stub_optimizer(grads))
    assert scaler._found_inf
