"""The port's learning-rate schedulers against the JAX package's.

Each scheduler of `paddle_tpu.optimizer.lr` is built on both sides with
the same arguments and stepped 25 times (`LinearWarmup` wrapping a float
and wrapping another scheduler; `ReduceOnPlateau` fed the same metrics;
one case jumps with `step(epoch)`); the rate series must be equal to the
last bit (the same host arithmetic in Python floats).  Then each
`state_dict` is equal to the JAX one, and restoring it into a fresh
scheduler gives the same rates from there on.  An optimizer reads its
scheduler at every update.
"""
import math

import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.optimizer import lr as tlr

CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 8, 15],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=10,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=6, end_lr=0.01, cycle=True),
    "LinearWarmup_float": lambda m: m.LinearWarmup(0.1, warmup_steps=5,
                                                   start_lr=0.0, end_lr=0.1),
    "LinearWarmup_scheduler": lambda m: m.LinearWarmup(
        m.PolynomialDecay(2e-5, decay_steps=12, end_lr=0.0),
        warmup_steps=4, start_lr=0.0, end_lr=2e-5),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, milestones=[4, 9, 17],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.2, step_size=4, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=10, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.3, total_steps=20),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.3, total_steps=20, anneal_strategy="linear", phase_pct=0.25),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-3),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.01),
    "CyclicLR_triangular": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, step_size_down=5, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, mode="exp_range", exp_gamma=0.97),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.2, lambda e: 0.9 if e % 2 else 1.0),
}
STEPS = 25


def _metric(i):
    """A loss that improves, then stalls: ReduceOnPlateau's input."""
    return 1.0 / (1 + i) if i < 6 else 0.2 + 0.01 * math.sin(i)


def _series(sched, name, steps=STEPS):
    out = []
    for i in range(steps):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(_metric(i))
        else:
            sched.step()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_rate_series_equals_jax(name):
    assert _series(CASES[name](tlr), name) == _series(CASES[name](jlr), name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trip(name):
    j, t = CASES[name](jlr), CASES[name](tlr)
    _series(j, name, 7)
    _series(t, name, 7)
    assert t.state_dict() == j.state_dict()
    fresh = CASES[name](tlr)
    fresh.set_state_dict(t.state_dict())
    assert _series(fresh, name, 10) == _series(j, name, 10)


def test_step_to_an_epoch_and_every_scheduler_is_ported():
    t, j = tlr.StepDecay(0.2, step_size=4), jlr.StepDecay(0.2, step_size=4)
    t.step(13)
    j.step(13)
    assert t() == j() and t.last_epoch == 13
    jax_classes = {n for n, v in vars(jlr).items()
                   if isinstance(v, type) and issubclass(v, jlr.LRScheduler)}
    port_classes = {n for n, v in vars(tlr).items()
                    if isinstance(v, type) and issubclass(v, tlr.LRScheduler)}
    assert port_classes == jax_classes
    covered = {n.split("_")[0] for n in CASES} | {"LRScheduler"}
    assert covered == jax_classes


def test_optimizer_reads_its_scheduler_at_every_update():
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, step_size=1, gamma=0.5)
    opt = optimizer.Momentum(learning_rate=sched, momentum=0.0,
                             parameters=[p])
    rates = []
    for _ in range(3):
        p.grad = torch.ones(3)
        before = p.detach().clone()
        rates.append(opt.get_lr())
        opt.step()
        torch.testing.assert_close(before - p.detach(),
                                   torch.full((3,), rates[-1]))
        sched.step()
    assert rates == [0.5, 0.25, 0.125]
    opt.set_lr(0.01)
    assert opt.get_lr() == 0.01
