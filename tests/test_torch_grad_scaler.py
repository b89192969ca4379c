"""The port's GradScaler against the JAX package's, on the CPU.

Two small Linear layers, each with its own optimizer, train eagerly
through `scaler.scale(loss).backward()`, `scaler.step(opt)` for each
optimizer and `scaler.update()`, on both sides from the same weights and
inputs made with numpy.  An inf is injected into some steps' inputs: of
both layers, or of the second only (so one optimizer steps and the other
skips, and the scale still shrinks, per iteration).  One optimizer also
holds a parameter that never gets a gradient.  Compared after every
iteration: the loss scale, each optimizer's step count (a skipped step
leaves it where it was), and the parameters, which a skipped step must
not move.  Then an explicit `unscale_` before `step` (as a user who clips
does) unscales once, `minimize` steps and updates, `state_dict` round
trips, and a disabled scaler passes everything through.

Tolerance for the parameters: float32 on both sides, the same formulas
summed in another order: rtol 1e-6, atol 1e-7.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.weights import load_paddle_tpu_state

TOL = dict(rtol=1e-6, atol=1e-7)
# iteration -> which inputs get an inf: "both", "b" (the second layer's)
INF_AT = {1: "both", 2: "both", 4: "b", 7: "both"}
ITERS = 10


def _layers():
    pt.seed(0)
    ja, jb, junused = pt.nn.Linear(4, 3), pt.nn.Linear(3, 2), \
        pt.nn.Linear(2, 2)
    ta, tb, tunused = (torch.nn.Linear(i, o) for i, o in
                       ((4, 3), (3, 2), (2, 2)))
    for j, t in ((ja, ta), (jb, tb), (junused, tunused)):
        load_paddle_tpu_state(t, {k: np.asarray(v)
                                  for k, v in j.state_dict().items()})
    return (ja, jb, junused), (ta, tb, tunused)


def _inputs(i):
    rng = np.random.default_rng(i)
    xa = rng.standard_normal((5, 4)).astype(np.float32)
    xb = rng.standard_normal((5, 3)).astype(np.float32)
    kind = INF_AT.get(i)
    if kind == "both":
        xa[0, 1] = np.inf
    if kind in ("both", "b"):
        xb[2, 0] = np.inf
    return xa, xb


def _jax_run():
    (ja, jb, junused), _ = _layers()
    opt_a = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=list(ja.parameters())
                                  + list(junused.parameters()))
    opt_b = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=jb.parameters())
    scaler = JaxGradScaler(init_loss_scaling=2.0 ** 10,
                           incr_every_n_steps=2)
    rows = []
    for i in range(ITERS):
        xa, xb = _inputs(i)
        ya, yb = ja(pt.to_tensor(xa)), jb(pt.to_tensor(xb))
        loss = (ya * ya).mean() + (yb * yb).mean()
        scaler.scale(loss).backward()
        scaler.step(opt_a)
        scaler.step(opt_b)
        scaler.update()
        opt_a.clear_grad()
        opt_b.clear_grad()
        rows.append((scaler.get_loss_scaling(), opt_a._step_count,
                     opt_b._step_count,
                     {f"{n}.{k}": np.asarray(v) for n, m in
                      (("a", ja), ("b", jb)) for k, v in
                      m.state_dict().items()}))
    return rows


def _port_run():
    _, (ta, tb, tunused) = _layers()
    opt_a = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=list(ta.parameters())
                               + list(tunused.parameters()))
    opt_b = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=tb.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10,
                            incr_every_n_steps=2)
    rows = []
    for i in range(ITERS):
        xa, xb = (torch.from_numpy(x) for x in _inputs(i))
        ya, yb = ta(xa), tb(xb)
        loss = (ya * ya).mean() + (yb * yb).mean()
        scaler.scale(loss).backward()
        assert tunused.weight.grad is None
        scaler.step(opt_a)
        scaler.step(opt_b)
        scaler.update()
        opt_a.clear_grad()
        opt_b.clear_grad()
        rows.append((scaler.get_loss_scaling(), opt_a._step_count,
                     opt_b._step_count,
                     {f"{n}.{k}": v.detach().clone() for n, m in
                      (("a", ta), ("b", tb)) for k, v in
                      m.state_dict().items()}))
    return rows


def test_scale_skip_and_step_count_series_match_jax():
    jrows, trows = _jax_run(), _port_run()
    assert [r[:3] for r in trows] == [r[:3] for r in jrows]
    # the series shows what it should: skips shrink, two good steps grow
    scales = [r[0] for r in trows]
    assert scales[:7] == [2.0 ** e for e in (10, 9, 8, 8, 7, 7, 8)]
    assert [r[1] for r in trows][-1] == ITERS - 3      # a skipped 1, 2, 7
    assert [r[2] for r in trows][-1] == ITERS - 4      # b also skipped 4
    for i, (jr, tr) in enumerate(zip(jrows, trows)):
        for name, jv in jr[3].items():
            tv = tr[3][name].numpy()
            want = jv.T if name.endswith("weight") else jv
            np.testing.assert_allclose(tv, want, err_msg=f"{i} {name}",
                                       **TOL)
        if INF_AT.get(i):                  # a skipped step moved nothing
            prev = trows[i - 1][3] if i else None
            for name in (n for n in tr[3] if n.startswith("b.")):
                if prev is not None:
                    assert torch.equal(tr[3][name], prev[name]), (i, name)


def test_explicit_unscale_then_step_unscales_once():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.Momentum(learning_rate=1.0, momentum=0.0,
                             parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    scaler.scale((p * torch.tensor([1.0, 2.0, 3.0])).sum()).backward()
    scaler.unscale_(opt)
    torch.testing.assert_close(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    scaler.step(opt)              # no second division
    torch.testing.assert_close(p.detach(), torch.tensor([0.0, -1.0, -2.0]))
    scaler.update()
    assert opt._step_count == 1


def test_minimize_state_dict_and_disabled_scaler():
    p = torch.nn.Parameter(torch.ones(2))
    opt = optimizer.Momentum(learning_rate=0.5, momentum=0.0,
                             parameters=[p])
    scaler = amp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=1)
    scaler.scale(p.sum()).backward()
    scaler.minimize(opt, None)
    assert scaler.get_loss_scaling() == 8.0 and opt._step_count == 1
    fresh = amp.GradScaler()
    fresh.load_state_dict(scaler.state_dict())
    assert fresh.state_dict() == {"scale": 8.0, "good_steps": 0,
                                  "bad_steps": 0}
    off = amp.GradScaler(enable=False)
    loss = p.sum()
    assert off.scale(loss) is loss and not off.is_enable()
    p.grad = torch.full((2,), float("inf"))
    off.step(opt)                  # passes through: steps even on inf
    assert opt._step_count == 2
    with pytest.raises(KeyError):
        fresh.load_state_dict({})
