"""The port's optimizers against the JAX package's update rules, on the CPU.

Single parameters, their gradients for several steps made with numpy from
a seed, go through the JAX optimizer's functional `update` and through the
port's optimizer (`.grad` set, `update(lr, step)` in place).  Covered:
Adam with coupled decay, AdamW with decoupled decay and
`apply_decay_param_fun`, Adafactor factored and unfactored and with
`beta1`, Adafactor on a Linear weight (the JAX layout [in, out] against
torch's [out, in]), float32 master weights of a bfloat16 parameter,
`ClipGradByGlobalNorm`, and parameter groups (a group's rate coefficient
and decay override, with `apply_decay_param_fun`).

Tolerance: both sides compute in float32 with the same formulas; the
scalar bias corrections are float32 powers on both sides, which may differ
in the last place: rtol 2e-6, atol 1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

TOL = dict(rtol=2e-6, atol=1e-7)
STEPS = 4


def _run(jax_cls, torch_cls, shape, kw, transpose=False, name="w",
         dtype=np.float32, lr=1e-2, seed=0):
    """Both optimizers on one parameter for STEPS steps.  With
    `transpose`, the port's parameter and grads are the JAX ones
    transposed (a Linear weight).  Returns (jax param, jax state, port
    param, port slots) after the last step."""
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(STEPS)]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    jp = jnp.asarray(p0).astype(jdt)
    jopt = jax_cls(learning_rate=lr, parameters=[pt.to_tensor(p0)], **kw)
    jopt._param_names = [name]
    jstate = jopt.init_state([jp])

    tp = torch.nn.Parameter(torch.from_numpy(p0.T.copy() if transpose
                                             else p0).to(tdt))
    tw = torch_cls(learning_rate=lr, parameters=[tp], **kw)
    tw._param_names = [name]
    for i, g in enumerate(grads, start=1):
        [jp], jstate = jopt.update([jnp.asarray(g).astype(jdt)], [jp],
                                   jstate, jnp.float32(lr), jnp.float32(i))
        tp.grad = torch.from_numpy(g.T.copy() if transpose else g).to(tdt)
        tw.update(lr, i)
    return np.asarray(jp.astype(jnp.float32)), jstate[0], \
        tp.detach().float().numpy(), tw._state[0]


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adam_matches_jax(wd):
    jp, js, tp, ts = _run(pt.optimizer.Adam, topt.Adam, (6, 5),
                          dict(weight_decay=wd))
    np.testing.assert_allclose(tp, jp, **TOL)
    for s in ("moment1", "moment2"):
        np.testing.assert_allclose(ts[s].numpy(), np.asarray(js[s]), **TOL)


@pytest.mark.parametrize("decayed", [True, False])
def test_adamw_decoupled_decay_and_decay_fun(decayed):
    kw = dict(weight_decay=0.1,
              apply_decay_param_fun=lambda n: n.endswith("weight"))
    name = "fc.weight" if decayed else "fc.bias"
    jp, _, tp, _ = _run(pt.optimizer.AdamW, topt.AdamW, (7,), kw, name=name)
    np.testing.assert_allclose(tp, jp, **TOL)
    # and the decay really applied (or not): against no decay at all
    jp0, _, _, _ = _run(pt.optimizer.AdamW, topt.AdamW, (7,),
                        dict(weight_decay=0.0), name=name)
    assert (not np.allclose(jp, jp0)) == decayed


@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum"])
def test_parameter_groups_match_jax(cls):
    """Three parameters in two groups: the first group at the global rate
    and decay; the second at 0.3 x the rate with its own decay 0.05, one
    of its names refused by apply_decay_param_fun.  STEPS updates of the
    JAX functional rule (lr_scales / wd_overrides from the groups)
    against the port's in-place update."""
    rng = np.random.default_rng(3)
    shapes = [(5, 4), (4,), (3, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]
    names = ["w", "b", "skip.w"]
    kw = dict(weight_decay=0.1,
              apply_decay_param_fun=lambda n: not n.startswith("skip"))
    if cls == "Momentum":
        kw = dict(kw, momentum=0.9)

    def groups(ps):
        return [{"params": ps[:1]},
                {"params": ps[1:], "learning_rate": 0.3,
                 "weight_decay": 0.05}]

    jps = [pt.to_tensor(p) for p in p0]
    jopt = getattr(pt.optimizer, cls)(learning_rate=0.01,
                                      parameters=groups(jps), **kw)
    jopt._param_names = names
    jarr = [jnp.asarray(p) for p in p0]
    jstate = jopt.init_state(jarr)
    tps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt_ = getattr(topt, cls)(learning_rate=0.01, parameters=groups(tps),
                               **kw)
    topt_._param_names = names
    assert topt_._lr_scales == [1.0, 0.3, 0.3]
    assert topt_._wd_overrides == [None, 0.05, 0.05]
    for i, gs in enumerate(grads, start=1):
        jarr, jstate = jopt.update([jnp.asarray(g) for g in gs], jarr,
                                   jstate, jnp.float32(0.01), jnp.float32(i))
        for p, g in zip(tps, gs):
            p.grad = torch.from_numpy(g)
        topt_.update(0.01, i)
    for n, jp, tp in zip(names, jarr, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("case", ["factored", "unfactored", "beta1",
                                  "stacked"])
def test_adafactor_matches_jax(case):
    shape = {"factored": (6, 5), "unfactored": (9,), "beta1": (4, 8),
             "stacked": (3, 4, 5)}[case]
    kw = dict(beta1=0.9) if case == "beta1" else {}
    jp, js, tp, ts = _run(pt.optimizer.Adafactor, topt.Adafactor, shape, kw)
    np.testing.assert_allclose(tp, jp, **TOL)
    assert sorted(ts) == sorted(js)
    for s in ts:
        np.testing.assert_allclose(ts[s].numpy(), np.asarray(js[s]), **TOL)


def test_adafactor_on_a_transposed_linear_weight():
    """torch keeps the weight [out, in] where JAX keeps [in, out]: the
    update is the same (transposed), and the port's vr / vc are the JAX
    vc / vr."""
    jp, js, tp, ts = _run(pt.optimizer.Adafactor, topt.Adafactor, (6, 5),
                          {}, transpose=True)
    np.testing.assert_allclose(tp, jp.T, **TOL)
    np.testing.assert_allclose(ts["vr"].numpy(), np.asarray(js["vc"]), **TOL)
    np.testing.assert_allclose(ts["vc"].numpy(), np.asarray(js["vr"]), **TOL)


@pytest.mark.parametrize("cls", ["Adam", "Adafactor"])
def test_master_weights_of_a_bf16_parameter(cls):
    jp, js, tp, ts = _run(getattr(pt.optimizer, cls), getattr(topt, cls),
                          (6, 5), dict(multi_precision=True), dtype="bf16")
    np.testing.assert_allclose(ts["master"].numpy(), np.asarray(js["master"]),
                               **TOL)
    # the parameter is the master rounded to bfloat16 on both sides
    np.testing.assert_array_equal(tp, jp)


def test_no_master_without_multi_precision():
    p = torch.nn.Parameter(torch.zeros(3, 4, dtype=torch.bfloat16))
    opt = topt.Adafactor(parameters=[p])
    assert "master" not in opt.init_state()[0]


def test_clip_grad_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 5), (7,), (2, 3, 2))]
    want = JaxClip(1.5)._clip_arrays([jnp.asarray(g) for g in grads])
    got = ClipGradByGlobalNorm(1.5).clip_([torch.from_numpy(g.copy())
                                           for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # under the norm: unchanged
    small = [torch.from_numpy(g / 100) for g in grads]
    before = [g.clone() for g in small]
    ClipGradByGlobalNorm(1.5).clip_(small)
    for a, b in zip(small, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_step_clips_then_updates_and_clear_grad():
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32) * 10
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = topt.Adam(learning_rate=0.1, parameters=[p],
                    grad_clip=ClipGradByGlobalNorm(1.0))
    p.grad = torch.from_numpy(g.copy())
    opt.step()
    jopt = pt.optimizer.Adam(learning_rate=0.1,
                             parameters=[pt.to_tensor(p0)],
                             grad_clip=JaxClip(1.0))
    st = jopt.init_state([jnp.asarray(p0)])
    [jg] = jopt._clip_grad_arrays([jnp.asarray(g)])
    [jp], _ = jopt.update([jg], [jnp.asarray(p0)], st, jnp.float32(0.1),
                          jnp.float32(1))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), **TOL)
    assert opt._step_count == 1
    opt.clear_grad()
    assert p.grad is None
    assert opt.get_lr() == 0.1



def test_parameter_unfrozen_after_init_raises_until_rebuilt():
    """A parameter frozen when the slots were made and unfrozen later has
    no slots: the update raises a RuntimeError naming it (the reference
    raises a bare KeyError from its rule), and `init_state()` after
    unfreezing makes its slots."""
    rng = np.random.default_rng(3)
    a, b = (torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((4, 3)).astype(np.float32))) for _ in range(2))
    b.requires_grad_(False)
    opt = topt.AdamW(learning_rate=0.1, parameters=[a, b])
    opt._param_names = ["a", "b"]
    a.grad = torch.ones_like(a)
    opt.step()
    b.requires_grad_(True)
    a.grad, b.grad = torch.ones_like(a), torch.ones_like(b)
    frozen = b.detach().clone()
    with pytest.raises(RuntimeError, match="'b'.*init_state"):
        opt.step()
    assert torch.equal(b.detach(), frozen)
    opt.init_state()
    opt.step()
    assert not torch.equal(b.detach(), frozen)
