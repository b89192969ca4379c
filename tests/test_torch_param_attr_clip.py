"""`ParamAttr` and the per-tensor clips against the JAX package's, on the
CPU.

`framework.ParamAttr.apply_to` stamps `optimize_attr` on a Parameter and
the optimizer folds it in (`paddle_tpu/optimizer/optimizer.py:49-69`):
the learning-rate factor multiplies the group coefficient, a
per-parameter regularizer overrides the global decay where the group
sets none, `need_clip=False` keeps a gradient out of the clip
(`:192-199`), `trainable=False` freezes the parameter and `name` names
it in the state dict.  `nn.ClipGradByNorm` / `ClipGradByValue`
(`paddle_tpu/nn/clip.py:26-45`) clip in each gradient's own dtype.

Inputs are made with numpy from a seed and set as both sides' `.grad`.
Tolerances: float32 updates 1e-6 (rtol and atol), as
tests/test_torch_optimizer_state.py states; clipped bfloat16 gradients
within one bfloat16 unit of the JAX package's (2**-7 relative), since
the norm is summed in another order before it rounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework.param_attr import ParamAttr as JaxParamAttr
from paddle_tpu.nn import clip as jclip
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import ParamAttr, optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(6, 5), (5,), (3, 4)]
LR = 1e-2


def _data(steps, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32)
              for s in SHAPES] for _ in range(steps)]
    return p0, grads


def _run(torch_side, cls, p0, grads, attrs, **kw):
    """`steps` eager steps with `attrs[i]` (a dict of ParamAttr keywords,
    or None) applied to parameter i; returns (params as numpy, opt)."""
    if torch_side:
        params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                  for p in p0]
        Attr, mod = ParamAttr, topt
        tensor = (lambda g: torch.from_numpy(g.copy()))
    else:
        params = [pt.to_tensor(p, stop_gradient=False) for p in p0]
        Attr, mod = JaxParamAttr, pt.optimizer
        tensor = pt.to_tensor
    for p, a in zip(params, attrs):
        if a is not None:
            Attr(**a).apply_to(p)
    opt = getattr(mod, cls)(parameters=params, learning_rate=LR, **kw)
    for gs in grads:
        for p, g in zip(params, gs):
            if p.stop_gradient if not torch_side else not p.requires_grad:
                continue
            p.grad = tensor(g)
        opt.step()
        opt.clear_grad()
    values = [p.detach().numpy().copy() if torch_side
              else np.asarray(p._array) for p in params]
    return values, opt


def _both(cls, attrs, grads_scale=1.0, torch_kw=None, jax_kw=None,
          steps=3):
    p0, grads = _data(steps, scale=grads_scale)
    t, topt_ = _run(True, cls, p0, grads, attrs, **(torch_kw or {}))
    j, jopt = _run(False, cls, p0, grads, attrs, **(jax_kw or {}))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **TOL)
    return t, topt_, p0


@pytest.mark.parametrize("cls", ["SGD", "Adam", "AdamW", "Momentum"])
@pytest.mark.parametrize("factor", [0.0, 0.5, 3.0])
def test_learning_rate_factor_matches_jax(cls, factor):
    """ParamAttr(learning_rate=f) multiplies the rate of that parameter
    alone; a factor 0 leaves it where it was."""
    t, opt, p0 = _both(cls, [dict(learning_rate=factor), None, None])
    assert opt._lr_scales == [factor, 1.0, 1.0]
    if factor == 0.0:
        np.testing.assert_array_equal(t[0], p0[0])


def test_learning_rate_factor_composes_with_a_group_coefficient():
    p0, grads = _data(3, seed=1)

    def run(torch_side):
        if torch_side:
            ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
            ParamAttr(learning_rate=0.5).apply_to(ps[0])
            mk, tensor = topt.Adam, (lambda g: torch.from_numpy(g.copy()))
        else:
            ps = [pt.to_tensor(p, stop_gradient=False) for p in p0]
            JaxParamAttr(learning_rate=0.5).apply_to(ps[0])
            mk, tensor = pt.optimizer.Adam, pt.to_tensor
        opt = mk(learning_rate=LR, parameters=[
            {"params": ps[:2], "learning_rate": 4.0}, {"params": ps[2:]}])
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = tensor(g)
            opt.step()
            opt.clear_grad()
        return opt._lr_scales, [np.asarray(p.detach().numpy() if torch_side
                                           else p._array) for p in ps]

    (ts, tv), (js, jv) = run(True), run(False)
    assert ts == js == [2.0, 4.0, 1.0]
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum"])
@pytest.mark.parametrize("global_wd", [None, 0.01])
def test_regularizer_overrides_the_global_decay(cls, global_wd):
    """ParamAttr(regularizer=L2Decay(c)) sets that parameter's decay
    (coupled in Adam and Momentum, decoupled in AdamW), over the global
    one."""
    kw = {} if global_wd is None else dict(weight_decay=global_wd)
    t, opt, _ = _both(cls, [None, dict(regularizer=0.2), None],
                      torch_kw=kw, jax_kw=kw)
    assert opt._wd_overrides == [None, 0.2, None]


def test_regularizer_objects_of_each_package_agree():
    p0, grads = _data(3, seed=2)
    t, _ = _run(True, "Adam", p0, grads,
                [dict(regularizer=treg.L2Decay(0.3)), None, None])
    j, _ = _run(False, "Adam", p0, grads,
                [dict(regularizer=jreg.L2Decay(0.3)), None, None])
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **TOL)


def test_a_group_decay_wins_over_the_parameter_regularizer():
    p0, grads = _data(2, seed=3)
    for Attr, mod, make in (
            (ParamAttr, topt,
             lambda p: torch.nn.Parameter(torch.from_numpy(p.copy()))),
            (JaxParamAttr, pt.optimizer,
             lambda p: pt.to_tensor(p, stop_gradient=False))):
        ps = [make(p) for p in p0]
        Attr(regularizer=0.7).apply_to(ps[0])
        Attr(regularizer=0.7).apply_to(ps[2])
        opt = mod.Adam(learning_rate=LR, parameters=[
            {"params": ps[:2], "weight_decay": 0.1}, {"params": ps[2:]}])
        assert opt._wd_overrides == [0.1, 0.1, 0.7]


@pytest.mark.parametrize("clip", ["global_norm", "norm", "value"])
@pytest.mark.parametrize("cls", ["SGD", "Adam"])
def test_need_clip_false_keeps_a_gradient_out_of_the_clip(clip, cls):
    """need_clip=False: that gradient is neither clipped nor counted in a
    global norm; the others are, as in the JAX package."""
    make = {"global_norm": (lambda m: m.ClipGradByGlobalNorm(0.5)),
            "norm": (lambda m: m.ClipGradByNorm(0.5)),
            "value": (lambda m: m.ClipGradByValue(0.3))}[clip]
    attrs = [dict(need_clip=False), None, None]
    t, opt, _ = _both(cls, attrs, grads_scale=4.0,
                      torch_kw=dict(grad_clip=make(tnn)),
                      jax_kw=dict(grad_clip=make(jclip)))
    assert opt._need_clip == [False, True, True]
    # against the same run with every gradient clipped: parameter 0 ends
    # elsewhere (its gradient was not clipped)
    p0, grads = _data(3, scale=4.0)
    full, _ = _run(True, cls, p0, grads, [None] * 3,
                   grad_clip=make(tnn))
    assert not np.allclose(t[0], full[0], **TOL)


def test_trainable_false_and_name_match_jax():
    attrs = [dict(trainable=False), dict(name="enc.bias"), None]
    t, topt_, p0 = _both("Adam", attrs)
    np.testing.assert_array_equal(t[0], p0[0])
    _, jopt = _run(False, "Adam", *_data(2, seed=4), attrs)
    assert topt_._param_names[1] == "enc.bias"
    tkeys = {k for k in topt_.state_dict() if k.startswith("enc.bias/")}
    jkeys = {k for k in jopt.state_dict() if k.startswith("enc.bias/")}
    assert tkeys == jkeys == {"enc.bias/moment1", "enc.bias/moment2"}


def test_apply_to_stamps_only_what_differs_from_the_defaults():
    p = torch.nn.Parameter(torch.zeros(3))
    assert ParamAttr().apply_to(p) is p
    assert not hasattr(p, "optimize_attr") and p.requires_grad
    ParamAttr(learning_rate=2.0, need_clip=False,
              regularizer=treg.L2Decay(0.1)).apply_to(p)
    assert set(p.optimize_attr) == {"learning_rate", "need_clip",
                                    "regularizer"}
    j = pt.to_tensor(np.zeros(3, np.float32))
    JaxParamAttr(learning_rate=2.0, need_clip=False,
                 regularizer=jreg.L2Decay(0.1)).apply_to(j)
    assert set(j.optimize_attr) == set(p.optimize_attr)


# ----------------------------------------------------------------- clips
def _grads(dtype, seed=5, scale=3.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [("norm", 1.0), ("norm", 100.0),
                                  ("value", 0.5), ("value", (0.7, -0.2)),
                                  ("global_norm", 1.0)])
def test_clip_matches_jax(clip, dtype):
    """Each clip on the same gradients as the JAX class's `_clip_arrays`,
    in float32 and bfloat16 (the norm clip in the gradient's own dtype,
    the global norm in float32, as the JAX classes take them)."""
    kind, arg = clip
    gs = _grads(dtype)
    if kind == "norm":
        tc, jc = ClipGradByNorm(arg), jclip.ClipGradByNorm(arg)
    elif kind == "value":
        mx, mn = arg if isinstance(arg, tuple) else (arg, None)
        tc, jc = ClipGradByValue(mx, mn), jclip.ClipGradByValue(mx, mn)
    else:
        tc, jc = ClipGradByGlobalNorm(arg), jclip.ClipGradByGlobalNorm(arg)
    t = [torch.from_numpy(g.copy()).to(_TDT[dtype]) for g in gs]
    out = tc.clip_(t)
    assert all(a is b for a, b in zip(out, t))          # in place
    j = jc._clip_arrays([jnp.asarray(g).astype(_JDT[dtype]) for g in gs])
    for a, b in zip(t, j):
        assert a.dtype == _TDT[dtype] and str(b.dtype) == dtype
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, **TOL)
        else:
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)
    if kind == "value":
        mx, mn = arg if isinstance(arg, tuple) else (arg, -arg)
        assert all(x.max() <= torch.tensor(mx, dtype=x.dtype)
                   and x.min() >= torch.tensor(mn, dtype=x.dtype) for x in t)


def test_norm_clip_scales_each_gradient_by_its_own_norm():
    gs = [torch.full((4,), 3.0), torch.full((4,), 0.1)]
    ClipGradByNorm(1.0).clip_(gs)
    np.testing.assert_allclose(float(gs[0].norm()), 1.0, rtol=1e-6)
    np.testing.assert_allclose(gs[1].numpy(), 0.1)     # under the norm
    assert ClipGradByValue(2.0).min == -2.0
    assert ClipGradByNorm(1.0).clip_([None]) == []
