"""The port's incubate package against the JAX package's, on the CPU.

Inputs come from seeded numpy generators.  Each of the seven fused
functions is held to the JAX one, forward and (where it differentiates)
the gradients of every input for a random cotangent, JAX's through its
eager tape; `FusedMultiHeadAttention` and `FusedFeedForward` pre-LN and
post-LN, with and without a mask, with the JAX layer's weights carried
across by `load_paddle_tpu_state`, forward and every gradient;
`LookAhead`'s slow-weight arithmetic over k steps and its state crossing
between the packages in both directions; `ModelAverage`'s mean, apply
and restore.  Dropout is checked on the port alone (JAX's key stream and
torch's generators never draw the same masks).

Tolerances: float32 on both sides, the products and reductions in
another order: values 1e-5 relative, 1e-6 absolute; gradients 1e-4 /
1e-6; the optimizers' parameters 1e-6 / 1e-7.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.incubate as jax_incubate
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch import incubate, optimizer
from paddle_tpu_torch.incubate import LookAhead, ModelAverage
from paddle_tpu_torch.incubate.nn import (FusedFeedForward,
                                          FusedMultiHeadAttention)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.weights import load_paddle_tpu_state

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _compare(jax_fn, port_fn, arrays, seed=99, grad=True):
    """jax_fn and port_fn on the same arrays (None passes through): the
    outputs (a tensor or a tuple with None slots) and, with `grad`, the
    gradients of every array input for random cotangents."""
    jts = [None if a is None else pt.to_tensor(a) for a in arrays]
    tts = [None if a is None else torch.tensor(a, requires_grad=grad)
           for a in arrays]
    for t in jts:
        if t is not None:
            t.stop_gradient = not grad
    jout, tout = jax_fn(*jts), port_fn(*tts)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert [o is None for o in jout] == [o is None for o in tout]
    rng = np.random.default_rng(seed)
    jloss, tloss = 0.0, 0.0
    for jo, to in zip(jout, tout):
        if jo is None:
            continue
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   **VAL_TOL)
        dy = rng.standard_normal(tuple(to.shape)).astype(np.float32)
        jloss = jloss + (jo * pt.to_tensor(dy)).sum()
        tloss = tloss + (to * torch.from_numpy(dy)).sum()
    if not grad:
        return
    jloss.backward()
    tloss.backward()
    for i, (jt, tt) in enumerate(zip(jts, tts)):
        if jt is None:
            continue
        np.testing.assert_allclose(tt.grad.numpy(), jt.grad.numpy(),
                                   err_msg=f"input {i}", **GRAD_TOL)


# ===================================================================
# the fused functions
# ===================================================================
@pytest.mark.parametrize("bias", [False, True])
def test_fused_rms_norm_matches_jax(bias):
    x, w, b = _rand(0, (2, 5, 8), (8,), (8,))
    _compare(lambda x, w, b: JIF.fused_rms_norm(x, w, b, epsilon=1e-5),
             lambda x, w, b: IF.fused_rms_norm(x, w, b, epsilon=1e-5),
             [x, w, b if bias else None])


def test_fused_rms_norm_normalizes_the_last_axis_only():
    x, w = _rand(1, (2, 5, 8), (8,))
    with pytest.raises(NotImplementedError, match="last axis"):
        JIF.fused_rms_norm(pt.to_tensor(x), pt.to_tensor(w),
                           begin_norm_axis=1)
    with pytest.raises(NotImplementedError, match="last axis"):
        IF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                          begin_norm_axis=1)
    IF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                      begin_norm_axis=2)


@pytest.mark.parametrize("axis,wshape", [(-1, (8,)), (1, (5, 8)),
                                         (1, (8,))],
                         ids=["last", "two_axes", "two_axes_broadcast"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_layer_norm_matches_jax(axis, wshape, residual):
    x, r, w, b = _rand(2, (2, 5, 8), (2, 5, 8), wshape, wshape)
    _compare(lambda x, w, b, r: JIF.fused_layer_norm(
                 x, w, b, begin_norm_axis=axis, residual=r),
             lambda x, w, b, r: IF.fused_layer_norm(
                 x, w, b, begin_norm_axis=axis, residual=r),
             [x, w, b, r if residual else None])


def test_swiglu_one_and_two_inputs_match_jax():
    x, a, b = _rand(3, (4, 16), (4, 8), (4, 8))
    _compare(JIF.swiglu, IF.swiglu, [x])
    _compare(JIF.swiglu, IF.swiglu, [a, b])
    torch.testing.assert_close(IF.swiglu(torch.from_numpy(x)),
                               IF.swiglu(*torch.from_numpy(x).chunk(2, -1)))


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("angles", ["default", "sin_cos", "position_ids"])
@pytest.mark.parametrize("slots", ["q", "qk", "qkv", "qv"])
def test_fused_rotary_position_embedding_matches_jax(neox, angles, slots):
    b, s, h, d = 2, 6, 3, 8
    q, k, v = _rand(4, (b, s, h, d), (b, s, h, d), (b, s, h, d))
    arrays = [q, k if "k" in slots else None, v if "v" in slots else None]
    extra = {}
    if angles == "sin_cos":
        ang = np.arange(s)[:, None] * (
            1.0 / 500.0 ** (np.arange(0, d, 2) / d))[None, :]
        extra = dict(sin=np.sin(ang).astype(np.float32),
                     cos=np.cos(ang).astype(np.float32))
    elif angles == "position_ids":
        extra = dict(position_ids=np.array([[3, 4, 5, 6, 7, 8],
                                            [0, 2, 4, 6, 8, 10]]))

    def call(lib, fn):
        kw = {n: lib(a) for n, a in extra.items()}
        return lambda q, k, v: fn(q, k, v, use_neox_rotary_style=neox,
                                  rotary_emb_base=500.0, **kw)

    _compare(call(pt.to_tensor, JIF.fused_rotary_position_embedding),
             call(torch.from_numpy, IF.fused_rotary_position_embedding),
             arrays)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_linear_matches_jax(transpose, bias):
    x, w, b = _rand(5, (3, 4), (5, 4) if transpose else (4, 5), (5,))
    _compare(lambda x, w, b: JIF.fused_linear(x, w, b,
                                              transpose_weight=transpose),
             lambda x, w, b: IF.fused_linear(x, w, b,
                                             transpose_weight=transpose),
             [x, w, b if bias else None])


@pytest.mark.parametrize("p,training,mode", [
    (0.0, True, "upscale_in_train"), (0.5, False, "upscale_in_train"),
    (0.3, False, "downscale_in_infer")])
def test_fused_dropout_add_without_draws_matches_jax(p, training, mode):
    x, y = _rand(6, (3, 8), (3, 8))
    _compare(lambda x, y: JIF.fused_dropout_add(x, y, p, training, mode),
             lambda x, y: IF.fused_dropout_add(x, y, p, training, mode),
             [x, y])


@pytest.mark.parametrize("bias,ln", [(False, False), (True, True),
                                     (True, False)])
@pytest.mark.parametrize("rate,training", [(0.0, True), (0.4, False)])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(bias, ln, rate,
                                                            training):
    x, r, b, s, lb = _rand(7, (2, 3, 8), (2, 3, 8), (8,), (8,), (8,))

    def call(fn):
        return lambda x, r, b, s, lb: fn(
            x, r, b, ln_scale=s, ln_bias=lb, dropout_rate=rate,
            epsilon=1e-5, training=training)

    _compare(call(JIF.fused_bias_dropout_residual_layer_norm),
             call(IF.fused_bias_dropout_residual_layer_norm),
             [x, r, b if bias else None, s if ln else None,
              lb if ln else None])


def test_fused_dropouts_draw_from_the_generator():
    """With p > 0 in training each keeps, upscaled, what a dropout of the
    same generator state keeps; the same seed gives the same mask."""
    from paddle_tpu_torch.nn import functional as PF
    x, y = (torch.from_numpy(a) for a in _rand(8, (64, 32), (64, 32)))
    g = torch.Generator().manual_seed(3)
    got = IF.fused_dropout_add(x, y, p=0.25, generator=g)
    want = PF.dropout(x, 0.25, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, want + y)
    kept = (want != 0).float().mean()
    assert 0.7 < float(kept) < 0.8
    out = IF.fused_bias_dropout_residual_layer_norm(
        x, y, dropout_rate=0.25, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(out, torch.nn.functional.layer_norm(
        want + y, (32,)))


# ===================================================================
# the fused layers
# ===================================================================
def _layer_pair(jax_cls, port_cls, *args, **kw):
    pt.seed(0)
    jl = jax_cls(*args, **kw)
    tl = port_cls(*args, **kw, device="cpu")
    load_paddle_tpu_state(tl, {k: np.asarray(v)
                               for k, v in jl.state_dict().items()})
    return jl, tl


def _layer_grads(jl, tl, x, call):
    """The layers' outputs on x, and the gradients of x and of every
    parameter for one random cotangent."""
    jx = pt.to_tensor(x)
    jx.stop_gradient = False
    tx = torch.tensor(x, requires_grad=True)
    jo, to = call(jl, jx), call(tl, tx)
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **VAL_TOL)
    dy = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)
    (jo * pt.to_tensor(dy)).sum().backward()
    (to * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **GRAD_TOL)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n].grad.numpy(),
                                   err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_fused_multi_head_attention_matches_jax(pre, mask):
    jl, tl = _layer_pair(jax_incubate.nn.FusedMultiHeadAttention,
                         FusedMultiHeadAttention, 32, 4, dropout_rate=0.0,
                         attn_dropout_rate=0.0, normalize_before=pre)
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == {
        "qkv_weight": (32, 96), "qkv_bias": (96,), "linear_weight": (32, 32),
        "linear_bias": (32,), "ln_scale": (32,), "ln_bias": (32,)}
    (x,) = _rand(12, (2, 6, 32))
    m = None
    if mask is not None:
        keep = np.tril(np.ones((6, 6), bool))[None, None].repeat(2, 0)
        keep[1, :, :, 4:] = False
        keep[1, :, 4:, :] = np.tril(np.ones((2, 6), bool), 4)
        m = keep if mask == "bool" else np.where(keep, 0.0, -1e9).astype(
            np.float32)

    def call(layer, t):
        if m is None:
            return layer(t)
        conv = pt.to_tensor if isinstance(t, pt.Tensor) else torch.from_numpy
        return layer(t, attn_mask=conv(m))

    _layer_grads(jl, tl, x, call)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feed_forward_matches_jax(pre, act):
    jl, tl = _layer_pair(jax_incubate.nn.FusedFeedForward, FusedFeedForward,
                         32, 64, dropout_rate=0.0, activation=act,
                         normalize_before=pre)
    assert {n: tuple(p.shape) for n, p in tl.named_parameters()} == {
        "linear1_weight": (32, 64), "linear1_bias": (64,),
        "linear2_weight": (64, 32), "linear2_bias": (32,),
        "ln_scale": (32,), "ln_bias": (32,)}
    (x,) = _rand(13, (2, 5, 32))
    _layer_grads(jl, tl, x, lambda layer, t: layer(t))


def test_fused_layers_initialise_as_the_reference():
    """Xavier-uniform weights within sqrt(6 / (fan_in + fan_out)), zero
    biases, unit norm scales; the same generator seed, the same draw;
    dropout in training draws from the layer's generator."""
    g = torch.Generator().manual_seed(0)
    attn = FusedMultiHeadAttention(64, 4, device="cpu", generator=g)
    ffn = FusedFeedForward(64, 256, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    for w, (fi, fo) in ((attn.qkv_weight, (64, 192)),
                        (attn.linear_weight, (64, 64)),
                        (ffn.linear1_weight, (64, 256)),
                        (ffn.linear2_weight, (256, 64))):
        limit = (6.0 / (fi + fo)) ** 0.5
        assert float(w.detach().abs().max()) <= limit
        assert float(w.detach().std()) == pytest.approx(limit / 3 ** 0.5,
                                                        rel=0.1)
    assert not attn.qkv_bias.any() and bool((attn.ln_scale == 1).all())
    again = FusedFeedForward(64, 256, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.linear1_weight, ffn.linear1_weight)
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(1))
    outs = []
    for _ in range(2):
        ffn.generator = torch.Generator().manual_seed(4)
        outs.append(ffn(x))
    torch.testing.assert_close(outs[0], outs[1])
    ffn.eval()
    assert not torch.equal(ffn(x), outs[0])


def test_incubate_exports_the_jax_names():
    """Everything `paddle_tpu.incubate` and its `nn` export, the port
    exports (`group_sharded_parallel` belongs to A11 and is not among
    them)."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(jax_incubate) - {"annotations"} <= public(incubate)
    assert public(jax_incubate.nn) - {"annotations"} <= public(incubate.nn)
    assert public(JIF) - {"annotations", "jax", "jnp", "engine", "F",
                          "Tensor"} <= public(IF)


# ===================================================================
# LookAhead and ModelAverage
# ===================================================================
def _jax_param(value):
    p = pt.to_tensor(np.array(value, np.float32))
    p.stop_gradient = False
    return p


def _port_param(value):
    return torch.nn.Parameter(torch.tensor(np.array(value, np.float32)))


W0 = [[4.0, -3.0, 0.5], [1.5, 2.0, -1.0]]
TARGET = np.array([[1.0, 0.0, -2.0]], np.float32).T


def _jax_loss(w):
    return ((w.matmul(pt.to_tensor(TARGET)) - 1.0) ** 2).sum() + \
        (w ** 2).sum() * 0.1


def _port_loss(w):
    return ((w @ torch.from_numpy(TARGET) - 1.0) ** 2).sum() + \
        w.square().sum() * 0.1


def _jax_lookahead(steps, k, alpha=0.5, state=None):
    w = _jax_param(W0)
    opt = jax_incubate.LookAhead(
        pt.optimizer.Momentum(learning_rate=0.05, parameters=[w]),
        alpha=alpha, k=k)
    if state is not None:
        w.set_value(state.pop("w"))
        opt.set_state_dict(state)
    for _ in range(steps):
        opt.minimize(_jax_loss(w))
    return w, opt


def _port_lookahead(steps, k, alpha=0.5, state=None):
    w = _port_param(W0)
    opt = LookAhead(optimizer.Momentum(learning_rate=0.05, parameters=[w]),
                    alpha=alpha, k=k)
    if state is not None:
        with torch.no_grad():
            w.copy_(torch.tensor(state.pop("w")))
        opt.set_state_dict(state)
    for _ in range(steps):
        opt.minimize(_port_loss(w))
    return w, opt


@pytest.mark.parametrize("steps,k", [(1, 1), (3, 3), (7, 3), (10, 5)])
def test_lookahead_matches_jax(steps, k):
    jw, jopt = _jax_lookahead(steps, k)
    tw, topt = _port_lookahead(steps, k)
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), **OPT_TOL)
    assert topt._steps == jopt._steps == steps


def test_lookahead_slow_weight_arithmetic():
    """After k fast steps from w0 the weights are w0 + alpha (fast - w0);
    the slow weights start there for the next k."""
    w = _port_param([1.0, -2.0])
    inner = optimizer.SGD(learning_rate=0.1, parameters=[w])
    opt = LookAhead(inner, alpha=0.25, k=2)
    fast = w0 = np.array([1.0, -2.0], np.float32)
    for _ in range(2):
        fast = fast - np.float32(0.1) * 2 * fast    # the gradient of w**2
        opt.minimize(w.square().sum())
    np.testing.assert_allclose(w.detach().numpy(),
                               w0 + 0.25 * (fast - w0), **OPT_TOL)
    np.testing.assert_array_equal(opt.state_dict()["__lookahead__/slow0"],
                                  w.detach().numpy())
    with pytest.raises(ValueError, match="alpha"):
        LookAhead(inner, alpha=1.5)
    with pytest.raises(ValueError, match="k"):
        LookAhead(inner, k=0)
    assert opt.get_lr() == 0.1


def test_lookahead_state_crosses_between_the_packages():
    """A JAX LookAhead's state after 4 steps (k 3: one sync behind it,
    the inner Momentum's velocity beside it) carried into the port, and
    the port's into JAX, each then takes 4 more steps to where 8
    uninterrupted JAX steps go."""
    want, _ = _jax_lookahead(8, 3)
    jw, jopt = _jax_lookahead(4, 3)
    jstate = {k: np.asarray(v.numpy()) if isinstance(v, pt.Tensor) else v
              for k, v in jopt.state_dict().items()}
    assert set(jstate) == {"step", "param_0/velocity", "__lookahead__/slow0",
                           "__lookahead__/steps"}
    tw, topt = _port_lookahead(4, 3, state=dict(jstate, w=jw.numpy()))
    np.testing.assert_allclose(tw.detach().numpy(), want.numpy(), **OPT_TOL)

    tw, topt = _port_lookahead(4, 3)
    tstate = {k: v.numpy() if isinstance(v, torch.Tensor) else v
              for k, v in topt.state_dict().items()}
    assert set(tstate) == set(jstate)
    jw, _ = _jax_lookahead(4, 3, state=dict(tstate,
                                            w=tw.detach().numpy()))
    np.testing.assert_allclose(jw.numpy(), want.numpy(), **OPT_TOL)


def test_model_average_matches_jax():
    jw, tw = _jax_param(W0), _port_param(W0)
    jopt = pt.optimizer.SGD(learning_rate=0.3, parameters=[jw])
    topt = optimizer.SGD(learning_rate=0.3, parameters=[tw])
    jma = jax_incubate.ModelAverage(parameters=[jw])
    tma = ModelAverage(parameters=[tw])
    for _ in range(5):
        jopt.minimize(_jax_loss(jw))
        topt.minimize(_port_loss(tw))
        jma.step()
        tma.step()
    current = tw.detach().clone()
    jma.apply()
    tma.apply()
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), **OPT_TOL)
    tma.restore()
    assert torch.equal(tw.detach(), current)
    with pytest.raises(RuntimeError, match="apply"):
        tma.restore()
    tma.apply(need_restore=False)
    with pytest.raises(RuntimeError, match="apply"):
        tma.restore()
    with pytest.raises(ValueError, match="parameters"):
        ModelAverage()
