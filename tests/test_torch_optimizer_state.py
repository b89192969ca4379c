"""The port's optimizer API against the JAX package's, on the CPU: decay
given as `regularizer.L2Decay` / `L1Decay`, the keywords the JAX
optimizers take and ignore, checkpoints (`state_dict` /
`set_state_dict`) crossing between the packages, and `minimize`.

Both packages run eager steps: the same float32 parameters and
gradients, made with numpy from a seed, set as each side's `.grad` and
stepped.  Tolerance: both compute the same float32 formulas; the JAX
side fuses them under jit and rounds its bias corrections in another
order, so parameters agree within 1e-6 (rtol and atol).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(6, 5), (5,), (3, 4)]
LR = 1e-2


def _data(steps, seed=0):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return p0, grads


def _groups(params, wd_first, wd_rest):
    return [{"params": params[:1], "weight_decay": wd_first},
            {"params": params[1:], "weight_decay": wd_rest}]


def _jax_opt(cls, p0, groups=None, **kw):
    params = [pt.to_tensor(p, stop_gradient=False) for p in p0]
    opt = cls(parameters=groups(params) if groups else params, **kw)
    return params, opt


def _torch_opt(cls, p0, groups=None, **kw):
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = cls(parameters=groups(params) if groups else params, **kw)
    return params, opt


def _steps(params, opt, grads, tensor, sched=None):
    """Set each step's gradients, step, clear; step the scheduler."""
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = tensor(g)
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()


def _jax_values(params):
    return [np.asarray(p._array) for p in params]


def _torch_values(params):
    return [p.detach().numpy().copy() for p in params]


def _jax_steps(params, opt, grads, sched=None):
    _steps(params, opt, grads, pt.to_tensor, sched)


def _torch_steps(params, opt, grads, sched=None):
    _steps(params, opt, grads, lambda g: torch.from_numpy(g.copy()), sched)


def _close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **TOL)


# ------------------------------------------------------------------- C4
@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum"])
@pytest.mark.parametrize("where", ["global", "group"])
def test_l2decay_matches_jax_and_a_float(cls, where):
    """weight_decay=L2Decay(c), global or a group's, gives the JAX
    package's parameters after 3 steps and the same bits as the float c."""
    p0, grads = _data(3)

    def kw(reg):
        if where == "global":
            return dict(weight_decay=reg(0.01)), None
        return {}, lambda ps: _groups(ps, reg(0.02), reg(0.0))

    jkw, jgroups = kw(jreg.L2Decay)
    jp, jopt = _jax_opt(getattr(pt.optimizer, cls), p0, jgroups,
                        learning_rate=LR, **jkw)
    _jax_steps(jp, jopt, grads)
    tkw, tgroups = kw(treg.L2Decay)
    tp, tw = _torch_opt(getattr(topt, cls), p0, tgroups, learning_rate=LR,
                        **tkw)
    _torch_steps(tp, tw, grads)
    _close(_torch_values(tp), _jax_values(jp))
    fkw, fgroups = kw(float)
    fp, fw = _torch_opt(getattr(topt, cls), p0, fgroups, learning_rate=LR,
                        **fkw)
    _torch_steps(fp, fw, grads)
    for a, b in zip(_torch_values(tp), _torch_values(fp)):
        assert np.array_equal(a, b)
    # and the decay took effect: a run without it ends elsewhere
    np_, nw = _torch_opt(getattr(topt, cls), p0, None, learning_rate=LR,
                         weight_decay=0.0)
    _torch_steps(np_, nw, grads)
    assert not np.array_equal(_torch_values(tp)[0], _torch_values(np_)[0])


@pytest.mark.parametrize("where", ["global", "group"])
def test_l1decay_raises_like_jax(where):
    p0, _ = _data(0)
    for cls, reg, make in ((pt.optimizer.AdamW, jreg.L1Decay, _jax_opt),
                           (topt.AdamW, treg.L1Decay, _torch_opt)):
        kw = dict(weight_decay=reg(0.01)) if where == "global" else {}
        groups = None if where == "global" else \
            (lambda ps, reg=reg: _groups(ps, reg(0.01), None))
        with pytest.raises(NotImplementedError, match="L1Decay"):
            make(cls, p0, groups, learning_rate=LR, **kw)


@pytest.mark.parametrize("case", ["name", "set_to_zero", "clear_gradients",
                                  "lr_ratio", "lazy_mode", "group_name"])
def test_ignored_keywords_are_taken_and_change_nothing(case):
    """Each keyword the JAX optimizers take without effect is taken here
    too, and the updates equal a run without it (bit for bit) and the JAX
    package's with it (within 1e-6)."""
    p0, grads = _data(3, seed=1)
    cls = "Adam" if case == "lazy_mode" else "AdamW"
    kw = {"name": dict(name="opt"), "lr_ratio": dict(lr_ratio=0.5),
          "lazy_mode": dict(lazy_mode=True)}.get(case, {})

    def run(torch_side, with_kw):
        mod = topt if torch_side else pt.optimizer
        make = _torch_opt if torch_side else _jax_opt
        clip = (ClipGradByGlobalNorm if torch_side else JaxClip)(
            1.0, **(dict(group_name="enc") if with_kw and
                    case == "group_name" else {}))
        params, opt = make(getattr(mod, cls), p0, None, learning_rate=LR,
                           grad_clip=clip, **(kw if with_kw else {}))
        tensor = (lambda g: torch.from_numpy(g.copy())) if torch_side \
            else pt.to_tensor
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad = tensor(g)
            opt.step()
            if with_kw and case == "set_to_zero":
                opt.clear_grad(set_to_zero=True)
            elif with_kw and case == "clear_gradients":
                opt.clear_gradients()
            else:
                opt.clear_grad()
            if with_kw and case in ("set_to_zero", "clear_gradients"):
                assert all(p.grad is None for p in params)
        return (_torch_values if torch_side else _jax_values)(params)

    port = run(True, True)
    for a, b in zip(port, run(True, False)):
        assert np.array_equal(a, b)
    _close(port, run(False, True))


# ------------------------------------------------------------------- C5
def _sched(mod):
    return mod.LinearWarmup(mod.StepDecay(LR, step_size=2, gamma=0.5),
                            warmup_steps=2, start_lr=0.0, end_lr=LR)


def _numpy_state(state):
    """A state dict with every tensor as a numpy array, as a checkpoint
    carries it between the packages."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().numpy().copy()
        elif hasattr(v, "_array"):
            out[k] = np.asarray(v._array)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_dict_crosses_the_packages(direction):
    """3 AdamW steps under a scheduler in one package, its state dict
    through numpy into the other package's optimizer (over the
    parameters as they stand), 3 more steps there: the parameters match
    6 unbroken steps of the second package.  Keys equal the JAX
    package's."""
    p0, grads = _data(6, seed=2)
    src_torch = direction == "torch_to_jax"
    src = (topt, tlr, _torch_opt, _torch_steps, _torch_values) if src_torch \
        else (pt.optimizer, jlr, _jax_opt, _jax_steps, _jax_values)
    dst = (pt.optimizer, jlr, _jax_opt, _jax_steps, _jax_values) \
        if src_torch else (topt, tlr, _torch_opt, _torch_steps,
                           _torch_values)

    mod, lrmod, make, steps, values = src
    sched = _sched(lrmod)
    params, opt = make(mod.AdamW, p0, None, learning_rate=sched,
                       weight_decay=0.01)
    steps(params, opt, grads[:3], sched)
    state = _numpy_state(opt.state_dict())
    mid = values(params)

    mod, lrmod, make, steps, values = dst
    sched2 = _sched(lrmod)
    params2, opt2 = make(mod.AdamW, mid, None, learning_rate=sched2,
                         weight_decay=0.01)
    opt2.set_state_dict(state)
    assert opt2._step_count == 3
    assert sched2.last_epoch == sched.last_epoch
    steps(params2, opt2, grads[3:], sched2)

    sched3 = _sched(lrmod)
    params3, opt3 = make(mod.AdamW, p0, None, learning_rate=sched3,
                         weight_decay=0.01)
    steps(params3, opt3, grads, sched3)
    _close(values(params2), values(params3))
    assert set(opt2.state_dict()) == set(opt3.state_dict()) == set(state)
    assert {"step", "LR_Scheduler", "param_0/moment1",
            "param_2/moment2"} <= set(state)


def test_state_dict_keys_equal_the_jax_packages():
    p0, grads = _data(1)
    jp, jopt = _jax_opt(pt.optimizer.Adam, p0, None, learning_rate=LR)
    tp, tw = _torch_opt(topt.Adam, p0, None, learning_rate=LR)
    assert set(tw.state_dict()) == set(jopt.state_dict()) == {"step"}
    _jax_steps(jp, jopt, grads)
    _torch_steps(tp, tw, grads)
    js, ts = jopt.state_dict(), tw.state_dict()
    assert set(ts) == set(js) and ts["step"] == js["step"] == 1
    for k in ts:
        if k != "step":
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(
                js[k]._array), **TOL)


def test_set_state_dict_on_a_fresh_optimizer_restores_a_run():
    """A checkpoint taken after 3 steps and loaded into a new optimizer
    over the saved parameters continues bit for bit."""
    p0, grads = _data(6, seed=3)
    tp, tw = _torch_opt(topt.AdamW, p0, None, learning_rate=LR)
    _torch_steps(tp, tw, grads[:3])
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in tw.state_dict().items()}
    mid = _torch_values(tp)
    _torch_steps(tp, tw, grads[3:])
    tp2, tw2 = _torch_opt(topt.AdamW, mid, None, learning_rate=LR)
    tw2.set_state_dict(state)
    _torch_steps(tp2, tw2, grads[3:])
    for a, b in zip(_torch_values(tp2), _torch_values(tp)):
        assert np.array_equal(a, b)


def test_minimize_matches_backward_step_clear_grad_and_jax():
    """minimize(loss) == loss.backward(); step(); clear_grad() (bit for
    bit), and the JAX package's minimize within 1e-6, over 3 steps of
    loss = sum(w * x) + sum(w * w) (gradient x + 2 w)."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    xs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]

    def port(use_minimize):
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = topt.AdamW(learning_rate=LR, parameters=[w])
        for x in xs:
            loss = (w * torch.from_numpy(x)).sum() + (w * w).sum()
            if use_minimize:
                opt.minimize(loss)
            else:
                loss.backward()
                opt.step()
                opt.clear_grad()
            assert w.grad is None
        return w.detach().numpy()

    jw = pt.to_tensor(w0, stop_gradient=False)
    jopt = pt.optimizer.AdamW(learning_rate=LR, parameters=[jw])
    for x in xs:
        jopt.minimize((jw * pt.to_tensor(x)).sum() + (jw * jw).sum())
    got = port(True)
    assert np.array_equal(got, port(False))
    np.testing.assert_allclose(got, np.asarray(jw._array), **TOL)
