"""Eleven of the port's optimizers against the JAX package's, on the CPU.

SGD, Adagrad, RMSProp (plain, centered, with momentum), Adadelta, Lamb,
Adamax, NAdam, RAdam, ASGD, Rprop and LBFGS.  Each takes 5 eager steps
in both packages from the same float32 parameters (the shapes of a small
two-layer model's weights and biases) and gradients, made with numpy
from a seed; their `state_dict`s cross between the packages through
numpy both ways; and LBFGS solves `tests/test_lbfgs.py`'s problems.

Tolerance: both packages compute the same float32 formulas (the JAX
rules fused by jit, the host scalars in another order), so parameters
and slots agree within 1e-6 (rtol and atol).  LBFGS: on the quadratic
both packages take the same line-search decisions and agree within 1e-6;
on the ill-conditioned Rosenbrock valley float32 rounding moves the
iterates apart midway, and the minima they reach agree within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import optimizer as topt

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(8, 16), (16,), (16, 4), (4,)]     # Linear(8, 16), Linear(16, 4)
STEPS = 5

# name -> (class name, keyword arguments) in both packages
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_l2": ("SGD", dict(learning_rate=0.1, weight_decay=0.05)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1)),
    "adagrad_init_acc": ("Adagrad", dict(learning_rate=0.1,
                                         initial_accumulator_value=0.5)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop_momentum": ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, centered=True,
                                         momentum=0.5)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "adadelta_l2": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.1)),
    "lamb": ("Lamb", dict(learning_rate=0.01)),
    "lamb_no_decay": ("Lamb", dict(learning_rate=0.01,
                                   lamb_weight_decay=0.0)),
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "adamax_l2": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "nadam": ("NAdam", dict(learning_rate=0.01)),
    "nadam_l2": ("NAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    "radam": ("RAdam", dict(learning_rate=0.01)),
    "radam_beta2_0.9": ("RAdam", dict(learning_rate=0.01, beta2=0.9)),
    "asgd": ("ASGD", dict(learning_rate=0.1)),
    "asgd_batch3": ("ASGD", dict(learning_rate=0.1, batch_num=3)),
    "rprop": ("Rprop", dict(learning_rate=0.01)),
    "rprop_range": ("Rprop", dict(learning_rate=0.5,
                                  learning_rate_range=(1e-3, 0.6),
                                  etas=(0.3, 1.5))),
}


def _data(steps, seed=0):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    # Rprop meets sign changes and repeats: the second step's gradients
    # keep the first's signs on half the entries
    for g1, g0 in (zip(grads[1], grads[0]) if steps > 1 else ()):
        g1.reshape(-1)[::2] = np.abs(g1.reshape(-1)[::2]) * np.sign(
            g0.reshape(-1)[::2])
    return p0, grads


def _jax(cls, p0, **kw):
    params = [pt.to_tensor(p, stop_gradient=False) for p in p0]
    return params, getattr(pt.optimizer, cls)(parameters=params, **kw)


def _torch(cls, p0, **kw):
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    return params, getattr(topt, cls)(parameters=params, **kw)


def _step(params, opt, grads, tensor):
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = tensor(g)
        opt.step()
        opt.clear_grad()


def _jax_steps(params, opt, grads):
    _step(params, opt, grads, pt.to_tensor)


def _torch_steps(params, opt, grads):
    _step(params, opt, grads, lambda g: torch.from_numpy(g.copy()))


def _np(state):
    """A state dict with every tensor as a numpy array."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().numpy().copy()
        elif hasattr(v, "_array"):
            out[k] = np.asarray(v._array)
        else:
            out[k] = v
    return out


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case):
    """5 steps: parameters and every slot equal the JAX package's; the
    state dicts have the same keys."""
    cls, kw = CASES[case]
    p0, grads = _data(STEPS)
    jp, jopt = _jax(cls, p0, **kw)
    _jax_steps(jp, jopt, grads)
    tp, tw = _torch(cls, p0, **kw)
    _torch_steps(tp, tw, grads)
    _close([p.detach().numpy() for p in tp],
           [np.asarray(p._array) for p in jp])
    js, ts = _np(jopt.state_dict()), _np(tw.state_dict())
    assert set(ts) == set(js) and ts["step"] == js["step"] == STEPS
    for k in ts:
        if k != "step":
            np.testing.assert_allclose(ts[k], js[k], **TOL, err_msg=k)
    # and the steps moved every parameter
    assert all(not np.array_equal(p.detach().numpy(), q)
               for p, q in zip(tp, p0))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_dict_crosses_the_packages(case, direction):
    """3 steps in one package, its state dict through numpy into the
    other's optimizer over the parameters as they stand, 2 more steps
    there: the parameters equal 5 unbroken steps of the second
    package."""
    cls, kw = CASES[case]
    p0, grads = _data(STEPS, seed=1)
    sides = {"jax": (_jax, _jax_steps,
                     lambda ps: [np.asarray(p._array) for p in ps]),
             "torch": (_torch, _torch_steps,
                       lambda ps: [p.detach().numpy().copy() for p in ps])}
    src, dst = direction.split("_to_")
    make, steps, values = sides[src]
    params, opt = make(cls, p0, **kw)
    steps(params, opt, grads[:3])
    state, mid = _np(opt.state_dict()), values(params)
    make, steps, values = sides[dst]
    params2, opt2 = make(cls, mid, **kw)
    opt2.set_state_dict(state)
    assert opt2._step_count == 3
    steps(params2, opt2, grads[3:])
    params3, opt3 = make(cls, p0, **kw)
    steps(params3, opt3, grads)
    _close(values(params2), values(params3))


@pytest.mark.parametrize("cls", sorted({c for c, _ in CASES.values()}))
def test_slot_names_equal_the_jax_packages(cls):
    kw = {k: v for k, v in CASES[cls.lower()][1].items()}
    p0, grads = _data(1)
    jp, jopt = _jax(cls, p0, **kw)
    tp, tw = _torch(cls, p0, **kw)
    _jax_steps(jp, jopt, grads)
    _torch_steps(tp, tw, grads)
    assert set(_np(tw.state_dict())) == set(_np(jopt.state_dict()))
    assert type(tw).SLOTS == getattr(pt.optimizer, cls).SLOTS


def test_lamb_ignores_the_global_weight_decay_like_jax():
    """Lamb's decay is `lamb_weight_decay`; both packages pass None as the
    global decay, so `apply_decay_param_fun` changes nothing either."""
    p0, grads = _data(3, seed=2)
    fn = dict(apply_decay_param_fun=lambda n: n == "param_0")
    jp, jopt = _jax("Lamb", p0, learning_rate=0.01, **fn)
    _jax_steps(jp, jopt, grads)
    tp, tw = _torch("Lamb", p0, learning_rate=0.01, **fn)
    _torch_steps(tp, tw, grads)
    up, uw = _torch("Lamb", p0, learning_rate=0.01)
    _torch_steps(up, uw, grads)
    _close([p.detach().numpy() for p in tp],
           [np.asarray(p._array) for p in jp])
    for a, b in zip(tp, up):
        assert torch.equal(a, b)


def test_rprop_starts_from_its_rate_or_the_default_under_a_scheduler():
    p0, _ = _data(0)
    _, tw = _torch("Rprop", p0, learning_rate=0.05)
    tw.init_state()
    assert float(tw._state[0]["learning_rate"].max()) == np.float32(0.05)
    sched = topt.lr.StepDecay(0.05, step_size=1)
    _, sw = _torch("Rprop", p0, learning_rate=sched)
    sw.init_state()
    assert float(sw._state[0]["learning_rate"].max()) == np.float32(0.001)


def test_slot_less_sgd_updates_a_parameter_unfrozen_after_init():
    """SGD has no slots, so a parameter frozen when the state was made
    and unfrozen later updates as in the JAX package (an optimizer with
    slots raises there, C1)."""
    p0, grads = _data(1)
    tp, tw = _torch("SGD", p0, learning_rate=0.1)
    tp[0].requires_grad_(False)
    tw.init_state()
    tp[0].requires_grad_(True)
    _torch_steps(tp, tw, grads)
    np.testing.assert_array_equal(
        tp[0].detach().numpy(),
        p0[0] - np.float32(0.1) * grads[0][0])


# ----------------------------------------------------------------- LBFGS
def _rosenbrock(lib, opt, w):
    def closure():
        opt.clear_grad()
        x, y = w[0], w[1]
        loss = (1.0 - x) ** 2 + 100.0 * (y - x ** 2) ** 2
        loss.backward()
        return loss
    return closure


def _lbfgs(lib, init, **kw):
    if lib == "jax":
        w = pt.to_tensor(np.array(init, np.float32))
        w.stop_gradient = False
        return w, pt.optimizer.LBFGS(parameters=[w], **kw)
    w = torch.nn.Parameter(torch.tensor(init, dtype=torch.float32))
    return w, topt.LBFGS(parameters=[w], **kw)


def _value(w):
    return np.asarray(w._array) if hasattr(w, "_array") else \
        w.detach().numpy()


def test_lbfgs_rosenbrock_strong_wolfe_matches_jax():
    """tests/test_lbfgs.py's Rosenbrock: both packages reach the minimum
    and end within 1e-5 of each other.  Midway along the curved valley
    (the first step's 30 iterations) float32 rounding moves the two
    packages' iterates apart by up to 1e-2, so only the end is held."""
    kw = dict(learning_rate=1.0, max_iter=30, line_search_fn="strong_wolfe")
    out = {}
    for lib in ("jax", "torch"):
        w, opt = _lbfgs(lib, [-1.2, 1.0], **kw)
        closure = _rosenbrock(lib, opt, w)
        trace = []
        for _ in range(10):
            loss = opt.step(closure)
            trace.append(_value(w).copy())
        out[lib] = (float(loss), trace)
    assert out["torch"][0] < 1e-5
    np.testing.assert_allclose(out["torch"][1][-1], [1.0, 1.0], atol=1e-2)
    assert out["jax"][0] < 1e-5
    np.testing.assert_allclose(out["torch"][1][-1], out["jax"][1][-1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_quadratic_matches_jax(line_search):
    out = {}
    for lib in ("jax", "torch"):
        v, opt = _lbfgs(lib, [3.0, -4.0, 5.0], learning_rate=0.5,
                        max_iter=10, line_search_fn=line_search)

        def closure(v=v, opt=opt):
            opt.clear_grad()
            loss = (v ** 2).sum()
            loss.backward()
            return loss

        losses = [float(opt.step(closure)) for _ in range(5)]
        out[lib] = (losses, _value(v))
    assert out["torch"][0][-1] < 1e-6
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-6)


def test_lbfgs_state_dict_crosses_the_packages():
    """The curvature history under the reference's "__lbfgs__/..." keys:
    a port state loads into the JAX optimizer and the other way, and the
    next step from it equals the source's own next step."""
    kw = dict(learning_rate=1.0, max_iter=5, line_search_fn="strong_wolfe")
    for src, dst in (("torch", "jax"), ("jax", "torch")):
        w, opt = _lbfgs(src, [-1.2, 1.0], **kw)
        opt.step(_rosenbrock(src, opt, w))
        state = _np(opt.state_dict())
        assert any(k.startswith("__lbfgs__/s") for k in state)
        w2, opt2 = _lbfgs(dst, _value(w).tolist(), **kw)
        opt2.set_state_dict(state)
        assert len(opt2._state_lb["s"]) == len(opt._state_lb["s"]) > 0
        opt.step(_rosenbrock(src, opt, w))
        opt2.step(_rosenbrock(dst, opt2, w2))
        np.testing.assert_allclose(_value(w2), _value(w), rtol=1e-5,
                                   atol=1e-5)


def test_lbfgs_weight_decay_and_closure_like_jax():
    v, opt = _lbfgs("torch", [2.0], learning_rate=0.1, max_iter=3,
                    weight_decay=1.0)

    def closure():
        opt.clear_grad()
        loss = ((v - 2.0) ** 2).sum()
        loss.backward()
        return loss

    for _ in range(20):
        opt.step(closure)
    # L2 decay pulls the optimum below the data term's v = 2
    assert float(v.detach()[0]) < 1.9
    with pytest.raises(ValueError, match="closure"):
        opt.step()
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="parameter groups"):
        topt.LBFGS(parameters=[{"params": [w], "learning_rate": 0.5}])
