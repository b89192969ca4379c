"""dy2static in the port against the JAX package: every case of
`tests/test_dy2static.py`, written once with the JAX package's ops and
once with torch's, run through both packages' `to_static` and eagerly.

The port lowers a tensor `if` onto `torch.cond`, an unbounded `while`
onto `while_loop` (forward only), a `while_max_iters` loop onto a masked
loop Dynamo unrolls (differentiable), a `for` over a tensor onto
Dynamo's unrolling and a `range` with a tensor bound onto the while
lowering.  The cases compile with the `aot_eager` backend (the private
`jit._BACKEND` switch): the Dynamo capture and the operators are the
subject here, not Inductor's code.  Inputs are small float32 vectors:
both packages and the eager run agree to rtol 1e-6 (the reference's own
tolerance), integers exactly.  Errors: a branch mismatch raises the
reference's ValueError in both packages; an unconvertible tensor `if`
raises a RuntimeError in both (JAX's concretization error, Dynamo's
data-dependent branching error).
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit.dy2static import convert_to_static as jax_convert
from paddle_tpu_torch import jit, nn, seed
from paddle_tpu_torch.jit.dy2static import convert_to_static
from paddle_tpu_torch.weights import load_paddle_tpu_state

import torch_cpu_threads

torch_cpu_threads.limit()

TOL = dict(rtol=1e-6)


@pytest.fixture(autouse=True)
def aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._array if hasattr(t, "_array") else t)


def _both(jf, tf, *vals, **kw):
    """(JAX to_static, port to_static, port eager) of the case on vals."""
    jx = [pt.to_tensor(v) for v in vals]
    tx = [torch.tensor(v) for v in vals]
    return (pt.jit.to_static(jf, **kw)(*jx), jit.to_static(tf, **kw)(*tx),
            tf(*tx))


def _check(jf, tf, *vals, **kw):
    j, t, e = _both(jf, tf, *vals, **kw)
    js, ts, es = (x if isinstance(x, tuple) else (x,) for x in (j, t, e))
    for a, b, c in zip(js, ts, es):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
        np.testing.assert_allclose(_np(b), _np(c), **TOL)


# ------------------------------------------------------------ the cases
def _if_both_assign(m):
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y + 1.0
    return f


def _if_no_else(m):
    def f(x):
        y = x + 1.0
        if x.mean() > 0:
            y = y * 10.0
        return y
    return f


def _if_elif_chain(m):
    def f(x):
        s = x.sum()
        if s > 1.0:
            y = x * 2.0
        elif s > -1.0:
            y = x * 0.5
        else:
            y = -x
        return y
    return f


def _if_both_return(m):
    def f(x):
        if x.sum() > 0:
            return x * 3.0
        else:
            return x - 7.0
    return f


def _bool_ops(m):
    def f(x):
        if x.sum() > 0 and x.max() < 10.0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y
    return f


def _not_in_test(m):
    def f(x):
        if not (x.sum() > 0):
            y = x * -1.0
        else:
            y = x
        return y
    return f


def _ternary(m):
    def f(x):
        y = x * 2.0 if x.sum() > 0 else x * -1.0
        return y
    return f


def _while_collatz(m):
    def f(x):
        n = m.zeros([])
        while x.sum() > 1.0:
            x = x * 0.5
            n = n + 1.0
        return x, n
    return f


def _python_while(m):
    def f(x):
        i = 0
        while i < 3:
            x = x + 1.0
            i += 1
        return x
    return f


def _python_range(m):
    def f(x):
        for i in range(3):
            x = x + float(i)
        return x
    return f


def _int_seed_float_carry(m):
    def f(x):
        i = 0
        while i < x.sum():
            i = i + 0.5
        return i
    return f


CASES = {
    "if_both_assign": (_if_both_assign, [[1.0, 2.0], [-5.0, 1.0]]),
    "if_no_else": (_if_no_else, [[1.0], [-1.0]]),
    "if_elif_chain": (_if_elif_chain, [[2.0, 1.0], [0.1, 0.2],
                                       [-3.0, -4.0]]),
    "if_both_return": (_if_both_return, [[1.0], [-1.0]]),
    "bool_ops": (_bool_ops, [[1.0, 2.0], [20.0, 1.0], [-1.0, -2.0]]),
    "not_in_test": (_not_in_test, [[1.0], [-1.0]]),
    "ternary": (_ternary, [[1.0], [-1.0]]),
    "while_collatz": (_while_collatz, [[8.0, 8.0]]),
    "python_while": (_python_while, [[0.0]]),
    "python_range": (_python_range, [[0.0]]),
    "int_seed_float_carry": (_int_seed_float_carry, [[2.0]]),
}


class _TorchOps:
    zeros = staticmethod(lambda shape: torch.zeros(shape))


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax_and_eager(name):
    make, inputs = CASES[name]
    jf, tf = make(pt), make(_TorchOps)
    for v in inputs:
        _check(jf, tf, np.asarray(v, np.float32))


def test_python_if_untouched_semantics():
    def f(x, flag):
        if flag:
            y = x * 2.0
        return y.sum()

    x = np.asarray([3.0], np.float32)
    j = pt.jit.to_static(f)(pt.to_tensor(x), True)
    t = jit.to_static(f)(torch.tensor(x), True)
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    np.testing.assert_allclose(_np(t), 6.0, **TOL)


def test_if_grad_flows():
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x * -3.0
        return y.sum()

    st, jst = jit.to_static(f), pt.jit.to_static(f)
    for v, expect in (([1.0, 1.0], 2.0), ([-1.0, -1.0], -3.0)):
        x = torch.tensor(v, requires_grad=True)
        st(x).backward()
        jx = pt.to_tensor(v, stop_gradient=False)
        jst(jx).backward()
        np.testing.assert_allclose(_np(x.grad), [expect, expect], **TOL)
        np.testing.assert_allclose(_np(x.grad), _np(jx.grad), **TOL)


def test_while_grad_bounded():
    """Reverse mode through a tensor `while` needs the bounded lowering:
    d/dx of repeated halving until <= 1 at x = 8 is 1/8."""
    def f(x):
        while x > 1.0:
            x = x / 2.0
        return x

    x = torch.tensor(8.0, requires_grad=True)
    out = jit.to_static(f, while_max_iters=10)(x)
    out.backward()
    jx = pt.to_tensor(8.0, stop_gradient=False)
    jout = pt.jit.to_static(f, while_max_iters=10)(jx)
    jout.backward()
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(x.grad), 0.125, **TOL)
    np.testing.assert_allclose(_np(x.grad), _np(jx.grad), **TOL)


def test_for_over_tensor_rows():
    def jf(xs):
        acc = pt.zeros([2])
        for row in xs:
            acc = acc + row * 2.0
        return acc

    def tf(xs):
        acc = torch.zeros([2])
        for row in xs:
            acc = acc + row * 2.0
        return acc

    _check(jf, tf, np.arange(6, dtype=np.float32).reshape(3, 2))


def test_for_range_tensor_bound():
    def f(x, n):
        acc = x * 0.0
        for i in range(n):
            acc = acc + x
        return acc

    x = np.asarray([2.0], np.float32)
    j = pt.jit.to_static(f)(pt.to_tensor(x), pt.to_tensor(4))
    t = jit.to_static(f)(torch.tensor(x), torch.tensor(4))
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    np.testing.assert_allclose(_np(t), [8.0], **TOL)


def _gate(m, base):
    class Gate(base):
        def __init__(self):
            super().__init__()
            self.fc = m.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = h * 2.0
            else:
                out = h * 0.5
            return out
    return Gate


def test_layer_forward_with_tensor_if():
    pt.seed(0)
    jl = _gate(pt.nn, pt.nn.Layer)()
    seed(0)
    tl = _gate(_CpuLayers, nn.Layer)()
    load_paddle_tpu_state(tl, {k: np.asarray(v)
                               for k, v in jl.state_dict().items()})
    jst, tst = pt.jit.to_static(jl), jit.to_static(tl)
    for sign in (1.0, -1.0):
        x = np.full((2, 4), sign, np.float32)
        t = tst(torch.tensor(x))
        np.testing.assert_allclose(_np(t), _np(jst(pt.to_tensor(x))),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(t), _np(tl(torch.tensor(x))),
                                   rtol=1e-5)


class _CpuLayers:
    Linear = staticmethod(functools.partial(nn.Linear, device="cpu"))
    Embedding = staticmethod(functools.partial(nn.Embedding, device="cpu"))


def _decoder(m, base, zeros, ones):
    class TinyDecoder(base):
        """Greedy argmax decoding until token 0 or 8 steps: an unbounded
        tensor `while` in a Layer's forward (forward only)."""

        def __init__(self, vocab=16, hidden=8):
            super().__init__()
            self.emb = m.Embedding(vocab, hidden)
            self.proj = m.Linear(hidden, vocab)

        def forward(self, tok):
            steps = zeros()
            go = ones()
            while go and steps < 8:
                h = self.emb(tok.reshape([1]))
                logits = self.proj(h)[0]
                tok = logits.argmax()
                steps = steps + 1
                go = tok != 0
            return tok, steps
    return TinyDecoder


def test_while_decode_loop():
    pt.seed(3)
    jd = _decoder(pt.nn, pt.nn.Layer, lambda: pt.zeros([], dtype="int32"),
                  lambda: pt.ones([], dtype="bool"))()
    td = _decoder(_CpuLayers, nn.Layer,
                  lambda: torch.zeros([], dtype=torch.int32),
                  lambda: torch.ones([], dtype=torch.bool))()
    load_paddle_tpu_state(td, {k: np.asarray(v)
                               for k, v in jd.state_dict().items()})
    with torch.no_grad():
        e_tok, e_steps = td(torch.tensor(3))
        s_tok, s_steps = jit.to_static(td)(torch.tensor(3))
    j_tok, j_steps = pt.jit.to_static(jd)(pt.to_tensor(3))
    assert int(s_steps) == int(e_steps) == int(_np(j_steps))
    assert int(s_tok) == int(e_tok) == int(_np(j_tok))
    assert 1 <= int(s_steps) <= 8


def test_convert_reports_unchanged():
    def plain(x):
        return x * 2.0

    assert convert_to_static(plain)[1] is False
    assert jax_convert(plain)[1] is False


def test_structure_mismatch_raises_the_reference_error():
    def f(x):
        if x.sum() > 0:
            y = x
        else:
            y = "a string"
        return y

    with pytest.raises(ValueError, match="dy2static") as jerr:
        pt.jit.to_static(f)(pt.to_tensor([1.0]))
    with pytest.raises(ValueError, match="dy2static") as terr:
        jit.to_static(f)(torch.tensor([1.0]))
    assert str(terr.value) == str(jerr.value)


def test_variable_defined_in_one_branch_raises():
    """A name bound on one path only: both packages raise the
    mismatch (UNDEF on the other path)."""
    def f(x):
        if x.sum() > 0:
            z = x * 2.0
        return z

    with pytest.raises(ValueError, match="different structures"):
        pt.jit.to_static(f)(pt.to_tensor([1.0]))
    with pytest.raises(ValueError, match="different structures"):
        jit.to_static(f)(torch.tensor([1.0]))


def test_enable_to_static_switch():
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x
        return y

    st = jit.to_static(f)
    jit.enable_to_static(False)
    try:
        np.testing.assert_allclose(_np(st(torch.tensor([2.0]))), [4.0])
    finally:
        jit.enable_to_static(True)


def test_early_return_left_native():
    def f(x, flag):
        if flag:
            return x * 2.0
        return x

    st = jit.to_static(f)
    np.testing.assert_allclose(_np(st(torch.tensor([1.0]), True)), [2.0])
    np.testing.assert_allclose(_np(st(torch.tensor([1.0]), False)), [1.0])


def test_not_to_static_opt_out():
    @jit.not_to_static
    def f(x, flag):
        if flag:
            return x * 2.0
        return x

    assert convert_to_static(f)[1] is False


def test_decorated_fn_not_converted():
    def deco(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            return fn(*a, **k) + 100.0
        return inner

    @deco
    def f(x):
        y = x * 2.0 if x.shape[0] > 0 else x   # would normally convert
        return y

    assert convert_to_static(f)[1] is False
    np.testing.assert_allclose(_np(jit.to_static(f)(torch.tensor([1.0]))),
                               [102.0], **TOL)

    @deco
    def g(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x
        return y

    # an unconvertible tensor `if`: JAX's concretization error, Dynamo's
    # data-dependent branching error (full_graph), both RuntimeErrors
    with pytest.raises(RuntimeError, match="traced Tensor"):
        pt.jit.to_static(g)(pt.to_tensor([1.0]))
    with pytest.raises(RuntimeError):
        jit.to_static(g)(torch.tensor([1.0]))
