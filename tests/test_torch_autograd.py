"""The port's public autograd API (`autograd`, `grad`, `PyLayer`, the
functional transforms, `saved_tensors_hooks`), `Tensor` / `parameter`,
the `base` / `fluid` aliases and the flags, against the JAX package.

Inputs come from a numpy seed and cross as arrays.  Tolerance: float32
on both sides, summed in another order: rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import autograd as JA
import paddle_tpu_torch as tp
from paddle_tpu_torch import autograd as TA

import torch_cpu_threads

torch_cpu_threads.limit()

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cpu_place():
    """`set_device("cpu")` for the test, the place restored after."""
    from paddle_tpu_torch import device
    before = device._current_place[0]
    tp.set_device("cpu")
    yield
    device._current_place[0] = before


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._array if hasattr(t, "_array") else t)


def _inputs(seed=0, n=2, shape=(3,)):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    return ([pt.to_tensor(a, stop_gradient=False) for a in arrays],
            [torch.tensor(a, requires_grad=True) for a in arrays])


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_grad_create_graph_and_double_grad():
    (jx,), (tx,) = _inputs(n=1)
    (jg,) = pt.grad((jx * jx * jx).sum(), jx, create_graph=True)
    (tg,) = tp.grad((tx * tx * tx).sum(), tx, create_graph=True)
    _close(tg, jg)
    assert tx.grad is None       # grad does not touch .grad
    (jgg,) = pt.grad(jg.sum(), jx)
    (tgg,) = tp.grad(tg.sum(), tx)
    _close(tgg, jgg)             # 6x


def test_grad_outputs_allow_unused_and_errors():
    (jx, jz), (tx, tz) = _inputs(seed=1)
    seed = np.linspace(0.5, 1.5, 3).astype(np.float32)
    jg = pt.grad(jx * 2.0, [jx, jz], grad_outputs=[pt.to_tensor(seed)],
                 allow_unused=True, retain_graph=True)
    tg = tp.grad(tx * 2.0, [tx, tz], grad_outputs=[torch.tensor(seed)],
                 allow_unused=True, retain_graph=True)
    _close(tg[0], jg[0])
    assert tg[1] is None and jg[1] is None
    for grad, x, z in ((pt.grad, jx, jz), (tp.grad, tx, tz)):
        with pytest.raises(RuntimeError, match="not used"):
            grad((x * 2.0).sum(), [z])
        with pytest.raises(RuntimeError, match="scalar"):
            grad(x * 2.0, [x])
    # grad_outputs=[None] is the implicit ones seed; no_grad_vars and
    # only_inputs are taken and ignored in both packages
    _close(tp.grad((tx * tx).sum(), tx, grad_outputs=[None],
                   no_grad_vars=[tz], only_inputs=False)[0],
           pt.grad((jx * jx).sum(), jx, grad_outputs=[None],
                   no_grad_vars=[jz])[0])


def test_backward_accumulates_and_run_backward():
    (jx,), (tx,) = _inputs(seed=2, n=1)
    for f in (lambda x: (x * 2.0).sum(), lambda x: (x * x).sum()):
        JA.backward(f(jx))
        TA.backward(f(tx))
    _close(tx.grad, jx.grad)
    y = tx * 3.0
    TA.run_backward([y], [torch.ones(3)])
    _close(tx.grad, _np(jx.grad) + 3.0)
    (g,) = TA.run_backward([(tx * tx).sum()], [torch.tensor(1.0)],
                           accumulate_into_grad=False, wanted=[tx])
    _close(g, 2 * _np(tx))
    assert TA.grad_enabled()
    with TA.no_grad():
        assert not TA.grad_enabled()


@pytest.mark.parametrize("which", ["single", "multi"])
def test_jacobian_and_hessian(which):
    rng = np.random.RandomState(3)
    a, b = (rng.randn(3).astype(np.float32) for _ in range(2))
    if which == "single":
        jxs, txs = pt.to_tensor(a), torch.tensor(a)

        def f(x):
            return x ** 3

        def s(x):
            return (x ** 2 * x.sum()).sum()
    else:
        jxs = [pt.to_tensor(a), pt.to_tensor(b)]
        txs = [torch.tensor(a), torch.tensor(b)]

        def f(x, y):
            return x * y + x ** 2

        def s(x, y):
            return (x * x * y).sum()
    jj, tj = JA.jacobian(f, jxs), TA.jacobian(f, txs)
    jh, th = JA.hessian(s, jxs), TA.hessian(s, txs)
    for got, want in ((tj, jj), (th, jh)):
        flat_g = torch.utils._pytree.tree_leaves(got)
        flat_w = [x for x in _leaves(want)]
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            _close(g, w)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def test_jvp_and_vjp():
    rng = np.random.RandomState(4)
    a, v = (rng.randn(3).astype(np.float32) for _ in range(2))

    def f(x):
        return torch.sin(x) * x if isinstance(x, torch.Tensor) else \
            pt.sin(x) * x

    for which in ("jvp", "vjp"):
        jo, jt = getattr(JA, which)(f, pt.to_tensor(a), pt.to_tensor(v))
        to, tt = getattr(TA, which)(f, torch.tensor(a), torch.tensor(v))
        _close(to, jo)
        _close(tt, jt)
    # v defaults to ones
    _close(TA.vjp(f, torch.tensor(a))[1], JA.vjp(f, pt.to_tensor(a))[1])
    with pytest.raises(NotImplementedError):
        TA.jacobian(f, torch.tensor(a), create_graph=True)


def test_pylayer_context_and_non_differentiable_outputs():
    def layer(base):
        class ScaledSquare(base):
            @staticmethod
            def forward(ctx, x, k=2.0):
                ctx.save_for_backward(x)
                ctx.saved_extras["k"] = k
                return x * x * k

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * 2.0 * x * ctx.saved_extras["k"]
        return ScaledSquare

    (jx,), (tx,) = _inputs(seed=5, n=1)
    layer(JA.PyLayer).apply(jx, k=3.0).sum().backward()
    layer(TA.PyLayer).apply(tx, k=3.0).sum().backward()
    _close(tx.grad, jx.grad)

    class ArgMaxAndValue(TA.PyLayer):
        @staticmethod
        def forward(ctx, x):
            i = x.argmax()
            ctx.mark_non_differentiable(i)
            ctx.save_for_backward(x, i)
            return x[i], i

        @staticmethod
        def backward(ctx, g, _gi):
            x, i = ctx.saved_tensor()
            out = torch.zeros_like(x)
            out[i] = g
            return out

    x = torch.tensor([1.0, 5.0, 2.0], requires_grad=True)
    val, idx = ArgMaxAndValue.apply(x)
    assert not idx.requires_grad
    val.backward()
    _close(x.grad, [0.0, 1.0, 0.0])


def test_saved_tensors_hooks_see_every_saved_tensor():
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t.detach().numpy()

    xv = np.linspace(-1, 1, 12, dtype=np.float32)
    x = torch.tensor(xv, requires_grad=True)
    with TA.saved_tensors_hooks(pack, torch.from_numpy):
        loss = (torch.exp(x) * x).sum()
    loss.backward()
    assert packed
    jx = pt.to_tensor(xv, stop_gradient=False)
    with JA.saved_tensors_hooks(lambda t: t.numpy(), pt.to_tensor):
        jloss = (pt.exp(jx) * jx).sum()
    jloss.backward()
    _close(x.grad, jx.grad)


def test_tensor_is_torchs_and_parameter(cpu_place):
    assert tp.Tensor is torch.Tensor
    p = tp.parameter(np.ones((2, 3), np.float64))
    assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert p.dtype == torch.float32        # the default dtype, as to_tensor
    jp = pt.parameter(np.ones((2, 3), np.float32))
    assert not jp.stop_gradient
    assert tp.parameter(np.ones(2), dtype="bfloat16").dtype == \
        torch.bfloat16


def test_paddle_only_tensor_methods_torch_lacks():
    """Intended divergence: `Tensor` is torch.Tensor, so the
    Paddle-only spellings the reference's tests/test_tensor.py uses are
    torch's: astype -> to, transpose(perm) -> permute, a Size for shape,
    squeeze() for squeeze(None), requires_grad for stop_gradient."""
    jx = pt.arange(24, dtype="float32").reshape([2, 3, 4])
    tx = torch.arange(24, dtype=torch.float32).reshape([2, 3, 4])
    assert not hasattr(torch.Tensor, "astype")
    assert jx.astype("int32").dtype == pt.int32
    assert tx.to(torch.int32).dtype == torch.int32
    assert jx.transpose([2, 0, 1]).shape == [4, 2, 3]
    with pytest.raises(TypeError):
        tx.transpose([2, 0, 1])
    assert tuple(tx.permute([2, 0, 1]).shape) == (4, 2, 3)
    assert jx.shape == [2, 3, 4] and tx.shape != [2, 3, 4]
    assert list(tx.shape) == [2, 3, 4]
    y = tx[:, :1]
    assert jx[:, :1].squeeze(None).shape == [2, 4]
    with pytest.raises(TypeError):
        y.squeeze(None)
    assert tuple(y.squeeze().shape) == (2, 4)
    assert not hasattr(torch.Tensor, "stop_gradient")


def test_static_switch_base_fluid_and_flags():
    import paddle_tpu_torch.fluid as fluid
    assert fluid is tp.base is tp.fluid
    assert tp.in_dynamic_mode() == pt.in_dynamic_mode() is True
    tp.enable_static()
    try:
        assert not tp.in_dynamic_mode()
    finally:
        tp.disable_static()
    assert tp.in_dynamic_mode()
    assert tp.base.is_compiled_with_cuda() == (torch.version.cuda is not None)
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags
    assert flags.get_flags("matmul_precision") == \
        jflags.get_flags("matmul_precision")
    flags.set_flags({"check_numerics": True})
    try:
        assert flags.get_flags("check_numerics") is True
    finally:
        flags.set_flags({"check_numerics": False})
    assert tp.framework.flags is flags


def test_entry_points_run_on_the_card_unless_the_cpu_is_named(monkeypatch):
    """`parameter` and `static.data` make their tensors on the card; with
    none and no device named they raise, as the other entry points do."""
    from paddle_tpu_torch import device, static
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_current_place", [None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.parameter(np.ones(2, np.float32))
    tp.enable_static()
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            static.data("x", [None, 2], "float32")
        tp.set_device("cpu")
        assert static.data("y", [None, 2], "float32").device.type == "cpu"
    finally:
        tp.disable_static()
        tp.framework.static_graph.reset()
