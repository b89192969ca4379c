"""The port's `nn.Layer`, initializers, containers and `nn.utils` against
the JAX package's, on the CPU.

The same structures are built in both packages; names, state dicts and
the values the initializers fix exactly (Constant, Assign, Dirac,
Bilinear, Orthogonal's orthogonality, the bounds that the fans set) are
compared; random initializers are held by their moments over a large
draw, since the two packages' random streams differ.  Weights go across
through `load_paddle_tpu_state`.

Tolerances.  float32: rtol 1e-5, atol 1e-5 (the same formulas summed in
another order).  Moments over 2**20 draws: the mean within 5e-3 of the
standard deviation's scale and the standard deviation within 1 %
(five and ten standard errors).
"""
import math
from collections import OrderedDict

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import ParamAttr
from paddle_tpu_torch.weights import load_paddle_tpu_state

TOL = dict(rtol=1e-5, atol=1e-5)
I, JI = tnn.initializer, pt.nn.initializer


def _state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _carry(jax_layer, port_layer):
    load_paddle_tpu_state(port_layer, _state(jax_layer))
    return port_layer


# ----------------------------------------------------- device of a layer
BUILDERS = {
    "Linear": lambda **kw: tnn.Linear(4, 3, **kw),
    "Embedding": lambda **kw: tnn.Embedding(10, 4, **kw),
    "LayerNorm": lambda **kw: tnn.LayerNorm(4, **kw),
    "RMSNorm": lambda **kw: tnn.RMSNorm(4, **kw),
    "Conv2D": lambda **kw: tnn.Conv2D(2, 3, 3, **kw),
    "BatchNorm2D": lambda **kw: tnn.BatchNorm2D(3, **kw),
    "MultiHeadAttention": lambda **kw: tnn.MultiHeadAttention(8, 2, **kw),
    "TransformerEncoderLayer": lambda **kw: tnn.TransformerEncoderLayer(
        8, 2, 16, **kw),
    "LSTM": lambda **kw: tnn.LSTM(4, 5, **kw),
    "TransformerModel": lambda **kw: __import__(
        "paddle_tpu_torch.text", fromlist=["TransformerModel"])
    .TransformerModel(20, 20, 16, 8, 2, 1, 1, 16, **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_public_layer_builds_on_the_card_unless_asked(name):
    """device=None is the current CUDA device (a RuntimeError without
    one); device="cpu" builds on the CPU."""
    build = BUILDERS[name]
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in build().parameters())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    layer = build(device="cpu")
    assert all(p.device.type == "cpu" for p in layer.parameters())


# ------------------------------------------------------------- Layer API
class _Net:
    """A custom layer built the same way in both packages."""

    @staticmethod
    def build(nn, **kw):
        class Net(nn.Layer):
            def __init__(self):
                super().__init__(**kw)
                self.fc = nn.Linear(4, 3, **kw)
                self.blocks = nn.LayerList(
                    [nn.Sequential(nn.Linear(3, 3, **kw), nn.ReLU())
                     for _ in range(2)])
                self.norm = nn.LayerNorm(3, **kw)
                self.scale = self.create_parameter([3], default_initializer=(
                    nn.initializer.Constant(2.0)))

            def forward(self, x):
                x = self.fc(x)
                for b in self.blocks:
                    x = b(x)
                return self.norm(x) * self.scale

        return Net()


def test_custom_layer_names_state_and_forward_match_jax():
    pt.seed(0)
    jn = _Net.build(pt.nn)
    tn = _carry(jn, _Net.build(tnn, device="cpu"))
    assert [n for n, _ in tn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert [n for n, _ in tn.named_parameters()] == \
        [n for n, _ in jn.named_parameters()]
    assert len(tn.parameters(include_sublayers=False)) == \
        len(jn.parameters(include_sublayers=False)) == 1
    assert isinstance(tn.parameters(), list)
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    with torch.no_grad():
        out = tn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, jn(pt.to_tensor(x)).numpy(), **TOL)


def test_create_parameter_takes_param_attr():
    layer = tnn.Layer(device="cpu")
    p = layer.create_parameter(
        [2, 3], attr=ParamAttr(name="w", initializer=I.Constant(3.0),
                               learning_rate=0.5, trainable=False))
    assert torch.equal(p, torch.full((2, 3), 3.0))
    assert not p.requires_grad and p.paddle_name == "w"
    assert p.optimize_attr == {"learning_rate": 0.5}
    b = layer.create_parameter([3], is_bias=True)
    assert torch.equal(b, torch.zeros(3))
    assert layer.create_parameter([2], dtype="bfloat16").dtype == \
        torch.bfloat16


def test_buffers_sublayers_and_state_dict():
    layer = tnn.Layer(device="cpu")
    layer.add_parameter("w", torch.nn.Parameter(torch.ones(2)))
    layer.add_sublayer("child", tnn.Linear(2, 2, device="cpu"))
    assert layer.register_buffer("kept", torch.zeros(1)) is layer.kept
    layer.register_buffer("scratch", torch.zeros(1), persistable=False)
    layer.register_buffer("torch_style", torch.zeros(1), persistent=False)
    assert sorted(layer.state_dict()) == ["child.bias", "child.weight",
                                          "kept", "w"]
    assert len(layer.buffers()) == 3 and layer.buffers(False)[0] is \
        layer.kept
    assert layer.sublayers() == [layer.child]
    assert layer.sublayers(include_self=True)[0] is layer
    missing, unexpected = layer.set_state_dict(
        {"w": np.full(2, 7.0, np.float32), "nope": np.zeros(1)})
    assert torch.equal(layer.w, torch.full((2,), 7.0))
    assert unexpected == ["nope"]
    assert sorted(missing) == ["child.bias", "child.weight", "kept"]
    assert layer.load_dict == layer.set_state_dict


def test_train_eval_to_astype_apply_and_gradients():
    pt.seed(1)
    jn = _Net.build(pt.nn)
    tn = _Net.build(tnn, device="cpu")
    for net in (jn, tn):
        net.eval()
        assert not net.blocks[0][0].training
        net.train()
        assert net.blocks[1][1].training
    tn.to(dtype="bfloat16")
    assert tn.fc.weight.dtype == torch.bfloat16
    tn.astype("float32")
    assert tn.norm.weight.dtype == torch.float32
    tn.to("cpu", "bfloat16").float()
    assert tn.scale.dtype == torch.float32
    seen, jseen = [], []
    tn.apply(lambda l: seen.append(type(l).__name__))
    jn.apply(lambda l: jseen.append(type(l).__name__))
    assert seen == jseen                     # each layer before its own
    tn(torch.ones(2, 4)).sum().backward()
    assert tn.fc.weight.grad is not None
    tn.clear_gradients()
    assert all(p.grad is None for p in tn.parameters())
    assert tn.full_name() == jn.full_name() == "net"


def test_forward_hooks_and_their_removal():
    layer = tnn.Linear(2, 2, device="cpu")
    pre = layer.register_forward_pre_hook(lambda l, args: (args[0] * 0,))
    post = layer.register_forward_post_hook(lambda l, args, out: out + 1)
    out = layer(torch.ones(1, 2))
    assert torch.equal(out, layer.bias.detach()[None] + 1)
    pre.remove()
    post.remove()
    x = torch.ones(1, 2)
    assert torch.equal(layer(x), torch.nn.functional.linear(
        x, layer.weight, layer.bias))


# ------------------------------------------------------------ initializers
def test_linear_keeps_out_in_with_reference_fans_and_assign():
    """An intended divergence: the port's Linear weight is [out, in]
    (torch's), the JAX one's [in, out]; load_paddle_tpu_state transposes,
    and the initializers work on the [in, out] view."""
    pt.seed(2)
    jl = pt.nn.Linear(6, 3)
    tl = _carry(jl, tnn.Linear(6, 3, device="cpu"))
    assert tuple(tl.weight.shape) == (3, 6)
    np.testing.assert_array_equal(tl.weight.detach().numpy().T,
                                  jl.weight.numpy())
    value = np.arange(18, dtype=np.float32).reshape(6, 3)
    ja = pt.nn.Linear(6, 3, weight_attr=JI.Assign(value))
    ta = tnn.Linear(6, 3, weight_attr=I.Assign(value), device="cpu")
    np.testing.assert_array_equal(ta.weight.detach().numpy().T,
                                  ja.weight.numpy())
    # Kaiming's fan_in is `in` (6), not the torch layout's first dim (3)
    tk = tnn.Linear(6, 3000, device="cpu",
                    weight_attr=I.KaimingUniform(),
                    generator=torch.Generator().manual_seed(0))
    limit = math.sqrt(6.0 / 6)
    w = tk.weight.detach()
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.99 * limit


def _moments(fn, shape=(1024, 1024)):
    t = torch.empty(shape)
    fn(t, torch.Generator().manual_seed(0))
    return float(t.mean()), float(t.std()), t


@pytest.mark.parametrize("name,init,mean,std,bound", [
    ("normal", I.Normal(0.5, 2.0), 0.5, 2.0, None),
    ("truncated", I.TruncatedNormal(0.0, 1.0), 0.0, 0.8796, 2.0),
    ("uniform", I.Uniform(-3.0, 1.0), -1.0, 4 / math.sqrt(12), 3.0),
    ("xavier_uniform", I.XavierUniform(), 0.0, math.sqrt(1 / 1024),
     math.sqrt(6 / 2048)),
    ("xavier_normal", I.XavierNormal(), 0.0, math.sqrt(1 / 1024), None),
    ("kaiming_uniform", I.KaimingUniform(), 0.0, math.sqrt(2 / 1024),
     math.sqrt(6 / 1024)),
    ("kaiming_normal", I.KaimingNormal(), 0.0, math.sqrt(2 / 1024), None),
])
def test_random_initializer_moments(name, init, mean, std, bound):
    m, s, t = _moments(init)
    assert abs(m - mean) <= 5e-3 * std, (m, mean)
    assert abs(s / std - 1) <= 1e-2, (s, std)
    if bound is not None:
        assert float((t - mean).abs().max()) <= bound + 1e-6


@pytest.mark.parametrize("shape", [(4, 6), (6, 4), (3, 2, 2, 2)])
def test_orthogonal_rows_or_columns_like_jax(shape):
    pt.seed(3)
    j = pt.create_parameter(list(shape), "float32",
                            default_initializer=JI.Orthogonal(gain=2.0))
    t = torch.empty(shape)
    I.Orthogonal(gain=2.0)(t, torch.Generator().manual_seed(0))
    for arr in (j.numpy(), t.numpy()):
        m = arr.reshape(shape[0], -1) / 2.0
        small = min(m.shape)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, np.eye(small), atol=1e-5)


def test_orthogonal_on_a_linear_takes_the_reference_rows():
    tl = tnn.Linear(4, 6, weight_attr=I.Orthogonal(), device="cpu")
    ref = tl.weight.detach().numpy().T          # [in 4, out 6]
    np.testing.assert_allclose(ref @ ref.T, np.eye(4), atol=1e-5)


@pytest.mark.parametrize("init", ["constant", "dirac", "bilinear"])
def test_deterministic_initializers_equal_jax(init):
    shape = [4, 3, 3, 5]
    jinit, tinit = {"constant": (JI.Constant(0.25), I.Constant(0.25)),
                    "dirac": (JI.Dirac(), I.Dirac()),
                    "bilinear": (JI.Bilinear(), I.Bilinear())}[init]
    j = pt.create_parameter(shape, "float32", default_initializer=jinit)
    t = torch.empty(shape)
    tinit(t)
    np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_calculate_gain_and_global_initializer():
    for name, param in [("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                        ("leaky_relu", None), ("selu", None),
                        ("linear", None)]:
        assert I.calculate_gain(name, param) == JI.calculate_gain(name,
                                                                  param)
    I.set_global_initializer(I.Constant(1.0), I.Constant(0.0))
    try:
        assert isinstance(I._GLOBAL_INIT["weight"], I.Constant)
    finally:
        I.set_global_initializer(None)
    assert I._GLOBAL_INIT == {"weight": None, "bias": None}


# -------------------------------------------------------------- containers
def test_containers_match_jax():
    pt.seed(4)
    def build(nn, **kw):
        seq = nn.Sequential(OrderedDict([
            ("a", nn.Linear(3, 4, **kw)), ("act", nn.Tanh()),
            ("b", nn.Linear(4, 2, **kw))]))
        lst = nn.LayerList([nn.Linear(2, 2, **kw)])
        lst.append(nn.Linear(2, 2, **kw))
        lst.insert(0, nn.Linear(2, 2, **kw))
        lst.extend([nn.Identity()])
        d = nn.LayerDict({"x": nn.Linear(2, 1, **kw)})
        d["y"] = nn.Linear(2, 1, **kw)
        return nn.Sequential(("seq", seq), ("lst", lst), ("d", d))

    j, t = build(pt.nn), build(tnn, device="cpu")
    assert list(t.state_dict()) == list(j.state_dict())
    _carry(j, t)
    x = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    jx, tx = pt.to_tensor(x), torch.from_numpy(x)
    jo, to = j[0](jx), t[0](tx)
    for jl, tl in zip(j[1], t[1]):
        jo, to = jl(jo), tl(to)
    jo = j[2]["x"](jo) + j[2]["y"](jo)
    to = t[2]["x"](to) + t[2]["y"](to)
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **TOL)
    assert len(t[1]) == len(j[1]) == 4 and t[1][-1] is t[1][3]
    assert list(t[2].keys()) == list(j[2].keys()) == ["x", "y"]
    assert len(t[0][:2]) == 2 and isinstance(t[0][:2], tnn.Sequential)
    params = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    params.append(torch.nn.Parameter(torch.zeros(1)))
    assert len(params) == 2 and list(params.state_dict()) == ["0", "1"]
    assert params[-1].shape == (1,)


# -------------------------------------------------------------- nn.utils
def _grads(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((3, 2), (2,))]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_norm_and_value_match_jax(max_norm):
    pt.seed(5)
    jl = pt.nn.Linear(3, 2)
    tl = _carry(jl, tnn.Linear(3, 2, device="cpu"))
    g = _grads(6)
    jl.weight.grad, jl.bias.grad = (pt.to_tensor(a) for a in g)
    tl.weight.grad = torch.from_numpy(g[0].T.copy())
    tl.bias.grad = torch.from_numpy(g[1])
    jt = pt.nn.utils.clip_grad_norm_(jl.parameters(), max_norm)
    tt = tnn.utils.clip_grad_norm_(tl.parameters(), max_norm)
    np.testing.assert_allclose(float(tt), float(jt), **TOL)
    np.testing.assert_allclose(tl.weight.grad.numpy().T,
                               jl.weight.grad.numpy(), **TOL)
    pt.nn.utils.clip_grad_value_(jl.parameters(), 0.1)
    tnn.utils.clip_grad_value_(tl.parameters(), 0.1)
    np.testing.assert_allclose(tl.bias.grad.numpy(), jl.bias.grad.numpy(),
                               **TOL)


def test_parameters_to_vector_and_back_match_jax():
    pt.seed(7)
    jc = pt.nn.Conv1D(2, 3, 3)
    tc = _carry(jc, tnn.Conv1D(2, 3, 3, device="cpu"))
    jv = pt.nn.utils.parameters_to_vector(jc.parameters())
    tv = tnn.utils.parameters_to_vector(tc.parameters())
    np.testing.assert_array_equal(tv.detach().numpy(), jv.numpy())
    tnn.utils.vector_to_parameters(tv * 2, tc.parameters())
    np.testing.assert_array_equal(tc.weight.detach().numpy(),
                                  2 * jc.weight.numpy())


def test_weight_norm_reparameterises_and_folds_back():
    conv = tnn.Conv1D(2, 4, 3, device="cpu")
    x = torch.randn(2, 2, 7, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = conv(x)
        tnn.utils.weight_norm(conv)
        assert sorted(n for n, _ in conv.named_parameters()) == \
            ["bias", "weight_g", "weight_v"]
        assert conv.weight_g.shape == (4,)
        torch.testing.assert_close(conv(x), before)
        conv.weight_g.mul_(2)
        torch.testing.assert_close(conv(x) - conv.bias[None, :, None],
                                   2 * (before - conv.bias[None, :, None]))
        tnn.utils.remove_weight_norm(conv)
    assert sorted(n for n, _ in conv.named_parameters()) == ["bias",
                                                             "weight"]
    assert tnn.utils.spectral_norm(conv) is conv      # as the JAX package


def test_clip_classes_take_param_grad_pairs():
    p = torch.nn.Parameter(torch.zeros(2))
    g = torch.tensor([3.0, 4.0])
    out = tnn.ClipGradByGlobalNorm(1.0)([(p, g)])
    assert out[0][0] is p
    torch.testing.assert_close(out[0][1], torch.tensor([0.6, 0.8]))
    assert isinstance(tnn.ClipGradByValue(1.0), tnn.clip.ClipGradBase)
