"""The dtypes, the Place API and the top-level functions of the port
against the JAX package's, on the CPU.

* dtypes: the names, string and numpy aliases, `finfo` / `iinfo`,
  `promote_types` and the default dtype as in the JAX package; the
  intended divergence: a 64-bit request stays 64-bit (the JAX package
  makes it 32-bit while JAX's x64 mode is off).
* The Place API: `set_device` / `get_device` / `current_place`, the
  places' equality, `device_count` and `is_compiled_with_*`; the
  intended divergence: the card is "gpu:N" where the JAX package says
  "tpu:N".  `set_device("cpu")` is the explicit request for the CPU
  that `resolve_device(None)` honours; without it and without a card
  `to_tensor`, `create_parameter`, `Model`, `LazyGuard`'s
  materialisation on the default device and `load` raise RuntimeError.
* `to_tensor` keeps the reference's dtypes (float64 data -> the default
  dtype) and values; `create_parameter` its zeros and initializer;
  `summary` its count; the grad-mode switches are torch's.
* `flops`: on a Conv2D + Linear net built from `nn` in both packages
  the two counts agree within 5 % (the port counts the padded taps of a
  convolution and no elementwise operation, XLA the reverse); on
  ResNet-18 at 32 x 32, where most of the last stages' taps fall on
  padding (a 1 x 1 map under a 3 x 3 kernel keeps 1 tap in 9), the gap
  is 1.69x: the intended divergence, held by the port's count equal to
  every tap of every convolution and Linear, 2 flops a multiply-add.
* `save` / `load`: a file written by either package loads in the other,
  tensors, nesting, `stop_gradient` and bfloat16 included.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as P
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import dtypes
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF


@pytest.fixture
def cpu_place():
    """`set_device("cpu")` for the test, the place restored after."""
    before = tdevice._current_place[0]
    P.set_device("cpu")
    yield
    tdevice._current_place[0] = before


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])


# ------------------------------------------------------------------ dtypes
NAMES = ["float64", "float32", "float16", "bfloat16", "int64", "int32",
         "int16", "int8", "uint8", "complex64", "complex128"]


@pytest.mark.parametrize("name", NAMES + ["bool8"])
def test_top_level_dtype_names(name):
    ours, ref = getattr(P, name), getattr(pt, name)
    want = "bool" if name == "bool8" else name
    assert ours == getattr(torch, want) and str(ref) == want
    assert dtypes.dtype_name(ours) == want


@pytest.mark.parametrize("alias", ["float", "double", "half", "bf16",
                                   "long", "int", "short", "bool",
                                   "paddle.float32", np.float32, np.int8])
def test_convert_dtype_matches_jax(alias):
    ours = dtypes.convert_dtype(alias)
    ref = pt.dtypes.convert_dtype(alias)
    expect = {"double": "float64", "long": "int64"}.get(alias, str(ref))
    assert dtypes.dtype_name(ours) == expect


def test_64_bit_requests_stay_64_bit():
    """The intended divergence: the JAX package turns int64 / float64 /
    complex128 into 32 bits while x64 is off; the port keeps them."""
    assert not pt.dtypes.x64_enabled()
    for name in ("int64", "float64", "complex128"):
        assert str(pt.dtypes.convert_dtype(name)) != name
        assert dtypes.convert_dtype(name) == getattr(torch, name)


def test_finfo_iinfo_promote_and_default():
    for name in ("float32", "float16", "bfloat16"):
        assert P.finfo(name).eps == float(pt.finfo(name).eps)
        assert P.finfo(name).max == float(pt.finfo(name).max)
    for name in ("int8", "int16", "int32", "uint8"):
        assert (P.iinfo(name).min, P.iinfo(name).max) == \
            (int(pt.iinfo(name).min), int(pt.iinfo(name).max))
    for a, b in (("float16", "float32"), ("int8", "uint8"),
                 ("int32", "float16"), ("bfloat16", "float16")):
        assert dtypes.dtype_name(dtypes.promote_types(a, b)) == \
            str(pt.dtypes.promote_types(a, b))
    assert dtypes.is_integer_dtype("bool") and \
        pt.dtypes.is_integer_dtype("bool")
    assert dtypes.is_floating_point_dtype("bf16")
    assert P.get_default_dtype() == torch.float32
    P.set_default_dtype("float16")
    try:
        assert P.get_default_dtype() == torch.float16
        assert P.to_tensor([1.5], place="cpu").dtype == torch.float16
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        P.set_default_dtype("int32")


# -------------------------------------------------------------- the places
def test_places_and_set_device(cpu_place):
    assert P.TPUPlace(1) == P.CUDAPlace(1) and P.CPUPlace() != P.TPUPlace()
    assert len({P.CPUPlace(0), P.CPUPlace(0), P.TPUPlace(0)}) == 2
    assert P.get_device() == "cpu:0" and P.device.current_place() == \
        P.CPUPlace(0)
    assert P.resolve_device(None) == torch.device("cpu")
    assert P.set_device("gpu:1") == P.TPUPlace(1)
    assert P.get_device() == "gpu:1"          # the JAX package: "tpu:1"
    assert pt.set_device("gpu:1") == pt.TPUPlace(1)
    assert pt.get_device() == "tpu:1"
    pt.set_device("cpu")
    assert P.set_device("tpu") == P.TPUPlace(0)
    with pytest.raises(ValueError):
        P.set_device("abacus")
    assert P.set_device("cpu") == P.CPUPlace(0)


def test_device_queries_without_a_card(no_card):
    assert P.device_count() == torch.cuda.device_count()
    assert P.is_compiled_with_tpu() is False
    assert P.is_compiled_with_xpu() is False
    assert P.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert P.get_device() == "cpu:0"          # a query, not a request
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        P.resolve_device("gpu:0")
    assert P.device.cuda.device_count() == torch.cuda.device_count()


def test_entry_points_raise_without_a_card_unless_the_cpu_is_named(
        no_card, tmp_path):
    from paddle_tpu_torch.hapi import Model
    for call in (lambda: P.to_tensor([1.0]),
                 lambda: P.create_parameter([2]),
                 lambda: Model(torch.nn.ReLU()),
                 lambda: P.load(str(tmp_path / "x.pdparams"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with P.LazyGuard():
            tnn.Linear(2, 2)
    assert P.to_tensor([1.0], place="cpu").device.type == "cpu"
    assert P.create_parameter([2], device="cpu").device.type == "cpu"
    P.set_device("cpu")
    assert P.to_tensor([1.0]).device.type == "cpu"
    assert P.create_parameter([2]).device.type == "cpu"
    assert Model(torch.nn.ReLU())._device.type == "cpu"
    with P.LazyGuard():
        lin = tnn.Linear(2, 2)
    assert lin.weight.device.type == "cpu"


# ------------------------------------------------------- the top-level API
@pytest.mark.parametrize("data", [[1.5, 2.5], np.arange(6.0).reshape(2, 3),
                                  np.arange(4, dtype=np.int32), [True],
                                  np.ones(3, np.float16)])
def test_to_tensor_matches_jax(data, cpu_place):
    ours = P.to_tensor(data)
    ref = pt.to_tensor(data)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref.numpy()))
    assert dtypes.dtype_name(ours.dtype) == str(ref.dtype)
    assert not ours.requires_grad
    t = P.to_tensor(data, dtype="float32", stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad
    src = torch.ones(2)
    assert P.to_tensor(src).data_ptr() != src.data_ptr()


def test_create_parameter_summary_and_grad_mode(cpu_place):
    ours = P.create_parameter([3, 2])
    ref = pt.create_parameter([3, 2])
    np.testing.assert_array_equal(ours.detach().numpy(),
                                  np.asarray(ref.numpy()))
    assert isinstance(ours, torch.nn.Parameter) and ours.requires_grad
    assert ours.dtype == torch.float32
    from paddle_tpu_torch.nn import initializer as I
    from paddle_tpu.nn import initializer as JI
    p = P.create_parameter([2, 2], "float64",
                           default_initializer=I.Constant(0.5))
    q = pt.create_parameter([2, 2], default_initializer=JI.Constant(0.5))
    assert p.dtype == torch.float64
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(q.numpy()))
    net = tnn.Linear(4, 3, device="cpu")
    assert P.summary(net) == pt.summary(pt.nn.Linear(4, 3)) == \
        {"total_params": 15}
    assert P.no_grad is torch.no_grad and P.enable_grad is torch.enable_grad
    assert P.set_grad_enabled is torch.set_grad_enabled
    with P.no_grad():
        assert not P.is_grad_enabled()
    assert P.is_grad_enabled() == pt.is_grad_enabled()


class _JaxNet(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = pt.nn.Conv2D(3, 8, 3, padding=1)
        self.fc = pt.nn.Linear(8 * 16 * 16, 10)

    def forward(self, x):
        y = pt.nn.functional.relu(self.conv(x))
        return self.fc(y.reshape([x.shape[0], -1]))


class _TorchNet(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2D(3, 8, 3, padding=1, device="cpu")
        self.fc = tnn.Linear(8 * 16 * 16, 10, device="cpu")

    def forward(self, x):
        y = TF.relu(self.conv(x))
        return self.fc(y.reshape([x.shape[0], -1]))


def _every_tap(net, input_size):
    """2 x the multiply-adds of every Conv2D and Linear of `net`, padded
    taps included, from their output shapes in one forward."""
    total, hooks = [0], []

    def conv_hook(m, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        total[0] += 2 * out.numel() * k

    def linear_hook(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    for m in net.modules():
        if "Conv" in type(m).__name__ and m.weight.dim() == 4:
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear_hook))
    with torch.no_grad():
        net(torch.zeros(input_size))
    for h in hooks:
        h.remove()
    return total[0]


def test_flops_against_the_reference():
    size = [2, 3, 16, 16]
    net = _TorchNet()
    ours, ref = P.flops(net, size), pt.flops(_JaxNet(), size)
    assert net.training                      # the mode is put back
    assert ours == _every_tap(net, size)
    assert abs(ours - ref) / ref < 0.05, (ours, ref)
    from paddle_tpu.vision.models import resnet18 as jax_resnet18
    from paddle_tpu_torch.vision.models import resnet18
    r18 = resnet18(num_classes=10, device="cpu").eval()
    ours = P.flops(r18, [1, 3, 32, 32])
    ref = pt.flops(jax_resnet18(num_classes=10), [1, 3, 32, 32])
    assert ours == _every_tap(r18, [1, 3, 32, 32])
    assert 1.5 < ours / ref < 1.9, (ours, ref)     # padded taps: 1.69x


# ----------------------------------------------------------- save and load
def _nested(mod, to_t):
    return {"w": to_t(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "steps": [to_t(np.array([1, 2], np.int32)), 3, "note"],
            "half": to_t(np.array([0.5, -2.0], np.float16))}


def test_save_load_cross_both_ways(tmp_path, cpu_place):
    import ml_dtypes
    # ours -> JAX
    state = _nested(P, torch.from_numpy)
    state["w"].requires_grad_(True)
    state["bf16"] = torch.tensor([1.5, -3.0], dtype=torch.bfloat16)
    P.save(state, str(tmp_path / "ours.pdparams"))
    got = pt.load(str(tmp_path / "ours.pdparams"))
    np.testing.assert_array_equal(np.asarray(got["w"].numpy()),
                                  state["w"].detach().numpy())
    assert got["w"].stop_gradient is False
    assert got["steps"][1:] == [3, "note"]
    assert np.asarray(got["bf16"].numpy()).dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["bf16"].numpy()).astype(np.float32), [1.5, -3.0])
    # JAX -> ours
    ref = _nested(pt, pt.to_tensor)
    ref["bf16"] = pt.to_tensor(np.array([1.5, -3.0], np.float32)).astype(
        "bfloat16")
    pt.save(ref, str(tmp_path / "jax.pdparams"))
    back = P.load(str(tmp_path / "jax.pdparams"))
    np.testing.assert_array_equal(back["w"].numpy(),
                                  np.asarray(ref["w"].numpy()))
    assert back["steps"][0].dtype == torch.int32
    assert back["half"].dtype == torch.float16
    assert back["bf16"].dtype == torch.bfloat16
    assert back["bf16"].tolist() == [1.5, -3.0]
    assert not back["w"].requires_grad
    with pytest.raises(ValueError, match="input_spec"):
        P.save(tnn.Linear(2, 2, device="cpu"), str(tmp_path / "layer"))
