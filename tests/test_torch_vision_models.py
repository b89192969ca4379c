"""The port's vision model zoo (`paddle_tpu_torch.vision.models`)
against the JAX package's, on the CPU: every builder's state names and
shapes, the builders' device rule, the feature-extractor contracts and
the plain stacks' forwards.

* all 32 of the JAX package's builders (the 28 new ones and resnet18 /
  34 / 50 / 101) and VGG with batch norm, MobileNet at other scales:
  the same parameter and buffer names, shapes equal (a Linear's weight
  transposed: [out, in] here, [in, out] there);
* without a card a builder raises unless the CPU is named;
* the eval and train-mode forwards (batch norm's running statistics
  after the latter) of LeNet (1 x 28 x 28), AlexNet (64), VGG11 with
  batch norm (32), SqueezeNet 1.0 and 1.1 (64) at the sizes of
  `tests/test_models.py:213-216`, the same seeded weights in both
  (`torch_vision_zoo`), dropout off for the train-mode runs.

Tolerances: float32 on both sides, convolutions summed in other orders
by XLA and by oneDNN: logits to 1e-4 of their scale (max(1, max |y|))
in eval mode; train-mode outputs (batch 8) and running statistics by
`torch_vision_zoo.check_train`'s rule (within 4x the port's own float32
error against float64, at least 1e-4 of the scale).
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads
from torch_vision_zoo import (assert_close_scaled, build_pair, check_train,
                              forward_pair, jax_shell, no_dropout, shapes)

import paddle_tpu_torch.vision.models as TM
from paddle_tpu_torch import device as tdevice

torch_cpu_threads.limit()

BUILDERS = [
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "resnext50_32x4d", "vgg11", "vgg13", "vgg16",
    "vgg19", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large", "alexnet", "squeezenet1_0", "squeezenet1_1",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "googlenet", "inception_v3", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
VARIANTS = [("vgg11", dict(batch_norm=True)),
            ("mobilenet_v1", dict(scale=0.25)),
            ("mobilenet_v2", dict(scale=1.4)),
            ("mobilenet_v3_large", dict(scale=0.75))]


def _linear_weights(model):
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


def _port_shapes(model):
    lin = _linear_weights(model)
    return {k: tuple(v.shape)[::-1] if k in lin else tuple(v.shape)
            for k, v in model.state_dict().items()}


def test_the_builders_are_the_reference_ones():
    import paddle_tpu.vision.models as JM
    ref = sorted(n for n in vars(JM) if n[0].islower() and callable(
        getattr(JM, n)) and not n.startswith("_"))
    assert sorted(BUILDERS) == ref


@pytest.mark.parametrize("name, kwargs",
                         [(b, {}) for b in BUILDERS] + VARIANTS,
                         ids=[b for b in BUILDERS]
                         + [f"{b}-{next(iter(k))}" for b, k in VARIANTS])
def test_builder_state_names_and_shapes_match_jax(name, kwargs):
    want = shapes(jax_shell(name, num_classes=10, **kwargs).state_dict())
    got = _port_shapes(getattr(TM, name)(num_classes=10, device="cpu",
                                         **kwargs))
    assert got == want


def test_builders_need_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    for name in ("lenet", "alexnet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            (TM.LeNet if name == "lenet" else TM.alexnet)()
    assert TM.LeNet(device="cpu").fc[0].weight.device.type == "cpu"


def test_builders_draw_from_the_generator():
    g = torch.Generator().manual_seed(3)
    a = TM.mobilenet_v3_small(scale=0.5, device="cpu", generator=g)
    b = TM.mobilenet_v3_small(scale=0.5, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    c = TM.mobilenet_v3_small(scale=0.5, device="cpu")
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.features[0].weight, c.features[0].weight)
    with pytest.raises(NotImplementedError, match="pretrained"):
        TM.alexnet(pretrained=True, device="cpu")


FORWARDS = [("LeNet", 28, {}), ("alexnet", 64, {}),
            ("vgg11", 32, dict(batch_norm=True)), ("squeezenet1_0", 64, {}),
            ("squeezenet1_1", 64, {})]


@pytest.mark.parametrize("name, size, kw", FORWARDS,
                         ids=[f[0] for f in FORWARDS])
def test_plain_stack_forwards_match_jax(name, size, kw):
    jm, tm = build_pair(name, seed=3, num_classes=7, **kw)
    chans = 1 if name == "LeNet" else 3
    x = np.random.RandomState(4).randn(2, chans, size, size).astype(
        np.float32)
    (jy,), (ty,) = forward_pair(jm, tm, x, train=False)
    assert ty.shape == (2, 7)
    assert_close_scaled(ty, jy, 1e-4, "eval")
    no_dropout(jm, tm)
    check_train(jm, tm, np.random.RandomState(11).randn(
        8, *x.shape[1:]).astype(np.float32))
