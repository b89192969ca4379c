"""The port's ShuffleNetV2 and a MobileNetV3 training step against the JAX package's, on the
CPU, the same seeded weights in both (`torch_vision_zoo`):

* the eval and train-mode forwards (batch norm's running statistics
  after the latter) of ShuffleNetV2 x0.25 and swish at 32 x 32 (the
  sizes of `tests/test_models.py:213-216`), its channel shuffle through
  the port's `tensor_api`;
* one training step of `mobilenet_v3_small(scale=0.5)` (4 classes,
  batch 8, cross entropy, SGD at rate 1 with batch norm in train mode):
  the loss, every gradient (each parameter's change) and the running
  statistics after it.

Tolerances: float32 on both sides, convolutions summed in other orders
by XLA and by oneDNN: logits to 1e-4 of their scale (max(1, max |y|))
in eval mode; the loss to 1e-5 relative; train-mode outputs, gradients
and running statistics by `torch_vision_zoo.check_train`'s rule (within
4x the port's own float32 error against float64, at least 1e-4 of the
scale: batch statistics of eight images at 1 x 1 maps are
ill-conditioned).
"""
import copy

import numpy as np
import pytest
import torch

import torch_cpu_threads
from torch_vision_zoo import (as_numpy, assert_close_scaled, buffers_of,
                              build_pair, check_train, conditioned_error,
                              forward_pair, no_dropout)

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD

torch_cpu_threads.limit()

FORWARDS = [("shufflenet_v2_x0_25", {}), ("shufflenet_v2_swish", {})]


@pytest.mark.parametrize("name, kw", FORWARDS, ids=[f[0] for f in FORWARDS])
def test_shufflenet_forwards_match_jax(name, kw):
    jm, tm = build_pair(name, seed=5, num_classes=7, **kw)
    x = np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32)
    (jy,), (ty,) = forward_pair(jm, tm, x, train=False)
    assert ty.shape == (2, 7)
    assert_close_scaled(ty, jy, 1e-4, "eval")
    no_dropout(jm, tm)
    check_train(jm, tm, np.random.RandomState(11).randn(
        8, *x.shape[1:]).astype(np.float32))


def test_mobilenet_v3_small_training_step_matches_jax():
    """The gradients are read as each parameter's change under SGD at rate
    1; the port's float32 step is held to the JAX step by
    `conditioned_error` against a float64 step of the port."""
    jm, tm = build_pair("mobilenet_v3_small", seed=7, num_classes=4,
                        scale=0.5)
    no_dropout(jm, tm)
    t64 = copy.deepcopy(tm).double()
    rng = np.random.RandomState(8)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = np.array([0, 3, 1, 2, 2, 1, 0, 3])
    before = {k: as_numpy(v).copy() for k, v in jm.state_dict().items()}
    jstep = pt.jit.train_step(
        jm, lambda m, a, b: JF.cross_entropy(m(a), b),
        pt.optimizer.SGD(learning_rate=1.0, parameters=jm.parameters()))
    jloss = float(jstep(pt.to_tensor(x), pt.to_tensor(y)))
    runs = {}
    for name, model, dt in (("f32", tm, torch.float32),
                            ("f64", t64, torch.float64)):
        step = train_step(model, lambda m, a, b: TF.cross_entropy(m(a), b),
                          SGD(learning_rate=1.0,
                              parameters=model.parameters()))
        runs[name] = float(step(torch.from_numpy(x).to(dt),
                                torch.from_numpy(y)))
    np.testing.assert_allclose(runs["f32"], jloss, rtol=1e-5)
    lin = {f"{n}.weight" for n, m in tm.named_modules()
           if isinstance(m, torch.nn.Linear)}
    s32, s64 = tm.state_dict(), t64.state_dict()

    def ref_layout(k, v):
        return v.numpy().T if k in lin else v.numpy()

    for k, _ in tm.named_parameters():
        want = before[k] - as_numpy(jm.state_dict()[k])
        err, allowed = conditioned_error(
            before[k] - ref_layout(k, s32[k]),
            before[k] - ref_layout(k, s64[k]), want)
        assert err <= allowed, (k, err, allowed)
    for k, (got, want) in buffers_of(jm, tm).items():
        err, allowed = conditioned_error(got, s64[k].numpy(), want)
        assert err <= allowed, (k, err, allowed)
