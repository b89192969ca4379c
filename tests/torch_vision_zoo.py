"""Helpers of the vision model tests (`test_torch_vision_models*.py`):
the JAX package's models built without drawing their weights, one set of
seeded numpy weights carried into both packages, and runs of both.

A JAX model is built under its `LazyGuard`, which is left by an
exception, so the deferred initializers never run (a zoo model drawn in
the JAX package's eager mode takes seconds to a minute); its parameters
then take the numpy weights by `set_state_dict`, and the port's model
the same arrays by `load_paddle_tpu_state`.  A JAX forward is the
model's pure function (`jit.functional_bridge.call_functional`, what
`jit.to_static` compiles) under one `jax.jit`: one compile of the whole
network, where op by op the first call compiles every op at its shape.
It is compiled with `REFERENCE_COMPILE`: without XLA's constant folding
(which spends seconds folding the divisor maps of average pools that
exclude their padding: InceptionV3's eval forward compiles in 33 s on
one core with it, 7 s without) and at LLVM optimization level 0 (a
third to a half of the rest); neither changes what is computed, only
how fast the program runs.

A train-mode forward normalizes by batch statistics: where a batch norm
sees few values (a 1 x 1 map late in the network), it is ill-conditioned
and float32 rounding alone moves its output by up to 1e-3 of the logits'
scale at these sizes.  So `check_train` holds the port's float32 result
to the JAX package's within 4x the port's own float32 error against a
float64 run of the same weights (an error that a fault in the port
would not show, since its float64 run shares the fault), or within
1e-4 of the output's scale, whichever is larger.
"""
import copy

import jax
import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu.vision.models as JM
from paddle_tpu.framework import random as jrandom
from paddle_tpu.framework.lazy import LazyGuard
from paddle_tpu.jit import functional_bridge as FB
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.weights import load_paddle_tpu_state


REFERENCE_COMPILE = {"xla_disable_hlo_passes": "constant_folding",
                     "xla_backend_optimization_level": 0}


class _Unbuilt(Exception):
    pass


def jax_shell(name, **kwargs):
    """The JAX package's `name(**kwargs)` with its weights undrawn."""
    try:
        with LazyGuard():
            model = getattr(JM, name)(**kwargs)
            raise _Unbuilt
    except _Unbuilt:
        return model


def shapes(state):
    return {k: tuple(v.shape) for k, v in state.items()}


def random_state(jax_model, seed):
    """Seeded weights for every name of the JAX model's state: Kaiming-
    normal conv and linear weights (fan in: a conv's in / groups x
    kernel, a linear's rows), small biases, batch norms with scales and
    variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in shapes(jax_model.state_dict()).items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "_variance" or (leaf == "weight" and len(s) == 1):
            v = rng.uniform(0.5, 1.5, s)
        elif leaf in ("_mean", "bias"):
            v = 0.1 * rng.randn(*s)
        else:
            fan_in = int(np.prod(s[1:])) if len(s) == 4 else s[0]
            v = rng.randn(*s) * np.sqrt(2.0 / fan_in)
        out[k] = v.astype(np.float32)
    return out


def build_pair(name, seed=0, **kwargs):
    """(JAX model, port model on the CPU) of `name(**kwargs)` holding
    the same seeded weights."""
    jm = jax_shell(name, **kwargs)
    state = random_state(jm, seed)
    jm.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    tm = getattr(TM, name)(device="cpu", **kwargs)
    load_paddle_tpu_state(tm, state)
    return jm, tm


def no_dropout(jm, tm):
    """Dropout off in both models (train-mode runs draw no masks)."""
    for m in jm.sublayers():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    for m in tm.modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def as_numpy(out):
    if isinstance(out, (tuple, list)):
        return [as_numpy(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(getattr(out, "_array", out))


def jax_forward(jm, x):
    """The JAX model's forward on the numpy batch x in its current mode,
    compiled with `REFERENCE_COMPILE`; the batch norms' new running
    statistics written back into the model, as `to_static` does."""
    _, params, _, bufs = FB.split_state(jm)

    def pure(params, bufs, key, x):
        return FB.call_functional(jm, params, bufs, [x], rng_key=key)

    key = jrandom.next_key()
    out, new = jax.jit(pure).lower(params, bufs, key, x).compile(
        compiler_options=REFERENCE_COMPILE)(params, bufs, key, x)
    for (_, b), a in zip(jm.named_buffers(), new):
        b._inplace_assign(a)
    return out


def forward_pair(jm, tm, x, train):
    """Both models on x in train or eval mode (the JAX one through
    `jax_forward`): their outputs as numpy, each a list of heads."""
    jm.train() if train else jm.eval()
    tm.train(train)
    jout = as_numpy(jax_forward(jm, x))
    with torch.no_grad():
        tout = as_numpy(tm(torch.from_numpy(x)))
    listed = isinstance(tout, list)
    return (jout if listed else [jout]), (tout if listed else [tout])


def assert_close_scaled(got, want, tol, what=""):
    """max |got - want| <= tol x max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, (what, err, scale)


def buffers_of(jm, tm):
    """{name: (port value, JAX value)} of every batch-norm statistic."""
    js = {k: as_numpy(v) for k, v in jm.state_dict().items()
          if k.endswith(("_mean", "_variance"))}
    ts = tm.state_dict()
    return {k: (ts[k].numpy(), v) for k, v in js.items()}


def conditioned_error(got32, got64, want):
    """(|got32 - want|, allowed): allowed = max(1e-4, 4 x |got32 -
    got64|), both relative to max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    err = float(np.abs(got32 - want).max()) / scale if want.size else 0.0
    noise = float(np.abs(got32 - got64).max()) / scale if want.size else 0.0
    return err, max(1e-4, 4.0 * noise)


def check_train(jm, tm, x):
    """One train-mode forward of both models (and of a float64 copy of
    the port's): every output head and every running statistic after it
    within `conditioned_error`'s bound."""
    t64 = copy.deepcopy(tm).double()
    jys, tys = forward_pair(jm, tm, x, train=True)
    t64.train()
    with torch.no_grad():
        y64 = as_numpy(t64(torch.from_numpy(x).double()))
    y64 = y64 if isinstance(y64, list) else [y64]
    for i, (ty, y, jy) in enumerate(zip(tys, y64, jys)):
        err, allowed = conditioned_error(ty, y, jy)
        assert err <= allowed, ("train output", i, err, allowed)
    s64 = t64.state_dict()
    for k, (got, want) in buffers_of(jm, tm).items():
        err, allowed = conditioned_error(got, s64[k].numpy(), want)
        assert err <= allowed, (k, err, allowed)
