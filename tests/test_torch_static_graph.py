"""The port's static graph (`enable_static`, `static.data`, `Program`,
`Executor.run`, `minimize`, `save_inference_model` /
`load_inference_model`) against the JAX package's `paddle_tpu.static`.

The program is `examples/static_mnist.py`'s (784-128-10, Adam 1e-3,
batch 64) on synthetic separable digits made with numpy, built in both
packages, with the loss summed over the batch: the JAX package's static
`mean` divides by the batch the placeholder had at build time (1 for a
`None` dim), a reference behaviour
(`test_reference_static_mean_divides_by_the_build_time_batch`), where
the port's divides by the fed batch.  The port's `Sequential` takes the
JAX one's weights through `load_paddle_tpu_state`.  The port's Executor compiles each program with
the `aot_eager` backend (the private `jit._BACKEND` switch): the capture
and the replay are the subject, not Inductor's code.

Tolerances: float32 on both sides, summed in another order; Adam
normalises each update to about the learning rate, so the loss series
agree to rtol 1e-4 / atol 1e-5 over 5 steps; logits of the reloaded
programs to rtol 1e-4 / atol 1e-5; the port's reloaded program against
its own for_test run exactly in value (the same replay, exported).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import static_graph as JSG
import paddle_tpu_torch as tp
from paddle_tpu_torch import base, jit, nn, optimizer, static
from paddle_tpu_torch.framework import static_graph as SG
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import compile_tracker as ct
from paddle_tpu_torch.weights import load_paddle_tpu_state

import torch_cpu_threads

torch_cpu_threads.limit()

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 5


@pytest.fixture
def cpu_place():
    """`set_device("cpu")` for the test, the place restored after."""
    from paddle_tpu_torch import device
    before = device._current_place[0]
    tp.set_device("cpu")
    yield
    device._current_place[0] = before


@pytest.fixture
def static_mode(monkeypatch, cpu_place):
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    tp.enable_static()
    SG.reset()
    yield
    SG.reset()
    tp.disable_static()


def _digits(seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype(np.float32)

    def batch(n=64):
        lab = rng.randint(0, 10, n)
        img = centers[lab] + 0.3 * rng.randn(n, 784).astype(np.float32)
        return img, lab.astype(np.int64)
    return batch


def _jax_program(tmp_path):
    """The JAX package's run of the program: (weights, loss series,
    reloaded logits on the last batch)."""
    batch = _digits()
    jp.enable_static()
    JSG.reset()
    try:
        x = jp.static.data("x", [None, 784], "float32")
        y = jp.static.data("y", [None], "int64")
        jp.seed(0)
        net = jnn.Sequential(jnn.Linear(784, 128), jnn.ReLU(),
                             jnn.Linear(128, 10))
        weights = {k: np.asarray(v) for k, v in net.state_dict().items()}
        logits = net(x)
        loss = JF.cross_entropy(logits, y, reduction="sum")
        jp.optimizer.Adam(learning_rate=1e-3,
                          parameters=net.parameters()).minimize(loss)
        exe = jp.static.Executor()
        exe.run(jp.static.default_startup_program())
        losses = []
        for _ in range(STEPS):
            img, lab = batch()
            (lv,) = exe.run(feed={"x": img, "y": lab}, fetch_list=[loss])
            losses.append(float(np.asarray(lv)))
        path = str(tmp_path / "jax_model")
        jp.static.save_inference_model(path, [x], [logits], exe)
        prog, feeds, fetches = jp.static.load_inference_model(path, exe)
        (out,) = exe.run(prog, feed={feeds[0]: img}, fetch_list=fetches)
    finally:
        JSG.reset()
        jp.disable_static()
    return weights, losses, np.asarray(out), img


def test_mnist_program_matches_jax_and_round_trips(static_mode, tmp_path):
    weights, jlosses, jout, last_img = _jax_program(tmp_path)
    batch = _digits()
    x = static.data("x", [None, 784], "float32")
    y = static.data("y", [None], "int64")
    net = nn.Sequential(nn.Linear(784, 128), nn.ReLU(), nn.Linear(128, 10))
    load_paddle_tpu_state(net, weights)
    logits = net(x)
    loss = F.cross_entropy(logits, y, reduction="sum")
    optimizer.Adam(learning_rate=1e-3,
                   parameters=net.parameters()).minimize(loss)
    exe = static.Executor()
    assert exe.run(static.default_startup_program()) == []
    ct.reset()
    losses = []
    for _ in range(STEPS):
        img, lab = batch()
        (lv,) = exe.run(feed={"x": img, "y": lab}, fetch_list=[loss])
        losses.append(float(lv))
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    # one compile for the steady feed signature
    assert [e.cause for e in ct.events()] == ["first compile"]

    path = str(tmp_path / "port_model")
    static.save_inference_model(path, [x], [logits], exe)
    prog, feeds, fetches = static.load_inference_model(path, exe)
    assert feeds == ["x"] and fetches == [0]
    (out,) = exe.run(prog, feed={"x": last_img}, fetch_list=fetches)
    test_prog = static.default_main_program().clone(for_test=True)
    (ref,) = exe.run(test_prog, feed={"x": last_img}, fetch_list=[logits])
    np.testing.assert_allclose(out, ref, rtol=0, atol=0)
    np.testing.assert_allclose(out, jout, **LOSS_TOL)
    # the exported program takes another batch size (a None dim)
    (out3,) = exe.run(prog, feed={"x": last_img[:3]}, fetch_list=fetches)
    np.testing.assert_allclose(out3, ref[:3], rtol=1e-6, atol=1e-6)


def _regression():
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 4], "float32")
        y = static.data("y", [None, 1], "float32")
        model = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 1))
        pred = model(x)
        loss = F.mse_loss(pred, y)
        optimizer.Adam(learning_rate=0.05,
                       parameters=model.parameters()).minimize(loss)
    return main, startup, x, y, pred, loss


def test_training_converges_and_clone_for_test_is_pure(static_mode):
    main, startup, x, y, pred, loss = _regression()
    exe = static.Executor()
    exe.run(startup)
    test_prog = main.clone(for_test=True)
    feed = {"x": np.ones((3, 4), np.float32),
            "y": np.zeros((3, 1), np.float32)}
    (p1,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
    (p2,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
    np.testing.assert_allclose(p1, p2)      # no optimizer side effects
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    losses = []
    for _ in range(30):
        xb = rng.randn(16, 4).astype(np.float32)
        (lv,) = exe.run(main, feed={"x": xb, "y": xb @ w}, fetch_list=[loss])
        losses.append(float(lv))
    assert losses[-1] < losses[0] * 0.1
    (p3,) = exe.run(test_prog, feed=feed, fetch_list=[pred])
    assert not np.allclose(p1, p3)          # reads the live parameters


def test_feed_signatures_compile_once_each(static_mode):
    main, startup, x, y, pred, loss = _regression()
    test_prog = main.clone(for_test=True)
    exe = static.Executor()
    ct.reset()
    for n in (3, 3, 5, 3):
        exe.run(test_prog, feed={"x": np.ones((n, 4), np.float32)},
                fetch_list=[pred])
    assert [e.cause for e in ct.events()] == ["first compile"] * 2


def test_errors_match_the_reference(static_mode):
    main, startup, x, y, pred, loss = _regression()
    exe = static.Executor()
    with pytest.raises(ValueError, match="feed missing"):
        exe.run(main.clone(for_test=True), feed={}, fetch_list=[pred])
    eager = torch.ones(2)
    with pytest.raises(ValueError, match="not recorded"):
        exe.run(main, feed={"x": np.ones((1, 4), np.float32)},
                fetch_list=[eager])
    with pytest.raises(ValueError, match="duplicate"):
        with static.program_guard(main):
            static.data("x", [None, 4], "float32")
    with pytest.raises(NotImplementedError):
        with static.program_guard(main):
            optimizer.SGD(parameters=[]).minimize(loss)
    tp.disable_static()
    try:
        assert tp.in_dynamic_mode()
        with pytest.raises(RuntimeError, match="enable_static"):
            static.data("z", [1], "float32")
    finally:
        tp.enable_static()
    assert not tp.in_dynamic_mode()


def test_random_creation_draws_anew_each_run(static_mode):
    x = static.data("x", [None, 3], "float32")
    noisy = x + torch.randn(2, 3)
    exe = static.Executor()
    feed = {"x": np.zeros((2, 3), np.float32)}
    (a,) = exe.run(feed=feed, fetch_list=[noisy])
    (b,) = exe.run(feed=feed, fetch_list=[noisy])
    assert a.shape == (2, 3) and not np.allclose(a, b)


def test_fluid_layers_and_static_nn_build_programs(static_mode):
    x = base.layers.data("x", [None, 6], "float32")
    h = base.layers.fc(x, 5, act="relu")
    out = static.nn.fc(h, 2, name="head")
    same = static.nn.fc(h, 2, name="head")     # named: the same layer
    exe = static.Executor()
    feed = {"x": np.ones((4, 6), np.float32)}
    o1, o2 = exe.run(feed=feed, fetch_list=[out, same])
    assert o1.shape == (4, 2)
    np.testing.assert_allclose(o1, o2)
    with base.dygraph.guard():
        assert isinstance(base.dygraph.to_variable(np.ones(2)),
                          torch.Tensor)
    assert base.CUDAPlace is tp.CUDAPlace
    with pytest.raises(NotImplementedError):
        base.create_lod_tensor()


def test_reference_static_mean_divides_by_the_build_time_batch(cpu_place):
    """Reference behaviour the parity test accounts for: in the JAX
    package's static mode a `mean` over a `None` dim divides by its
    build-time size 1, so it returns the sum; the port's returns the
    mean of the fed batch."""
    logits = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    lab = np.array([0, 2, 1, 1], np.int64)
    jp.enable_static()
    JSG.reset()
    try:
        x = jp.static.data("x", [None, 3], "float32")
        y = jp.static.data("y", [None], "int64")
        loss = JF.cross_entropy(x, y, reduction="mean")
        (jl,) = jp.static.Executor().run(feed={"x": logits, "y": lab},
                                         fetch_list=[loss])
    finally:
        JSG.reset()
        jp.disable_static()
    per = -torch.log_softmax(torch.from_numpy(logits), -1)[
        torch.arange(4), torch.from_numpy(lab)]
    np.testing.assert_allclose(float(jl), float(per.sum()), rtol=1e-5)
    tp.enable_static()
    SG.reset()
    try:
        x = static.data("x", [None, 3], "float32")
        y = static.data("y", [None], "int64")
        loss = F.cross_entropy(x, y, reduction="mean")
        (tl,) = static.Executor().run(feed={"x": logits, "y": lab},
                                      fetch_list=[loss])
    finally:
        SG.reset()
        tp.disable_static()
    np.testing.assert_allclose(float(tl), float(per.mean()), rtol=1e-5)
