"""The port's compile path (`jit.to_static` over `torch.compile`) against
the JAX package's (`paddle_tpu.jit.to_static` over `jax.jit`), and the
flash operators that keep the hand kernels inside a compiled graph.

One GPT (2 layers, hidden 32) is compiled by Inductor, once for the file
(a module fixture); the cases that check semantics alone compile with
the `aot_eager` backend (the private `jit._BACKEND` switch), which runs
the same Dynamo capture and AOTAutograd split without generating code.

Tolerances: float32 on both sides, summed in another order: the loss
within rtol 1e-5 / atol 1e-6, every parameter gradient within rtol 1e-4
/ atol 1e-6 (as `tests/test_torch_gpt_training.py`); the compiled port
against its own eager run within rtol 1e-5 / atol 1e-6 (Inductor fuses
and reorders the float32 sums).
"""
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import paddle_tpu as pt
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu_torch import jit, observability, ops
from paddle_tpu_torch.observability import compile_tracker as ct
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM, gpt_loss_fn
from paddle_tpu_torch.weights import load_paddle_tpu_state

import torch_cpu_threads

torch_cpu_threads.limit()

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def aot_eager(monkeypatch):
    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")


def _batch(seed=0, b=2, s=12):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, size=(b, s)).astype("int64"),
            rng.randint(0, 64, size=(b, s)).astype("int64"))


def _linear_names(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


@pytest.fixture(scope="module")
def compiled_gpt():
    """The JAX GPT from seed 0, its to_static; the port's GPT with its
    weights loaded through the StaticFunction, compiled by Inductor; and
    the first step's compile events."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **TINY))
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    st = jit.to_static(tm)
    # weights.load_paddle_tpu_state reads the wrapped GPT through the
    # StaticFunction
    load_paddle_tpu_state(st, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    ct.reset()
    ids, labels = _batch()
    loss = gpt_loss_fn(st, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    events = ct.events(st._label)
    return types.SimpleNamespace(jm=jm, tm=tm, st=st, loss=loss,
                                 events=events)


def test_gpt_loss_and_gradients_match_jax_to_static(compiled_gpt):
    g = compiled_gpt
    jst = pt.jit.to_static(g.jm)
    ids, labels = _batch()
    jloss = jax_gpt_loss_fn(jst, pt.to_tensor(ids), pt.to_tensor(labels))
    jloss.backward()
    np.testing.assert_allclose(g.loss.item(), float(jloss.numpy()),
                               **LOSS_TOL)
    linear = _linear_names(g.tm)
    jgrads = {n: p.grad.numpy() for n, p in g.jm.named_parameters()}
    for n, p in g.tm.named_parameters():
        want = jgrads[n].T if n in linear else jgrads[n]
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=n,
                                   **GRAD_TOL)


def test_one_compile_no_graph_break_then_steady(compiled_gpt):
    """The first step compiled one graph with no break; later steps of
    the same signature compile nothing, also across optimizer steps and
    cleared gradients, and give what the eager model gives."""
    g = compiled_gpt
    assert [(e.cause, e.graphs, e.graph_breaks) for e in g.events] == \
        [("first compile", 1, 0)]
    from paddle_tpu_torch.optimizer import SGD
    opt = SGD(learning_rate=1e-2, parameters=g.tm.parameters())
    ids, labels = (torch.from_numpy(a) for a in _batch(seed=1))
    for _ in range(2):
        loss = gpt_loss_fn(g.st, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert ct.compile_count(g.st._label) == 1
    assert ct.graph_breaks(g.st._label) == 0
    eager = gpt_loss_fn(g.tm, ids, labels)
    compiled = gpt_loss_fn(g.st, ids, labels)
    assert ct.compile_count(g.st._label) == 1
    np.testing.assert_allclose(compiled.item(), eager.item(), **SELF_TOL)


def test_tracker_causes_and_static_arguments(aot_eager):
    """Bool / str / None arguments specialise the program ("new static
    arg"); a new shape recompiles ("shape change"); a seen signature
    compiles nothing; the training flag is part of the signature."""
    ct.reset()

    def f(x, scale_up, mode):
        y = x * 2.0 if scale_up else x
        return y + 1.0 if mode == "plus" else y

    st = jit.to_static(f)
    x = torch.ones(3)
    torch.testing.assert_close(st(x, True, "plus"), torch.full((3,), 3.0))
    st(torch.ones(5), True, "plus")
    torch.testing.assert_close(st(x, False, "plus"), torch.full((3,), 2.0))
    torch.testing.assert_close(st(x, False, None), torch.ones(3))
    st(x, True, "plus")
    causes = [e.cause for e in ct.events(st._label)]
    assert causes == ["first compile", "shape change", "new static arg",
                      "new static arg"]
    assert ct.compile_count(st._label) == 4

    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.Dropout(0.5))
    sl = jit.to_static(net)
    sl(torch.ones(2, 3))
    net.eval()
    sl(torch.ones(2, 3))
    assert [e.cause for e in ct.events(sl._label)] == ["first compile",
                                                       "new static arg"]
    # a Linear's forward reads no training flag: Dynamo reuses its graph,
    # and the new signature records no compile
    lin = torch.nn.Linear(3, 3)
    sl = jit.to_static(lin)
    sl(torch.ones(2, 3))
    lin.eval()
    sl(torch.ones(2, 3))
    assert [e.cause for e in ct.events(sl._label)] == ["first compile"]


def test_recompile_warning_and_telemetry_reset(aot_eager):
    ct.reset()
    ct.set_warn_after(2)
    try:
        st = jit.to_static(lambda x: x * 3.0)
        with pytest.warns(observability.RecompileWarning):
            for n in range(1, 5):
                st(torch.ones(n))
    finally:
        ct.set_warn_after(5)
    assert ct.compile_count(st._label) == 4
    observability.reset()
    assert ct.events() == [] and ct.compile_count(st._label) == 0


def test_graph_breaks_counted_or_refused(aot_eager):
    """full_graph=True (the default) refuses a graph break with Dynamo's
    own error, without running the function again in Python; with
    full_graph=False the tracker counts it."""
    calls = []

    def f(x):
        calls.append(1)
        y = x * 2.0
        torch._dynamo.graph_break()
        return y + 1.0

    with pytest.raises(torch._dynamo.exc.Unsupported):
        jit.to_static(f)(torch.ones(2))
    assert calls == []
    ct.reset()
    st = jit.to_static(f, full_graph=False)
    torch.testing.assert_close(st(torch.ones(2)), torch.full((2,), 3.0))
    (ev,) = ct.events(st._label)
    assert ev.graph_breaks == 1 and ev.graphs == 2


def test_enable_to_static_runs_the_original_python(aot_eager):
    calls = []

    def f(x):
        calls.append(1)      # a Python side effect: once per eager call
        return x + 1.0

    st = jit.to_static(f)
    jit.enable_to_static(False)
    try:
        st(torch.ones(1))
        st(torch.ones(1))
    finally:
        jit.enable_to_static(True)
    assert len(calls) == 2


def test_static_function_saves_as_its_layer(aot_eager, tmp_path):
    lin = torch.nn.Linear(4, 2)
    st = jit.to_static(lin)
    jit.save(st, str(tmp_path / "m"), input_spec=[jit.InputSpec([None, 4])])
    loaded = jit.load(str(tmp_path / "m"))
    x = torch.randn(3, 4)
    torch.testing.assert_close(loaded(x), lin(x).detach())
    with pytest.raises(ValueError):
        jit.save(st, str(tmp_path / "n"))


def test_plain_sdpa_calls_count_inside_a_compiled_graph():
    """`ops._count_plain_call` (what a CUDA `sdpa` outside the flash gate
    calls) counts each run of a compiled graph, not its trace."""
    def f(x):
        ops._count_plain_call()
        y = x * 2.0
        ops._count_plain_call()
        return y.sum()

    for backend in ("aot_eager", "inductor"):
        torch._dynamo.reset()
        before = ops.sdpa.plain_calls
        cf = torch.compile(f, backend=backend, fullgraph=True)
        x = torch.randn(4, requires_grad=True)
        for _ in range(3):
            cf(x).backward()
        assert ops.sdpa.plain_calls - before == 6, backend
        ops.sdpa.plain_calls = before


# ---------------------------------------------------- the flash operators
def _flash_inputs(seed=5, B=2, L=24, H=4, Hkv=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k, v = (rng.randn(B, L, Hkv, D).astype(np.float32) for _ in range(2))
    do = rng.randn(B, L, H, D).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, do)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_op_matches_the_plain_backward(causal):
    """The backward operator on the CPU is `flash_bwd_plain` (exact:
    the same computation) and the forward operator's registered backward
    returns what it gives."""
    q, k, v, do = _flash_inputs()
    scale = tfa._scale(None, q.shape[-1])
    o, lse = tfa.flash_fwd_op(q, k, v, None, causal, scale, 0)
    got = tfa.flash_bwd_op(q, k, v, o, lse, do, None, causal, scale, 0)
    want = tfa.flash_bwd_plain(q, k, v, do, lse, tfa._delta(do, o), None,
                               causal, scale, 0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qq, kk, vv, is_causal=causal).backward(do)
    for g, w in zip((qq.grad, kk.grad, vv.grad), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_both_flash_operators_pass_opcheck():
    q, k, v, do = _flash_inputs(seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    scale = tfa._scale(None, q.shape[-1])
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_fwd.default,
                          (q, k, v, None, True, scale, 0))
    with torch.no_grad():
        o, lse = tfa.flash_fwd_op(q, k, v, None, True, scale, 0)
    torch.library.opcheck(
        torch.ops.paddle_tpu_torch.flash_bwd.default,
        (q.detach(), k.detach(), v.detach(), o, lse, do, None, True, scale,
         0))


def test_registered_backward_traces_on_fake_cuda_tensors():
    """The repair: AOTAutograd runs a compiled graph's backward on fake
    tensors.  The registered backward must reach the backward operator
    (whose fake gives the shapes), not the ctypes launch of the kernels,
    which needs real storage."""
    with FakeTensorMode():
        q, k, v, o, do = (torch.empty(2, 64, 4, 64, device="cuda",
                                      dtype=torch.bfloat16)
                          for _ in range(5))
        lse = torch.empty(2, 4, 64, device="cuda")
        ctx = types.SimpleNamespace(saved_tensors=(q, k, v, None, o, lse),
                                    args=(True, 0.125, 0))
        grads = tfa._flash_fwd_op_backward(ctx, do, None)
    assert [(g.shape, g.device.type, g.dtype) for g in grads[:3]] == \
        [((2, 64, 4, 64), "cuda", torch.bfloat16)] * 3
    assert grads[3:] == (None,) * 4


def _recording_backend(seen):
    """aot_eager that keeps the targets of the forward and backward
    graphs AOTAutograd hands on."""
    from functorch.compile import make_boxed_func
    from torch._dynamo.backends.common import aot_autograd

    def rec(kind):
        def compiler(gm, example_inputs):
            seen[kind] = [str(n.target) for n in gm.graph.nodes]
            return make_boxed_func(gm.forward)
        return compiler

    return aot_autograd(fw_compiler=rec("fw"), bw_compiler=rec("bw"))


@pytest.mark.parametrize("backend", ["recorded", "inductor"])
def test_compiled_flash_attention_keeps_both_operators(monkeypatch, backend):
    """Flash attention under to_static: the forward graph holds the
    forward operator and the backward graph the backward operator (each
    one node), and the compiled gradients equal the eager ones."""
    seen = {}
    monkeypatch.setattr(jit, "_BACKEND", _recording_backend(seen)
                        if backend == "recorded" else backend)
    q, k, v, do = _flash_inputs(seed=8)

    def f(q, k, v):
        return tfa.flash_attention(q, k, v, is_causal=True)

    st = jit.to_static(f)
    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    st(*qs).backward(do)
    qe = [t.clone().requires_grad_() for t in (q, k, v)]
    f(*qe).backward(do)
    if backend == "recorded":
        assert sum("flash_fwd" in t for t in seen["fw"]) == 1, seen["fw"]
        assert sum("flash_bwd" in t for t in seen["bw"]) == 1, seen["bw"]
    for a, b in zip(qs, qe):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_the_wrapped_layers_own_hooks_do_not_run(aot_eager):
    """Intended divergence: to_static compiles the Layer's forward, so
    hooks on the wrapped Layer itself do not run (its sublayers' do)."""
    outer_calls, inner_calls = [], []
    net = torch.nn.Sequential(torch.nn.Linear(2, 2))
    net.register_forward_hook(lambda m, i, o: outer_calls.append(1))
    net[0].register_forward_hook(lambda m, i, o: inner_calls.append(1))
    jit.to_static(net)(torch.ones(1, 2))
    assert outer_calls == [] and inner_calls == [1]
