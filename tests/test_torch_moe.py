"""The port's MoE and GPT-MoE against the JAX package's, on the CPU.

Inputs come from seeded numpy generators; weights are drawn by the JAX
package and carried into the port by `load_paddle_tpu_state`.

* `moe_ffn` and `moe_ffn_expert_choice` against the JAX functions:
  outputs, aux losses and the gradients of x and every weight (JAX
  through `jax.vjp`), at top-1 and top-2, with capacities that drop
  choices.  Which (token, expert) choices were kept, and with what
  combine weight, is read from the JAX function itself: with zero
  expert weights and a one-hot bias per expert, its output row is the
  row of combine weights (the routing reads only x and the router).
* `MoELayer`: capacity in training and eval, gate names, the
  ValueErrors, the initialisation.
* GPT-MoE: logits, `gpt_loss_fn` with the aux loss and every gradient,
  with and without recompute; a pure-bf16 Adafactor `TrainStep` loss
  series; `jit_generate`, eager `generate` and `jit_beam_search` tokens;
  `LLMEngine` tokens against the JAX engine's; the parallel flags of
  `GPTConfig`.
* The reference behaviour of ROADMAP C: a token's output depends on the
  other tokens of its call once E > 2 * top_k (eval capacity below n).

Tolerances (float32 on both sides, the products summed in another
order): outputs and aux 1e-5 relative, 1e-6 absolute; gradients 1e-4
relative, 1e-6 absolute; logits 2e-4 / 2e-5; tokens exact.  Expert
choice draws continuous random scores, so no two tokens tie for an
expert's last slot (torch.topk promises no order among ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import moe as jax_moe
from paddle_tpu.jit import functional_bridge as FB
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import decode as jax_decode
from paddle_tpu.text import generation as jax_generation
from paddle_tpu.text import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.incubate import MoELayer, moe_aux_loss
from paddle_tpu_torch.incubate.nn import moe_ffn, moe_ffn_expert_choice
from paddle_tpu_torch.incubate.nn.moe import route_top_k
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, decode,
                                   generate, gpt_loss_fn)
from paddle_tpu_torch.weights import load_paddle_tpu_state

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
NAMES = ("x", "wg", "w1", "b1", "w2", "b2")


# ===================================================================
# moe_ffn and moe_ffn_expert_choice
# ===================================================================
def _inputs(seed, N=24, d=8, f=16, E=4):
    rng = np.random.default_rng(seed)
    shapes = ((N, d), (d, E), (E, d, f), (E, f), (E, f, d), (E, d))
    # the router's weights large enough that the top choices spread
    scale = (1.0, 1.0, 0.3, 0.1, 0.3, 0.1)
    return [(rng.standard_normal(s) * c).astype(np.float32)
            for s, c in zip(shapes, scale)]


def _jax_run(fn, arrays, dy, daux, **kw):
    """(y, aux, grads) of the JAX function, grads through jax.vjp."""
    (y, aux), vjp = jax.vjp(lambda *a: fn(*a, **kw),
                            *[jnp.asarray(a) for a in arrays])
    grads = vjp((jnp.asarray(dy), jnp.asarray(daux, jnp.float32)))
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _port_run(fn, arrays, dy, daux, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, aux = fn(*ts, **kw)
    ((y * torch.from_numpy(dy)).sum() + aux * float(daux)).backward()
    return (y.detach().numpy(), float(aux.detach()),
            [t.grad.numpy() for t in ts])


def _assert_runs_match(want, got):
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    np.testing.assert_allclose(got[1], want[1], **OUT_TOL)
    for name, g, w in zip(NAMES, got[2], want[2]):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def _jax_combine(x, wg, top_k, capacity):
    """JAX's combine weights [N, E] for these tokens and router: its
    output with zero expert weights and the bias of expert e the e-th
    unit vector."""
    N, d = x.shape
    E = wg.shape[1]
    f = 4
    b2 = np.eye(E, d, dtype=np.float32)
    y, _ = jax_moe.moe_ffn(jnp.asarray(x), jnp.asarray(wg),
                           jnp.zeros((E, d, f)), jnp.zeros((E, f)),
                           jnp.zeros((E, f, d)), jnp.asarray(b2),
                           top_k=top_k, capacity=capacity)
    return np.asarray(y)[:, :E]


def _port_combine(x, wg, top_k, capacity):
    """The port's kept choices and combine weights [N, E] from
    `route_top_k`, as the layer combines them."""
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(wg), -1)
    experts, slots, _ = route_top_k(probs, top_k, capacity)
    gates = probs.gather(1, experts) * (slots < capacity)
    w = gates / gates.sum(1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(probs).scatter_add_(1, experts, w)
    return out.numpy(), (slots < capacity).numpy(), experts.numpy()


# (top_k, capacity): a capacity of N keeps every choice; the others drop
ROUTES = [(1, 24), (1, 4), (2, 24), (2, 12), (2, 5)]


@pytest.mark.parametrize("top_k,capacity", ROUTES,
                         ids=[f"top{k}_C{c}" for k, c in ROUTES])
def test_moe_ffn_matches_jax(top_k, capacity):
    arrays = _inputs(0)
    rng = np.random.default_rng(1)
    dy = rng.standard_normal(arrays[0].shape).astype(np.float32)
    want = _jax_run(jax_moe.moe_ffn, arrays, dy, 0.7, top_k=top_k,
                    capacity=capacity)
    got = _port_run(moe_ffn, arrays, dy, 0.7, top_k=top_k,
                    capacity=capacity)
    _assert_runs_match(want, got)


@pytest.mark.parametrize("top_k,capacity", ROUTES,
                         ids=[f"top{k}_C{c}" for k, c in ROUTES])
def test_moe_ffn_keeps_and_drops_the_choices_jax_does(top_k, capacity):
    x, wg = _inputs(0)[:2]
    want = _jax_combine(x, wg, top_k, capacity)
    got, kept, experts = _port_combine(x, wg, top_k, capacity)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    # the (token, expert) pairs kept are JAX's, exactly
    np.testing.assert_array_equal(got > 0, want > 0)
    dropped = int((~kept).sum())
    if capacity == x.shape[0]:
        assert dropped == 0
    else:
        assert dropped > 0, "the capacity drops no choice"
    # every kept choice's expert is one of the token's top-k
    for n in range(x.shape[0]):
        assert set(np.flatnonzero(want[n] > 0)) == \
            set(experts[n][kept[n]].tolist())


def test_later_choices_queue_behind_every_first_choice():
    """With top-2, the second choices take the slots after all first
    choices of their expert: one expert with few slots keeps first
    choices only."""
    N, E = 8, 2
    probs = torch.tensor([[0.9, 0.1]] * 4 + [[0.2, 0.8]] * 4)
    experts, slots, top1 = route_top_k(probs, 2, capacity=N)
    assert experts[:, 0].tolist() == [0] * 4 + [1] * 4
    assert slots[:, 0].tolist() == [0, 1, 2, 3] * 2
    assert slots[:, 1].tolist() == [4, 5, 6, 7] * 2
    assert top1.sum(0).tolist() == [4.0, 4.0]


def test_moe_ffn_ties_go_to_the_first_expert():
    x = np.zeros((4, 8), np.float32)           # every router score equal
    wg = np.ones((8, 4), np.float32)
    got, _, experts = _port_combine(x, wg, 2, 4)
    assert experts.tolist() == [[0, 1]] * 4
    np.testing.assert_allclose(got, _jax_combine(x, wg, 2, 4), **OUT_TOL)


@pytest.mark.parametrize("z", [0.0, 1e-3])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swish"])
def test_moe_ffn_activations_and_z_loss_match_jax(act, z):
    arrays = _inputs(2)
    dy = np.random.default_rng(3).standard_normal(
        arrays[0].shape).astype(np.float32)
    kw = dict(top_k=2, capacity=10, act=act, z_loss_weight=z)
    _assert_runs_match(_jax_run(jax_moe.moe_ffn, arrays, dy, 1.3, **kw),
                       _port_run(moe_ffn, arrays, dy, 1.3, **kw))


@pytest.mark.parametrize("capacity,z", [(6, 0.0), (3, 1e-3), (24, 0.0)])
def test_moe_ffn_expert_choice_matches_jax(capacity, z):
    arrays = _inputs(4)
    dy = np.random.default_rng(5).standard_normal(
        arrays[0].shape).astype(np.float32)
    kw = dict(capacity=capacity, z_loss_weight=z)
    want = _jax_run(jax_moe.moe_ffn_expert_choice, arrays, dy, 0.5, **kw)
    got = _port_run(moe_ffn_expert_choice, arrays, dy, 0.5, **kw)
    _assert_runs_match(want, got)
    if not z:
        assert got[1] == 0.0


def test_moe_ffn_bf16_stays_near_float32():
    """x and the experts in bfloat16: the router still runs in float32 on
    x as given, so the routing and aux are those of float32 on the same
    (rounded) values, and the output is within bf16 rounding (2**-8
    relative, a few roundings deep: 2e-2 of the largest output) of it."""
    arrays = _inputs(6, N=64, d=32, f=64, E=8)
    ts = [torch.from_numpy(a).bfloat16() for a in arrays]
    y16, aux16 = moe_ffn(ts[0], torch.from_numpy(arrays[1]), *ts[2:],
                         top_k=2, capacity=20)
    assert y16.dtype == torch.bfloat16 and aux16.dtype == torch.float32
    y32, aux32 = moe_ffn(ts[0].float(), torch.from_numpy(arrays[1]),
                         *[t.float() for t in ts[2:]], top_k=2, capacity=20)
    assert float(aux16) == float(aux32)
    scale = float(y32.abs().max())
    torch.testing.assert_close(y16.float(), y32, rtol=0, atol=2e-2 * scale)


# ===================================================================
# MoELayer
# ===================================================================
def test_moe_layer_capacity_train_and_eval():
    m = MoELayer(8, 16, num_experts=4, top_k=2, device="cpu")
    assert m.capacity(10) == 7                 # ceil(1.25 * 2 * 10 / 4)
    m.eval()
    assert m.capacity(10) == 10                # ceil(2.0 * 2 * 10 / 4)
    assert m.capacity(100) == 100
    m8 = MoELayer(8, 16, num_experts=8, top_k=2, device="cpu").eval()
    assert m8.capacity(10) == 5                # below n: choices can drop
    m.train()
    m.capacity_factor = 1e-9
    assert m.capacity(10) == 1                 # clamped to [1, n]
    ec = MoELayer(8, 16, num_experts=4, gate="expert_choice",
                  capacity_factor=1.0, device="cpu")
    assert ec.capacity(16) == 4                # k is 1 for expert choice


def test_moe_layer_gate_names_and_errors():
    assert MoELayer(8, 16, 4, top_k=2, gate="switch",
                    device="cpu").top_k == 1
    g = MoELayer(8, 16, 4, top_k=2, gate="gshard", device="cpu")
    assert (g.gate, g.top_k) == ("top_k", 2)
    assert MoELayer(8, 16, 4, gate="expert_choice",
                    device="cpu").gate == "expert_choice"
    with pytest.raises(ValueError, match="gate"):
        MoELayer(8, 16, 2, gate="bogus", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        MoELayer(8, 16, 2, top_k=3, device="cpu")
    MoELayer(8, 16, 2, top_k=3, gate="expert_choice", device="cpu")


def test_moe_layer_initialisation_and_names():
    m = MoELayer(64, 128, num_experts=8, device="cpu",
                 generator=torch.Generator().manual_seed(0)).requires_grad_(
                     False)
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert shapes == {"gate_weight": (64, 8), "w1": (8, 64, 128),
                      "b1": (8, 128), "w2": (8, 128, 64), "b2": (8, 64)}
    for w in (m.w1, m.w2):
        assert abs(float(w.mean())) < 1e-3
        assert abs(float(w.std()) - 0.02) < 5e-4
    assert float(m.gate_weight.std()) == pytest.approx(0.02, abs=3e-3)
    assert not m.b1.any() and not m.b2.any()
    again = MoELayer(64, 128, num_experts=8, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.w1, m.w1)
    assert m.aux_loss is None and moe_aux_loss(m) is None


def test_moe_layer_matches_jax_layer_and_sums_aux():
    """The layer on [b, s, d] in training and eval against the JAX layer
    with the same weights; moe_aux_loss sums over the layers."""
    pt.seed(3)
    jl = jax_moe.MoELayer(16, 32, num_experts=4, top_k=2)
    tl = MoELayer(16, 32, num_experts=4, top_k=2, device="cpu")
    load_paddle_tpu_state(tl, {k: np.asarray(v)
                               for k, v in jl.state_dict().items()})
    x = np.random.default_rng(7).standard_normal((2, 9, 16)).astype(
        np.float32)
    for train in (True, False):
        jl.train() if train else jl.eval()
        tl.train(train)
        want = jl(pt.to_tensor(x)).numpy()
        got = tl(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), want, **OUT_TOL)
        np.testing.assert_allclose(float(tl.aux_loss.detach()),
                                   float(jl.aux_loss),
                                   **OUT_TOL)
    holder = torch.nn.ModuleList([tl, tl])
    assert moe_aux_loss(holder) is tl.aux_loss     # one module, once
    two = torch.nn.ModuleList([tl, MoELayer(16, 32, 4, device="cpu")])
    two[1](torch.from_numpy(x))
    torch.testing.assert_close(moe_aux_loss(two),
                               tl.aux_loss + two[1].aux_loss)


# ===================================================================
# GPT-MoE
# ===================================================================
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
MOE = dict(num_experts=4, moe_top_k=2)


def _pair(seed=0, **over):
    """A JAX GPT-MoE from `seed` and the port's carrying its weights."""
    cfg = dict(TINY, **dict(MOE, **over))
    pt.seed(seed)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **cfg))
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=0, b=2, s=12):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 64, size=(b, s)), rng.randint(0, 64, size=(b, s))


def _j(ids):
    return pt.to_tensor(np.asarray(ids).astype("int64"))


def _t(ids):
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


def test_gpt_moe_builds_with_the_reference_layout():
    cfg = GPTConfig(**dict(TINY, num_layers=4), num_experts=8, moe_top_k=2,
                    moe_capacity_factor=1.25, moe_every=2,
                    moe_aux_weight=0.01)
    tm = GPTForCausalLM(cfg, device="cpu")
    routed = [isinstance(b.mlp, MoELayer) for b in tm.gpt.h]
    assert routed == [False, True, False, True]
    mlp = tm.gpt.h[1].mlp
    assert (mlp.num_experts, mlp.top_k, mlp.capacity_factor) == (8, 2, 1.25)
    # the experts are drawn, not left as torch.empty's memory
    assert abs(float(mlp.w1.std()) - 0.02) < 2e-3
    assert not mlp.b1.any()
    defaults = GPTConfig()
    assert (defaults.num_experts, defaults.moe_top_k,
            defaults.moe_capacity_factor, defaults.moe_every,
            defaults.moe_aux_weight) == (0, 2, 1.25, 1, 0.01)


def test_gpt_config_takes_the_reference_parallel_flags(monkeypatch):
    """A JAX test's config (tensor_parallel=False) builds in the port;
    at mp 2 (the mesh's degrees set by hand) an MoE model under tensor or
    context parallelism raises, naming the distributed slice's open
    item (expert parallelism, ROADMAP.md A11)."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    cfg = GPTConfig(**TINY, tensor_parallel=False, sequence_parallel=False,
                    context_parallel=False, num_experts=4)
    assert cfg.tensor_parallel is False
    GPTForCausalLM(cfg, device="cpu")
    monkeypatch.setitem(mesh_mod._state, "degrees",
                        {"dp": 1, "pp": 1, "mp": 2, "ep": 1})
    for flag in ("tensor_parallel", "context_parallel"):
        with pytest.raises(NotImplementedError, match="A11"):
            GPTConfig(**TINY, num_experts=4, **{flag: True})


@pytest.mark.parametrize("over", [{}, dict(moe_every=2),
                                  dict(num_experts=8, moe_top_k=1),
                                  dict(moe_capacity_factor=0.5)],
                         ids=["E4_top2", "every2", "E8_top1", "dropping"])
def test_gpt_moe_logits_and_loss_match_jax(over):
    """Training mode (the training capacity) and eval mode; with
    `moe_capacity_factor` 0.5 the training forward drops choices."""
    jm, tm = _pair(**over)
    ids, labels = _batch()
    for train in (True, False):
        jm.train() if train else jm.eval()
        tm.train(train)
        want = jm(_j(ids)).numpy()
        with torch.no_grad():
            got = tm(_t(ids)).numpy()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        jloss = float(jax_gpt_loss_fn(jm, _j(ids), _j(labels)))
        with torch.no_grad():
            loss = float(gpt_loss_fn(tm, _t(ids), _t(labels)))
        np.testing.assert_allclose(loss, jloss, **OUT_TOL)
        ce = float(torch.nn.functional.cross_entropy(
            torch.from_numpy(got).reshape(-1, 64), _t(labels).reshape(-1)))
        assert loss - ce == pytest.approx(
            0.01 * float(moe_aux_loss(tm)), rel=1e-4)
    if over.get("moe_capacity_factor"):
        # 24 tokens make 48 choices for 4 experts of 6 slots: some drop
        tm.train()
        assert tm.gpt.h[0].mlp.capacity(24) * 4 < 48


def _jax_grads(jm, ids, labels):
    pn, pa, _, ba = FB.split_state(jm)

    def f(params):
        out, _ = FB.call_functional(
            jm, params, ba, (ids.astype("int64"), labels.astype("int64")),
            fn=lambda *ts: jax_gpt_loss_fn(jm, *ts))
        return out

    loss, grads = jax.jit(jax.value_and_grad(f))(pa)
    return float(loss), {n: np.asarray(g) for n, g in zip(pn, grads)}


def _port_grads(tm, ids, labels):
    tm.zero_grad(set_to_none=True)
    loss = gpt_loss_fn(tm, _t(ids), _t(labels))
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tm.named_parameters()}


@pytest.mark.parametrize("over", [{}, dict(moe_capacity_factor=0.5)],
                         ids=["E4_top2", "dropping"])
def test_gpt_moe_gradients_match_jax_with_and_without_recompute(over):
    """Every gradient (the router's through the aux loss and the kept
    gates) equals JAX's; recompute re-runs the same routing, so its
    gradients equal those without it."""
    ids, labels = _batch(1)
    jm, _ = _pair(**over, use_recompute=True)
    jm.train()
    jloss, jgrads = _jax_grads(jm, ids, labels)
    linear = None
    runs = []
    for use in (False, True):
        _, tm = _pair(**over, use_recompute=use)
        tm.train()
        runs.append(_port_grads(tm, ids, labels))
        linear = {f"{n}.weight" for n, m in tm.named_modules()
                  if isinstance(m, torch.nn.Linear)}
        assert isinstance(tm.gpt.h[0].mlp.aux_loss, torch.Tensor)
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    np.testing.assert_allclose(l0, jloss, **OUT_TOL)
    assert sorted(g0) == sorted(jgrads)
    for n, jg in jgrads.items():
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
        np.testing.assert_allclose(g0[n].numpy(),
                                   jg.T if n in linear else jg,
                                   err_msg=n, **GRAD_TOL)
    assert g0["gpt.h.0.mlp.gate_weight"].abs().sum() > 0


# pure bfloat16 on both sides, rounded at other places (see
# test_torch_gpt_training.py's BF16_LOSS_ATOL): 5 losses within 1e-2
BF16_LOSS_ATOL = 1e-2


def test_pure_bf16_adafactor_train_step_matches_jax():
    ids, labels = _batch()
    jm, tm = _pair()
    jopt = pt.optimizer.Adafactor(learning_rate=1e-2,
                                  parameters=jm.parameters())
    jm, jopt = pt.amp.decorate(models=jm, optimizers=jopt,
                               dtype="bfloat16", master_weight=False)
    jstep = pt.jit.train_step(jm, jax_gpt_loss_fn, jopt)
    jlosses = [float(jstep(_j(ids), _j(labels))) for _ in range(5)]
    opt = optimizer.Adafactor(learning_rate=1e-2,
                              parameters=tm.parameters())
    tm, opt = amp.decorate(models=tm, optimizers=opt, dtype="bfloat16",
                           master_weight=False)
    step = train_step(tm, gpt_loss_fn, opt)
    w1 = tm.gpt.h[0].mlp.w1.detach().clone()
    losses = [float(step(_t(ids), _t(labels))) for _ in range(5)]
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=BF16_LOSS_ATOL)
    assert losses[-1] < losses[0]
    moved = (tm.gpt.h[0].mlp.w1.detach() != w1).flatten(1).any(1)
    assert bool(moved.all()), "an expert's w1 did not move"


GEN_IDS = np.array([[5, 17, 40, 3], [9, 8, 7, 6]])


@pytest.mark.parametrize("experts", [4, 8], ids=["E4_top2", "E8_top2"])
def test_generation_tokens_match_jax(experts):
    """Greedy tokens of the captured-step loop and the eager loop equal
    each other and JAX's: every path routes the same tokens in the same
    calls (at E 8 the eval capacity is below n, so choices can drop, the
    same ones on both sides)."""
    jm, tm = _pair(5, num_experts=experts, vocab_size=96, hidden_size=48,
                   max_position_embeddings=64)
    jm.eval()
    tm.eval()
    want = jax_generation.generate(jm, _j(GEN_IDS), max_new_tokens=8)
    jwant = jax_decode.jit_generate(jm, _j(GEN_IDS), max_new_tokens=8)
    np.testing.assert_array_equal(np.asarray(want.numpy()),
                                  np.asarray(jwant.numpy()))
    jit = decode.jit_generate(tm, _t(GEN_IDS), max_new_tokens=8)
    eager = generate(tm, _t(GEN_IDS), max_new_tokens=8)
    np.testing.assert_array_equal(jit.numpy(), eager.numpy())
    np.testing.assert_array_equal(jit.numpy(), np.asarray(want.numpy()))


def test_jit_beam_search_matches_jax():
    jm, tm = _pair(5, vocab_size=96, hidden_size=48)
    jm.eval()
    tm.eval()
    want = jax_decode.jit_beam_search(jm, _j(GEN_IDS), beam_size=3,
                                      max_new_tokens=6)
    got = decode.jit_beam_search(tm, _t(GEN_IDS), beam_size=3,
                                 max_new_tokens=6)
    assert tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_engine_tokens_match_jax_engine():
    """E 4, top-2: the eval capacity is the call's token count, so no
    choice drops, and the JAX engine's pad tokens (prefill buckets,
    decode slots) cannot move a real token's output."""
    jm, tm = _pair(2)
    jm.eval()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, size=n).tolist() for n in (5, 11, 3, 14)]
    kw = dict(num_blocks=32, block_size=8, max_running=4, prefill_chunk=8)
    want = JaxEngine(jm, **kw).generate_batch(prompts, max_new_tokens=6)
    eng = LLMEngine(tm, **kw)
    assert eng.generate_batch(prompts, max_new_tokens=6) == want
    assert eng.pool.check_leaks() == ([], [])


def test_a_calls_other_tokens_change_an_output_when_choices_drop():
    """ROADMAP C: the eval capacity is ceil(2 * top_k * n / E) for the n
    tokens of one call.  Where E > 2 * top_k it is below n: a token's
    choices can drop because of the tokens it shares the call with, so
    its output depends on them.  Here one token alone keeps both its
    choices; after 31 tokens that route as it does (copies of it) both
    drop, at E 8.  At E 4, top-2 the capacity is n and nothing drops."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 1, 16)).astype(np.float32))
    call = x.expand(1, 32, 16)
    for experts, depends in ((8, True), (4, False)):
        m = MoELayer(16, 32, num_experts=experts, top_k=2, device="cpu",
                     generator=torch.Generator().manual_seed(1)).eval()
        with torch.no_grad():
            alone = m(x)[0, 0]
            shared = m(call)[0, -1]
        assert m.capacity(32) == (16 if experts == 8 else 32)
        assert float(alone.abs().max()) > 1e-3
        if depends:
            assert not shared.any()      # both choices dropped: zeros
        else:
            torch.testing.assert_close(shared, alone, rtol=1e-6, atol=1e-7)


def test_profile_names_the_moe_stages_forward_and_backward():
    """chip_smoke.py's `moe_stage_ms` gives each op's time to the MoE
    stage around it, and each backward op's to the stage of the forward
    op it differentiates (here CPU self time stands in for the kernels'
    device time, which only a card's profile has)."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    _, tm = _pair()
    tm.train()
    ids, labels = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gpt_loss_fn(tm, _t(ids), _t(labels)).backward()
    stages = chip_smoke.moe_stage_ms(prof, 1, attr="self_cpu_time_total")
    want = {s + tail for s in chip_smoke.MOE_STAGES for tail in ("", "_bwd")}
    assert set(stages) == want, stages
    assert all(ms > 0 for ms in stages.values())
