"""The port's fleet training step in gloo ranks against the JAX package's
`DistributedTrainStep` on its virtual mesh, on the CPU.

A tiny GPT (vocab 64, hidden 32, 4 heads, 2 layers, as
`tests/test_distributed.py:136-182`) and a tiny LLaMA with GQA (kv heads
2) are built in the JAX package under each hybrid strategy; their
weights and one batch go to the ranks as .npz.  Every rank builds the
port's model under the same strategy (`fleet.init`), loads the dense
weights (each parallel layer keeps its piece), and returns the full
logits, a 3-step loss series of `fleet.build_train_step` and the gathered
parameters, which are held against the JAX step's within rtol 1e-4,
atol 1e-5 in float32 (`tests/test_distributed.py:159`).  Momentum is the
optimizer there: Adam turns float32 rounding noise in near-zero
gradients into whole steps.  ZeRO stages 1 and 2 run Adam and are held
against the unsharded port step and the JAX step's losses.

One module fixture launches 2 gloo ranks for every 2-rank check, another
4 ranks for dp 2 x mp 2.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.nn import functional as JF
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text import LlamaForCausalLM as JaxLlama
from paddle_tpu.text import gpt_loss_fn as jax_gpt_loss_fn
from torch_gloo import Ranks

TINY_GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=32, hidden_dropout=0.0,
                attention_dropout=0.0)
TINY_LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=48,
                  max_position_embeddings=32)
TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
LR = {"momentum": 0.1, "adam": 0.02}

# name: (family, hybrid, model flags, optimizer, global-norm clip)
CASES = {
    "mp2": ("gpt", {"mp_degree": 2}, {"tensor_parallel": True},
            "momentum", None),
    "dp2": ("gpt", {"dp_degree": 2}, {}, "momentum", None),
    "sp": ("gpt", {"mp_degree": 2},
           {"tensor_parallel": True, "sequence_parallel": True},
           "momentum", None),
    "cp": ("gpt", {"mp_degree": 2},
           {"tensor_parallel": False, "context_parallel": True},
           "momentum", None),
    "mp2_clip": ("gpt", {"mp_degree": 2}, {"tensor_parallel": True},
                 "momentum", 0.05),
    "zero2_clip": ("gpt", {"dp_degree": 2, "sharding_stage": 2}, {},
                   "momentum", 0.05),
    "llama_mp2": ("llama", {"mp_degree": 2}, {"tensor_parallel": True},
                  "momentum", None),
    "llama_sp": ("llama", {"mp_degree": 2},
                 {"tensor_parallel": True, "sequence_parallel": True},
                 "momentum", None),
    "zero1": ("gpt", {"dp_degree": 2, "sharding_stage": 1}, {}, "adam",
              None),
    "zero2": ("gpt", {"dp_degree": 2, "sharding_stage": 2}, {}, "adam",
              None),
    "dp2_adam": ("gpt", {"dp_degree": 2}, {}, "adam", None),
}
FOUR = {"dp2mp2": ("gpt", {"dp_degree": 2, "mp_degree": 2},
                   {"tensor_parallel": True}, "momentum", None),
        "dp2mp2_sp": ("gpt", {"dp_degree": 2, "mp_degree": 2},
                      {"tensor_parallel": True, "sequence_parallel": True},
                      "momentum", None)}
JAX_REFERENCE = ("mp2", "dp2", "sp", "cp", "mp2_clip", "zero2_clip",
                 "llama_mp2", "llama_sp", "zero1", "zero2", "dp2mp2",
                 "dp2mp2_sp")


def _jax_run(family, hybrid, flags, opt, clip):
    """The JAX model under `hybrid` on the virtual mesh: its weights, a
    batch, the first logits, the fleet step's losses and parameters."""
    prev = dict(jmesh._state)
    try:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs.update(hybrid)
        jfleet.init(is_collective=True, strategy=s)
        pt.seed(13)
        if family == "gpt":
            m = JaxGPT(JaxGPTConfig(**TINY_GPT, **flags))
            loss_fn = jax_gpt_loss_fn
        else:
            m = JaxLlama(JaxLlamaConfig(**TINY_LLAMA, **flags))

            def loss_fn(mm, x, y):
                return JF.cross_entropy(mm(x), y, reduction="mean")
        weights = {k: np.asarray(v) for k, v in m.state_dict().items()}
        rng = np.random.RandomState(0)
        ids, labels = (rng.randint(0, 64, (4, 16)) for _ in range(2))
        logits = np.asarray(m(pt.to_tensor(ids)).numpy())
        kw = dict(learning_rate=LR[opt], parameters=m.parameters(),
                  grad_clip=None if clip is None
                  else pt.nn.ClipGradByGlobalNorm(clip))
        o = pt.optimizer.Momentum(momentum=0.9, **kw) if opt == "momentum" \
            else pt.optimizer.Adam(**kw)
        step = jfleet.build_train_step(m, loss_fn, o)
        losses = [float(step(pt.to_tensor(ids), pt.to_tensor(labels)))
                  for _ in range(STEPS)]
        params = {k: np.asarray(v) for k, v in m.state_dict().items()}
        return weights, ids, labels, logits, np.asarray(losses), params
    finally:
        jmesh._state.update(prev)


def _launch(cases, nproc, tmp):
    refs, jobs = {}, []
    for name, (family, hybrid, flags, opt, clip) in cases.items():
        w, ids, labels, logits, losses, params = _jax_run(
            family, hybrid, flags, opt, clip)
        refs[name] = dict(logits=logits, losses=losses, params=params)
        np.savez(tmp / f"{name}_w.npz", **w)
        np.savez(tmp / f"{name}_b.npz", ids=ids, labels=labels)
        cfg = dict(TINY_GPT if family == "gpt" else TINY_LLAMA, **flags)
        jobs.append({"name": name, "fn": "train", "kw": dict(
            family=family, cfg=cfg, hybrid=hybrid,
            weights=str(tmp / f"{name}_w.npz"),
            batch=str(tmp / f"{name}_b.npz"), steps=STEPS, lr=LR[opt],
            opt=opt, clip=clip, state=opt == "adam")})
    return refs, jobs


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet2")
    refs, jobs = _launch(CASES, 2, tmp)
    jobs += [{"name": "roundtrip", "fn": "shard_roundtrip",
              "kw": dict(cfg=dict(TINY_GPT, tensor_parallel=True),
                         weights=str(tmp / "mp2_w.npz"))},
             {"name": "refusals", "fn": "refusals"}]
    return refs, Ranks(2, jobs, tmp)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet4")
    refs, jobs = _launch(FOUR, 4, tmp)
    return refs, Ranks(4, jobs, tmp)


def _pick(two, four, name):
    refs, ranks = four if name in FOUR else two
    return refs[name], ranks[name]


def _params_close(got, want, tol):
    for k, v in want.items():
        np.testing.assert_allclose(got["p/" + k], v, err_msg=k, **tol)


@pytest.mark.parametrize("name", JAX_REFERENCE)
def test_logits_match_jax(two, four, name):
    ref, got = _pick(two, four, name)
    np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)


@pytest.mark.parametrize("name", JAX_REFERENCE)
def test_three_step_losses_match_jax(two, four, name):
    ref, got = _pick(two, four, name)
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)


@pytest.mark.parametrize("name", [n for n in JAX_REFERENCE
                                  if (CASES.get(n) or FOUR[n])[3]
                                  == "momentum"])
def test_gathered_parameters_match_jax(two, four, name):
    ref, got = _pick(two, four, name)
    _params_close(got, ref["params"], TOL)


@pytest.mark.parametrize("stage", ["zero1", "zero2"])
def test_zero_stages_match_unsharded(two, stage):
    """ZeRO 1 and 2 (each rank owning whole parameters and their Adam
    moments) against the unsharded dp 2 step of the port: the same
    losses, parameters and gathered optimizer state, and the JAX ZeRO
    step's losses."""
    _, ranks = two
    got, base = ranks[stage], ranks["dp2_adam"]
    np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-6)
    keys = [k for k in base if k.startswith(("p/", "s/"))]
    assert any(k.endswith("/moment1") for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k], base[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got["losses"], two[0][stage]["losses"],
                               **TOL)


def test_tensor_parallel_state_dict_is_dense(two):
    """At mp 2 each rank holds 48 of qkv's 96 rows (its 2 heads of each
    of q, k, v); state_dict() gives back the dense JAX weights bit for
    bit, and loading it into a fresh mp model gives the same pieces."""
    assert int(two[1]["roundtrip"]["qkv_local_rows"]) == 48


def test_refusals_and_topology(two):
    """Degrees past the world, pp, ZeRO 3, 'p_g_os', Adafactor over split
    parameters, cp beside tp, GQA kv heads below mp and a decode cache
    under mp raise on every rank; the hybrid group reports the rank's
    mp coordinates."""
    got = two[1]["refusals"]
    assert int(got["mp_rank"]) == 0 and int(got["mp_size"]) == 2


def test_ranks_load_no_jax(two, four):
    for _, ranks in (two, four):
        assert ranks.modules() == {r: [] for r in range(ranks.nproc)}
