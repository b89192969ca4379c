"""The port's LoRA against the JAX package's, on the CPU (the `TestLoRA`
cases of tests/test_peft_lora.py, held against JAX).

A JAX model is wrapped by the JAX package's LoRA and the port's model of
the same architecture by the port's; the whole wrapped state (base
weights and adapters) carries across through `load_paddle_tpu_state`.
Float32 on both sides:

* identity at init (B is zero) and the trainable names equal to the JAX
  package's, scale alpha / r, `trainable_bias`;
* a 5-step AdamW fine-tune series on GPT and on LLaMA (q/k/v/o) against
  the JAX TrainStep: losses to 1e-5 relative, adapters to 0.1 % of
  lr x steps, and the base BIT-identical on both sides;
* merge and unmerge: the merged base weights equal the JAX package's, the
  merged logits equal the unmerged ones, unmerge restores the base;
* an adapter `.npz` saved by the JAX package loaded into the port, and
  one saved by the port loaded into the JAX package;
* the four raises, no optimizer slots for frozen parameters, and
  greedy generate -> merge -> generate with the JAX package's tokens
  (where the JAX package's own reused program double-counts the
  adapter; see the test).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import decode as jax_decode
from paddle_tpu.text import generation as jax_generation
from paddle_tpu.text import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.text import peft as jpeft
from paddle_tpu.text.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                   LlamaForCausalLM, gpt_loss_fn)
from paddle_tpu_torch.text import decode
from paddle_tpu_torch.text.peft import (LoRAConfig, LoRALinear, LoRAModel,
                                        get_peft_model)
from paddle_tpu_torch.weights import load_paddle_tpu_state

GPT_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=32, hidden_dropout=0.0,
                attention_dropout=0.0)
LLAMA_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=48,
                  max_position_embeddings=32)
LLAMA_TARGETS = [".*q_proj", ".*k_proj", ".*v_proj", ".*o_proj"]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)
LR, STEPS = 1e-2, 5


def _arrays(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _models(arch, seed):
    pt.seed(seed)
    if arch == "gpt":
        return (JaxGPT(JaxGPTConfig(tensor_parallel=False, **GPT_TINY)),
                GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu"))
    return (JaxLlama(JaxLlamaConfig(tensor_parallel=False, **LLAMA_TINY)),
            LlamaForCausalLM(LlamaConfig(**LLAMA_TINY), device="cpu"))


def _pair(arch="gpt", seed=0, nonzero=False, **cfg):
    """The JAX LoRA model and the port's carrying its state; with
    `nonzero`, B is drawn too (so the adapters change the output)."""
    if arch == "llama":
        cfg.setdefault("target_modules", LLAMA_TARGETS)
    jm, tm = _models(arch, seed)
    jl = jpeft.get_peft_model(jm, jpeft.LoRAConfig(**cfg))
    if nonzero:
        rng = np.random.RandomState(seed + 1)
        for n, p in jl.adapter_state_dict().items():
            p._inplace_assign(pt.to_tensor(
                0.05 * rng.randn(*p.shape).astype(np.float32))._array)
    tl = get_peft_model(tm, LoRAConfig(**cfg))
    load_paddle_tpu_state(tl, _arrays(jl))
    return jl, tl


def _ids(b=2, n=8, seed=0):
    return np.random.RandomState(seed).randint(0, 64, size=(b, n))


def _logits(jl, tl, ids):
    want = jl(pt.to_tensor(ids.astype("int64"))).numpy()
    with torch.no_grad():
        got = tl(torch.from_numpy(ids)).numpy()
    return got, want


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_identity_at_init_and_trainable_names_match_jax(arch):
    jl, tl = _pair(arch, r=4)
    jm, _ = _models(arch, 0)
    ids = _ids()
    got, want = _logits(jl, tl, ids)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    base = jm(pt.to_tensor(ids.astype("int64"))).numpy()
    np.testing.assert_array_equal(want, base)          # B starts at zero
    assert tl.replaced == jl.replaced
    assert all(torch.count_nonzero(p) == 0
               for n, p in tl.adapter_state_dict().items() if "lora_B" in n)
    jtrain = {n for n, p in jl.model.named_parameters()
              if not p.stop_gradient}
    ttrain = {n for n, p in tl.model.named_parameters() if p.requires_grad}
    assert ttrain == jtrain and ttrain
    assert all("lora_" in n for n in ttrain)
    layer = next(m for m in tl.modules() if isinstance(m, LoRALinear))
    assert layer.scaling == 16 / 4 and layer.lora_A.shape[1] == 4


def test_trainable_bias():
    jl, tl = _pair(r=2, trainable_bias=True)
    jtrain = {n for n, p in jl.model.named_parameters()
              if not p.stop_gradient}
    ttrain = {n for n, p in tl.model.named_parameters() if p.requires_grad}
    assert ttrain == jtrain
    assert any(n.endswith(".bias") for n in ttrain)


# ------------------------------------------------------------ fine-tuning
def _llama_loss(m, ids, labels):
    return PF.cross_entropy(m(ids), labels)


def _jax_llama_loss(m, ids, labels):
    return pt.nn.functional.cross_entropy(m(ids), labels)


@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_fine_tune_series_matches_jax_and_freezes_the_base(arch):
    jl, tl = _pair(arch, seed=3, r=4, lora_alpha=8)
    jloss, tloss = {"gpt": (jax_gpt_loss_fn, gpt_loss_fn),
                    "llama": (_jax_llama_loss, _llama_loss)}[arch]
    base = {n: p.detach().clone() for n, p in tl.named_parameters()
            if "lora_" not in n}
    jbase = {n: v for n, v in _arrays(jl).items() if "lora_" not in n}
    jstep = pt.jit.train_step(jl, jloss, pt.optimizer.AdamW(
        learning_rate=LR, parameters=jl.trainable_parameters()))
    opt = optimizer.AdamW(learning_rate=LR,
                          parameters=tl.trainable_parameters())
    tstep = train_step(tl, tloss, opt)
    ids, labels = _ids(4, 16, seed=4), _ids(4, 16, seed=5)
    jlosses = [float(jstep(pt.to_tensor(ids.astype("int64")),
                           pt.to_tensor(labels.astype("int64"))))
               for _ in range(STEPS)]
    tlosses = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
               for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, **LOSS_TOL)
    assert tlosses[-1] < tlosses[0]
    after = _arrays(jl)
    for n, p in tl.named_parameters():
        if "lora_" in n:
            np.testing.assert_allclose(p.detach().numpy(), after[n],
                                       rtol=1e-4, atol=1e-3 * LR * STEPS,
                                       err_msg=n)
        else:   # frozen: bit-identical on both sides
            assert torch.equal(p, base[n]), n
            np.testing.assert_array_equal(after[n], jbase[n], err_msg=n)
    moved = [n for n, p in tl.adapter_state_dict().items()
             if "lora_B" in n and torch.count_nonzero(p) > 0]
    assert len(moved) == len(tl.replaced)


def test_frozen_parameters_get_no_optimizer_slots():
    """All parameters handed to the optimizer: the frozen ones get empty
    slots and no update, the adapters real moments."""
    _, tl = _pair(seed=11, r=2)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=tl.parameters())
    step = train_step(tl, gpt_loss_fn, opt)
    ids = torch.from_numpy(_ids())
    step(ids, ids)
    names = [n for n, _ in tl.named_parameters()]
    assert len(opt._state) == len(names)
    for n, slots in zip(names, opt._state):
        assert bool(slots) == ("lora_" in n), n
    assert all(p.grad is None for p in tl.parameters())


# ------------------------------------------------------------ merge, files
def test_merge_unmerge_exact_and_equal_to_jax():
    jl, tl = _pair(seed=5, nonzero=True, r=4)
    ids = _ids()
    got, want = _logits(jl, tl, ids)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    w0 = {n: p.detach().clone() for n, p in tl.named_parameters()
          if n.endswith("base.weight")}
    with pytest.raises(RuntimeError, match="train mode"):
        tl.merge()
    jl.eval()
    tl.eval()
    jl.merge()
    tl.merge()
    assert all(m.merged for m in tl.modules() if isinstance(m, LoRALinear))
    merged = _arrays(jl)
    for n in w0:
        np.testing.assert_allclose(dict(tl.named_parameters())[n]
                                   .detach().numpy(), merged[n].T,
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(ids)).numpy(), got,
                                   rtol=2e-5, atol=2e-5)
    tl.unmerge()
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(ids)).numpy(), got,
                                   rtol=2e-5, atol=2e-5)
    for n, w in w0.items():
        torch.testing.assert_close(dict(tl.named_parameters())[n], w,
                                   rtol=1e-5, atol=1e-6, msg=n)


def test_adapter_files_cross_between_the_packages(tmp_path):
    jl, tl = _pair(seed=7, nonzero=True, r=2)
    ids = _ids()
    _, want = _logits(jl, tl, ids)
    jl.save_adapter(str(tmp_path / "jax_adapter"))
    _, fresh = _pair(seed=8, r=2)
    fresh.load_adapter(str(tmp_path / "jax_adapter"))
    load_paddle_tpu_state(fresh, {**{n: v.detach().numpy()
                                     for n, v in fresh.state_dict().items()},
                                  **{n: v for n, v in _arrays(jl).items()
                                     if "lora_" not in n}})
    with torch.no_grad():
        np.testing.assert_allclose(fresh(torch.from_numpy(ids)).numpy(),
                                   want, **LOGIT_TOL)
    # the port's file into a fresh JAX LoRA model on the same base
    tl.save_adapter(str(tmp_path / "port_adapter.npz"))
    jfresh, _ = _pair(seed=7, r=2)
    jfresh.load_adapter(str(tmp_path / "port_adapter.npz"))
    for n, p in jfresh.adapter_state_dict().items():
        np.testing.assert_array_equal(np.asarray(p._array),
                                      tl.adapter_state_dict()[n]
                                      .detach().numpy())
    np.testing.assert_allclose(
        jfresh(pt.to_tensor(ids.astype("int64"))).numpy(), want, rtol=1e-6,
        atol=1e-6)
    with np.load(str(tmp_path / "port_adapter.npz")) as f:
        assert sorted(f.files) == sorted(jl.adapter_state_dict())


def test_the_four_raises():
    with pytest.raises(ValueError, match="no Linear matched"):
        LoRAModel(_models("gpt", 0)[1], LoRAConfig(target_modules=["nope.*"]))
    with pytest.raises(TypeError, match="wraps nn.Linear"):
        LoRALinear(torch.nn.LayerNorm(8), 4, 8)
    _, tl = _pair(r=2)
    ids = torch.from_numpy(_ids())
    with pytest.raises(RuntimeError, match="train mode"):
        tl.merge()
    tl.eval()
    tl.merge()
    tl.train()
    with pytest.raises(RuntimeError, match="MERGED"):
        tl(ids)
    tl.unmerge()
    tl(ids)
    with pytest.raises(ValueError, match="rank"):
        LoRAConfig(r=0)


# --------------------------------------------------------------- generate
def test_generate_merge_generate_equals_jax():
    """Greedy jit_generate through the wrapper, then merge(), then again:
    the same tokens before and after, and the JAX package's.  A program
    built unmerged is not reused merged.

    The JAX package's own `jit_generate` reuses its program after
    merge(): the program traced `merged` as False, so it adds the adapter
    again on top of the merged weights and its tokens change (shown
    below; ROADMAP.md C).  The merged tokens are therefore held to the
    JAX package's eager `generate` and to a JAX program built after the
    merge."""
    jl, tl = _pair("llama", seed=9, nonzero=True, r=4)
    jl.eval()
    tl.eval()
    ids = _ids(2, 6, seed=10)
    jids = pt.to_tensor(ids.astype("int64"))
    want = np.asarray(jax_decode.jit_generate(jl, jids,
                                              max_new_tokens=8).numpy())
    before = tl.generate(torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(before.numpy(), want)
    store = tl.model._jit_decode_cache
    prog = next(iter(store.values()))
    jl.merge()
    tl.merge()
    after = tl.generate(torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(after.numpy(), before.numpy())
    assert next(iter(store.values())) is not prog
    assert decode._fingerprint(tl.model, None, False) != prog.fingerprint
    stale = np.asarray(jax_decode.jit_generate(jl, jids,
                                               max_new_tokens=8).numpy())
    assert not np.array_equal(stale, want)        # the reference's reuse
    eager = np.asarray(jax_generation.generate(jl, jids,
                                               max_new_tokens=8).numpy())
    jl.__dict__.pop("_jit_decode_cache")
    fresh = np.asarray(jax_decode.jit_generate(jl, jids,
                                               max_new_tokens=8).numpy())
    np.testing.assert_array_equal(after.numpy(), eager)
    np.testing.assert_array_equal(after.numpy(), fresh)


@pytest.mark.parametrize("kw", [{}, dict(r=4, lora_alpha=8.0,
                                         lora_dropout=0.1,
                                         target_modules=[".*o_proj"],
                                         trainable_bias=True)])
def test_lora_config_to_dict_matches_jax(kw):
    """`LoRAConfig.to_dict` gives the JAX package's dict, key for key."""
    got = LoRAConfig(**kw).to_dict()
    assert got == jpeft.LoRAConfig(**kw).to_dict()
    assert LoRAConfig(**got).to_dict() == got
