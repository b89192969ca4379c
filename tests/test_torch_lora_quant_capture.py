"""`jit_generate` programs over LoRA and weight-only models: on the CPU the
static step, and on the card the step captured as a CUDA graph.

This file imports torch and numpy only, so it also runs on the machine
with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_lora_quant_capture.py

A captured graph reads the weights by address and replays the adapter
products a LoRA layer had when it was captured; `merge()` changes the
base weights in place.  So a program must not outlive a merge: the
programs are keyed on each layer's `merged` flag (`decode._fingerprint`).
The card tests hold generate -> merge -> generate (captured) token for
token against the uncaptured step, float32 with TF32 off, and show that
replaying the adapter over the merged weights would change the tokens.
Weight-only models (int8, int4) are held captured against uncaptured.
Parity with the JAX package is in tests/test_torch_peft.py and
tests/test_torch_quant.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.quant import convert_to_weight_only
from paddle_tpu_torch.text import LlamaConfig, LlamaForCausalLM, generate
from paddle_tpu_torch.text import decode
from paddle_tpu_torch.text.peft import LoRAConfig, LoRALinear, get_peft_model

CFG = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=8,
           num_kv_heads=2, intermediate_size=512,
           max_position_embeddings=128)
TARGETS = [".*q_proj", ".*k_proj", ".*v_proj", ".*o_proj"]


def _llama(device):
    return LlamaForCausalLM(LlamaConfig(**CFG), device=device,
                            generator=torch.Generator(device).manual_seed(0))


def _lora(device):
    """A LoRA LLaMA whose B adapters are drawn too, so the adapters move
    the logits."""
    g = torch.Generator(device).manual_seed(1)
    model = get_peft_model(_llama(device), LoRAConfig(
        r=8, lora_alpha=16, target_modules=TARGETS), generator=g)
    with torch.no_grad():
        for n, p in model.adapter_state_dict().items():
            if "lora_B" in n:
                p.normal_(0.0, 0.05, generator=g)
    return model.eval()


def _ids(b, n, device, seed=0):
    ids = np.random.RandomState(seed).randint(0, 256, size=(b, n))
    return torch.from_numpy(ids).to(device)


def _merge_cycle(model, ids, **kw):
    """Tokens before merge, after merge, and the program built before."""
    before = decode.jit_generate(model, ids, max_new_tokens=16, **kw)
    prog = next(iter(model._jit_decode_cache.values()))
    model.merge()
    after = decode.jit_generate(model, ids, max_new_tokens=16, **kw)
    return before, after, prog


def _stale(model, ids):
    """What a program captured unmerged would emit after the merge: the
    adapter products over the merged weights (eager, flags cleared)."""
    layers = [m for m in model.modules() if isinstance(m, LoRALinear)]
    for m in layers:
        m.merged = False
    try:
        return generate(model, ids, max_new_tokens=16)
    finally:
        for m in layers:
            m.merged = True


# ===================================================================
# on the CPU: the static step uncaptured
# ===================================================================
def test_merge_rebuilds_the_program_on_cpu():
    model = _lora("cpu")
    ids = _ids(2, 7, "cpu")
    before, after, prog = _merge_cycle(model, ids)
    assert torch.equal(after, before)
    assert next(iter(model._jit_decode_cache.values())) is not prog
    assert not torch.equal(_stale(model, ids), before)
    model.unmerge()
    assert torch.equal(decode.jit_generate(model, ids, max_new_tokens=16),
                       before)


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_static_step_equals_eager_loop_on_cpu(algo):
    model = _llama("cpu").eval()
    ids = _ids(2, 9, "cpu")
    dense = decode.jit_generate(model, ids, max_new_tokens=12)
    prog = next(iter(model._jit_decode_cache.values()))
    convert_to_weight_only(model, algo=algo,
                           skip=lambda name, layer: name == "lm_head")
    got = decode.jit_generate(model, ids, max_new_tokens=12)
    assert next(iter(model._jit_decode_cache.values())) is not prog
    assert torch.equal(got, generate(model, ids, max_new_tokens=12))
    assert got.shape == dense.shape


# ===================================================================
# on the card: the captured step
# ===================================================================
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 products
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_generate_merge_generate_on_card(card):
    model = _lora(card)
    ids = _ids(3, 11, card)
    ref = decode.jit_generate(model, ids, max_new_tokens=16, _capture=False)
    model._jit_decode_cache.clear()
    before, after, prog = _merge_cycle(model, ids)
    assert prog.graph is not None
    assert torch.equal(before, ref)
    assert torch.equal(after, before)
    new = next(iter(model._jit_decode_cache.values()))
    assert new is not prog and new.graph is not None
    # the captured unmerged program, replayed over the merged weights,
    # would emit these
    assert not torch.equal(_stale(model, ids), before)
    model.unmerge()
    assert torch.equal(decode.jit_generate(model, ids, max_new_tokens=16),
                       before)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_captured_weight_only_step_matches_uncaptured_on_card(card, algo):
    model = convert_to_weight_only(
        _llama(card).eval(), algo=algo,
        skip=lambda name, layer: name == "lm_head")
    ids = _ids(3, 20, card)
    ref = decode.jit_generate(model, ids, max_new_tokens=24, _capture=False)
    got = decode.jit_generate(model, ids, max_new_tokens=24)
    assert next(iter(model._jit_decode_cache.values())).graph is not None
    assert torch.equal(got, ref)
    assert torch.equal(generate(model, ids, max_new_tokens=24), ref)
