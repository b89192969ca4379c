"""The port's `jit_generate` program: its static decode step, the LRU of
built programs, sampling generators and, on the card, the step captured
as a CUDA graph.

This file imports torch and numpy only, so it also runs on the machine
with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_decode_capture.py

On the CPU the static step runs uncaptured and the `cuda` tests skip.
On the card they hold the captured step against the same step launched
op by op (`_capture=False`) and the eager loop, token for token in
float32, and check that replays draw anew from a registered generator
and count their kernel launches.  Parity with the JAX package is in
tests/test_torch_generation.py and tests/test_torch_llama.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                   LlamaForCausalLM, generate)
from paddle_tpu_torch.text import decode

GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, hidden_dropout=0.0,
           attention_dropout=0.0)


def _gpt(device="cpu", seed=0, **over):
    return GPTForCausalLM(GPTConfig(**dict(GPT, **over)), device=device,
                          generator=torch.Generator(device).manual_seed(seed))


def _ids(b, n, seed=0, vocab=64, device="cpu"):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(b, n))
    return torch.from_numpy(ids).to(device)


def _key(prompt, new, eos=None, batch=1):
    """The program key, as the JAX package's `cache_key` (greedy)."""
    return (prompt, new, False, 1.0, None, None, eos, batch)


# ===================================================================
# on the CPU: the static step uncaptured
# ===================================================================
def test_static_step_equals_eager_loop():
    model = _gpt().eval()
    ids = _ids(3, 5)
    out = decode.jit_generate(model, ids, max_new_tokens=12)
    assert torch.equal(out, generate(model, ids, max_new_tokens=12))
    prog = model._jit_decode_cache[_key(5, 12, batch=3)]
    assert prog.graph is None and not prog.capture
    assert int(prog.pos) == 5 + 12 - 1       # advanced by each step


def test_program_lru_and_rebuild_on_new_weights():
    model = _gpt()
    ids = _ids(1, 3)
    for n in range(1, 11):                   # ten keys, eight kept
        model.generate(ids, max_new_tokens=n)
    store = model._jit_decode_cache
    assert len(store) == 8 and _key(3, 1) not in store
    prog = store[_key(3, 10)]
    before = model.generate(ids, max_new_tokens=10)
    assert store[_key(3, 10)] is prog        # reused
    assert list(store)[-1] == _key(3, 10)    # and moved to the back
    for p in model.parameters():             # new storage: a captured
        p.data = p.data.clone()              # graph would read the old
    after = model.generate(ids, max_new_tokens=10)
    assert store[_key(3, 10)] is not prog    # rebuilt
    assert torch.equal(before, after)


def test_sampling_follows_its_generator():
    model = _gpt().eval()
    ids = _ids(2, 4)

    def draw(seed, **kw):
        return model.generate(ids, max_new_tokens=10, do_sample=True,
                              generator=torch.Generator().manual_seed(seed),
                              **kw)

    for kw in ({}, {"use_jit": False}):
        a, b, c = draw(1, **kw), draw(1, **kw), draw(2, **kw)
        assert torch.equal(a, b) and not torch.equal(a, c)
    # a new generator rebuilds the program (a captured graph registers
    # the one it was built with)
    assert len(model._jit_decode_cache) == 1


def test_launch_counts_add_and_read():
    before = ops.launch_counts()
    assert set(before) == {"flash_fwd", "flash_dkv", "flash_dq",
                           "flash_fwd_sm90", "flash_dkv_sm90",
                           "flash_dq_sm90", "flash_fwd_decode",
                           "flash_fwd_fp32", "paged_decode", "sdpa_plain"}
    ops.add_launch_counts({"flash_fwd": 2, "paged_decode": 1}, times=3)
    after = ops.launch_counts()
    assert after["flash_fwd"] == before["flash_fwd"] + 6
    assert after["paged_decode"] == before["paged_decode"] + 3
    ops.add_launch_counts({"flash_fwd": 2, "paged_decode": 1}, times=-3)
    assert ops.launch_counts() == before


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
@pytest.mark.parametrize("eos", [None, "emitted"])
def test_captured_gpt_step_matches_uncaptured_on_card(card, eos):
    model = _gpt(card, hidden_size=128)
    ids = _ids(3, 9, device=card)
    ref = decode.jit_generate(model, ids, max_new_tokens=20, _capture=False)
    eos_id = int(ref[0, 12]) if eos else None
    ref = decode.jit_generate(model, ids, max_new_tokens=20,
                              eos_token_id=eos_id, _capture=False)
    before = ops.launch_counts()
    got = decode.jit_generate(model, ids, max_new_tokens=20,
                              eos_token_id=eos_id)
    after = ops.launch_counts()
    assert torch.equal(got, ref)
    prog = model._jit_decode_cache[_key(9, 20, eos_id, 3)]
    assert prog.graph is not None and prog.counts["flash_fwd"] == 2
    assert after["sdpa_plain"] == before["sdpa_plain"]
    # the prefill, the eager first step, then a replay a token: each
    # launches the flash forward once a layer
    steps = got.shape[1] - 9 - 1
    assert after["flash_fwd"] - before["flash_fwd"] == 2 * (1 + steps)
    again = decode.jit_generate(model, ids, max_new_tokens=20,
                                eos_token_id=eos_id)
    assert torch.equal(again, ref)           # replays only, same tokens
    assert torch.equal(generate(model, ids, max_new_tokens=20,
                                eos_token_id=eos_id), ref)


@pytest.mark.cuda
def test_captured_sampling_replays_draw_anew(card):
    model = _gpt(card, hidden_size=128)
    ids = _ids(2, 5, device=card)
    g = torch.Generator(card).manual_seed(0)
    kw = dict(max_new_tokens=24, do_sample=True, temperature=2.0,
              generator=g)
    a = decode.jit_generate(model, ids, **kw)
    b = decode.jit_generate(model, ids, **kw)
    assert model._jit_decode_cache[(5, 24, True, 2.0, None, None, None,
                                    2)].graph is not None
    assert a.shape == b.shape == (2, 29)
    # each replay draws from the registered generator's advancing state:
    # two runs of replays differ, and the tokens of one run vary
    assert not torch.equal(a[:, 7:], b[:, 7:])
    assert len(torch.unique(a[:, 7:])) > 4


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 16])
def test_captured_llama_step_matches_uncaptured_on_card(card, window):
    """GQA 8 / 2 and, with a window of 16 over 44 positions, the band in
    the captured step's mask."""
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2,
                      num_heads=8, num_kv_heads=2, intermediate_size=512,
                      max_position_embeddings=128, sliding_window=window)
    model = LlamaForCausalLM(cfg, device=card,
                             generator=torch.Generator(card).manual_seed(0))
    ids = _ids(3, 20, vocab=256, device=card)
    ref = decode.jit_generate(model, ids, max_new_tokens=24, _capture=False)
    got = decode.jit_generate(model, ids, max_new_tokens=24)
    assert model._jit_decode_cache[_key(20, 24, batch=3)].graph is not None
    assert torch.equal(got, ref)
    assert torch.equal(model.generate(ids, max_new_tokens=24, use_jit=False),
                       ref)
