"""The port's weight-only quantization against the JAX package's, on the
CPU (the non-ONNX cases of tests/test_weight_only.py, held against JAX).

* `weight_quantize`: int8 and nibble-packed int4 codes and scales
  BIT-equal to the JAX package's (odd IN, a zero column);
* `weight_only_linear` in float32 (products summed in another order:
  1e-5 relative) and bfloat16 (dequantized in the JAX rounding order,
  then one bf16 product: within 2 bf16 units of the output scale);
* `WeightOnlyLinear` from a Linear, its state dict round trip, and a
  weight-only GPT converted in the JAX package loaded into the port's
  (codes and scales bit for bit) with the JAX logits;
* greedy `jit_generate` and `jit_beam_search` tokens of converted models
  equal to the JAX package's (GPT int8, LLaMA int4 with `lm_head`
  skipped);
* the skip predicate, `amp.decorate` (the int8 buffer stays int8) and the
  raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import quant as jq
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import decode as jax_decode
from paddle_tpu.text.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.text.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn.quant import (WeightOnlyLinear, _unpack_int4,
                                       convert_to_weight_only,
                                       weight_only_linear, weight_quantize)
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                   LlamaForCausalLM)
from paddle_tpu_torch.text import decode
from paddle_tpu_torch.weights import load_paddle_tpu_state

ALGOS = ["weight_only_int8", "weight_only_int4"]
GPT_TINY = dict(vocab_size=96, hidden_size=48, num_layers=2, num_heads=4,
                max_position_embeddings=64, hidden_dropout=0.0,
                attention_dropout=0.0)
LLAMA_TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=96,
                  max_position_embeddings=64)


def _arrays(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _w(k=31, n=8, seed=0):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.1
    w[:, 3] = 0.0                                 # a zero column: scale 1
    return w


@pytest.mark.parametrize("algo", ALGOS)
def test_codes_and_scales_are_bit_equal_to_jax(algo):
    w = _w()
    jqw, js = jq.weight_quantize(pt.to_tensor(w), algo=algo)
    q, s = weight_quantize(torch.from_numpy(w), algo=algo)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jqw.numpy())
    np.testing.assert_array_equal(s.numpy(), js.numpy())
    if algo == "weight_only_int4":
        assert tuple(q.shape) == (16, 8)
        np.testing.assert_array_equal(
            _unpack_int4(q, 31).numpy(),
            np.asarray(jq._unpack_int4(jqw._array, 31)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_matches_jax(algo, dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(4, 31).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    q, s = weight_quantize(torch.from_numpy(_w()), algo=algo)
    jqw, js = jq.weight_quantize(pt.to_tensor(_w()), algo=algo)
    tdt = getattr(torch, dtype)
    got = weight_only_linear(torch.from_numpy(x).to(tdt), q,
                             bias=torch.from_numpy(b).to(tdt),
                             weight_scale=s, weight_dtype=algo[-4:])
    want = jq.weight_only_linear(pt.to_tensor(x).astype(dtype), jqw,
                                 bias=pt.to_tensor(b).astype(dtype),
                                 weight_scale=js, weight_dtype=algo[-4:])
    assert got.dtype == tdt
    want = np.asarray(want.astype("float32").numpy())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 * 2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("algo", ALGOS)
def test_from_linear_and_state_dict_round_trip(algo):
    lin = torch.nn.Linear(15, 6)
    wol = WeightOnlyLinear.from_linear(lin, algo=algo)
    q, s = weight_quantize(lin.weight.detach().t(), algo=algo)
    assert torch.equal(wol.quant_weight, q) and torch.equal(
        wol.weight_scale, s)
    assert not wol.weight_scale.requires_grad
    x = torch.rand(2, 15)
    with torch.no_grad():
        np.testing.assert_allclose(wol(x).numpy(), lin(x).numpy(),
                                   rtol=0, atol=0.2 if algo.endswith("4")
                                   else 2e-2)
    sd = wol.state_dict()
    assert set(sd) == {"quant_weight", "weight_scale", "bias"}
    fresh = WeightOnlyLinear(15, 6, weight_dtype=algo[-4:])
    fresh.load_state_dict(sd)
    assert torch.equal(fresh(x), wol(x))


def _gpt_pair(seed, algo):
    pt.seed(seed)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **GPT_TINY))
    jm.eval()
    jq.convert_to_weight_only(jm, algo=algo)
    tm = convert_to_weight_only(
        GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu"), algo=algo)
    load_paddle_tpu_state(tm, _arrays(jm))
    return jm, tm.eval()


def test_converted_jax_model_loads_bit_exact_with_its_logits():
    jm, tm = _gpt_pair(7, "weight_only_int8")
    arrays = _arrays(jm)
    n = 0
    for name, t in tm.state_dict().items():
        if name.endswith(("quant_weight", "weight_scale")):
            np.testing.assert_array_equal(t.numpy(), arrays[name], name)
            n += 1
    assert n == 2 * 4 * GPT_TINY["num_layers"]
    ids = np.random.RandomState(3).randint(0, 96, size=(2, 10))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    want = jm(pt.to_tensor(ids.astype("int64"))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_gpt_int8_greedy_and_beam_tokens_equal_jax():
    jm, tm = _gpt_pair(7, "weight_only_int8")
    ids = np.array([[5, 17, 40, 3], [9, 2, 61, 77]], np.int64)
    want = np.asarray(jax_decode.jit_generate(
        jm, pt.to_tensor(ids), max_new_tokens=8).numpy())
    got = decode.jit_generate(tm, torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax_decode.jit_beam_search(
        jm, pt.to_tensor(ids[:1]), beam_size=3, max_new_tokens=6).numpy())
    got = decode.jit_beam_search(tm, torch.from_numpy(ids[:1]), beam_size=3,
                                 max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_llama_int4_greedy_tokens_equal_jax():
    pt.seed(8)
    jm = JaxLlama(JaxLlamaConfig(tensor_parallel=False, **LLAMA_TINY))
    jm.eval()
    skip = lambda name, layer: name == "lm_head"      # noqa: E731
    jq.convert_to_weight_only(jm, algo="weight_only_int4", skip=skip)
    tm = convert_to_weight_only(
        LlamaForCausalLM(LlamaConfig(**LLAMA_TINY), device="cpu"),
        algo="weight_only_int4", skip=skip)
    assert isinstance(tm.lm_head, torch.nn.Linear)
    assert isinstance(tm.llama.layers[0].mlp.up_proj, WeightOnlyLinear)
    load_paddle_tpu_state(tm, _arrays(jm))
    ids = np.random.RandomState(4).randint(0, 96, size=(2, 6))
    want = np.asarray(jax_decode.jit_generate(
        jm, pt.to_tensor(ids.astype("int64")), max_new_tokens=8).numpy())
    got = decode.jit_generate(tm.eval(), torch.from_numpy(ids),
                              max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_skip_predicate_and_amp_decorate():
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 4))
    convert_to_weight_only(m, skip=lambda name, layer: name.endswith("1"))
    assert [type(x).__name__ for x in m] == ["WeightOnlyLinear", "Linear"]
    amp.decorate(m, dtype="bfloat16")
    # parameters are cast (the scale too, as in the JAX package); the
    # int8 codes are a buffer and stay int8
    assert m[0].quant_weight.dtype == torch.int8
    assert m[0].weight_scale.dtype == torch.bfloat16
    assert m(torch.rand(2, 4).bfloat16()).dtype == torch.bfloat16


def test_raises():
    q, s = weight_quantize(torch.rand(8, 4))
    with pytest.raises(ValueError, match="weight_scale"):
        weight_only_linear(torch.rand(2, 8), q)
    with pytest.raises(NotImplementedError, match="group"):
        weight_only_linear(torch.rand(2, 8), q, weight_scale=s,
                           group_size=64)
    with pytest.raises(NotImplementedError, match="group"):
        weight_quantize(torch.rand(8, 4), group_size=64)
    with pytest.raises(ValueError):
        weight_quantize(torch.rand(8, 4), algo="weight_only_int2")
    with pytest.raises(ValueError):
        WeightOnlyLinear(8, 4, weight_dtype="int2")
