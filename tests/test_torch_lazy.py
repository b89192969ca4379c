"""`LazyGuard` of the port, and the serving worker's `lazy=True`.

The contract is the reference's (`paddle_tpu/framework/lazy.py`):
``seed(k); with LazyGuard(): M()`` gives the parameters of
``seed(k); M()`` and leaves the generators in the same state.  The JAX
package holds it within one unit in the last place (XLA fuses the init
program); the port holds it bit for bit, for the models whose weights
are drawn with direct torch calls on explicit generators (BERT, GPT,
ERNIE, GPT-MoE), through `Layer.create_parameter` and the initializers,
and through torch's own layers (ResNet's convolutions and norms), on
both the model's explicit generator and PyTorch's default one.  Then:
under the guard the parameters live on `meta`; a deep copy takes its
source's values; casts, moves and sums of deferred tensors replay;
guards nest; an exception drops the pending work; the
`defer` / `defer_alias` / `materialize` calls; and a serving worker spec
with ``lazy=True`` builds the model under the guard, equal to the eager
build (in the spec as the JAX package writes it).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.lazy import LazyGuard as JaxLazyGuard
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForSequenceClassification as JaxBertCls
from paddle_tpu_torch import nn, seed
from paddle_tpu_torch.framework import lazy
from paddle_tpu_torch.framework.lazy import LazyGuard
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.text import (BertConfig, BertForPretraining,
                                   BertForSequenceClassification, ErnieConfig,
                                   ErnieForSequenceClassification, GPTConfig,
                                   GPTForCausalLM)
from paddle_tpu_torch.vision.models import resnet18

BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32)
GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=32)


def _gen():
    return torch.Generator().manual_seed(11)


BUILDS = {
    "bert_cls": lambda g: BertForSequenceClassification(
        BertConfig(**BERT), num_classes=3, device="cpu", generator=g),
    "bert_pretraining": lambda g: BertForPretraining(
        BertConfig(**BERT), device="cpu", generator=g),
    "ernie_cls": lambda g: ErnieForSequenceClassification(
        ErnieConfig(**BERT), num_classes=2, device="cpu", generator=g),
    "gpt": lambda g: GPTForCausalLM(GPTConfig(**GPT), device="cpu",
                                    generator=g),
    "gpt_moe": lambda g: GPTForCausalLM(
        GPTConfig(**GPT, num_experts=4, moe_every=1), device="cpu",
        generator=g),
    "resnet18": lambda g: resnet18(num_classes=5, device="cpu",
                                   generator=g),
}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(BUILDS))
@pytest.mark.parametrize("explicit_generator", [True, False])
def test_lazy_build_equals_eager_bit_for_bit(name, explicit_generator):
    build = BUILDS[name]
    seed(5)
    g = _gen() if explicit_generator else None
    eager = build(g)
    after = (torch.get_rng_state(), g.get_state() if g is not None
             else None)
    seed(5)
    g = _gen() if explicit_generator else None
    with LazyGuard():
        made = build(g)
        assert all(p.untyped_storage().device.type == "meta"
                   for p in made.parameters())
    assert not lazy.active()
    e, m = _state(eager), _state(made)
    assert list(e) == list(m)
    for k in e:
        assert e[k].device == m[k].device == torch.device("cpu"), k
        assert e[k].dtype == m[k].dtype and torch.equal(e[k], m[k]), k
    assert torch.equal(after[0], torch.get_rng_state())
    if g is not None:
        assert torch.equal(after[1], g.get_state())
    # the materialised model trains like any other
    assert all(p.requires_grad for p in made.parameters())
    if name == "bert_pretraining":     # the tied LM decoder stays tied
        assert made.cls.decoder_weight is \
            made.bert.embeddings.word_embeddings.weight


def test_the_reference_keeps_the_same_contract():
    """The JAX package's own guard, on its BERT: equal values (its
    documented 1-ulp slack is not needed here) and the same key after."""
    cfg = JaxBertConfig(**BERT)
    pt.seed(5)
    eager = {k: np.asarray(v) for k, v in JaxBertCls(cfg).state_dict()
             .items()}
    key = np.asarray(pt.framework.random.default_key())
    pt.seed(5)
    with JaxLazyGuard():
        made = JaxBertCls(cfg)
    got = {k: np.asarray(v) for k, v in made.state_dict().items()}
    assert list(eager) == list(got)
    for k in eager:
        np.testing.assert_allclose(got[k], eager[k], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(pt.framework.random.default_key()), key)


class _Net(nn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.w = self.create_parameter([4, 3],
                                       default_initializer=I.Normal(0, 1))
        self.b = self.create_parameter([3], is_bias=True)
        self.fc = nn.Linear(3, 2, device="cpu")
        self.twin = copy.deepcopy(self.fc)
        self.register_buffer("steps", torch.arange(3, device="cpu"))


def test_create_parameter_deep_copies_and_buffers():
    torch.manual_seed(2)
    eager = _Net()
    torch.manual_seed(2)
    with LazyGuard():
        with LazyGuard():              # nested: the outer exit builds
            made = _Net()
        assert lazy.active()
        assert made.w.untyped_storage().device.type == "meta"
    for k, v in _state(eager).items():
        assert torch.equal(v, _state(made)[k]), k
    assert torch.equal(made.twin.weight, made.fc.weight)
    assert made.twin.weight.data_ptr() != made.fc.weight.data_ptr()
    assert made.fc.weight._paddle_transposed


def test_computed_and_moved_tensors_replay():
    """Out-of-place calls on deferred tensors (a cast, a move, a sum)
    give what they give eagerly; `.cpu()` of a CPU tensor is itself."""
    def build():
        lin = nn.Linear(3, 2, device="cpu")
        return lin, (lin.weight.to(torch.float64), lin.weight.cpu(),
                     lin.weight.to(device="cpu", dtype=torch.float16),
                     (lin.weight * 2).sum(0))

    torch.manual_seed(4)
    lin, eager = build()
    torch.manual_seed(4)
    with LazyGuard():
        lin2, made = build()
    assert made[1] is lin2.weight
    for a, b in zip(eager, made):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_an_exception_drops_the_pending_work():
    with pytest.raises(ValueError):
        with LazyGuard():
            made = _Net()
            raise ValueError("half built")
    assert not lazy.active()
    assert made.w.untyped_storage().device.type == "meta"
    with LazyGuard():                  # the next guard starts clean
        ok = _Net()
    assert ok.w.device.type == "cpu"


def test_defer_defer_alias_and_materialize():
    src = torch.zeros(2, 3)
    with LazyGuard():
        lazy.defer(src, (2, 3), torch.float32, lambda t: t.fill_(4.0))
        copy_t = torch.empty(2, 3, device="cpu")
        lazy.defer_alias(copy_t, src)
        assert src.untyped_storage().device.type == "meta"
        assert lazy.materialize() == 2
        assert torch.equal(src, torch.full((2, 3), 4.0))
    assert torch.equal(copy_t, src)


def test_reading_a_value_under_the_guard_raises():
    with pytest.raises(Exception):
        with LazyGuard():
            nn.Linear(2, 2, device="cpu").weight.sum().item()
    assert not lazy.active()


def test_serving_worker_builds_lazily():
    from paddle_tpu.serving import worker as jax_sw
    from paddle_tpu_torch.serving import worker as sw
    from tools import torch_chaos_check as tcc
    spec = sw.gpt_spec(config=tcc.TINY, seed=3, lazy=True, device="cpu")
    assert spec["model"]["lazy"] is True
    assert spec["model"] == {k: v for k, v in jax_sw.gpt_spec(
        config=tcc.TINY, seed=3, lazy=True)["model"].items()}
    made = sw.build_gpt(spec)
    eager = sw.build_gpt(dict(spec, model=dict(spec["model"], lazy=False)))
    for k, v in _state(eager).items():
        assert torch.equal(v, _state(made)[k]), k
