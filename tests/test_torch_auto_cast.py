"""`amp.auto_cast` (O1 and O2) and `amp.decorate` against the JAX
package's, on the CPU.

The JAX package casts at its op dispatch (`paddle_tpu/ops/dispatch.py:
74-102`) by each op's registered policy: allow ops cast their floating
inputs to the AMP dtype, deny ops to float32, keep ops nothing (O1);
under O2 every op casts to the AMP dtype but the deny ops.  The port
casts the inputs of the torch callables that stand for those ops
(`paddle_tpu_torch/amp/__init__.py`).  Covered:

* each op's output dtype under O1 and O2, bfloat16 and float16, from
  float32 and from low-precision inputs, equals the JAX package's;
* custom white / black lists (black wins), `enable=False`, nesting,
  `amp_guard`, a per-thread state, and an op no list names keeping its
  dtype;
* the dtype flow of a linear layer into sdpa: the additive mask reaches
  the attention in the AMP dtype (-1e4 as -9984 in bfloat16);
* BERT at 2 layers and full width (hidden 768, 12 heads) under O1:
  logits, loss and gradients against the JAX package's O1 run;
* C7: `decorate(level="O1")` casts the parameters and turns master
  weights on, as the JAX package's does.

Tolerances for BERT under O1 (measured on the CPU, weights and inputs
copied from the JAX model): both sides round each product's inputs to
the AMP dtype but accumulate and round at other places (torch's CPU
GEMM against XLA's), so logits agree within 2e-2 in bfloat16 (measured
7.8e-3) and 4e-3 in float16 (measured 9.8e-4), the loss within 1e-2
(measured 3.8e-3) and 1e-3 (6.2e-5), and each gradient within 6e-2
(bfloat16, measured 2.7e-2) or 1e-2 (float16, measured 2.7e-3) of its
largest element; the classifier's bias, the batch mean of softmax minus
one-hot, within half the logits' tolerance.  The key projection's bias
is left out: its gradient is zero in exact arithmetic, so each side
holds only its own rounding noise there.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForSequenceClassification as JaxBertCls
from paddle_tpu_torch import amp, ops, optimizer
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.text import BertConfig, BertForSequenceClassification
from paddle_tpu_torch.weights import load_paddle_tpu_state

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 4, 8)).astype(np.float32)
W = RNG.standard_normal((8, 8)).astype(np.float32)
B = RNG.standard_normal((8,)).astype(np.float32)
IMG = RNG.standard_normal((2, 3, 6, 6)).astype(np.float32)
KER = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)
KB = RNG.standard_normal((4,)).astype(np.float32)
LAB = RNG.integers(0, 8, (8,))
TGT = RNG.random((2, 4, 8)).astype(np.float32)
MASK = np.zeros((2, 1, 1, 4), np.float32)
MASK[0, ..., -1] = -1e4


def _q(x):
    return x.reshape([2, 4, 2, 4])


# op -> (JAX call on pt tensors, port call on torch tensors); inputs in
# `dt` (float32 or the AMP dtype), weights float32 as a model holds them
OPS = {
    "linear": (lambda x, w, b: JF.linear(x, w, b),
               lambda x, w, b: F.linear(x, w.T, b)),
    "linear_no_bias": (lambda x, w, b: JF.linear(x, w),
                       lambda x, w, b: F.linear(x, w.T)),
    "matmul": (lambda x, w, b: pt.matmul(x, w),
               lambda x, w, b: torch.matmul(x, w)),
    "matmul_operator": (lambda x, w, b: x @ w, lambda x, w, b: x @ w),
    "bmm": (lambda x, w, b: pt.bmm(x, x.transpose([0, 2, 1])),
            lambda x, w, b: torch.bmm(x, x.transpose(1, 2))),
    "einsum": (lambda x, w, b: pt.einsum("bld,de->ble", x, w),
               lambda x, w, b: torch.einsum("bld,de->ble", x, w)),
    "layer_norm": (lambda x, w, b: JF.layer_norm(x, 8, b, b),
                   lambda x, w, b: F.layer_norm(x, (8,), b, b)),
    "layer_norm_no_affine": (lambda x, w, b: JF.layer_norm(x, 8),
                             lambda x, w, b: F.layer_norm(x, (8,))),
    "rms_norm": (lambda x, w, b: JF.rms_norm(x, b),
                 lambda x, w, b: PF.rms_norm(x, b)),
    "rms_norm_no_weight": (lambda x, w, b: JF.rms_norm(x),
                           lambda x, w, b: PF.rms_norm(x)),
    "softmax": (lambda x, w, b: JF.softmax(x),
                lambda x, w, b: F.softmax(x, -1)),
    "log_softmax": (lambda x, w, b: JF.log_softmax(x),
                    lambda x, w, b: torch.log_softmax(x, -1)),
    "logsumexp": (lambda x, w, b: pt.logsumexp(x, axis=-1),
                  lambda x, w, b: torch.logsumexp(x, -1)),
    "cross_entropy": (
        lambda x, w, b: JF.cross_entropy(x.reshape([8, 8]),
                                         pt.to_tensor(LAB)),
        lambda x, w, b: PF.cross_entropy(x.reshape(8, 8),
                                         torch.from_numpy(LAB))),
    "cross_entropy_none": (
        lambda x, w, b: JF.cross_entropy(x.reshape([8, 8]),
                                         pt.to_tensor(LAB),
                                         reduction="none"),
        lambda x, w, b: PF.cross_entropy(x.reshape(8, 8),
                                         torch.from_numpy(LAB),
                                         reduction="none")),
    "bce_with_logits": (
        lambda x, w, b: JF.binary_cross_entropy_with_logits(
            x, pt.to_tensor(TGT), reduction="none"),
        lambda x, w, b: F.binary_cross_entropy_with_logits(
            x, torch.from_numpy(TGT), reduction="none")),
    "sdpa_masked": (
        lambda x, w, b: JF.scaled_dot_product_attention(
            _q(x), _q(x), _q(x), attn_mask=pt.to_tensor(MASK)),
        lambda x, w, b: PF.scaled_dot_product_attention(
            _q(x), _q(x), _q(x), attn_mask=torch.from_numpy(MASK))),
    "sdpa_unmasked": (
        lambda x, w, b: JF.scaled_dot_product_attention(_q(x), _q(x),
                                                        _q(x)),
        lambda x, w, b: PF.scaled_dot_product_attention(_q(x), _q(x),
                                                        _q(x))),
    "gelu": (lambda x, w, b: JF.gelu(x), lambda x, w, b: PF.gelu(x)),
    "tanh": (lambda x, w, b: pt.tanh(x), lambda x, w, b: torch.tanh(x)),
    "add": (lambda x, w, b: x + x, lambda x, w, b: x + x),
    "add_bias": (lambda x, w, b: x + b, lambda x, w, b: x + b),
    "mul_scalar": (lambda x, w, b: x * 2.0, lambda x, w, b: x * 2.0),
    "sum": (lambda x, w, b: x.sum(), lambda x, w, b: x.sum()),
    "reshape": (lambda x, w, b: x.reshape([8, 8]),
                lambda x, w, b: x.reshape(8, 8)),
}
CONV = {
    "conv2d": (lambda i, k, kb: JF.conv2d(i, k, kb, padding=1),
               lambda i, k, kb: F.conv2d(i, k, kb, padding=1)),
    "conv2d_no_bias": (lambda i, k, kb: JF.conv2d(i, k, padding=1),
                       lambda i, k, kb: F.conv2d(i, k, padding=1)),
    "group_norm": (lambda i, k, kb: JF.group_norm(
        i, 1, pt.to_tensor(np.ones(3, np.float32)),
        pt.to_tensor(np.zeros(3, np.float32))),
        lambda i, k, kb: F.group_norm(i, 1, torch.ones(3), torch.zeros(3))),
}


def _jdt(t):
    return str(t._array.dtype)


def _tdt(t):
    return str(t.dtype).replace("torch.", "")


def _inputs(lib, dt, arrays):
    out = []
    for a, cast in arrays:
        if lib == "jax":
            t = pt.to_tensor(a)
            out.append(t.astype(dt) if cast else t)
        else:
            t = torch.from_numpy(a.copy())
            out.append(t.to(getattr(torch, dt)) if cast else t)
    return out


def _dtypes(table, name, level, amp_dt, in_dt, arrays):
    jfn, tfn = table[name]
    with jamp.auto_cast(level=level, dtype=amp_dt):
        j = jfn(*_inputs("jax", in_dt, arrays))
    with amp.auto_cast(level=level, dtype=amp_dt):
        t = tfn(*_inputs("torch", in_dt, arrays))
    return _jdt(j), _tdt(t)


@pytest.mark.parametrize("name", sorted(OPS))
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("amp_dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("in_low", [False, True])
def test_op_output_dtype_matches_jax(name, level, amp_dt, in_low):
    """Activations in float32 or in the AMP dtype, weights float32."""
    j, t = _dtypes(OPS, name, level, amp_dt,
                   amp_dt if in_low else "float32",
                   [(X, True), (W, False), (B, False)])
    assert t == j, (name, level, amp_dt, in_low, j, t)


@pytest.mark.parametrize("name", sorted(CONV))
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("amp_dt", ["bfloat16", "float16"])
def test_conv_and_group_norm_output_dtype_matches_jax(name, level, amp_dt):
    j, t = _dtypes(CONV, name, level, amp_dt, "float32",
                   [(IMG, True), (KER, False), (KB, False)])
    assert t == j, (name, level, amp_dt, j, t)


@pytest.mark.parametrize("lists,op,want", [
    # (white, black): black wins over white
    (({"layer_norm"}, {"layer_norm"}), "layer_norm", "float32"),
    (({"layer_norm"}, set()), "layer_norm", "bfloat16"),
    ((set(), {"matmul"}), "matmul", "float32"),
    ((set(), {"matmul"}), "linear", "float32"),
    (({"softmax"}, set()), "softmax", "bfloat16"),
    # the kernel itself computes in float32 whatever its inputs
    (({"softmax_ce"}, set()), "cross_entropy_none", "float32"),
    ((set(), {"sdpa"}), "sdpa_masked", "float32"),
    # an op outside the tables, by its JAX name
    (({"tanh"}, set()), "tanh", "bfloat16"),
    ((set(), {"add"}), "add", "float32"),
    (({"multiply"}, set()), "mul_scalar", "bfloat16"),
])
def test_custom_lists_take_jax_op_names(lists, op, want):
    white, black = lists
    jfn, tfn = OPS[op]
    kw = dict(custom_white_list=white, custom_black_list=black)
    with jamp.auto_cast(**kw):
        j = jfn(*_inputs("jax", "float32", [(X, 1), (W, 0), (B, 0)]))
    with amp.auto_cast(**kw):
        t = tfn(*_inputs("torch", "float32", [(X, 1), (W, 0), (B, 0)]))
    assert _tdt(t) == _jdt(j) == want


def test_an_op_no_list_names_keeps_its_dtype():
    """A torch call the policy table does not know is a keep op under O1,
    as every JAX op registered without a policy is: its dtypes stay."""
    x = torch.from_numpy(X)
    with amp.auto_cast(dtype="bfloat16"):
        assert torch.tanh(x).dtype == torch.float32
        assert torch.sigmoid(x.bfloat16()).dtype == torch.bfloat16
        assert torch.cumsum(x, 0).dtype == torch.float32
    with jamp.auto_cast(dtype="bfloat16"):
        assert _jdt(pt.tanh(pt.to_tensor(X))) == "float32"


def test_enable_false_nesting_and_amp_guard():
    x, w = torch.from_numpy(X), torch.from_numpy(W)
    assert amp.amp_guard is amp.auto_cast
    assert amp.amp_state() is None
    with amp.auto_cast(dtype="float16"):
        assert torch.matmul(x, w).dtype == torch.float16
        with amp.auto_cast(enable=False):
            assert amp.amp_state() is None
            assert torch.matmul(x, w).dtype == torch.float32
        with amp.amp_guard(dtype="bfloat16", level="O2"):
            assert amp.amp_state().level == "O2"
            assert (x + x).dtype == torch.bfloat16
        assert amp.amp_state().dtype == torch.float16
        assert (x + x).dtype == torch.float32
    assert amp.amp_state() is None
    assert torch.matmul(x, w).dtype == torch.float32
    with jamp.auto_cast(dtype="float16"):
        with jamp.auto_cast(enable=False):
            assert jamp.amp_state() is None


def test_the_state_is_per_thread():
    seen = {}

    def other():
        seen["state"] = amp.amp_state()
        x = torch.from_numpy(X)
        seen["dtype"] = torch.matmul(x, x.transpose(1, 2)).dtype

    with amp.auto_cast(dtype="bfloat16"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert seen == {"state": None, "dtype": torch.float32}


def test_the_mask_reaches_sdpa_in_the_amp_dtype(monkeypatch):
    """q, k, v come out of a float32-biased linear in float32; sdpa (an
    allow op) casts them and the additive mask: BERT's -1e4 arrives as
    -9984 in bfloat16, as in the JAX package."""
    got = {}
    plain = ops._sdpa

    def spy(q, k, v, mask, *a):
        got.update(q=q.dtype, mask=mask)
        return plain(q, k, v, mask, *a)

    monkeypatch.setattr(ops, "_sdpa", spy)
    lin = torch.nn.Linear(8, 8)
    mask = torch.from_numpy(MASK)
    with amp.auto_cast(dtype="bfloat16"):
        q = _q(lin(torch.from_numpy(X)))
        assert q.dtype == torch.float32
        out = PF.scaled_dot_product_attention(q, q, q, attn_mask=mask)
    assert out.dtype == got["q"] == torch.bfloat16
    assert got["mask"].dtype == torch.bfloat16
    assert float(got["mask"].min()) == -9984.0
    j = pt.to_tensor(MASK).astype("bfloat16")
    assert float(np.asarray(j._array.astype(jnp.float32)).min()) == -9984.0


def test_gradients_flow_back_in_the_parameters_dtype():
    lin = torch.nn.Linear(8, 8)
    with amp.auto_cast(dtype="bfloat16"):
        y = lin(torch.from_numpy(X))
    y.sum().backward()
    assert y.dtype == torch.float32
    assert lin.weight.grad.dtype == torch.float32
    assert lin.bias.grad.dtype == torch.float32


# ------------------------------------------------------------ BERT, O1
BERT = dict(vocab_size=128, hidden_size=768, num_hidden_layers=2,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# (logits atol, loss atol, gradient error against its largest element)
BERT_TOL = {"bfloat16": (2e-2, 1e-2, 6e-2), "float16": (4e-3, 1e-3, 1e-2)}


@pytest.fixture(scope="module")
def bert_pair():
    pt.seed(0)
    jm = JaxBertCls(JaxBertConfig(**BERT), num_classes=2)
    tm = BertForSequenceClassification(BertConfig(**BERT), num_classes=2,
                                       device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(1)
    b, s = 4, 32
    ids = rng.integers(0, BERT["vocab_size"], (b, s))
    seg = np.zeros((b, s), np.int64)
    lens = rng.integers(s // 2, s + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    return jm, tm, (ids, seg, mask, rng.integers(0, 2, b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bert_under_o1_matches_jax(bert_pair, dtype):
    jm, tm, (ids, seg, mask, labels) = bert_pair
    for p in jm.parameters():
        p.clear_grad()
    tm.zero_grad(set_to_none=True)
    with jamp.auto_cast(dtype=dtype):
        jl = jm(pt.to_tensor(ids), pt.to_tensor(seg),
                attention_mask=pt.to_tensor(mask))
        jloss = JF.cross_entropy(jl, pt.to_tensor(labels))
    jloss.backward()
    jg = {n: np.asarray(p.grad._array.astype(jnp.float32))
          for n, p in jm.named_parameters() if p.grad is not None}
    with amp.auto_cast(dtype=dtype):
        tl = tm(torch.from_numpy(ids), torch.from_numpy(seg),
                attention_mask=torch.from_numpy(mask))
        tloss = PF.cross_entropy(tl, torch.from_numpy(labels))
    tloss.backward()
    logit_tol, loss_tol, grad_tol = BERT_TOL[dtype]
    assert tl.dtype == torch.float32 and str(jl._array.dtype) == "float32"
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl._array),
                               atol=logit_tol, rtol=0)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=loss_tol)
    checked = 0
    for n, p in tm.named_parameters():
        if "k_proj.bias" in n:
            continue
        g = p.grad.numpy()
        ref = jg[n]
        if g.ndim == 2 and "embeddings" not in n:
            ref = ref.T                       # Linear: [in, out] in JAX
        if n == "classifier.bias":
            # the batch mean of softmax - one-hot: a logit error e moves
            # it by at most e / 2, however small it is
            assert np.abs(g - ref).max() <= logit_tol / 2, n
        else:
            err = np.abs(g - ref).max() / np.abs(ref).max()
            assert err <= grad_tol, (n, err)
        checked += 1
    assert checked == len(jg) - 2


# ------------------------------------------------------------------ C7
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("master_weight", [None, False])
def test_decorate_takes_o1_as_the_jax_package_does(level, dtype,
                                                   master_weight):
    """C7: the JAX `decorate` never reads `level`: it casts the floating
    parameters and turns master weights on at O1 as at O2."""
    lin = torch.nn.Linear(4, 4)
    opt = optimizer.AdamW(parameters=lin.parameters())
    m, o = amp.decorate(models=lin, optimizers=opt, level=level,
                        dtype=dtype, master_weight=master_weight)
    jlin = pt.nn.Linear(4, 4)
    jopt = pt.optimizer.AdamW(parameters=jlin.parameters())
    jm, jo = jamp.decorate(models=jlin, optimizers=jopt, level=level,
                           dtype=dtype, master_weight=master_weight)
    assert m is lin and o is opt and jm is jlin and jo is jopt
    assert _tdt(lin.weight) == _jdt(jlin.weight) == dtype
    assert opt._use_master_weights == jopt._use_master_weights == (
        master_weight is not False)
