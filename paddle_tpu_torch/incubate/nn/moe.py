"""Mixture-of-Experts feed-forward layers.

Counterpart: `paddle_tpu/incubate/nn/moe.py`.  The experts' weights are
stacked on a leading expert axis (`w1` [E, d, f], `w2` [E, f, d]), under
the JAX names and layouts, so `weights.load_paddle_tpu_state` copies
them without a transpose, and each expert product is one batched GEMM
over a static [E, C, d] buffer.

Routing is the reference's decision for decision (`moe_ffn`, `:96-162`):
the router runs in float32; `top_k` rounds of argmax over the remaining
probabilities (a tie goes to the first index in both libraries); a
choice's slot is `cumsum(mask) - 1 + fill`, so the k-th choices queue
behind every token's earlier ones; a slot at or past the capacity C drops
the choice; the kept gates are divided by their sum, and gradients flow
through that division.  Two things differ in form, not in value:

* every one-hot is a comparison against an `arange`: torch's `one_hot`
  raises on an index out of range (on the card a device-side assert),
  where JAX's gives the zero row the reference drops a token with;
* the dense one-hot einsums of dispatch and combine (N·E·C·d products
  each) become a gather into the [E·C + 1, d] buffer and a gather back
  over the same slots.  A dropped choice points at the extra dump row,
  which no expert reads and which holds zeros on the way back.  Shapes
  stay static, with no `nonzero`, no `.item()` and no boolean indexing,
  so a captured decode step records the layer.

The four stages run under `torch.profiler.record_function` ranges
("moe_route", "moe_dispatch", "moe_experts", "moe_combine"), so that a
profile can name the device time of each.

The JAX `_maybe_shard` annotations belong to the expert-parallel mesh,
which the port does not have yet (ROADMAP.md A11); they are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

__all__ = ["MoELayer", "moe_aux_loss", "moe_ffn", "moe_ffn_expert_choice",
           "route_top_k"]


def _activation(name):
    return {"gelu": lambda h: F.gelu(h, approximate="tanh"),
            "relu": F.relu,
            "silu": F.silu,
            "swish": F.silu}[name]


def _z_loss(logits):
    return torch.logsumexp(logits, dim=-1).square().mean()


def _experts(xin, w1, b1, w2, b2, act, dtype):
    """The stacked expert FFNs on the [E, C, d] buffer: two batched GEMMs
    with the biases folded in."""
    h = torch.baddbmm(b1.to(dtype)[:, None, :], xin, w1.to(dtype))
    return torch.baddbmm(b2.to(dtype)[:, None, :], _activation(act)(h),
                         w2.to(dtype))


@torch.no_grad()
def route_top_k(probs, top_k, capacity):
    """The reference's top-k routing decisions for probs [N, E] (float32):
    (experts [N, k], slots [N, k], top1 [N, E]), where experts[n, j] is
    token n's j-th choice, slots[n, j] its position in that expert's
    capacity buffer (at or past `capacity` it drops) and top1 the one-hot
    of the first choices."""
    N, E = probs.shape
    ar = torch.arange(E, device=probs.device)
    remaining = probs
    fill = torch.zeros(E, 1, dtype=torch.long, device=probs.device)
    experts, slots, top1 = [], [], None
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)                             # [N]
        # the one-hot transposed, [E, N], so that the running count
        # over the tokens scans the contiguous axis
        mask = (ar[:, None] == idx).long()
        if top1 is None:
            top1 = mask.t().float()
        remaining = remaining * (1 - mask.t())
        pos = torch.cumsum(mask, dim=1) - 1 + fill                 # [E, N]
        slots.append(pos.gather(0, idx[None])[0])
        experts.append(idx)
        fill = fill + mask.sum(1, keepdim=True)
    return torch.stack(experts, 1), torch.stack(slots, 1), top1


def moe_ffn(x, wg, w1, b1, w2, b2, *, top_k, capacity, act="gelu",
            z_loss_weight=0.0):
    """MoE feed-forward on flattened tokens, as the reference's `moe_ffn`.

    x [N, d]; wg [d, E]; w1 [E, d, f]; b1 [E, f]; w2 [E, f, d]; b2 [E, d].
    Returns (y [N, d] in x's dtype, aux float32 scalar): aux is the
    load-balancing loss E * sum_e(mean prob_e * share of first choices on
    e), plus `z_loss_weight` times the router z-loss."""
    N, d = x.shape
    E = wg.shape[1]
    C = capacity
    dtype = x.dtype

    with record_function("moe_route"):
        logits = x.float() @ wg.float()                            # [N, E]
        probs = torch.softmax(logits, dim=-1)
        experts, slots, top1 = route_top_k(probs, top_k, C)
        gates = probs.gather(1, experts)                           # [N, k]
        gates = gates * (slots < C)
        combine = gates / gates.sum(1, keepdim=True).clamp(min=1e-9)
        # a dispatched choice holds a slot with a nonzero combine weight,
        # as the reference's `dispatch = combine > 0`; the others go to
        # the dump row E * C
        flat = torch.where(combine > 0, experts * C + slots,
                           torch.full_like(slots, E * C))          # [N, k]
        me = probs.mean(dim=0)
        ce = top1.mean(dim=0)
        aux = E * torch.sum(me * ce)
        if z_loss_weight:
            aux = aux + z_loss_weight * _z_loss(logits)

    with record_function("moe_dispatch"):
        # which token fills each slot (N: a zero row), then a gather
        token = torch.arange(N, device=x.device)[:, None].expand(N, top_k)
        src = torch.full((E * C + 1,), N, dtype=torch.long, device=x.device)
        src.scatter_(0, flat.reshape(-1), token.reshape(-1))
        xin = torch.cat([x, x.new_zeros(1, d)]).index_select(
            0, src[:E * C]).view(E, C, d)
    with record_function("moe_experts"):
        out = _experts(xin, w1, b1, w2, b2, act, dtype)            # [E, C, d]
    with record_function("moe_combine"):
        # each choice's expert output back to its token, weighted
        rows = torch.cat([out.reshape(E * C, d), out.new_zeros(1, d)])
        y = torch.einsum("nk,nkd->nd", combine.to(dtype), rows.index_select(
            0, flat.reshape(-1)).view(N, top_k, d))
    return y, aux


def moe_ffn_expert_choice(x, wg, w1, b1, w2, b2, *, capacity, act="gelu",
                          z_loss_weight=0.0):
    """Expert-choice routing (Zhou et al. 2022), as the reference's
    `moe_ffn_expert_choice`: each expert takes its `capacity` best tokens
    by router score; a token several experts take sums their weighted
    outputs.  torch.topk promises no order among equal scores, so on a
    tie the set of tokens taken may differ from JAX's.  Returns (y, aux),
    aux 0 unless `z_loss_weight`."""
    N, d = x.shape
    dtype = x.dtype
    logits = x.float() @ wg.float()
    scores = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(scores.t(), capacity, dim=-1)           # [E, C]
    E, C = idx.shape
    xin = x.index_select(0, idx.reshape(-1)).view(E, C, d)
    out = _experts(xin, w1, b1, w2, b2, act, dtype)                # [E, C, d]
    weighted = vals.to(dtype)[..., None] * out
    y = x.new_zeros(N, d).index_add(0, idx.reshape(-1),
                                    weighted.reshape(E * C, d))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if z_loss_weight:
        aux = z_loss_weight * _z_loss(logits)
    return y, aux


class MoELayer(nn.Module):
    """A feed-forward layer of `num_experts` experts with top-k routing
    (counterpart `paddle_tpu.incubate.nn.MoELayer`, `:165-283`).

    `gate` is "top_k" (top_k=2 is GShard's), "gshard", "switch" (top-1)
    or "expert_choice".  Parameters: `gate_weight` [d, E], `w1`
    [E, d, f], `b1` [E, f], `w2` [E, f, d], `b2` [E, d]; the weights are
    drawn from Normal(0, 0.02) with `generator` (None: the device's
    default generator), the biases are zeros.  The layer is built on
    `device` (None: PyTorch's default device).  Each forward keeps its
    load-balancing loss in `aux_loss`; `moe_aux_loss(model)` sums them."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, eval_capacity_factor=2.0,
                 activation="gelu", z_loss_weight=0.0, gate="top_k",
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        if gate not in ("top_k", "gshard", "switch", "expert_choice"):
            raise ValueError(f"unknown gate type {gate!r}")
        if gate == "switch":
            top_k = 1          # a switch gate is top-1 routing
        self.gate = "top_k" if gate in ("gshard", "switch") else gate
        if self.gate != "expert_choice" and top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        _activation(activation)          # KeyError on an unknown name
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.activation = activation
        self.z_loss_weight = z_loss_weight
        kw = dict(device=device, dtype=dtype)
        E = num_experts
        self.gate_weight = nn.Parameter(torch.empty(d_model, E, **kw))
        self.w1 = nn.Parameter(torch.empty(E, d_model, d_hidden, **kw))
        self.b1 = nn.Parameter(torch.empty(E, d_hidden, **kw))
        self.w2 = nn.Parameter(torch.empty(E, d_hidden, d_model, **kw))
        self.b2 = nn.Parameter(torch.empty(E, d_model, **kw))
        self._aux_loss = None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for w in (self.gate_weight, self.w1, self.w2):
            w.normal_(0.0, 0.02, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    @property
    def aux_loss(self):
        """The last forward's load-balancing loss (None before one)."""
        return self._aux_loss

    def restore_aux_loss(self, aux):
        """Re-attach an aux loss returned across recompute's boundary."""
        self._aux_loss = aux

    def capacity(self, n_tokens):
        """Slots per expert for a call of `n_tokens` tokens: the training
        or eval capacity factor times k * n / E, rounded up, in [1, n]
        (expert choice: k is 1)."""
        cf = self.capacity_factor if self.training \
            else self.eval_capacity_factor
        k = 1 if self.gate == "expert_choice" else self.top_k
        c = int(math.ceil(cf * k * n_tokens / self.num_experts))
        return max(1, min(n_tokens, c))

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        args = (x2, self.gate_weight, self.w1, self.b1, self.w2, self.b2)
        kw = dict(capacity=self.capacity(x2.shape[0]), act=self.activation,
                  z_loss_weight=self.z_loss_weight)
        if self.gate == "expert_choice":
            y, aux = moe_ffn_expert_choice(*args, **kw)
        else:
            y, aux = moe_ffn(*args, top_k=self.top_k, **kw)
        self._aux_loss = aux
        return y.reshape(shape)


def moe_aux_loss(model):
    """The sum of the aux losses of every MoELayer of `model` after a
    forward, or None when it has no routed layer that ran."""
    total = None
    for mod in model.modules():
        if isinstance(mod, MoELayer) and mod.aux_loss is not None:
            total = mod.aux_loss if total is None else total + mod.aux_loss
    return total
