"""LoRA fine-tuning over frozen base weights.

Counterpart: `paddle_tpu/text/peft.py:35-261` — `LoRAConfig`,
`LoRALinear`, `LoRAModel` and `get_peft_model`.  The adapters are plain
parameters; every other parameter gets `requires_grad=False` (the JAX
package's `stop_gradient`), so the optimizer makes no slots for it
(`Optimizer.init_state`) and `TrainStep` collects no gradient for it.
`TrainStep` takes its parameter list when it is built, so wrap the model
before building the step.

Layouts.  The base stays a `torch.nn.Linear` (weight [out, in]);
`lora_A` is [in, r] and `lora_B` [r, out], the JAX package's own layout,
so y = base(x) + scale * (x @ A) @ B in both packages and an adapter
`.npz` saved by either loads into the other unchanged.  The adapters
take the base weight's dtype: the JAX package makes them float32 and
lets XLA promote a bfloat16 x against them, which torch's matmul does
not do.  Through
`weights.load_paddle_tpu_state` the base weight is transposed as every
Linear weight is and the adapters are copied as they are.

`merge()` / `unmerge()` add / subtract scale * (A @ B)^T into the base
weights IN PLACE, every layer's delta in one batched `torch.no_grad`
pass (`torch._foreach_add_`).  A merged
model's decode programs are not reused for the unmerged one or the other
way round: `decode.jit_generate` keys them on each layer's `merged` flag.
Tensor-parallel wrapping is a later slice of the port.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ..nn import functional as PF


class LoRAConfig:
    """Rank r, alpha (scale = alpha / r), dropout on the adapter input,
    target_modules (regexes matched in full against sublayer paths), and
    whether biases train too."""

    def __init__(self, r=8, lora_alpha=16, lora_dropout=0.0,
                 target_modules=(".*q_proj", ".*k_proj", ".*v_proj",
                                 ".*qkv_proj"),
                 trainable_bias=False):
        if r < 1:
            raise ValueError("LoRA rank must be >= 1")
        self.r = int(r)
        self.lora_alpha = float(lora_alpha)
        self.lora_dropout = float(lora_dropout)
        self.target_modules = list(target_modules)
        self.trainable_bias = bool(trainable_bias)

    def to_dict(self):
        """The configuration as a dict, with the JAX package's keys
        (`paddle_tpu/text/peft.py:53`)."""
        return dict(r=self.r, lora_alpha=self.lora_alpha,
                    lora_dropout=self.lora_dropout,
                    target_modules=self.target_modules,
                    trainable_bias=self.trainable_bias)


class LoRALinear(nn.Module):
    """A frozen Linear plus a rank-r residual: y = base(x) + s * (xA)B.

    A is drawn Normal(0, 1 / sqrt(in)) from `generator` (None: the
    device's default generator) and B starts at zero, so the layer is
    exactly the base layer at step 0.  Dropout on the adapter input draws
    from `self.generator` in training."""

    def __init__(self, base, r, alpha, dropout=0.0, generator=None):
        super().__init__()
        if not isinstance(base, nn.Linear):
            raise TypeError(
                f"LoRALinear wraps nn.Linear, got {type(base).__name__}")
        self.base = base
        self.r = r
        self.scaling = alpha / r
        self._dropout_p = dropout
        self.generator = None
        out_f, in_f = base.weight.shape
        kw = dict(device=base.weight.device, dtype=base.weight.dtype)
        self.lora_A = nn.Parameter(torch.empty(in_f, r, **kw))
        self.lora_B = nn.Parameter(torch.zeros(r, out_f, **kw))
        with torch.no_grad():
            self.lora_A.normal_(0.0, 1.0 / np.sqrt(in_f),
                                generator=generator)
        self.merged = False

    def forward(self, x):
        y = self.base(x)
        if self.merged:
            return y
        h = x
        if self._dropout_p > 0.0 and self.training:
            h = PF.dropout(h, self._dropout_p, generator=self.generator)
        return y + (h @ self.lora_A) @ self.lora_B * self.scaling

    def _delta(self):
        """scale * (A @ B)^T in the base weight's [out, in] layout."""
        return ((self.lora_A @ self.lora_B) * self.scaling).t()

    @torch.no_grad()
    def merge(self):
        """Fold the adapter into the base weight."""
        if not self.merged:
            w = self.base.weight
            w.add_(self._delta().to(w.dtype))
            self.merged = True

    @torch.no_grad()
    def unmerge(self):
        if self.merged:
            w = self.base.weight
            w.sub_(self._delta().to(w.dtype))
            self.merged = False

    def extra_repr(self):
        fo, fi = self.base.weight.shape
        return (f"in={fi}, out={fo}, r={self.r}, scale={self.scaling}, "
                f"merged={self.merged}")


class LoRAModel(nn.Module):
    """Wrap `model`: every Linear whose dotted path matches a target
    pattern becomes a LoRALinear (adapters on the Linear's device and in
    its dtype, A drawn from `generator`), and every parameter but the
    adapters (and the biases, with `trainable_bias`) is frozen.  Other
    attributes (generate, new_caches, cfg, ...) are the wrapped model's."""

    def __init__(self, model, lora_config, generator=None):
        super().__init__()
        self.model = model
        self.lora_config = lora_config
        pats = [re.compile(p + "$") for p in lora_config.target_modules]
        replaced = []
        for path, sub in list(model.named_modules()):
            if not isinstance(sub, nn.Linear) or \
                    not any(p.match(path) for p in pats):
                continue
            parent, leaf = self._resolve_parent(model, path)
            setattr(parent, leaf, LoRALinear(
                sub, lora_config.r, lora_config.lora_alpha,
                lora_config.lora_dropout, generator=generator))
            replaced.append(path)
        if not replaced:
            raise ValueError(
                f"no Linear matched target_modules="
                f"{lora_config.target_modules}")
        self.replaced = replaced
        self._freeze()

    @staticmethod
    def _resolve_parent(model, path):
        parts = path.split(".")
        parent = model
        for p in parts[:-1]:
            parent = getattr(parent, p)
        return parent, parts[-1]

    def _freeze(self):
        for name, p in self.model.named_parameters():
            is_adapter = "lora_A" in name or "lora_B" in name
            is_bias = name.endswith(".bias")
            p.requires_grad_(is_adapter or (
                is_bias and self.lora_config.trainable_bias))

    def _lora_layers(self):
        return [m for m in self.model.modules() if isinstance(m, LoRALinear)]

    def forward(self, *args, **kwargs):
        if self.training and any(s.merged for s in self._lora_layers()):
            # a merged layer skips its adapter, so a training forward
            # would give lora_A / lora_B zero gradients: a silent no-op
            raise RuntimeError(
                "training forward with MERGED adapters: gradients to "
                "lora_A/lora_B would be zero. unmerge() first.")
        return self.model(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            model = self.__dict__["_modules"].get("model")
            if model is None:
                raise
            return getattr(model, name)

    # ----------------------------------------------------------- adapters
    def trainable_parameters(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def adapter_state_dict(self):
        """{name: parameter} of every adapter, named as in the wrapped
        model ("...q_proj.lora_A")."""
        return {n: p for n, p in self.model.named_parameters()
                if "lora_A" in n or "lora_B" in n}

    def save_adapter(self, path):
        """The adapters as an `.npz` of float32 arrays, the JAX package's
        layout and names."""
        np.savez(path, **{n: p.detach().float().cpu().numpy()
                          for n, p in self.adapter_state_dict().items()})

    @torch.no_grad()
    def load_adapter(self, path):
        """Load an adapter `.npz` (this package's or the JAX package's);
        raises KeyError on a missing name and ValueError on a shape
        mismatch."""
        path = str(path)
        with np.load(path if path.endswith(".npz") else path + ".npz") as f:
            data = {n: f[n] for n in f.files}
        own = self.adapter_state_dict()
        missing = set(own) - set(data)
        if missing:
            raise KeyError(f"adapter file missing {sorted(missing)[:3]}")
        for n, p in own.items():
            if tuple(data[n].shape) != tuple(p.shape):
                raise ValueError(f"{n}: shape {data[n].shape} does not fit "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(data[n])))

    def merge(self):
        """Fold every adapter into its base weight.  Refuses in train mode
        (a training forward after it would train nothing): call .eval()
        first, and unmerge() before training again."""
        if self.training:
            raise RuntimeError(
                "merge() on a model in train mode: a training step after "
                "it would double-count or skip the adapter against the "
                "merged weight. Call .eval() first, and unmerge() before "
                "resuming training.")
        self._merge_all(True)

    def unmerge(self):
        self._merge_all(False)

    @torch.no_grad()
    def _merge_all(self, want_merged):
        subs = [s for s in self._lora_layers() if s.merged != want_merged]
        if not subs:
            return
        weights = [s.base.weight for s in subs]
        deltas = [s._delta().to(w.dtype) for s, w in zip(subs, weights)]
        if want_merged:
            torch._foreach_add_(weights, deltas)
        else:
            torch._foreach_sub_(weights, deltas)
        for s in subs:
            s.merged = want_merged


def get_peft_model(model, lora_config, generator=None):
    """PaddleNLP-style entry point: `LoRAModel(model, lora_config)`."""
    return LoRAModel(model, lora_config, generator=generator)
