"""Block-paged KV cache pool — one allocation per serving replica.

Counterpart: `paddle_tpu/serving/block_pool.py`.  Per-layer
[num_blocks, block_size, Hkv, D] tensors allocated once on the model's
device (the current CUDA device when none is named; with no card it
raises unless told device="cpu"), carved into fixed-size token blocks that a host-side free list
with reference counts hands to requests.  Freed requests return their
blocks at once (refcount 0 -> back on the free list), so pool pressure
is a pure function of live context tokens.

The engine writes the pool tensors IN PLACE (`ops.paged_write`); the JAX
package returned new arrays from each step instead.  `shard_` (the
tensor-parallel layout) waits for the distributed slice of the port.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..observability import metrics as _metrics
from ..resilience import chaos


class PoolExhausted(RuntimeError):
    """A single request needs more blocks than the whole pool holds."""


class BlockPool:
    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, dtype=torch.float32, device=None):
        device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        shape = (self.num_blocks, self.block_size, self.num_kv_heads,
                 self.head_dim)
        # zeros, not empty: the plain gather path reads whole blocks and
        # masks afterwards, and 0 * NaN garbage would still be NaN
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(self.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(self.num_layers)]
        # host-side allocator: LIFO free list + per-block refcounts
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._refs = [0] * self.num_blocks

    @classmethod
    def for_model(cls, model, num_blocks, block_size=16, dtype=None):
        """Size the pool from the model config, on the model's device and,
        by default, in the model's dtype."""
        cfg = model.cfg
        hd = cfg.hidden_size // cfg.num_heads
        hkv = getattr(cfg, "num_kv_heads", None) or cfg.num_heads
        param = next(iter(model.parameters()))
        return cls(cfg.num_layers, num_blocks, block_size, hkv, hd,
                   dtype=dtype or param.dtype, device=param.device)

    # ------------------------------------------------------------ allocator
    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.num_blocks - len(self._free)

    def blocks_for(self, n_tokens):
        """Blocks needed to hold n_tokens."""
        return -(-int(n_tokens) // self.block_size)

    def allocate(self, n):
        """n block ids at refcount 1, or None when the pool can't serve
        them right now (the scheduler's preemption trigger).  The
        `serving.pool_exhausted` chaos site simulates that exhaustion."""
        n = int(n)
        if n > self.num_blocks:
            raise PoolExhausted(
                f"request needs {n} blocks but the whole pool is only "
                f"{self.num_blocks}; grow num_blocks or cap request "
                f"lengths")
        if chaos.fire("serving.pool_exhausted") or n > len(self._free):
            _metrics.registry().counter("serving_pool_exhausted_total").inc()
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, ids):
        for b in ids:
            if self._refs[b] <= 0:
                raise ValueError(f"ref of unallocated block {b}")
            self._refs[b] += 1

    def free(self, ids):
        """Drop one reference per id; blocks at refcount 0 return to the
        free list immediately."""
        for b in ids:
            r = self._refs[b] - 1
            if r < 0:
                raise ValueError(f"double free of block {b}")
            self._refs[b] = r
            if r == 0:
                self._free.append(b)

    def check_leaks(self):
        """(leaked_blocks, bad_refcounts) — both empty when every block
        is home."""
        leaked = [b for b, r in enumerate(self._refs) if r > 0]
        bad = [b for b, r in enumerate(self._refs) if r < 0]
        return leaked, bad
