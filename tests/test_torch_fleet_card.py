"""Ring attention on the card: one rank, through the flash kernels.

This file imports torch and numpy only, so it runs on the machine with
the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_fleet_card.py

With one rank and no process group, `ring_attention` is one diagonal
block (causal) or one full block: `flash_block_fwd` and `flash_block_bwd`
on the whole sequence.  Its output and the three gradients must equal
`flash_attention`'s bit for bit (the same kernels on the same operands),
and each call launches the sm90 forward, dK/dV and dQ once.  Two shapes:
the GPT-3 1.3B training shape (B 4, L 1024, H 16, D 128, causal, bf16)
and a GQA one at D 64 (B 2, L 512, H 8, Hkv 2, not causal, bf16).  On the
CPU both tests skip.
"""
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.distributed import ring_attention
from paddle_tpu_torch.ops import flash_attention as fa

SHAPES = {"gpt13_train": (4, 1024, 16, 16, 128, True),
          "gqa_d64_full": (2, 512, 8, 2, 64, False)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sm90():
    c = ops.launch_counts()
    return tuple(c[f"flash_{k}_sm90"] for k in ("fwd", "dkv", "dq"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ring_equals_flash_attention_on_the_card(card, name):
    B, L, H, Hkv, D, causal = SHAPES[name]
    g = torch.Generator(device=card).manual_seed(0)
    mk = lambda h: torch.randn(B, L, h, D, generator=g, device=card,  # noqa
                               dtype=torch.bfloat16)
    q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
    outs = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, is_causal=causal),
               lambda a, b, c: ring_attention(a, b, c, causal=causal)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = _sm90()
        o = fn(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        grew = tuple(a - b for a, b in zip(_sm90(), before))
        assert grew == (1, 1, 1), grew
        outs.append([o.detach()] + [t.grad for t in leaves])
    for a, b, what in zip(*outs, ("o", "dq", "dk", "dv")):
        assert torch.equal(a, b), what
