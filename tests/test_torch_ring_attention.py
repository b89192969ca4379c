"""The port's ring attention in gloo ranks against the JAX package's, on
the CPU.

q, k and v (float32, B 2, L 16, D 16; 4 q heads over 4 or 2 kv heads)
are made with numpy; the ranks run `ring_attention` over mp 2 and mp 4
(one launch each: every case runs in its fixture's ranks), through
`flash_block_fwd` / `flash_block_bwd` (their plain versions on the CPU),
and return the output and the gradients of sum(o * do).  These are held
against the JAX package's `ring_attention` on its virtual mesh (the
einsum ring, differentiated by `jax.grad`) and against plain full
attention in torch, within rtol 1e-4, atol 1e-5.  With one rank and no
process group the ring is `flash_attention`, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from paddle_tpu.distributed.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.distributed import ring_attention, ring_attention_local
from paddle_tpu_torch.ops.flash_attention import flash_attention
from torch_gloo import Ranks

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(4, 4, True), (4, 4, False), (4, 2, True), (4, 2, False)]


def _inputs(H, Hkv, seed=0, B=2, L=16, D=16):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, L, H, D), k=f(B, L, Hkv, D), v=f(B, L, Hkv, D),
                do=f(B, L, H, D))


def _name(n, H, Hkv, causal):
    return f"mp{n}_h{H}_kv{Hkv}_{'causal' if causal else 'full'}"


def _jax(n, x, causal):
    mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))

    def f(q, k, v):
        o = jax_ring(q, k, v, mesh=mesh, causal=causal, impl="einsum")
        return jnp.sum(o * x["do"]), o

    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(
        x["q"], x["k"], x["v"])
    return dict(o=o, dq=g[0], dk=g[1], dv=g[2])


def _full(x, causal):
    """Plain attention in torch (kv heads repeated) and its gradients."""
    q, k, v = (torch.from_numpy(x[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    g = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
        is_causal=causal).transpose(1, 2)
    (o * torch.from_numpy(x["do"])).sum().backward()
    return dict(o=o.detach().numpy(), dq=q.grad.numpy(),
                dk=k.grad.numpy(), dv=v.grad.numpy())


def _ranks(n, tmp):
    jobs, refs = [], {}
    for seed, (H, Hkv, causal) in enumerate(SHAPES):
        name = _name(n, H, Hkv, causal)
        x = _inputs(H, Hkv, seed)
        np.savez(tmp / f"{name}.npz", **x)
        refs[name] = (_jax(n, x, causal), _full(x, causal))
        jobs.append({"name": name, "fn": "ring", "kw": dict(
            inputs=str(tmp / f"{name}.npz"), causal=causal, mp=n)})
    return refs, Ranks(n, jobs, tmp)


@pytest.fixture(scope="module")
def mp2(tmp_path_factory):
    return _ranks(2, tmp_path_factory.mktemp("ring2"))


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    return _ranks(4, tmp_path_factory.mktemp("ring4"))


def _case(mp2, mp4, n, shape):
    refs, ranks = mp2 if n == 2 else mp4
    name = _name(n, *shape)
    return ranks[name], refs[name]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_ring_matches_jax_ring(mp2, mp4, n, shape):
    got, (jax_ref, _) = _case(mp2, mp4, n, shape)
    for key in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], np.asarray(jax_ref[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_ring_matches_full_attention(mp2, mp4, n, shape):
    got, (_, full) = _case(mp2, mp4, n, shape)
    for key in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], full[key], err_msg=key, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_one_rank_is_flash_attention_bit_for_bit(causal):
    """No process group: one diagonal (or full) block, the flash
    forward and backward themselves."""
    x = _inputs(4, 2, seed=7)
    outs = []
    for fn in (lambda q, k, v: ring_attention(q, k, v, causal=causal),
               lambda q, k, v: ring_attention_local(q, k, v, causal=causal),
               lambda q, k, v: flash_attention(q, k, v, is_causal=causal)):
        q, k, v = (torch.from_numpy(x[n]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = fn(q, k, v)
        (o * torch.from_numpy(x["do"])).sum().backward()
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    for other in outs[:2]:
        for a, b in zip(other, outs[2]):
            assert torch.equal(a, b)


def test_ring_refuses_what_it_cannot_run():
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_local(q, k, k)
    with pytest.raises(ValueError, match="impl"):
        ring_attention(q, q, q, impl="einsum")
