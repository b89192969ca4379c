"""The checks `torch_gloo.py` runs inside gloo ranks (torch, numpy and the
port only).  Each takes plain JSON arguments and .npz paths the parent
wrote, asserts what it can hold on its own, and returns the numpy arrays
the parent holds against the JAX package."""
import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet, mesh
from paddle_tpu_torch.weights import _linear_weights, load_paddle_tpu_state


def reset():
    mesh.clear_mesh()
    fleet.fleet._strategy = None


def _init(hybrid):
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(hybrid)
    fleet.init(is_collective=True, strategy=s)
    return s


# ------------------------------------------------------------ collectives
def collectives():
    """Every collective on every rank against numpy."""
    r, w = dist.get_rank(), dist.get_world_size()
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    mine = lambda k=1.0: torch.from_numpy(base * (k + r))  # noqa: E731
    per = [base * (1.0 + i) for i in range(w)]
    ok = lambda t, want: np.testing.assert_allclose(  # noqa: E731
        t.numpy(), want, rtol=1e-6)
    for op, red in (("sum", np.sum), ("max", np.max), ("min", np.min),
                    ("prod", np.prod), ("avg", np.mean)):
        t = mine()
        assert C.all_reduce(t, op=op) is t
        ok(t, red(np.stack(per), axis=0))
    ti = torch.full((3,), 2 * r + 1, dtype=torch.int64)
    C.all_reduce(ti, op=C.ReduceOp.AVG)            # floor of the mean
    assert ti.tolist() == [sum(2 * i + 1 for i in range(w)) // w] * 3
    got = C.all_gather([], mine())
    assert len(got) == w
    for g, want in zip(got, per):
        ok(g, want)
    ok(C.all_gather(None, mine()), np.stack(per))
    full = torch.from_numpy(np.arange(4 * w, dtype=np.float32)) * (r + 1)
    out = torch.empty(4)
    C.reduce_scatter(out, full)
    tot = np.arange(4 * w, dtype=np.float32) * sum(range(1, w + 1))
    ok(out, tot[4 * r:4 * (r + 1)])
    t = mine()
    C.broadcast(t, src=w - 1)
    ok(t, per[w - 1])
    t = mine()
    C.reduce(t, dst=0)
    if r == 0:
        ok(t, sum(per))
    t = torch.empty(2, 3)
    C.scatter(t, [torch.full((2, 3), float(i)) for i in range(w)]
              if r == 0 else None, src=0)
    ok(t, np.full((2, 3), float(r)))
    outs = C.alltoall(None, [torch.full((2,), 10.0 * r + j)
                             for j in range(w)])
    for j, o in enumerate(outs):
        ok(o, np.full(2, 10.0 * j + r))
    x = torch.arange(2 * w, dtype=torch.float32) + 100 * r
    y = C.alltoall_single(None, x)
    ok(y, np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * j
                          for j in range(w)]))
    if w >= 2:
        if r == 0:
            C.send(torch.full((3,), 7.0), dst=1)
        elif r == 1:
            t = torch.empty(3)
            C.recv(t, src=0)
            ok(t, np.full(3, 7.0))
        if r in (0, 1):
            t = torch.full((2,), float(r))
            work = (C.isend(t, dst=1) if r == 0 else C.irecv(t, src=0))
            work.wait()
            ok(t, np.zeros(2))
    _init({"mp_degree": w})
    perm = [(i, (i + 1) % w) for i in range(w)]
    ok(C.ppermute(torch.full((2,), float(r)), "mp", perm),
       np.full(2, float((r - 1) % w)))
    ok(C.ppermute(torch.full((2,), 5.0), "mp", [(0, 0)]),
       np.full(2, 5.0 if r == 0 else 0.0))
    t = mine()
    C.all_reduce(t, group="mp")
    ok(t, sum(per))
    reset()
    C.barrier()
    objs = []
    C.all_gather_object(objs, {"rank": r})
    assert objs == [{"rank": i} for i in range(w)]
    lst = [f"from {r}", r]
    C.broadcast_object_list(lst, src=0)
    assert lst == ["from 0", 0]
    got = []
    C.scatter_object_list(got, [f"to {i}" for i in range(w)], src=0)
    assert got == [f"to {r}"]
    g = C.get_group()
    assert g.nranks == w and g.get_group_rank(r) == r
    sub = dist.new_group(list(range(w)))
    t = mine()
    C.all_reduce(t, group=sub)
    ok(t, sum(per))
    assert [p.shape[0] for p in C.split(torch.zeros(6, 2), [2, 4])] == [2, 4]
    # accounting: the calls and payload bytes of this rank
    from paddle_tpu_torch.observability import metrics
    reg = metrics.registry()
    assert reg.counter("collective_calls_total", op="all_gather",
                       axis="world").value == 2
    assert reg.counter("collective_bytes_total", op="broadcast",
                       axis="world").value == 24
    # chaos: fail_once fires on every rank at the same call, before the
    # attempt, and the policy's retry delivers it
    from paddle_tpu_torch.resilience import chaos
    C.configure_collectives(retries=1, backoff_base=0.0)
    chaos.install(chaos.ChaosPlan("collective.fail_once@1"))
    try:
        t = mine()
        C.all_reduce(t)
        ok(t, sum(per))
    finally:
        chaos.uninstall()
        C.configure_collectives()
    return {"retry": np.asarray(reg.counter(
        "collective_retry_total", op="all_reduce").value),
        "failures": np.asarray(reg.counter(
            "collective_failures_total", op="all_reduce").value)}


# ----------------------------------------------------------------- models
def _model(family, cfg):
    from paddle_tpu_torch import text
    if family == "gpt":
        return text.GPTForCausalLM(text.GPTConfig(**cfg), device="cpu")
    return text.LlamaForCausalLM(text.LlamaConfig(**cfg), device="cpu")


def train(family, cfg, hybrid, weights, batch, steps, lr, opt="adam",
          clip=None, state=False):
    """Build the model under `hybrid`, load the JAX weights, return the
    full logits of the first batch, the loss series of `steps` fleet
    steps, and the gathered parameters in the JAX layout (and the
    gathered optimizer state with `state`)."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.text import gpt_loss_fn
    _init(hybrid)
    model = _model(family, cfg)
    with np.load(weights) as z:
        load_paddle_tpu_state(model, {k: z[k] for k in z.files})
    with np.load(batch) as z:
        ids, labels = (torch.from_numpy(z[k]).long() for k in ("ids",
                                                                 "labels"))
    with torch.no_grad():
        logits = model(ids).numpy()
    kw = dict(learning_rate=lr, parameters=model.parameters(),
              grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    if opt == "momentum":
        kw["momentum"] = 0.9
    o = {"adam": O.Adam, "adafactor": O.Adafactor,
         "momentum": O.Momentum}[opt](**kw)
    if family == "gpt":
        loss_fn = gpt_loss_fn
    else:
        from paddle_tpu_torch.nn import functional as PF

        def loss_fn(m, x, y):
            return PF.cross_entropy(m(x), y, reduction="mean")
    step = fleet.build_train_step(model, loss_fn, o)
    losses = [float(step(ids, labels)) for _ in range(steps)]
    linear = _linear_weights(model)
    out = {"logits": logits, "losses": np.asarray(losses)}
    for n, t in model.state_dict().items():
        t = t.numpy()
        out["p/" + n] = t.T if n in linear else t
    if state:
        for k, v in step.state_dict().items():
            if isinstance(v, torch.Tensor):
                out["s/" + k] = v.numpy()
    return out


def shard_roundtrip(cfg, weights):
    """A tensor-parallel GPT's state_dict is the dense one it loaded, and
    loading it into a fresh mp model gives the same shards."""
    _init({"mp_degree": dist.get_world_size()})
    model = _model("gpt", cfg)
    with np.load(weights) as z:
        arrays = {k: z[k] for k in z.files}
    load_paddle_tpu_state(model, arrays)
    linear = _linear_weights(model)
    sd = model.state_dict()
    for n, want in arrays.items():
        got = sd[n].numpy()
        np.testing.assert_array_equal(got.T if n in linear else got, want,
                                      err_msg=n)
    fresh = _model("gpt", cfg)
    fresh.load_state_dict(sd)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
    qkv = model.gpt.h[0].attn.qkv_proj.weight
    return {"qkv_local_rows": np.asarray(qkv.shape[0])}


# ------------------------------------------------------------------- ring
def ring(inputs, causal, mp):
    """ring_attention over mp ranks on the full q, k, v of `inputs`: the
    output and the gradients of sum(o * do)."""
    from paddle_tpu_torch.distributed import ring_attention
    _init({"mp_degree": mp})
    with np.load(inputs) as z:
        q, k, v, do = (torch.from_numpy(z[n]) for n in ("q", "k", "v",
                                                         "do"))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ring_attention(q, k, v, causal=causal)
    (o * do).sum().backward()
    return {"o": o.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


# ------------------------------------------------------------------- misc
def data_parallel(inputs, steps, lr):
    """DataParallel over every rank: each feeds its rows of the batch,
    averages its gradients and steps Adam."""
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.optimizer import Adam
    r, w = dist.get_rank(), dist.get_world_size()
    with np.load(inputs) as z:
        arrays = {k: torch.from_numpy(z[k]) for k in z.files}
    torch.manual_seed(5)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 8))
    net.load_state_dict({k: arrays[k] for k in net.state_dict()})
    model = DataParallel(net)
    opt = Adam(learning_rate=lr, parameters=model.parameters())
    x, y = arrays["x"].chunk(w)[r], arrays["y"].chunk(w)[r]
    losses = []
    for _ in range(steps):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        model.apply_collective_grads()
        opt.step()
        opt.clear_grad()
        t = loss.detach().clone()
        C.all_reduce(t, op="avg")
        losses.append(float(t))
    assert sorted(model.state_dict()) == sorted(net.state_dict())
    return {"losses": np.asarray(losses),
            **{k: v.detach().numpy() for k, v in net.state_dict().items()}}


def refusals():
    """What the slice refuses, on every rank: degrees past the world,
    pp > 1, ZeRO 3, 'p_g_os', an Adafactor over split parameters, and a
    context-parallel model beside tensor parallelism."""
    import pytest
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.optimizer import Adafactor, Adam
    from paddle_tpu_torch.text import gpt_loss_fn
    w = dist.get_world_size()
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
               max_position_embeddings=32, hidden_dropout=0.0,
               attention_dropout=0.0)
    with pytest.raises(ValueError, match="ranks"):
        _init({"mp_degree": 2 * w})
    for hybrid, match in (({"pp_degree": w}, "A11"),
                          ({"dp_degree": w, "sharding_stage": 3}, "A11")):
        reset()
        _init(hybrid)
        m = _model("gpt", cfg)
        with pytest.raises(NotImplementedError, match=match):
            fleet.build_train_step(m, gpt_loss_fn,
                                   Adam(parameters=m.parameters()))
    reset()
    _init({"dp_degree": w})
    m = _model("gpt", cfg)
    with pytest.raises(NotImplementedError, match="A11"):
        sharding.group_sharded_parallel(m, Adam(parameters=m.parameters()),
                                        "p_g_os")
    reset()
    _init({"mp_degree": w})
    m = _model("gpt", cfg)
    assert m.cfg.tensor_parallel
    with pytest.raises(NotImplementedError, match="whole tensors"):
        fleet.build_train_step(m, gpt_loss_fn,
                               Adafactor(parameters=m.parameters()))
    with pytest.raises(NotImplementedError, match="both ride"):
        _model("gpt", dict(cfg, context_parallel=True,
                           tensor_parallel=True))
    assert not _model("gpt", dict(cfg, context_parallel=True)
                      ).cfg.tensor_parallel
    with pytest.raises(ValueError, match="num_kv_heads"):
        _model("llama", dict(vocab_size=64, hidden_size=32, num_layers=1,
                             num_heads=4, num_kv_heads=1,
                             intermediate_size=48))
    with pytest.raises(NotImplementedError, match="A11"):
        m(torch.zeros(1, 4, dtype=torch.long), caches=m.new_caches(1))
    hcg = fleet.fleet.get_hybrid_communicate_group()
    return {"mp_rank": np.asarray(hcg.get_model_parallel_rank()),
            "mp_size": np.asarray(hcg.get_model_parallel_world_size())}


def sync_batch_norm(seed):
    """SyncBatchNorm over every rank, each with its rows of one batch:
    rank 0's output, input gradient and running statistics, for the
    parent to hold against one BatchNorm over the whole batch."""
    from paddle_tpu_torch import nn
    r, w = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((4 * w, 3, 5, 2)).astype(
        np.float32) * 2 + 1)
    proj = torch.from_numpy(rng.standard_normal((4, 3, 5, 2)).astype(
        np.float32))
    bn = nn.SyncBatchNorm(3, momentum=0.8, device="cpu")
    mine = x.chunk(w)[r].clone().requires_grad_()
    out = bn(mine)
    (out * proj).sum().backward()
    return {"out": out.detach().numpy(), "grad": mine.grad.numpy(),
            "mean": bn._mean.numpy(), "variance": bn._variance.numpy()}


# ---------------------------------------------------------- check_numerics
def check_numerics():
    """dp 2: one good step, then a step in which rank 1 alone feeds NaN
    rows: every rank raises FloatingPointError with the same message
    (the flags are combined over the ranks) and keeps its parameters."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.framework import flags
    flags.set_flags({"check_numerics": True})
    _init({"dp_degree": 2})
    torch.manual_seed(0)
    model = tnn.Sequential(tnn.Linear(4, 4, device="cpu"))
    opt = O.SGD(learning_rate=0.1, parameters=model.parameters())
    step = fleet.build_train_step(
        model, lambda m, x: (m(x) ** 2).mean() * x.sum(), opt)
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 16
    step(x)
    before = [p.detach().clone() for p in model.parameters()]
    bad = x.clone()
    bad[2:] = float("nan")            # rank 1's rows
    try:
        step(bad)
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("no FloatingPointError")
    mine = torch.tensor([ord(c) for c in message.ljust(120)],
                        dtype=torch.int32)
    theirs = mine.clone()
    C.broadcast(theirs, src=0)
    unchanged = all(torch.equal(a, b)
                    for a, b in zip(before, model.parameters()))
    flags.set_flags({"check_numerics": False})
    reset()
    return {"message": np.asarray(message),
            "unchanged": np.asarray([unchanged]),
            "same_message": np.asarray([torch.equal(mine, theirs)])}
