"""Running a case of `torch_tensor_api_cases` through the JAX package
and through the port on the CPU: values and, for `grad` cases, the
gradients of the float inputs under a seeded weight on each output
(the JAX package's tape `backward` against torch autograd)."""
import zlib

import numpy as np
import torch

import paddle_tpu as pt
import paddle_tpu_torch as P
from torch_tensor_api_cases import build, mismatch, to_numpy

REF = {"tensor_api": pt.tensor_api, "linalg": pt.linalg, "fft": pt.fft,
       "signal": pt.signal}
PORT = {"tensor_api": P.tensor_api, "linalg": P.linalg, "fft": P.fft,
        "signal": P.signal}


def _is_float(a):
    return isinstance(a, np.ndarray) and a.dtype.kind in "fc"


def ref_call(case, args, kw, grad=False):
    def conv(a):
        return pt.to_tensor(a, stop_gradient=not (grad and _is_float(a)))
    a, k = build(args, conv), build(kw, conv)
    return getattr(REF[case.module], case.name)(*a, **k), a, k


def port_call(case, args, kw, grad=False, device="cpu"):
    def conv(a):
        t = torch.from_numpy(np.array(a)).to(device)
        return t.requires_grad_(True) if grad and _is_float(a) else t
    a, k = build(args, conv), build(kw, conv)
    return getattr(PORT[case.module], case.name)(*a, **k), a, k


def leaves(tree, kind):
    """The input tensors of a built argument tree, in order."""
    out = []
    if isinstance(tree, (list, tuple)):
        for t in tree:
            out += leaves(t, kind)
    elif isinstance(tree, dict):
        for t in tree.values():
            out += leaves(t, kind)
    elif isinstance(tree, kind):
        out.append(tree)
    return out


def _outputs(out, kind):
    return [o for o in leaves(out if isinstance(out, (list, tuple))
                              else [out], kind)]


def weights(case, outs_np):
    rng = np.random.default_rng(zlib.crc32(("w" + case.id).encode()))
    return [rng.standard_normal(o.shape).astype(np.float32)
            for o in outs_np]


def ref_grads(case, args, kw):
    out, a, k = ref_call(case, args, kw, grad=True)
    outs = [o for o in _outputs(out, pt.Tensor)
            if np.asarray(o._array).dtype.kind in "fc"]
    ws = weights(case, [np.asarray(o._array) for o in outs])
    loss = None
    for o, w in zip(outs, ws):
        wt = pt.to_tensor(w)
        term = (pt.real(o) * wt).sum() + (pt.imag(o) * wt).sum() \
            if np.asarray(o._array).dtype.kind == "c" else (o * wt).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [np.zeros(np.shape(t._array), np.float32) if t.grad is None
            else np.asarray(t.grad._array)
            for t in leaves((a, k), pt.Tensor) if not t.stop_gradient]


def port_grads(case, args, kw):
    out, a, k = port_call(case, args, kw, grad=True)
    outs = [o for o in _outputs(out, torch.Tensor)
            if o.is_floating_point() or o.is_complex()]
    ws = weights(case, [o.detach().resolve_conj().numpy() for o in outs])
    loss = None
    for o, w in zip(outs, ws):
        wt = torch.from_numpy(w)
        term = (torch.real(o) * wt).sum() + (torch.imag(o) * wt).sum() \
            if o.is_complex() else (o * wt).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [torch.zeros(t.shape) if t.grad is None else t.grad.detach()
            for t in leaves((a, k), torch.Tensor) if t.requires_grad]


def check_values(case):
    args, kw = case.inputs()
    want = to_numpy(ref_call(case, args, kw)[0])
    got = to_numpy(port_call(case, args, kw)[0])
    if case.post is not None:
        want, got = case.post(want), case.post(got)
    return mismatch(got, want, case.tol)


def check_grads(case, tol):
    args, kw = case.inputs()
    want = ref_grads(case, args, kw)
    got = [g.numpy() for g in port_grads(case, args, kw)]
    assert want, f"{case.id}: no gradient"
    return mismatch(got, want, tol)
