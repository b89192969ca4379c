"""Linear algebra (counterpart: `paddle_tpu/linalg.py`; reference:
python/paddle/tensor/linalg.py), over `torch.linalg`.

The reference's contracts are kept: `lu` returns the packed factors with
1-based int32 pivots (LAPACK's, as `torch.linalg.lu_factor` gives them)
and, with `get_infos`, an int32 info tensor; `lu_unpack` gives P [m, m],
L [m, k] and U [k, n] with A = P @ L @ U; `qr(mode="r")` returns R
alone; `cholesky_solve(x, y)` takes the right-hand side first;
`pinv`'s cut-off is `jnp.linalg.pinv`'s (10 * max(m, n) * eps of the
largest singular value); `cond` is the ratio of singular values for p
in (None, 2, -2), else norm(x) * norm(inv(x)).  Where the reference
computes on the host (`eig`) or in numpy (`lu_unpack`'s row swaps), the
port stays on the device and takes batches too.  The signs and phases
of the vectors of `qr`, `svd`, `eigh` and `eig` are LAPACK's (cuSOLVER's
on the card) and may differ from the reference's; their products and
invariants agree.  `lstsq` takes full-rank inputs on the card (torch's
only CUDA driver is "gels").
"""
from __future__ import annotations

import torch

from .tensor_api import _axes, _float, _t

__all__ = ["cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
           "eig", "eigh", "eigvals", "eigvalsh", "householder_product",
           "inv", "lstsq", "lu", "lu_unpack", "matrix_exp", "matrix_norm",
           "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv", "qr",
           "slogdet", "solve", "svd", "svdvals", "triangular_solve",
           "vector_norm"]


def norm(x, p=None, axis=None, keepdim=False):
    return torch.linalg.norm(_float(_t(x)), ord=p, dim=_axes(axis),
                             keepdim=keepdim)


def inv(x):
    return torch.linalg.inv(_t(x))


def det(x):
    return torch.linalg.det(_t(x))


def slogdet(x):
    return tuple(torch.linalg.slogdet(_t(x)))


def cholesky(x, upper=False):
    return torch.linalg.cholesky(_t(x), upper=upper)


def solve(a, b):
    return torch.linalg.solve(_t(a), _t(b))


def _as_matrix(b):
    return (b.unsqueeze(-1), True) if b.dim() == 1 else (b, False)


def lstsq(a, b):
    """The least-squares solution alone, as the reference returns it."""
    b, vec = _as_matrix(_t(b))
    out = torch.linalg.lstsq(_t(a), b).solution
    return out.squeeze(-1) if vec else out


def matrix_power(x, n):
    return torch.linalg.matrix_power(_t(x), int(n))


def pinv(x):
    x = _t(x)
    m, n = x.shape[-2:]
    return torch.linalg.pinv(
        x, rtol=10 * max(m, n) * torch.finfo(x.dtype).eps)


def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(_t(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(_t(x), full_matrices=full_matrices))


def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(_t(x), UPLO=UPLO))


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_t(x), UPLO=UPLO)


def triangular_solve(a, b, upper=True, transpose=False, unitriangular=False):
    """Solve a @ out = b (a^T @ out = b with `transpose`) for a
    triangular `a`."""
    a, b = _t(a), _t(b)
    if transpose:
        a, upper = a.mT, not upper
    b, vec = _as_matrix(b)
    out = torch.linalg.solve_triangular(a, b, upper=upper,
                                        unitriangular=unitriangular)
    return out.squeeze(-1) if vec else out


def matrix_rank(x, tol=None):
    x = _t(x)
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0)


def multi_dot(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out.matmul(x)
    return out


def lu(x, pivot=True, get_infos=False):
    """Packed LU and 1-based int32 pivots; `get_infos` adds the int32
    info tensor (0 where the factorisation succeeded)."""
    lu_packed, piv, info = torch.linalg.lu_factor_ex(_t(x), pivot=pivot)
    if get_infos:
        return lu_packed, piv, info.reshape(-1)
    return lu_packed, piv


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True):
    """(P [m, m], L [m, k], U [k, n]) of `lu`'s results."""
    return tuple(torch.lu_unpack(_t(lu_data), _t(lu_pivots),
                                 unpack_data=unpack_ludata,
                                 unpack_pivots=unpack_pivots))


def cholesky_solve(x, y, upper=False):
    """Solve A @ out = x given y = cholesky(A) (the right-hand side
    first, as in the reference)."""
    x, vec = _as_matrix(_t(x))
    out = torch.cholesky_solve(x, _t(y), upper=upper)
    return out.squeeze(-1) if vec else out


def matrix_exp(x):
    return torch.linalg.matrix_exp(_t(x))


def householder_product(x, tau):
    return torch.linalg.householder_product(_t(x), _t(tau))


def cond(x, p=None):
    """Condition number; p in {None, 2, -2, 'fro', 'nuc', 1, -1, inf,
    -inf}, None meaning 2."""
    if p is None or p == 2 or p == -2:
        s = torch.linalg.svdvals(_t(x))
        smax, smin = s.amax(dim=-1), s.amin(dim=-1)
        return smax / smin if p != -2 else smin / smax
    return norm(x, p=p) * norm(inv(x), p=p)


def eig(x):
    """(eigenvalues, eigenvectors) of a general square matrix, complex."""
    return tuple(torch.linalg.eig(_t(x)))


def eigvals(x):
    return eig(x)[0]


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = _t(x)
    if not rowvar:
        x = x.mT
    return torch.cov(x, correction=1 if ddof else 0,
                     fweights=None if fweights is None else _t(fweights),
                     aweights=None if aweights is None else _t(aweights))


def corrcoef(x, rowvar=True):
    x = _t(x)
    return torch.corrcoef(x if rowvar else x.mT)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(_t(x), ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False):
    return torch.linalg.vector_norm(_float(_t(x)), ord=p, dim=_axes(axis),
                                    keepdim=keepdim)


def svdvals(x):
    return torch.linalg.svdvals(_t(x))
