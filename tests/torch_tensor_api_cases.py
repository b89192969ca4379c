"""One table of cases for the port's tensor functions: every public name
of `tensor_api`, `linalg`, `fft` and `signal`, with seeded inputs.

Read by the CPU parity tests (`tests/test_torch_tensor_api.py`,
`tests/test_torch_linalg_fft_signal.py`: the JAX package's function
against the port's on the same inputs) and by `chip_smoke.py`'s
`tensor_api` phase (the port on the card against the port on the CPU).
It imports numpy and torch only, so the card's machine (no JAX) reads
it too.

A case is `C(module, name, *args, **options)`.  An argument `A(...)` is
an array made from the case's seed (its kind picks the domain: the
inputs of `log` are positive, of `atanh` inside (-1, 1), of `cholesky`
symmetric positive definite); lists, tuples and dicts of them are
built item by item; anything else is passed as it is.  Options:
- `kw`: keyword arguments (built the same way);
- `tol`: the tolerance, a fraction of the largest magnitude of each
  reference output (of 1 where that is smaller): `EXACT` (equal),
  `EW` 1e-6 for elementwise math, `RED` 1e-5 for reductions and
  products, `LIN` 1e-4 for linalg and fft; integer and bool outputs
  are always equal;
- `card_tol`: the card-against-CPU tolerance, when it is looser
  (the decompositions);
- `grad`: hold the gradients of the float inputs too (the JAX package's
  tape against torch autograd), with a seeded weight on each output;
- `post`: outputs -> what is compared (invariants where the factors are
  free: a QR's product, an eigendecomposition's reconstruction);
- `random`: a random function: `check(outputs)` holds shapes, dtypes
  and ranges instead of values;
- `tag`: a suffix for a second case of the same function.
"""
from __future__ import annotations

import zlib

import numpy as np

EXACT = 0.0
EW = 1e-6
RED = 1e-5
LIN = 1e-4


class A:
    """An input array: `shape`, `kind` and, for indices, `n`."""

    def __init__(self, *shape, kind="normal", n=None, dtype=None):
        self.shape, self.kind, self.n, self.dtype = shape, kind, n, dtype

    def make(self, rng):
        s, k = self.shape, self.kind
        if k == "normal":
            a = rng.standard_normal(s)
        elif k == "pos":
            a = rng.uniform(0.5, 2.0, s)
        elif k == "unit":
            a = rng.uniform(-0.9, 0.9, s)
        elif k == "prob":
            a = rng.uniform(0.05, 0.95, s)
        elif k == "ge1":
            a = rng.uniform(1.1, 3.0, s)
        elif k == "int":
            a = rng.integers(-4, 5, s)
        elif k == "intpos":
            a = rng.integers(1, 7, s)
        elif k == "small":
            a = rng.integers(0, 4, s)
        elif k == "index":
            a = rng.integers(0, self.n, s)
        elif k == "perm":
            a = rng.permutation(self.n)[:s[0]]
        elif k == "bool":
            a = rng.random(s) > 0.5
        elif k == "sorted":
            a = np.sort(rng.standard_normal(s), axis=-1)
        elif k == "complex":
            a = rng.standard_normal(s) + 1j * rng.standard_normal(s)
        elif k == "spd":
            m = rng.standard_normal(s)
            a = m @ np.swapaxes(m, -1, -2) + s[-1] * np.eye(s[-1])
        elif k == "cond":       # well conditioned, not symmetric
            a = rng.standard_normal(s) + 3 * np.eye(s[-1])
        elif k == "tril":
            a = np.tril(rng.standard_normal(s)) + 3 * np.eye(s[-1])
        elif k == "rank2":      # a 4 x 4 matrix of rank 2
            a = rng.standard_normal((4, 2)) @ rng.standard_normal((2, 4))
        elif k == "nan":
            a = rng.standard_normal(s)
            a.flat[::3] = np.nan
        elif k == "special":
            a = np.array([0.0, -0.0, 1.5, -2.5, np.inf, -np.inf, np.nan,
                          3.0])[:s[0]]
        else:
            raise ValueError(k)
        dt = self.dtype or ("complex64" if k == "complex" else
                            "int64" if k in ("int", "intpos", "small",
                                             "index", "perm") else
                            "bool" if k == "bool" else "float32")
        return np.asarray(a).astype(dt)


class C:
    def __init__(self, module, name, *args, kw=None, tol=EXACT,
                 card_tol=None, grad=False, post=None, random=False,
                 check=None, tag=""):
        self.module, self.name, self.args = module, name, args
        self.kw = kw or {}
        self.tol, self.grad, self.post = tol, grad, post
        self.card_tol = tol if card_tol is None else card_tol
        self.random, self.check = random, check
        self.id = f"{module}.{name}" + (f"[{tag}]" if tag else "")

    def inputs(self):
        """(args, kwargs) with every A made: numpy arrays."""
        rng = np.random.default_rng(zlib.crc32(self.id.encode()))
        return _make(self.args, rng), _make(self.kw, rng)


def _make(spec, rng):
    if isinstance(spec, A):
        return spec.make(rng)
    if isinstance(spec, tuple):
        return tuple(_make(s, rng) for s in spec)
    if isinstance(spec, list):
        return [_make(s, rng) for s in spec]
    if isinstance(spec, dict):
        return {k: _make(v, rng) for k, v in spec.items()}
    return spec


def build(spec, to_tensor):
    """Each numpy array of `spec` (as `C.inputs` made it) through
    `to_tensor`, containers rebuilt."""
    if isinstance(spec, np.ndarray):
        return to_tensor(spec)
    if isinstance(spec, tuple):
        return tuple(build(s, to_tensor) for s in spec)
    if isinstance(spec, list):
        return [build(s, to_tensor) for s in spec]
    if isinstance(spec, dict):
        return {k: build(v, to_tensor) for k, v in spec.items()}
    return spec


# ----------------------------------------------------- invariants (post)
def _qr(out):
    q, r = out
    return [q @ r, np.abs(np.diagonal(r, axis1=-2, axis2=-1))]


def _svd(out):
    u, s, vh = out
    return [(u * s[..., None, :]) @ vh, s]


def _eigh(out):
    w, v = out
    return [w, (v * w[..., None, :]) @ np.swapaxes(v, -1, -2).conj()]


def _eig(out):
    w, v = out
    order = np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))
    # A v = w v for each column: the reconstruction A = V W V^-1
    return [w[order], (v * w[None, :]) @ np.linalg.inv(v)]


def _eigvals(out):
    w = out[0]
    return [w[np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))]]


def _lu_unpack(out):
    p, l, u = out
    return [p @ l @ u, l, u]


def _finfo(out):
    f = out[0]
    return [np.asarray([f.bits, f.eps, f.max, f.min, f.tiny], np.float64)]


def _iinfo(out):
    f = out[0]
    return [np.asarray([f.bits, f.max, f.min], np.float64)]


def _edges(out):
    h, edges = out[0], out[1:]
    return [h] + list(edges)


# ------------------------------------------------------- random (check)
def _rng_check(lo=None, hi=None, shape=None, integer=False, mean=None,
               std=None):
    def check(out):
        x = out[0]
        problems = []
        if shape is not None and tuple(x.shape) != tuple(shape):
            problems.append(f"shape {x.shape} != {shape}")
        if integer and x.dtype.kind not in "iu":
            problems.append(f"dtype {x.dtype} is not an integer type")
        if not integer and x.dtype.kind != "f":
            problems.append(f"dtype {x.dtype} is not a float type")
        if lo is not None and x.min() < lo:
            problems.append(f"min {x.min()} < {lo}")
        if hi is not None and x.max() >= hi:
            problems.append(f"max {x.max()} >= {hi}")
        if mean is not None and abs(float(x.mean()) - mean) > 0.1:
            problems.append(f"mean {x.mean()} far from {mean}")
        if std is not None and abs(float(x.std()) - std) > 0.1:
            problems.append(f"std {x.std()} far from {std}")
        return problems
    return check


def _perm_check(n):
    def check(out):
        return [] if sorted(out[0].tolist()) == list(range(n)) else \
            [f"not a permutation of {n}"]
    return check


def _multinomial_check(out):
    x = out[0]
    problems = [] if x.shape == (3, 2) else [f"shape {x.shape}"]
    for row in x:
        if len(set(row.tolist())) != len(row):
            problems.append(f"repeated draw without replacement {row}")
    if x.min() < 0 or x.max() > 4:
        problems.append("index out of range")
    return problems


def _bernoulli_check(out):
    x = out[0]
    return [] if set(np.unique(x).tolist()) <= {0.0, 1.0} and \
        x.shape == (64, 64) else [f"values {np.unique(x)[:4]}"]


# ------------------------------------------------------------------ cases
T, L, F, S = "tensor_api", "linalg", "fft", "signal"

_BINARY_FLOAT = ["add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "fmax", "fmin", "atan2", "logaddexp", "hypot",
                 "copysign", "nextafter"]
_BINARY_INT = ["floor_divide", "mod", "remainder", "equal", "not_equal",
               "greater_than", "greater_equal", "less_than", "less_equal",
               "bitwise_and", "bitwise_or", "bitwise_xor"]
_UNARY = {
    "exp": "normal", "expm1": "normal", "log": "pos", "log2": "pos",
    "log10": "pos", "log1p": "pos", "sqrt": "pos", "rsqrt": "pos",
    "abs": "normal", "sign": "normal", "floor": "normal", "ceil": "normal",
    "round": "normal", "trunc": "normal", "sin": "normal", "cos": "normal",
    "tan": "unit", "asin": "unit", "acos": "unit", "atan": "normal",
    "sinh": "normal", "cosh": "normal", "tanh": "normal", "asinh": "normal",
    "acosh": "ge1", "atanh": "unit", "erf": "normal", "erfinv": "unit",
    "reciprocal": "pos", "square": "normal", "sigmoid": "normal",
    "digamma": "pos", "lgamma": "pos", "frac": "normal", "neg": "normal",
    "i0": "normal",
}
# no gradient: piecewise constant, or nothing to differentiate
_NO_GRAD = {"sign", "floor", "ceil", "round", "trunc"}


def _cases():
    cs = []
    add = cs.append
    # ---------------------------------------------------------- creation
    add(C(T, "to_tensor", [[1.5, 2.0], [3.0, -1.0]]))
    add(C(T, "zeros", [2, 3]))
    add(C(T, "ones", [2, 3], "int32"))
    add(C(T, "full", [2, 2], 7))
    add(C(T, "full", [2, 2], 1.5, "float32", tag="float"))
    add(C(T, "empty", [3]))
    add(C(T, "zeros_like", A(2, 3)))
    add(C(T, "ones_like", A(2, 3), "int32"))
    add(C(T, "full_like", A(2, 3), 2.5))
    add(C(T, "empty_like", A(4)))
    add(C(T, "arange", 7))
    add(C(T, "arange", 1.0, 2.0, 0.25, tag="float", tol=EW))
    add(C(T, "linspace", -1.0, 1.0, 9, tol=EW))
    add(C(T, "logspace", 0.0, 2.0, 5, tol=EW))
    add(C(T, "eye", 3, 4))
    add(C(T, "diag", A(4), kw={"offset": 1}))
    add(C(T, "diag", A(3, 4), tag="matrix"))
    add(C(T, "diag_embed", A(2, 3)))
    add(C(T, "diagonal", A(3, 4, 5), kw={"offset": 1, "axis1": 1,
                                          "axis2": 2}))
    add(C(T, "meshgrid", A(3), A(4)))
    add(C(T, "tril", A(4, 4), 1))
    add(C(T, "triu", A(4, 4), -1))
    add(C(T, "clone", A(3, 2)))
    add(C(T, "assign", A(3, 2)))
    # ------------------------------------------------------------ random
    add(C(T, "rand", [64, 64], random=True,
          check=_rng_check(0.0, 1.0, (64, 64), mean=0.5)))
    add(C(T, "randn", [64, 64], random=True,
          check=_rng_check(shape=(64, 64), mean=0.0, std=1.0)))
    add(C(T, "uniform", [64, 64], kw={"min": -2.0, "max": 3.0},
          random=True, check=_rng_check(-2.0, 3.0, (64, 64), mean=0.5)))
    add(C(T, "normal", 1.0, 2.0, [64, 64], random=True,
          check=_rng_check(shape=(64, 64), mean=1.0, std=2.0)))
    add(C(T, "randint", 2, 9, [64, 64], random=True,
          check=_rng_check(2, 9, (64, 64), integer=True)))
    add(C(T, "randperm", 50, random=True, check=_perm_check(50)))
    add(C(T, "multinomial", A(3, 5, kind="prob"), 2, random=True,
          check=_multinomial_check))
    add(C(T, "bernoulli", A(64, 64, kind="prob"), random=True,
          check=_bernoulli_check))
    add(C(T, "seed", 7, random=True, check=lambda out: []))
    add(C(T, "randint_like", A(8, 8, kind="int"), 0, 5, random=True,
          check=_rng_check(0, 5, (8, 8), integer=True)))
    # ------------------------------------------------------ binary family
    for n in _BINARY_FLOAT:
        grad = n in ("divide", "atan2")
        add(C(T, n, A(3, 4), A(3, 4), tol=EW, grad=grad))
    add(C(T, "add", A(3, 4), 2.5, tag="scalar", tol=EW))
    add(C(T, "pow", A(3, 4, kind="pos"), A(3, 4), tol=EW))
    add(C(T, "pow", A(3, 4), 2, tag="scalar", tol=EW))
    for n in _BINARY_INT:
        add(C(T, n, A(3, 4, kind="int"), A(3, 4, kind="intpos")))
    add(C(T, "floor_divide", A(3, 4), A(3, 4, kind="pos"), tag="float",
          tol=EW))
    add(C(T, "mod", A(3, 4), A(3, 4, kind="pos"), tag="float", tol=EW))
    add(C(T, "remainder", A(3, 4), A(3, 4), tag="signs", tol=EW))
    for n in ("logical_and", "logical_or", "logical_xor"):
        add(C(T, n, A(3, 4, kind="bool"), A(3, 4, kind="bool")))
    add(C(T, "heaviside", A(3, 4, kind="int", dtype="float32"), A(3, 4)))
    # ------------------------------------------------------- unary family
    for n, kind in _UNARY.items():
        add(C(T, n, A(3, 4, kind=kind), tol=EW, grad=n not in _NO_GRAD))
    for n in ("isnan", "isinf", "isfinite"):
        add(C(T, n, A(8, kind="special")))
    add(C(T, "logical_not", A(3, 4, kind="bool")))
    add(C(T, "bitwise_not", A(3, 4, kind="int")))
    for n in ("conj", "real", "imag"):
        add(C(T, n, A(3, 4, kind="complex")))
    add(C(T, "imag", A(3, 4), tag="real_input"))
    # ------------------------------------------------------ matmul family
    add(C(T, "matmul", A(2, 3, 4), A(2, 4, 5), tol=RED, grad=True))
    add(C(T, "matmul", A(4, 3), A(5, 4), kw={"transpose_x": True,
                                               "transpose_y": True},
          tag="transposed", tol=RED, grad=True))
    add(C(T, "mm", A(3, 4), A(4, 2), tol=RED, grad=True))
    add(C(T, "bmm", A(2, 3, 4), A(2, 4, 2), tol=RED, grad=True))
    add(C(T, "dot", A(5), A(5), tol=RED, grad=True))
    add(C(T, "dot", A(2, 3, 4), A(5, 4, 2), tag="nd", tol=RED))
    add(C(T, "cross", A(4, 3), A(4, 3), tol=RED, grad=True))
    add(C(T, "outer", A(3), A(4), tol=RED, grad=True))
    add(C(T, "einsum", "bij,bjk->bik", A(2, 3, 4), A(2, 4, 2), tol=RED,
          grad=True))
    add(C(T, "addmm", A(3, 2), A(3, 4), A(4, 2), kw={"beta": 0.5,
                                                      "alpha": 2.0},
          tol=RED, grad=True))
    add(C(T, "lerp", A(3, 4), A(3, 4), 0.3, tol=EW))
    add(C(T, "scale", A(3, 4), 2.0, 1.0, False, tol=EW))
    add(C(T, "clip", A(3, 4), -0.5, 0.5, tol=EXACT, grad=True))
    add(C(T, "clip", A(3, 4), A(3, 4), None, tag="tensor_min",
          tol=EXACT))
    add(C(T, "nan_to_num", A(8, kind="special"), kw={"nan": 9.0}))
    add(C(T, "cast", A(3, 4), "int32"))
    # -------------------------------------------------------- reductions
    for n in ("sum", "mean", "prod", "max", "min", "amax", "amin",
              "logsumexp"):
        add(C(T, n, A(3, 4, 5), tol=RED, grad=True))
        add(C(T, n, A(3, 4, 5), [0, 2], True, tag="axes", tol=RED))
    add(C(T, "sum", A(3, 4, kind="int"), 1, tag="int"))
    for n in ("all", "any"):
        add(C(T, n, A(3, 4, kind="bool"), 1))
    add(C(T, "count_nonzero", A(3, 4, kind="small"), 0, True))
    add(C(T, "median", A(3, 6), 1, tol=RED, grad=True))
    add(C(T, "median", A(3, 5), tag="odd_all", tol=RED, grad=True))
    add(C(T, "nanmean", A(3, 6, kind="nan"), 1, tol=RED))
    add(C(T, "nansum", A(3, 6, kind="nan"), 1, tol=RED))
    add(C(T, "std", A(3, 6), 1, tol=RED, grad=True))
    add(C(T, "var", A(3, 6), kw={"unbiased": False}, tol=RED, grad=True))
    add(C(T, "argmax", A(3, 6), 1))
    add(C(T, "argmin", A(3, 6), kw={"axis": 0, "keepdim": True}))
    add(C(T, "cumsum", A(3, 4), tol=RED, grad=True))
    add(C(T, "cumsum", A(3, 4), 1, tag="axis", tol=RED))
    add(C(T, "cumprod", A(3, 4, kind="pos"), 1, tol=RED, grad=True))
    add(C(T, "cumprod", A(3, 4, kind="pos"), tag="flat", tol=RED))
    add(C(T, "logcumsumexp", A(3, 4), 1, tol=RED))
    add(C(T, "norm", A(3, 4), tol=RED, grad=True))
    add(C(T, "norm", A(3, 4), 1.0, 1, tag="p1", tol=RED))
    add(C(T, "norm", A(3, 4), float("inf"), tag="inf", tol=RED))
    add(C(T, "quantile", A(4, 7), 0.3, 1, tol=RED))
    # ------------------------------------------------------ manipulation
    add(C(T, "reshape", A(3, 4), [2, -1]))
    add(C(T, "transpose", A(2, 3, 4), [2, 0, 1]))
    add(C(T, "flatten", A(2, 3, 4), 1))
    add(C(T, "squeeze", A(2, 1, 3, 1), 1))
    add(C(T, "unsqueeze", A(2, 3), [0, 2]))
    add(C(T, "concat", [A(2, 3), A(1, 3)]))
    add(C(T, "stack", [A(2, 3), A(2, 3)], 1))
    add(C(T, "split", A(6, 2), [1, -1, 2]))
    add(C(T, "split", A(6, 2), 3, tag="equal"))
    add(C(T, "chunk", A(7, 2), 3))
    add(C(T, "unbind", A(3, 2), 1))
    add(C(T, "tile", A(2, 3), [2, 1, 2]))
    add(C(T, "expand", A(1, 3), [2, -1, 3]))
    add(C(T, "expand_as", A(1, 3), A(4, 3)))
    add(C(T, "broadcast_to", A(3, 1), [3, 4]))
    add(C(T, "broadcast_tensors", [A(3, 1), A(1, 4)]))
    add(C(T, "roll", A(3, 4), 2, 1))
    add(C(T, "roll", A(3, 4), -3, tag="flat"))
    add(C(T, "flip", A(3, 4), [0, 1]))
    add(C(T, "rot90", A(3, 4), 1))
    add(C(T, "repeat_interleave", A(3, 2), 2, 0))
    add(C(T, "pad", A(2, 3), [1, 2, 0, 1], grad=True))
    add(C(T, "pad", A(2, 3, 5), [2, 1], "reflect", tag="reflect"))
    add(C(T, "pad", A(2, 3, 5), [1, 2, 2, 1], "replicate",
          tag="replicate"))
    add(C(T, "pad", A(2, 3, 5), [2, 3], "circular", tag="circular"))
    # --------------------------------------------- indexing and scatter
    add(C(T, "gather", A(5, 3), A(4, kind="index", n=5), grad=True))
    add(C(T, "gather", A(2, 5), A(2, 3, kind="index", n=5), 1, tag="2d"))
    add(C(T, "gather_nd", A(4, 5), A(3, 2, kind="index", n=4), grad=True))
    add(C(T, "scatter", A(5, 3), A(3, kind="perm", n=5), A(3, 3),
          grad=True))
    add(C(T, "scatter", A(5, 3), np.array([1, 1, 3]), A(3, 3),
          kw={"overwrite": False}, tag="add", tol=EW, grad=True))
    add(C(T, "scatter_nd_add", A(4, 3), np.array([[1], [1], [2]]),
          A(3, 3), tol=EW, grad=True))
    add(C(T, "index_select", A(5, 3), A(4, kind="index", n=3), 1,
          grad=True))
    add(C(T, "index_add", A(5, 3), np.array([0, 2, 2]), 0, A(3, 3),
          tol=EW, grad=True))
    add(C(T, "index_fill", A(5, 3), np.array([1, 3]), 0, -1.0))
    add(C(T, "take_along_axis", A(3, 5), A(3, 2, kind="index", n=5), 1,
          grad=True))
    add(C(T, "put_along_axis", A(3, 5), np.array([[0], [4], [2]]),
          A(3, 1), 1, grad=True))
    add(C(T, "put_along_axis", A(3, 5), np.array([[0], [4], [2]]),
          A(3, 1), 1, "add", tag="add", tol=EW))
    add(C(T, "masked_fill", A(3, 4), A(3, 4, kind="bool"), 0.5,
          grad=True))
    add(C(T, "masked_select", A(3, 4), A(3, 4, kind="bool")))
    add(C(T, "where", A(3, 4, kind="bool"), A(3, 4), A(3, 4), grad=True))
    add(C(T, "where", A(3, 4, kind="bool"), tag="nonzero"))
    add(C(T, "nonzero", A(3, 4, kind="small")))
    add(C(T, "nonzero", A(3, 4, kind="small"), True, tag="tuple"))
    add(C(T, "unique", A(12, kind="small"), True, True, True))
    add(C(T, "unique", A(5, 2, kind="small"), kw={"axis": 0}, tag="axis"))
    # ------------------------------------------------------ sort, search
    add(C(T, "sort", A(3, 6, kind="small"), 1, True))
    add(C(T, "sort", A(3, 6), 0, tag="float", grad=True))
    add(C(T, "argsort", A(3, 6, kind="small"), 1, True))
    add(C(T, "argsort", A(3, 6, kind="small"), 1, tag="ascending"))
    add(C(T, "topk", A(3, 6, kind="small"), 3))
    add(C(T, "topk", A(6, 3), 2, 0, False, tag="smallest"))
    add(C(T, "searchsorted", A(8, kind="sorted"), A(3, 4), True))
    add(C(T, "bincount", A(20, kind="small")))
    add(C(T, "bincount", A(20, kind="small"), A(20), 6, tag="weights",
          tol=RED))
    add(C(T, "one_hot", np.array([0, 3, 1, 7]), 5))
    add(C(T, "histogram", A(50), 6))
    add(C(T, "histogram", A(50), 4, -1.0, 1.0, tag="range"))
    # ------------------------------------------------------ comparisons
    add(C(T, "allclose", A(3, 4), A(3, 4)))
    add(C(T, "isclose", A(3, 4), A(3, 4), 10.0, 1.0))
    add(C(T, "equal_all", A(3, 4, kind="small"), A(3, 4, kind="small")))
    # ----------------------------------------------------------- numeric
    add(C(T, "numel", A(3, 4)))
    add(C(T, "shape", A(3, 4, 2)))
    add(C(T, "rank", A(3, 4, 2)))
    add(C(T, "is_tensor", A(3)))
    add(C(T, "iinfo", "int32", post=_iinfo))
    add(C(T, "finfo", "float32", post=_finfo))
    add(C(T, "increment", A(3), 2.0, tol=EW))
    add(C(T, "kthvalue", A(3, 6, kind="small"), 3, 1))
    add(C(T, "kthvalue", A(3, 6), 2, 0, True, tag="keepdim"))
    add(C(T, "mode", A(3, 7, kind="small")))
    add(C(T, "mode", A(6, 3, kind="small"), 0, True, tag="axis0"))
    add(C(T, "diff", A(3, 6), 2, 1, tol=EW))
    add(C(T, "diff", A(5), kw={"prepend": A(2), "append": A(1)},
          tag="pend", tol=EW))
    add(C(T, "as_strided", A(4, 5), [3, 2], [5, 2], 1))
    add(C(T, "matrix_power", A(3, 3), 3, tol=RED))
    add(C(T, "trace", A(4, 5), 1, tol=RED, grad=True))
    add(C(T, "trapezoid", A(3, 6), tol=RED))
    add(C(T, "trapezoid", A(3, 6), A(6, kind="sorted"), tag="x", tol=RED))
    add(C(T, "nanquantile", A(3, 7, kind="nan"), 0.3, 1, tol=RED))
    add(C(T, "bucketize", A(3, 4), A(6, kind="sorted")))
    add(C(T, "unique_consecutive", np.array([1, 1, 2, 2, 2, 3, 1, 1]),
          True, True))
    add(C(T, "take", A(3, 4), np.array([[0, 11], [-1, 5]])))
    add(C(T, "take", A(3, 4), np.array([0, 13, -2]), "wrap", tag="wrap"))
    add(C(T, "renorm", A(3, 4), 2.0, 0, 1.0, tol=EW))
    add(C(T, "gcd", A(3, 4, kind="intpos"), A(3, 4, kind="intpos")))
    add(C(T, "lcm", A(3, 4, kind="intpos"), A(3, 4, kind="intpos")))
    add(C(T, "frexp", A(3, 4)))
    add(C(T, "ldexp", A(3, 4), A(3, 4, kind="int"), tol=EW))
    add(C(T, "vander", A(4), 3, tol=EW))
    add(C(T, "vander", A(4), kw={"increasing": True}, tag="increasing",
          tol=EW))
    add(C(T, "msort", A(4, 3)))
    add(C(T, "view_as", A(3, 4), A(2, 6)))
    add(C(T, "unflatten", A(3, 8), 1, [2, 4]))
    add(C(T, "moveaxis", A(2, 3, 4), 0, 2))
    add(C(T, "tensordot", A(3, 4, 5), A(4, 5, 2), tol=RED, grad=True))
    add(C(T, "tensordot", A(3, 4, 5), A(5, 3), [[0, 2], [1, 0]],
          tag="axes", tol=RED))
    add(C(T, "histogramdd", A(40, 2), 3, tol=RED, post=_edges))
    add(C(T, "signbit", A(8, kind="special")))
    add(C(T, "isneginf", A(8, kind="special")))
    add(C(T, "isposinf", A(8, kind="special")))
    add(C(T, "polar", A(3, kind="pos"), A(3), tol=EW))
    add(C(T, "angle", A(3, 4, kind="complex"), tol=EW))
    add(C(T, "deg2rad", A(3, 4), tol=EW))
    add(C(T, "rad2deg", A(3, 4), tol=EW))
    add(C(T, "cat", [A(2, 3), A(2, 1)], 1))
    add(C(T, "t", A(3, 4)))
    add(C(T, "tolist", A(2, 3, kind="int")))
    add(C(T, "add_n", [A(2, 3), A(2, 3), A(2, 3)], tol=EW))
    add(C(T, "as_complex", A(3, 2)))
    add(C(T, "as_real", A(3, kind="complex")))
    add(C(T, "block_diag", [A(2, 2), A(1, 3)]))
    add(C(T, "broadcast_shape", [3, 1, 4], [5, 4]))
    add(C(T, "column_stack", [A(3), A(3, 2)]))
    add(C(T, "hstack", [A(2, 3), A(2, 1)]))
    add(C(T, "vstack", [A(3), A(3)]))
    add(C(T, "dstack", [A(2, 3), A(2, 3)]))
    add(C(T, "tensor_split", A(7, 2), 3))
    add(C(T, "tensor_split", A(7, 2), [2, 5], tag="indices"))
    add(C(T, "hsplit", A(2, 6), 3))
    add(C(T, "vsplit", A(6, 2), [1, 4]))
    add(C(T, "dsplit", A(2, 2, 4), 2))
    add(C(T, "cummax", A(3, 6, kind="small"), 1))
    add(C(T, "cummin", A(3, 6, kind="small")))
    add(C(T, "diagflat", A(2, 2), 1))
    add(C(T, "dist", A(3, 4), A(3, 4), 3, tol=RED))
    add(C(T, "floor_mod", A(3, 4, kind="int"), A(3, 4, kind="intpos")))
    add(C(T, "index_put", A(4, 3), [np.array([0, 2]), np.array([1, 1])],
          A(2)))
    add(C(T, "index_put", A(4, 3), [np.array([1, 1]), np.array([0, 0])],
          A(2), True, tag="accumulate", tol=EW))
    add(C(T, "index_sample", A(3, 5), A(3, 2, kind="index", n=5)))
    add(C(T, "inner", A(3, 4), A(2, 4), tol=RED, grad=True))
    add(C(T, "is_complex", A(3, kind="complex")))
    add(C(T, "is_floating_point", A(3)))
    add(C(T, "is_integer", A(3, kind="int")))
    add(C(T, "is_empty", A(0, 3)))
    add(C(T, "kron", A(2, 2), A(2, 3), tol=RED, grad=True))
    add(C(T, "logit", A(3, 4, kind="prob"), tol=EW))
    add(C(T, "logit", A(3, 4, kind="prob"), 0.2, tag="eps", tol=EW))
    add(C(T, "multiplex", [A(3, 2), A(3, 2)], np.array([[1], [0], [1]])))
    add(C(T, "mv", A(3, 4), A(4), tol=RED, grad=True))
    add(C(T, "nanmedian", A(3, 7, kind="nan"), 1, tol=RED))
    add(C(T, "polygamma", A(3, 4, kind="pos"), 1, tol=EW))
    add(C(T, "scatter_nd", np.array([[1], [3], [1]]), A(3, 2), [5, 2],
          tol=EW))
    add(C(T, "sgn", A(3, kind="complex"), tol=EW))
    add(C(T, "sgn", A(3, 4), tag="real"))
    add(C(T, "shard_index", np.array([[1], [6], [12], [19]]), 20, 2, 1))
    add(C(T, "slice", A(4, 5, 6), [0, 2], [1, 0], [3, -1]))
    add(C(T, "strided_slice", A(5, 6), [0, 1], [0, 5], [5, 0], [2, -2]))
    add(C(T, "stanh", A(3, 4), tol=EW))
    add(C(T, "tril_indices", 4, 5, 1))
    add(C(T, "triu_indices", 4, None, -1))
    add(C(T, "unfold", A(2, 9), 1, 4, 2))
    add(C(T, "unstack", A(3, 2), 1))
    # ------------------------------------------------------------ linalg
    add(C(L, "norm", A(3, 4), tol=LIN, grad=True))
    add(C(L, "norm", A(3, 4), "fro", (0, 1), tag="fro", tol=LIN))
    add(C(L, "inv", A(3, 3, kind="cond"), tol=LIN, grad=True))
    add(C(L, "det", A(2, 3, 3, kind="cond"), tol=LIN, grad=True))
    add(C(L, "slogdet", A(3, 3, kind="cond"), tol=LIN))
    add(C(L, "cholesky", A(3, 3, kind="spd"), tol=LIN, grad=True))
    add(C(L, "cholesky", A(3, 3, kind="spd"), True, tag="upper", tol=LIN))
    add(C(L, "solve", A(3, 3, kind="cond"), A(3, 2), tol=LIN, grad=True))
    add(C(L, "lstsq", A(5, 3), A(5, 2), tol=LIN))
    add(C(L, "matrix_power", A(3, 3), -2, tol=LIN))
    add(C(L, "pinv", A(4, 3), tol=LIN))
    add(C(L, "qr", A(4, 3), tol=LIN, card_tol=1e-3, post=_qr))
    add(C(L, "svd", A(4, 3), tol=LIN, card_tol=1e-3, post=_svd))
    add(C(L, "eigh", A(4, 4, kind="spd"), tol=LIN, card_tol=1e-3,
          post=_eigh))
    add(C(L, "eigvalsh", A(4, 4, kind="spd"), tol=LIN))
    add(C(L, "triangular_solve", A(3, 3, kind="tril"), A(3, 2), False,
          tol=LIN))
    add(C(L, "triangular_solve", A(3, 3, kind="tril"), A(3, 2), False,
          True, tag="transpose", tol=LIN))
    add(C(L, "matrix_rank", A(4, 4, kind="rank2")))
    add(C(L, "multi_dot", [A(3, 4), A(4, 5), A(5, 2)], tol=LIN))
    add(C(L, "lu", A(4, 4, kind="cond"), kw={"get_infos": True},
          tol=LIN, card_tol=1e-3))
    add(C(L, "lu_unpack", *_lu_inputs(), tol=LIN, card_tol=1e-3,
          post=_lu_unpack))
    add(C(L, "cholesky_solve", A(3, 2), np.linalg.cholesky(
        A(3, 3, kind="spd").make(np.random.default_rng(3))).astype(
        np.float32), tol=LIN))
    add(C(L, "matrix_exp", A(3, 3), tol=LIN))
    add(C(L, "householder_product", A(4, 3), A(3), tol=LIN))
    add(C(L, "cond", A(3, 3, kind="cond"), tol=LIN))
    add(C(L, "cond", A(3, 3, kind="cond"), "fro", tag="fro", tol=LIN))
    add(C(L, "eig", A(3, 3, kind="cond"), tol=LIN, card_tol=1e-3,
          post=_eig))
    add(C(L, "eigvals", A(3, 3, kind="cond"), tol=LIN, card_tol=1e-3,
          post=_eigvals))
    add(C(L, "cov", A(3, 6), tol=LIN))
    add(C(L, "cov", A(6, 3), False, False, tag="cols", tol=LIN))
    add(C(L, "corrcoef", A(3, 6), tol=LIN))
    add(C(L, "matrix_norm", A(2, 3, 4), tol=LIN))
    add(C(L, "matrix_norm", A(3, 4), "nuc", tag="nuc", tol=LIN,
          card_tol=1e-3))
    add(C(L, "vector_norm", A(3, 4), 3.0, tol=LIN))
    add(C(L, "vector_norm", A(3, 4), 2.0, 1, True, tag="axis", tol=LIN))
    add(C(L, "svdvals", A(4, 3), tol=LIN))
    # --------------------------------------------------------------- fft
    for n in ("fft", "ifft"):
        add(C(F, n, A(3, 8), tol=LIN, grad=True))
        add(C(F, n, A(3, 8, kind="complex"), 6, 0, "ortho",
              tag="complex", tol=LIN))
    add(C(F, "rfft", A(3, 8), tol=LIN, grad=True))
    add(C(F, "rfft", A(3, 8), 10, -1, "forward", tag="n", tol=LIN))
    add(C(F, "irfft", A(3, 5, kind="complex"), tol=LIN))
    add(C(F, "hfft", A(3, 5, kind="complex"), tol=LIN))
    add(C(F, "ihfft", A(3, 8), tol=LIN))
    for n in ("fft2", "ifft2", "fftn", "ifftn"):
        add(C(F, n, A(2, 4, 6), tol=LIN, grad=n == "fft2"))
    add(C(F, "rfft2", A(2, 4, 6), tol=LIN))
    add(C(F, "irfft2", A(2, 4, 4, kind="complex"), tol=LIN))
    add(C(F, "rfftn", A(2, 4, 6), kw={"axes": [0, 2]}, tol=LIN))
    add(C(F, "irfftn", A(2, 4, 4, kind="complex"), tol=LIN))
    add(C(F, "fftfreq", 8, 0.5, tol=EW))
    add(C(F, "rfftfreq", 9, tol=EW))
    add(C(F, "fftshift", A(4, 5)))
    add(C(F, "fftshift", A(4, 5), 1, tag="axis"))
    add(C(F, "ifftshift", A(4, 5)))
    # ------------------------------------------------------------ signal
    add(C(S, "frame", A(2, 20), 6, 3, grad=True))
    add(C(S, "overlap_add", A(2, 5, 6), 3, tol=EW, grad=True))
    add(C(S, "stft", A(2, 64), 16, kw={"window": A(16, kind="pos")},
          tol=LIN, grad=True))
    add(C(S, "stft", A(64), 16, 4, 12, tag="win_length", tol=LIN))
    add(C(S, "stft", A(2, 64), 16, kw={"center": False, "onesided": False,
                                        "normalized": True},
          tag="twosided", tol=LIN))
    add(C(S, "stft", A(2, 64), 16, kw={"pad_mode": "constant"},
          tag="constant", tol=LIN))
    add(C(S, "istft", *_istft_input(), 16, kw={"window": _hann(16)},
          tol=LIN))
    add(C(S, "istft", *_istft_input(), 16, kw={"length": 60},
          tag="length", tol=LIN))
    return cs


def _lu_inputs():
    """A packed LU and its 1-based pivots, from scipy's LAPACK."""
    import scipy.linalg
    a = A(4, 4, kind="cond").make(np.random.default_rng(5))
    lu, piv = scipy.linalg.lu_factor(a)
    return lu.astype(np.float32), (piv + 1).astype(np.int32)


def _istft_input():
    """A onesided spectrum [2, 9, 17] of a real signal (n_fft 16)."""
    x = np.random.default_rng(11).standard_normal((2, 64))
    frames = np.stack([np.pad(r, 8, mode="reflect") for r in x])
    idx = np.arange(17)[:, None] * 4 + np.arange(16)[None, :]
    spec = np.fft.rfft(frames[:, idx] * _hann(16), axis=-1)
    return (np.swapaxes(spec, -1, -2).astype(np.complex64),)


def _hann(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


CASES = _cases()


def public_names(module):
    """The public functions of a port module: `__all__`."""
    return set(module.__all__)


# ------------------------------------------------------------ comparison
def to_numpy(out):
    """A result as a list of numpy arrays (tensors of either package,
    tuples and lists flattened, scalars, bools, finfo objects kept)."""
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(to_numpy(o))
        return res
    if hasattr(out, "bits") and not isinstance(out, np.ndarray):
        return [out]
    if hasattr(out, "_array"):                      # the JAX package
        return [np.asarray(out._array)]
    if hasattr(out, "detach"):                      # torch
        return [out.detach().cpu().resolve_conj().numpy()]
    return [np.asarray(out)]


def mismatch(got, want, tol):
    """None, or why `got` (a list of numpy arrays) differs from `want`:
    shapes, kinds (bool / integer / float / complex; integer widths
    aside) and values within `tol` of the largest magnitude of each
    reference array (equal where tol is 0; NaN where the reference has
    NaN)."""
    if len(got) != len(want):
        return f"{len(got)} outputs, want {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return f"output {i}: shape {g.shape}, want {w.shape}"
        kind = {"b": "b", "i": "i", "u": "i", "f": "f", "c": "c"}
        if kind.get(g.dtype.kind) != kind.get(w.dtype.kind):
            return f"output {i}: dtype {g.dtype}, want {w.dtype}"
        if g.dtype.kind in "biu":
            if not np.array_equal(g, w):
                return f"output {i}: {g.ravel()[:6]} != {w.ravel()[:6]}"
            continue
        g64, w64 = g.astype(np.complex128), w.astype(np.complex128)
        if not np.array_equal(np.isnan(g64), np.isnan(w64)):
            return f"output {i}: NaN at other places"
        fin = np.isfinite(w64)
        if not np.array_equal(g64[~fin & ~np.isnan(w64)],
                              w64[~fin & ~np.isnan(w64)]):
            return f"output {i}: infinities differ"
        if not fin.any():
            continue
        scale = max(1.0, float(np.abs(w64[fin]).max())) if tol else 1.0
        err = float(np.abs(g64[fin] - w64[fin]).max()) if g.size else 0.0
        if err > tol * scale:
            return (f"output {i}: max |diff| {err:.3g} > {tol:g} x "
                    f"{scale:.3g}")
    return None
