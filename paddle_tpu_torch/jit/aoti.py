"""Programs compiled ahead of time: `torch.export` + AOTInductor.

The JAX package serializes a compiled XLA executable; the port's
counterpart is an AOTInductor package (a `.pt2` file): the exported
program compiled into a shared library of generated kernels and a C++
wrapper, loaded with `torch._inductor.aoti_load_package` and run without
tracing or compiling anything.  Operators the compiler does not lower
(`paddle_tpu_torch::flash_fwd`, `paddle_tpu_torch::paged_decode`) stay
calls of the operator, made through the package's proxy executor, so the
hand-written kernels launch, and count their launches, inside it.

* `FunctionalProgram` turns `fn(model, *args)` into a module whose
  inputs are the model's weights followed by `args`: a program takes the
  weights as inputs and never holds them, so N programs over one model
  cost one copy of its weights, not N + 1.
* `compile_packages` exports such programs and compiles each into a
  package, all at once, each in a child process of its own (a compile
  keeps about one core busy for minutes); it returns each package's
  input signature (dtype, device and shape of each input, a dynamic dim
  by its name and bounds).
* `AOTProgram` runs a loaded package after checking each call's inputs
  against that signature.  The generated wrapper checks nothing (unless
  `AOTI_RUNTIME_CHECK_INPUTS` is set), so a call it was not compiled for
  raises `AOTShapeMismatch` here, before it can read out of bounds.

Compiling needs a C++ compiler that links OpenMP programs (Inductor
always passes `-fopenmp`) and, on the card, Triton.  `cxx_compiler`
takes the first of `$CXX`, `g++`, `c++` and `clang++` that does: a
machine may set `CXX` to a compiler built without libgomp.  The
compiler's work files go to its cache under the temporary directory,
never into the repository.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch import nn
from torch.utils import _pytree as pytree


class AOTShapeMismatch(TypeError):
    """A call's inputs differ from those the package was compiled for."""


def module_weights(model):
    """(names, tensors) of the model's parameters, then its buffers, each
    tensor once (a tied parameter under its first name)."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return [n for n, _ in named], [t.detach() for _, t in named]


class _Body(nn.Module):
    def __init__(self, model, fn):
        super().__init__()
        self.m = model
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.m, *args)


class FunctionalProgram(nn.Module):
    """`forward(weights, *args)` = `fn(model, *args)` with the model's
    weights (in `module_weights` order, or `names`) replaced by the list
    `weights` (`torch.func.functional_call`).  The model is not a
    submodule, so the program owns no state: an export of it takes every
    weight as an input."""

    def __init__(self, model, fn, names=None):
        super().__init__()
        object.__setattr__(self, "_body", _Body(model, fn))
        self.names = list(names) if names is not None \
            else module_weights(model)[0]

    def forward(self, weights, *args):
        state = {f"m.{n}": w for n, w in zip(self.names, weights)}
        return torch.func.functional_call(self._body, state, args)


def _flat_dynamic(args, dynamic):
    """The dynamic dims of each flat input: `dynamic` mirrors `args` with
    None or {dim: (name, min, max)} at each tensor."""
    if dynamic is None:
        return [None] * len(pytree.tree_leaves(args))
    return pytree.tree_leaves(
        dynamic, is_leaf=lambda x: x is None or isinstance(x, dict))


@functools.lru_cache(maxsize=1)
def cxx_compiler():
    """The first C++ compiler of `$CXX`, `g++`, `c++`, `clang++` that
    compiles and links an OpenMP program; RuntimeError if none does."""
    tried = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "int main() { return omp_get_max_threads() < 1; }\n")
        for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"),
                                               "g++", "c++", "clang++"))):
            path = shutil.which(cxx)
            if path is None:
                continue
            rc = subprocess.run([path, "-fopenmp", src, "-o",
                                 os.path.join(tmp, "omp")],
                                capture_output=True).returncode
            if rc == 0:
                return path
            tried.append(path)
    raise RuntimeError(f"no C++ compiler here links an OpenMP program "
                       f"(tried {tried}); AOTInductor needs one")


def export_program(program, args, dynamic=None):
    """Export `program` (a `FunctionalProgram`: `args` is the weights,
    then its other inputs) over the example `args`.  `dynamic` (see
    `_flat_dynamic`) names the dims that may vary; one name is one
    `torch.export.Dim` wherever it appears.  Returns (the
    ExportedProgram, its input signature, export seconds)."""
    flat = pytree.tree_leaves(args)
    dims = _flat_dynamic(args, dynamic)
    if len(dims) != len(flat):
        raise ValueError(f"dynamic covers {len(dims)} inputs, the "
                         f"program takes {len(flat)}")
    made, signature, shapes = {}, [], []
    for t, d in zip(flat, dims):
        d = d or {}
        for name, lo, hi in d.values():
            made.setdefault(name, torch.export.Dim(name, min=lo, max=hi))
        shapes.append({i: made[name] for i, (name, _, _) in d.items()}
                      or None)
        signature.append({
            "dtype": str(t.dtype).split(".")[1], "device": t.device.type,
            "shape": [list(d[i]) if i in d else int(n)
                      for i, n in enumerate(t.shape)]})
    dynamic_shapes = None
    if made:
        # forward(weights, *args): export sees two inputs, the weights
        # and the tuple of the rest
        tree = pytree.tree_unflatten(shapes, pytree.tree_structure(args))
        dynamic_shapes = (tree[0], tuple(tree[1:]))
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(program, tuple(args),
                                 dynamic_shapes=dynamic_shapes)
    return ep, signature, time.perf_counter() - t0


def _compile(ep, path):
    from torch._inductor import aoti_compile_and_package
    t0 = time.perf_counter()
    aoti_compile_and_package(
        ep, package_path=path,
        inductor_configs={"cpp.cxx": (None, cxx_compiler())})
    return time.perf_counter() - t0


def compile_packages(jobs):
    """Export each (program, args, path, dynamic) of `jobs` here
    (`export_program`) and compile it with AOTInductor into the package
    file `path`, each in a child process of its own, all at once (a
    compile keeps about one core busy for minutes).  A child starts as
    soon as its program is exported; it loads the exported program (saved
    without its example inputs, which hold the weights) and compiles it
    over fake tensors of the example shapes, so it allocates no copy of
    the inputs on the device.  Returns [(signature, export seconds,
    compile seconds)] in job order; a failed child raises RuntimeError
    with its stderr, and no child outlives the call."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    children = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, (program, args, path, dynamic) in enumerate(jobs):
                ep, signature, export_s = export_program(program, args,
                                                         dynamic)
                ep_path = os.path.join(tmp, f"{i}.pt2")
                ep.example_inputs = None
                torch.export.save(ep, ep_path)
                shapes = [[list(t.shape), str(t.dtype).split(".")[1],
                           str(t.device)] for t in pytree.tree_leaves(args)]
                with open(ep_path + ".json", "w") as f:
                    json.dump({"inputs": shapes, "package": path}, f)
                children.append((_start(ep_path, env), ep_path, path,
                                 signature, export_s))
            out = []
            for proc, ep_path, path, signature, export_s in children:
                if proc.wait():
                    with open(ep_path + ".err") as f:
                        raise RuntimeError(
                            f"compiling {path} failed ({proc.returncode}):"
                            f"\n{f.read()[-4000:]}")
                with open(ep_path + ".out") as f:
                    out.append((signature, export_s,
                                json.loads(f.read().strip().splitlines()[-1])))
            return out
        finally:
            for proc, *_ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _start(ep_path, env):
    """A compile child for the exported program at `ep_path`, its output
    and errors in `ep_path.out` / `.err`."""
    logs = [open(f"{ep_path}.{n}", "w") for n in ("out", "err")]
    try:
        return subprocess.Popen(
            [sys.executable, "-c", "import sys; from paddle_tpu_torch.jit."
             "aoti import _compile_main; sys.exit(_compile_main(sys.argv[1]))",
             ep_path], env=env, stdout=logs[0], stderr=logs[1])
    finally:
        for f in logs:
            f.close()


def _compile_main(ep_path):
    """A compile child: load the exported program and its meta, give it
    zeros of the example shapes as example inputs, compile it into the
    package, print the compile seconds."""
    from .. import ops  # noqa: F401  registers the operators
    with open(ep_path + ".json") as f:
        meta = json.load(f)
    ep = torch.export.load(ep_path)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        flat = [torch.empty(shape, dtype=getattr(torch, dtype), device=dev)
                for shape, dtype, dev in meta["inputs"]]
    args, kwargs = pytree.tree_unflatten(flat, ep.call_spec.in_spec)
    ep.example_inputs = (tuple(args), kwargs)
    print(json.dumps(_compile(ep, meta["package"])), flush=True)
    return 0


class AOTProgram:
    """A loaded package and the signature it was compiled for.  A call
    checks its inputs (dtype, device type, rank, every static dim, each
    dynamic dim within its bounds and equal wherever its name appears)
    and raises `AOTShapeMismatch` on the first that differs."""

    def __init__(self, path, signature):
        from torch._inductor import aoti_load_package
        self.path = path
        self.signature = signature
        self._want = [(getattr(torch, s["dtype"]), s["device"],
                       tuple(d if isinstance(d, int) else tuple(d)
                             for d in s["shape"])) for s in signature]
        self.runner = aoti_load_package(path)

    def check(self, flat):
        if len(flat) != len(self._want):
            raise AOTShapeMismatch(f"{len(flat)} inputs, the package takes "
                                   f"{len(self._want)}")
        sizes = {}
        for i, (t, (dtype, dev, shape)) in enumerate(zip(flat, self._want)):
            if t.dtype != dtype or t.device.type != dev \
                    or t.dim() != len(shape):
                raise AOTShapeMismatch(
                    f"input {i}: {t.dtype} {tuple(t.shape)} on "
                    f"{t.device.type}, the package takes {dtype} of rank "
                    f"{len(shape)} on {dev}")
            for n, want in zip(t.shape, shape):
                if isinstance(want, int):
                    ok = n == want
                else:
                    name, lo, hi = want
                    ok = lo <= n <= hi and sizes.setdefault(name, n) == n
                if not ok:
                    raise AOTShapeMismatch(
                        f"input {i}: shape {tuple(t.shape)}, the package "
                        f"takes {list(shape)}")

    def check_bounds(self, args, dynamic):
        """Raise AOTShapeMismatch unless `args` fit and every dynamic dim
        that `dynamic` (as `export_program` takes it) gives a caller
        reaches as far in the package: a package compiled for fewer rows
        than an engine runs is refused when it loads, not on the first
        full step."""
        self.check(pytree.tree_leaves(args))
        have = {d[0]: d[2] for s in self.signature for d in s["shape"]
                if not isinstance(d, int)}
        for d in _flat_dynamic(args, dynamic):
            for name, _, hi in (d or {}).values():
                if have.get(name, 0) < hi:
                    raise AOTShapeMismatch(
                        f"dim {name} reaches {have.get(name)} in the "
                        f"package, the caller needs {hi}")

    def __call__(self, *args):
        self.check(pytree.tree_leaves(args))
        return self.runner(*args)
