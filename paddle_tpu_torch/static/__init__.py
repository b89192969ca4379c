"""paddle.static surface (counterpart: `paddle_tpu/static/__init__.py`;
reference: python/paddle/static/*).

The Program is an op DAG captured at call time
(`framework/static_graph.py`) and `Executor.run` compiles it with
`torch.compile` once per feed signature — see that module's note for the
design.  `save_inference_model` / `load_inference_model` round-trip
through the port's `jit/save_load.py` (`torch.export`), as `jit.save`
does: the program's replay, its parameters and buffers baked in, behind
`InputSpec`s of the feeds (a `None` dim stays dynamic).
"""
from __future__ import annotations

import json
import os

import torch

from ..framework.static_graph import (  # noqa: F401
    Executor, Program, data, default_main_program, default_startup_program,
    program_guard,
)
from ..jit.save_load import InputSpec  # noqa: F401

__all__ = ["Executor", "InputSpec", "Program", "data",
           "default_main_program", "default_startup_program",
           "load_inference_model", "nn", "program_guard",
           "save_inference_model"]


class nn:
    """Tiny paddle.static.nn analog: layer-creating ops for classic static
    programs.  Parameters are created eagerly (startup is a no-op) and
    captured as graph leaves.  Layers are cached PER PROGRAM; reuse across
    calls requires an explicit `name` (unnamed calls create a fresh layer
    each time, matching the reference's auto-unique parameter names).
    Layers build on the device of their input."""

    @staticmethod
    def _cache():
        prog = default_main_program()
        if not hasattr(prog, "_static_nn_layers"):
            prog._static_nn_layers = {}
        return prog._static_nn_layers

    @staticmethod
    def _get(key_prefix, name, factory):
        cache = nn._cache()
        key = name or f"{key_prefix}_{cache.get('__counter__', 0)}"
        if name is None:
            cache["__counter__"] = cache.get("__counter__", 0) + 1
        layer = cache.get(key)
        if layer is None:
            layer = factory()
            cache[key] = layer
        return layer

    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None):
        from .. import nn as dnn
        nfd = num_flatten_dims if num_flatten_dims >= 0 else x.ndim - 1
        in_f = 1
        for d in x.shape[nfd:]:
            in_f *= int(d)
        if nfd < x.ndim - 1 or nfd == 0:
            # reference semantics: flatten dims [num_flatten_dims:] into
            # one; -1 on the batch axis keeps the graph feed-polymorphic
            shape = ([-1] + list(x.shape[1:nfd]) if nfd >= 1 else []) \
                + [in_f]
            x = x.reshape(shape)
        layer = nn._get("fc", name,
                        lambda: dnn.Linear(in_f, size, device=x.device))
        out = layer(x)
        if activation is not None:
            from ..nn import functional as F
            out = getattr(F, activation)(out)
        return out

    @staticmethod
    def embedding(x, size, param_attr=None, name=None):
        from .. import nn as dnn
        layer = nn._get("emb", name,
                        lambda: dnn.Embedding(int(size[0]), int(size[1]),
                                              device=x.device))
        return layer(x)


_META = "static_meta.json"


class _ProgramModule(torch.nn.Module):
    """The replay of `refs` given the feeds, in feed order, as a Module
    (the leaves it reads as frozen parameters), for `save_inference`."""

    def __init__(self, refs, feed_nodes):
        super().__init__()
        from ..framework import static_graph as SG
        self._forward = SG._build_forward(refs, for_test=True)
        self._leaf_seqs = []
        for n in SG._leaf_nodes(refs):
            self.register_parameter(f"leaf{n.seq}", torch.nn.Parameter(
                n.tensor.detach(), requires_grad=False))
            self._leaf_seqs.append(n.seq)
        self._feed_names = [n.name for n in feed_nodes]

    def run(self, feeds):
        leaves = {s: getattr(self, f"leaf{s}") for s in self._leaf_seqs}
        outs = self._forward(leaves, dict(zip(self._feed_names, feeds)))
        return tuple(outs)


def _program_module(refs, feed_nodes):
    """A `_ProgramModule` whose forward takes one positional argument a
    feed (`torch.export` matches an `InputSpec` to each parameter)."""
    names = [f"feed{i}" for i in range(len(feed_nodes))]
    ns = {}
    exec(f"def forward(self, {', '.join(names)}):\n"
         f"    return self.run(({', '.join(names)},))\n", ns)
    cls = type("ProgramModule", (_ProgramModule,), {"forward": ns["forward"]})
    return cls(refs, feed_nodes)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """Export the recorded graph fetch_vars = f(feed_vars), parameters and
    buffers baked in, with `jit.save_inference` (a `torch.export`
    program) into the directory `path_prefix`."""
    from ..framework import static_graph as SG
    from ..jit.save_load import save_inference

    refs = []
    for t in fetch_vars:
        sym = getattr(t, "_sym", None)
        if sym is None:
            raise ValueError("fetch var was not recorded in the program")
        refs.append(sym)
    feed_nodes = []
    for t in feed_vars:
        sym = getattr(t, "_sym", None)
        if sym is None or not isinstance(sym[0], SG.FeedNode):
            raise ValueError("feed var must come from paddle.static.data")
        feed_nodes.append(sym[0])
    specs = [InputSpec(shape=[None if d is None or int(d) < 0 else int(d)
                              for d in n.shape], dtype=n.dtype, name=n.name)
             for n in feed_nodes]
    path = os.path.abspath(path_prefix)
    with SG._suspended():
        module = _program_module(refs, feed_nodes)
        save_inference(module, path, specs)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"feed_names": [n.name for n in feed_nodes],
                   "n_fetch": len(refs)}, f)


class _LoadedProgram(Program):
    """Program stand-in whose run path calls the loaded program."""

    def __init__(self, layer, meta):
        super().__init__()
        self._layer = layer
        self._meta = meta

    def _loaded_call(self, feed, fetch_list, return_numpy):
        import numpy as np
        from ..framework.static_graph import _as_feed, _numpy
        args = []
        for name in self._meta["feed_names"]:
            if name not in feed:
                raise ValueError(f"missing feed {name!r}")
            args.append(_as_feed(feed[name], self._layer.device))
        outs = self._layer(*args)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        if fetch_list:  # fetch targets are output indices (see loader)
            outs = [outs[int(i)] for i in fetch_list]
        if return_numpy:
            return [np.asarray(_numpy(o)) for o in outs]
        return outs


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Returns (program, feed_target_names, fetch_targets) — run with
    exe.run(program, feed={...}, fetch_list=fetch_targets)."""
    from ..jit.save_load import load_inference

    path = os.path.abspath(path_prefix)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    prog = _LoadedProgram(load_inference(path), meta)
    return prog, list(meta["feed_names"]), list(range(meta["n_fetch"]))
