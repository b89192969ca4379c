"""The deployment API (counterpart: `paddle_tpu/inference.py:18-149`).

`create_predictor(Config(path))` loads a `jit.save_inference` directory
and runs its exported program, not the eager model.  Handles follow the
JAX package's: `copy_from_cpu` takes a numpy array and moves it to the
program's device, `run()` launches the program and leaves its outputs
there without waiting, and `copy_to_cpu` copies an output back (the one
place that waits for the device).  An output handle fetched before
`run()` sees each later run's result.  The hardware and IR knobs of
`Config` are recorded and change nothing, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .jit.save_load import load_inference


class Config:
    def __init__(self, prog_file=None, params_file=None):
        self._dir = prog_file if prog_file is not None else ""
        self._params_file = params_file
        self._use_gpu = False
        self._memory_optim = False
        self._ir_optim = True
        self._cpu_threads = 1

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True

    def disable_gpu(self):
        self._use_gpu = False

    def enable_memory_optim(self):
        self._memory_optim = True

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_threads = n

    def model_dir(self):
        return self._dir

    def disable_glog_info(self):
        pass

    def enable_mkldnn(self):
        pass


class _Handle:
    """An input or output of the predictor; the tensor lies on the
    program's device."""

    def __init__(self, name, device):
        self.name = name
        self._device = device
        self._tensor = None

    def copy_from_cpu(self, arr):
        self._tensor = torch.from_numpy(np.ascontiguousarray(arr)).to(
            self._device)

    def copy_to_cpu(self):
        """The output as a numpy array; bfloat16, which numpy cannot
        hold, comes back as float32 (exactly)."""
        t = self._tensor
        if t is None:
            return None
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def reshape(self, shape):
        pass    # shapes come from the fed array

    def shape(self):
        return None if self._tensor is None else list(self._tensor.shape)


class Predictor:
    def __init__(self, config):
        self._layer = load_inference(config.model_dir())
        spec = self._layer.meta["input_spec"]
        self._input_names = [s.get("name") or f"input_{i}"
                             for i, s in enumerate(spec)]
        self._output_names = [f"output_{i}" for i in
                              range(self._layer.meta["n_outputs"])]
        dev = self._layer.device
        self._inputs = {n: _Handle(n, dev) for n in self._input_names}
        self._outputs = {n: _Handle(n, dev) for n in self._output_names}

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return list(self._output_names)

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self):
        args = []
        for n in self._input_names:
            t = self._inputs[n]._tensor
            if t is None:
                raise ValueError(f"input {n!r} was not fed "
                                 f"(copy_from_cpu first)")
            args.append(t)
        out = self._layer(*args)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for n, t in zip(self._output_names, outs):
            self._outputs[n]._tensor = t
        return True


def create_predictor(config):
    return Predictor(config)
