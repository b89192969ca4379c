"""Gradients of the port's top-level tensor functions against the JAX
package's, on the CPU: for each differentiable case of
`tests/torch_tensor_api_cases.py` in `tensor_api` (unary math,
reductions, matmul / einsum / tensordot, gather / scatter / index,
where / masked_fill, sort / median), the reference's tape `backward`
and torch autograd under the same seeded weight on each output; the
gradients of every float input agree within 1e-5 of the largest one
(of 1 where that is smaller), or the case's own tolerance where it is
looser.  The values are held in `test_torch_tensor_api.py`.
"""
import pytest

import torch_cpu_threads
from torch_api_parity import check_grads
from torch_tensor_api_cases import CASES, RED

torch_cpu_threads.limit()


@pytest.mark.parametrize(
    "case", [c for c in CASES if c.module == "tensor_api" and c.grad],
    ids=lambda c: c.id)
def test_gradients_match_the_reference(case):
    err = check_grads(case, max(case.tol, RED))
    assert err is None, (case.id, err)
