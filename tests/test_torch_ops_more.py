"""The port's op library held against the JAX package's, op by op on the
CPU (continued from tests/test_torch_ops.py, whose docstring says how): the
indexing and type ops, Resize and Upsample, reductions, the host ops, the
data-dependent and detection ops, the recurrent and attention ops and the
rest."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.executor.ops import default as jax_ops
from ppq_tpu.ir import Operation as JaxOperation
from ppq_tpu_torch.executor.ops import default as torch_ops
from ppq_tpu_torch.ir import Operation
from test_torch_ops import _one_torch_thread, run_jax  # noqa: F401
from torch_op_cases import CASES, EXACT, FIRST_FILE, assert_close, run_port


@pytest.mark.parametrize('case', CASES[FIRST_FILE:],
                         ids=[c.id for c in CASES[FIRST_FILE:]])
def test_op_against_jax(case):
    assert_close(run_port(case), run_jax(case), case.jax, case.id)


def test_cast_to_int64_is_int64():
    """Queue 3, item 35: a tensor cast to INT64 is int64 in the port and
    int32 in the JAX package (x64 off), whose range it saturates at."""
    x = np.asarray([3e9, -3e9, 2.5], np.float32)
    op = Operation('c', 'Cast', attributes={'to': 7})
    got = torch_ops.Cast_forward(op, [torch.from_numpy(x)])
    want = np.asarray(jax_ops.Cast_forward(
        JaxOperation('c', 'Cast', attributes={'to': 7}), [jnp.asarray(x)]))
    assert got.dtype == torch.int64 and want.dtype == np.int32
    assert got.tolist() == [3000000000, -3000000000, 2]
    assert want.tolist() == [2 ** 31 - 1, -2 ** 31, 2]


def test_slice_to_int_min_with_a_negative_step_is_empty_in_both():
    """The JAX package's bounds turn an end below -dim with a negative step
    into -1, which numpy reads as the last index: the slice is empty, where
    ONNX reads it as 'to the start'. The port computes the same
    (ROADMAP.md queue 3, known limit 8)."""
    case = next(c for c in CASES if c.id == 'Slice-reverse-to-int-min')
    got, = run_port(case)
    assert got.shape == (3, 4, 0)
    assert_close([got], run_jax(case), EXACT)


def test_host_ops_return_host_arrays():
    for op_type in ('Shape', 'Size', 'ConstantOfShape', 'Range', 'NonZero',
                    'NonMaxSuppression', 'Constant', 'Parameter'):
        case = next(c for c in CASES if c.op_type == op_type)
        op = Operation('h', op_type, attributes=case.attrs)
        op.outputs = [None]
        out = torch_ops.DEFAULT_BACKEND_TABLE[op_type](
            op, [torch.from_numpy(np.asarray(v).copy())
                 if np.asarray(v).dtype.kind == 'f' and op_type in
                 ('Shape', 'Size', 'NonZero', 'NonMaxSuppression')
                 else np.asarray(v) for v in case.inputs])
        assert isinstance(out, np.ndarray), op_type



def test_topk_ties_take_the_lower_index():
    """jax.lax.top_k's order among equal values, which the port's stable
    sort keeps (torch.topk on the card promises none)."""
    case = next(c for c in CASES if c.id == 'TopK-ties-largest')
    values, indices = run_port(case)
    assert indices.tolist() == [[0, 2, 4], [4, 0, 1]]
    case = next(c for c in CASES if c.id == 'TopK-ties-smallest')
    assert run_port(case)[1].tolist() == [[5, 1, 3, 0], [0, 1, 2, 3]]
