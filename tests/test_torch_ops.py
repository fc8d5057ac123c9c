"""The port's op library (ppq_tpu_torch/executor/ops/) held against the JAX
package's (ppq_tpu/executor/ops/), op by op on the CPU: the table, the
vendor override, and the cases of the convolutions, pools, products,
elementwise ops, softmax, norms and layout ops; tests/test_torch_ops_more.py
takes the rest of the cases.

Every case of tests/torch_op_cases.py runs through
`ppq_tpu.executor.ops.default.DEFAULT_BACKEND_TABLE[t]` (eager jnp on the
CPU) and the port's op on the same seeded numpy inputs, within the case's
stated tolerance: equal for layout, indexing, comparisons and elementwise
arithmetic in the same order; a few units in the last place for the
libraries' transcendental functions; the sum's order for reductions, norms,
pooling, resampling, products, and the recurrent and attention ops. The
port's integer results are int64 where the JAX package's are int32: values
are compared (ROADMAP.md queue 3, item 35).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.core import TargetPlatform as JaxPlatform
from ppq_tpu.executor import resolve_forward as jax_resolve
from ppq_tpu.executor.ops import default as jax_ops
from ppq_tpu.ir import Operation as JaxOperation
from ppq_tpu_torch.core import TargetPlatform
from ppq_tpu_torch.executor import OPERATION_FORWARD_TABLE, resolve_forward
from ppq_tpu_torch.executor.ops import default as torch_ops
from ppq_tpu_torch.executor.ops.vendor import NXP_Resize_forward
from ppq_tpu_torch.ir import Operation
from torch_op_cases import CASES, EXACT, FIRST_FILE, assert_close, run_port


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module: with more, every convolution
    opens an OpenMP region whose workers spin at its barriers, and under a
    test run of several processes that stalls this module. What is checked
    does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_jax(case):
    """The JAX package's op on the case's inputs, the ones the port takes as
    tensors as jnp arrays (the JAX executors' activations), the rest as
    host arrays."""
    op = JaxOperation(f'case_{case.id}', case.op_type, attributes=case.attrs)
    op.outputs = [None] * case.n_out
    platform = (JaxPlatform[case.platform] if case.platform
                else JaxPlatform.UNSPECIFIED)
    values = [jnp.asarray(v) if i not in case.host and
              np.asarray(v).dtype.kind == 'f' else np.asarray(v).copy()
              for i, v in enumerate(case.inputs)]
    out = jax_resolve(platform, case.op_type)(op, values, None)
    if not isinstance(out, (tuple, list)):
        out = [out]
    return [np.asarray(o) for o in out]


def test_table_keys_equal_the_jax_table():
    assert set(torch_ops.DEFAULT_BACKEND_TABLE) == \
        set(jax_ops.DEFAULT_BACKEND_TABLE)
    assert len(torch_ops.DEFAULT_BACKEND_TABLE) == 129


def test_every_table_op_has_a_case():
    covered = {c.op_type for c in CASES}
    assert covered >= set(torch_ops.DEFAULT_BACKEND_TABLE), \
        sorted(set(torch_ops.DEFAULT_BACKEND_TABLE) - covered)
    assert any(c.platform == 'NXP_INT8' for c in CASES)


def test_vendor_resize_on_the_jax_platforms():
    plats = {p for p, table in OPERATION_FORWARD_TABLE.items()
             if table.get('Resize') is NXP_Resize_forward}
    assert plats == {TargetPlatform.NXP_INT8, TargetPlatform.FPGA_INT8,
                     TargetPlatform.TPU_POWER_OF_2}
    for plat in plats:
        assert resolve_forward(plat, 'Resize') is NXP_Resize_forward
        assert jax_resolve(JaxPlatform[plat.name], 'Resize') is not \
            jax_ops.Resize_forward
    assert resolve_forward(TargetPlatform.TPU_INT8, 'Resize') is \
        torch_ops.Resize_forward


@pytest.mark.parametrize('case', CASES[:FIRST_FILE],
                         ids=[c.id for c in CASES[:FIRST_FILE]])
def test_op_against_jax(case):
    assert_close(run_port(case), run_jax(case), case.jax, case.id)


@pytest.mark.parametrize('axis', [1, 2])
def test_softmax_opset11_flattens_from_axis(axis):
    """Softmax before opset 13 (defined in both packages, registered in
    neither table): one softmax over every dim from `axis` on."""
    x = np.random.RandomState(5).randn(2, 3, 4).astype(np.float32)
    op = Operation('s', 'Softmax', attributes={'axis': axis})
    jop = JaxOperation('s', 'Softmax', attributes={'axis': axis})
    got = torch_ops.Softmax_opset11_forward(op, [torch.from_numpy(x)])
    want = np.asarray(jax_ops.Softmax_opset11_forward(jop, [x]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.numpy().reshape(2, -1).sum(-1) if axis == 1
                               else got.numpy().sum(-1), 1.0, rtol=1e-5)


def test_gelu_reads_no_approximate_attribute():
    case = next(c for c in CASES if c.id == 'Gelu-tanh-attribute')
    plain = next(c for c in CASES if c.id == 'Gelu')
    assert_close(run_port(case), run_port(plain), EXACT)


def test_a_card_operand_is_refused_on_the_host_side():
    """A shape operand that is a tensor on a card would need a read back:
    `_host` refuses it (a CPU tensor is read as it is)."""
    op = Operation('r', 'Reshape')
    assert torch_ops._host(op, torch.tensor([2, 3])).tolist() == [2, 3]

    class _OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device('cuda', 0)
    fake = torch.tensor([2, 3]).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match='lies on the card'):
        torch_ops._host(op, fake)


def test_uploads_are_kept_by_contents():
    """A host operand joining a card tensor is uploaded once per op input
    and kept while its contents stay the same (a capture replays the walk
    with new but equal host arrays); the CPU takes it as it is."""
    ctx = torch_ops.ExecContext(device=torch.device('cpu'))
    op = Operation('u', 'Add')
    a = np.arange(3, dtype=np.int64)
    t = torch_ops._arg(op, [a], 0, ctx, torch.device('cpu'))
    assert t.tolist() == [0, 1, 2] and not ctx.detail
    f64 = torch_ops._upload(np.asarray([0.1]), torch.device('cpu'))
    assert f64.dtype == torch.float32
