"""The CUDA kernels of ppq_tpu_torch held against their plain versions, on
the card. A CUDA kernel has no CPU mode, so without a card these skip.
They import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest -q -m gpu --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ppq_tpu_torch.core import RoundingPolicy
from ppq_tpu_torch.kernels import (LAUNCHES, histogram, histogram_plain,
                                   linear_quant, linear_quant_plain,
                                   reset_launches)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: a CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _case(shape, axis, asym, seed):
    rng = np.random.RandomState(seed)
    n_scales = 1 if axis is None else shape[axis]
    scale = (rng.rand(n_scales) * 0.05 + 0.003).astype(np.float32)
    offset = (rng.rand(n_scales) * 60 - 30 if asym
              else np.zeros(n_scales)).astype(np.float32)
    s_b = scale if axis is None else scale.reshape(
        [-1 if i == axis else 1 for i in range(len(shape))])
    x = (rng.randn(*shape) * 60).astype(np.float32) * s_b
    ties = (rng.randint(-150, 150, size=shape) + 0.5).astype(np.float32) * s_b
    x = np.where(rng.rand(*shape) < 0.3, ties, x).astype(np.float32)
    x.reshape(-1)[::101] = np.nan
    if axis is None:
        scale, offset = scale[0], offset[0]
    return x, scale, offset, ((0, 255) if asym else (-128, 127))


@pytest.mark.parametrize('policy', list(RoundingPolicy), ids=lambda p: p.name)
@pytest.mark.parametrize('shape', [(6, 5, 7, 9), (3, 1001), (64, 3, 3, 3)])
def test_fake_quant_kernel_bitwise_vs_plain(cuda, policy, shape):
    for axis in (None, 0, 1):
        for asym in (False, True):
            for codes in (False, True):
                x, s, o, (qmin, qmax) = _case(shape, axis, asym, seed=len(shape))
                xc = torch.from_numpy(x).to(cuda)
                reset_launches()
                got = linear_quant(xc, s, o, qmin, qmax, policy, axis, codes)
                assert sum(LAUNCHES.values()) == 1
                want = linear_quant_plain(xc, s, o, qmin, qmax, policy, axis,
                                          codes)
                torch.cuda.synchronize()
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_fake_quant_kernel_unaligned_view(cuda):
    """A view that starts off a 16-byte boundary takes the scalar loop."""
    base = torch.randn(10_001, device=cuda)
    x = base[1:]
    got = linear_quant(x, 0.01, 0.0, -128, 127)
    want = linear_quant_plain(x, 0.01, 0.0, -128, 127)
    assert torch.equal(got, want)


@pytest.mark.parametrize('absolute', [True, False], ids=['abs', 'signed'])
@pytest.mark.parametrize('n', [1, 1001, 1_000_003])
def test_histogram_kernel_exact_vs_plain(cuda, absolute, n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 2).astype(np.float32)
    x[rng.rand(n) < 0.3] = 0.0
    x[:min(n, 4)] = [40.0, -np.inf, np.nan, 1e30][:min(n, 4)]
    xc = torch.from_numpy(x).to(cuda)
    for bins in (2048, 4096):
        reset_launches()
        got = histogram(xc, 4.0 / bins, bins, absolute=absolute)
        assert LAUNCHES['histogram'] == 1
        want = histogram_plain(xc, 4.0 / bins, bins, absolute=absolute)
        assert torch.equal(got, want)
        assert int(got.sum()) == n


def test_histogram_kernel_accumulates_in_int64(cuda):
    x = torch.zeros(1 << 20, device=cuda)
    counts = torch.full((2048,), 2 ** 40, dtype=torch.int64, device=cuda)
    for _ in range(3):
        histogram(x, 0.01, 2048, out=counts)
    assert int(counts[0]) == 2 ** 40 + 3 * (1 << 20)
    assert int(counts[1]) == 2 ** 40


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 8, device=cuda)
    with pytest.raises(TypeError):
        linear_quant(x.double(), 0.1, 0.0, -128, 127)
    with pytest.raises(ValueError):
        linear_quant(x.t(), 0.1, 0.0, -128, 127)
    with pytest.raises(ValueError):
        linear_quant(x, np.ones(3, np.float32), np.zeros(3, np.float32),
                     -128, 127, channel_axis=1)
    with pytest.raises(ValueError):
        histogram(x, 0.1, 100_000)
