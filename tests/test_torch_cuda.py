"""The CUDA kernels of ppq_tpu_torch held against their plain versions, on
the card. A CUDA kernel has no CPU mode, so without a card these skip.
They import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest -q -m gpu --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ppq_tpu_torch.core import RoundingPolicy
from ppq_tpu_torch.kernels import (LAUNCHES, floating_quant,
                                   floating_quant_bwd,
                                   floating_quant_bwd_plain,
                                   floating_quant_plain, histogram,
                                   histogram_plain, linear_quant,
                                   linear_quant_bwd, linear_quant_bwd_plain,
                                   linear_quant_plain, reset_launches)
from ppq_tpu_torch.kernels.quant import linear_quant_bwd_terms
from ppq_tpu_torch.quantization import qfunction

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


def test_fake_quant_kernel_device_scalars(cuda):
    """A tensorwise scale and offset that are tensors on the card are read
    there (the offset rounded in the kernel): same bits as the host route."""
    x, s, o, (qmin, qmax) = _case((3, 1001), None, True, seed=7)
    xc = torch.from_numpy(x).to(cuda)
    st = torch.tensor(s, device=cuda)
    ot = torch.tensor(o, device=cuda)
    for policy in RoundingPolicy:
        for codes in (False, True):
            reset_launches()
            got = linear_quant(xc, st, ot, qmin, qmax, policy, None, codes)
            assert LAUNCHES['fake_quant_tensorwise'] == 1
            want = linear_quant(xc, s, o, qmin, qmax, policy, None, codes)
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


def _sums_close(got, terms, dims):
    """A kernel's ds or do against the float64 sum of the plain per-element
    terms: rtol 1e-5 of the sum plus 1e-6 of the terms' absolute mass."""
    t = terms.double()
    exact = t.sum(dim=dims) if dims else t.sum()
    mass = t.abs().sum(dim=dims) if dims else t.abs().sum()
    return bool(torch.all((got.double() - exact).abs()
                          <= 1e-5 * exact.abs() + 1e-6 * mass))


@pytest.mark.parametrize('policy', [RoundingPolicy.ROUND_HALF_EVEN,
                                    RoundingPolicy.ROUND_HALF_UP,
                                    RoundingPolicy.ROUND_HALF_TOWARDS_ZERO,
                                    RoundingPolicy.ROUND_DOWN],
                         ids=lambda p: p.name)
@pytest.mark.parametrize('shape', [(6, 5, 7, 9), (3, 1001), (64, 3, 3, 3),
                                   (33,), (2, 130, 31)])
def test_fake_quant_bwd_kernel_vs_plain(cuda, policy, shape):
    """dx bit for bit; ds and do against a float64 sum of the plain terms;
    the same bits on a second launch."""
    for axis in (None, 0, 1):
        if axis is not None and axis >= len(shape):
            continue
        for asym in (False, True):
            x, s, o, (qmin, qmax) = _case(shape, axis, asym, seed=len(shape))
            x = np.nan_to_num(x, nan=0.25)
            rng = np.random.RandomState(3)
            g = rng.randn(*shape).astype(np.float32)
            xc = torch.from_numpy(x).to(cuda)
            gc = torch.from_numpy(g).to(cuda)
            reset_launches()
            dx, ds, do = linear_quant_bwd(xc, gc, s, o, qmin, qmax, policy, axis)
            assert sum(LAUNCHES.values()) == 1
            want = linear_quant_bwd_plain(xc, gc, s, o, qmin, qmax, policy, axis)
            assert torch.equal(dx.view(torch.int32), want[0].view(torch.int32))
            assert ds.shape == want[1].shape and do.shape == want[2].shape
            _, ds_e, do_e = linear_quant_bwd_terms(xc, gc, s, o, qmin, qmax,
                                                   policy, axis)
            dims = None if axis is None else \
                [i for i in range(len(shape)) if i != axis]
            if dims == []:
                assert torch.equal(ds, ds_e) and torch.equal(do, do_e)
            else:
                assert _sums_close(ds, ds_e, dims)
                assert _sums_close(do, do_e, dims)
            again = linear_quant_bwd(xc, gc, s, o, qmin, qmax, policy, axis)
            for a, b in zip((dx, ds, do), again):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fake_quant_bwd_kernel_nan_and_empty(cuda):
    x = torch.tensor([0.3, float('nan'), 900.0, -900.0], device=cuda)
    g = torch.tensor([1.0, 2.0, 3.0, 4.0], device=cuda)
    dx, ds, do = linear_quant_bwd(x, g, 0.5, 0.0, -128, 127)
    want = linear_quant_bwd_plain(x, g, 0.5, 0.0, -128, 127)
    assert torch.equal(dx, want[0])          # a NaN is inside: g passes
    assert torch.isnan(ds) and float(do) == 3.5
    empty = torch.empty(0, 4, device=cuda)
    reset_launches()
    dx, ds, do = linear_quant_bwd(empty, empty, 0.5, 0.0, -128, 127)
    assert dx.shape == (0, 4) and float(ds) == 0 and float(do) == 0
    dx, ds, do = linear_quant_bwd(empty, empty, np.ones(4, np.float32),
                                  np.zeros(4, np.float32), -128, 127,
                                  channel_axis=1)
    assert ds.shape == (4,) and float(ds.abs().sum()) == 0
    assert linear_quant(empty, 0.5, 0.0, -128, 127).shape == (0, 4)
    assert floating_quant(empty, 1.0, 4, 3, -448.0, 448.0).shape == (0, 4)
    assert floating_quant_bwd(empty, empty, 1.0, -448.0, 448.0).shape == (0, 4)
    assert sum(LAUNCHES.values()) == 0


def test_fake_quant_autograd_on_card(cuda):
    """The autograd Function on CUDA tensors runs the two kernels (one
    forward, one backward launch) with a trainable scale on the card, and
    agrees with the plain versions."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 8, 15, 15).astype(np.float32) * 3,
                     device=cuda, requires_grad=True)
    w = torch.tensor(rng.randn(4, 8, 15, 15).astype(np.float32), device=cuda)
    for axis, n in ((None, ()), (1, (8,))):
        s = torch.full(n, 0.05, device=cuda, requires_grad=True)
        o = torch.zeros(n, device=cuda, requires_grad=True)
        reset_launches()
        y = qfunction.linear_fake_quant(x, s, o, -128, 127, channel_axis=axis)
        dx, ds, do = torch.autograd.grad((y * w).sum(), (x, s, o))
        kind = 'tensorwise' if axis is None else 'channelwise'
        assert LAUNCHES[f'fake_quant_{kind}'] == 1
        assert LAUNCHES[f'fake_quant_bwd_{kind}'] == 1
        want = linear_quant_bwd_plain(x.detach(), w, s.detach(), o.detach(),
                                      -128, 127, channel_axis=axis)
        assert torch.equal(dx, want[0])
        torch.testing.assert_close(ds, want[1], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(do, want[2], rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        reset_launches()
        qfunction.linear_fake_quant(x, s, o, -128, 127, channel_axis=1)
        assert sum(LAUNCHES.values()) == 1


def _float_case(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 3)).astype(np.float32)
    flat = x.reshape(-1)
    k = min(flat.size, 12)
    flat[:k] = [448.0, -448.0, 500.0, -500.0, 0.0, -0.0, 2.0 ** -7,
                1.5 * 2.0 ** -9, 2.5 * 2.0 ** -9, 1.0625, 57344.0, np.nan][:k]
    return x


@pytest.mark.parametrize('layout', [(4, 3, 448.0), (5, 2, 57344.0),
                                    (3, 4, 15.5), (2, 5, 3.9)],
                         ids=['e4m3', 'e5m2', 'e3m4', 'e2m5'])
@pytest.mark.parametrize('shape', [(6, 5, 7, 9), (3, 1001), (33,),
                                   (64, 3, 3, 3)])
def test_floating_quant_kernel_bitwise_vs_plain(cuda, layout, shape):
    e, m, qmax = layout
    x = _float_case(shape, seed=len(shape))
    xc = torch.from_numpy(x).to(cuda)
    rng = np.random.RandomState(1)
    for axis in (None, 0, 1):
        if axis is not None and axis >= len(shape):
            continue
        s = (np.float32(0.37) if axis is None
             else (rng.rand(shape[axis]) + 0.2).astype(np.float32))
        for scale in (s, torch.as_tensor(s, device=cuda)):
            reset_launches()
            got = floating_quant(xc, scale, e, m, -qmax, qmax, axis)
            assert LAUNCHES['floating_quant'] == 1
            want = floating_quant_plain(xc, scale, e, m, -qmax, qmax, axis)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    for scale in (np.float32(0.37), torch.tensor(0.37, device=cuda)):
        reset_launches()
        got = floating_quant_bwd(xc, g, scale, -qmax, qmax)
        assert LAUNCHES['floating_quant_bwd'] == 1
        want = floating_quant_bwd_plain(xc, g, scale, -qmax, qmax)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_floating_autograd_on_card(cuda):
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(5, 77).astype(np.float32) * 300, device=cuda,
                     requires_grad=True)
    s = torch.tensor(1.0, device=cuda, requires_grad=True)
    reset_launches()
    y = qfunction.floating_fake_quant(x, s, 4, 3, -448.0, 448.0)
    dx, ds = torch.autograd.grad(y.sum(), (x, s))
    assert LAUNCHES['floating_quant'] == 1
    assert LAUNCHES['floating_quant_bwd'] == 1
    inside = x.detach().abs() <= 448.0
    assert torch.equal(dx, inside.float())
    want = (y.detach() - torch.where(inside, x.detach(),
                                     torch.zeros_like(x))).double().sum()
    torch.testing.assert_close(ds.double(), want, rtol=1e-4, atol=1e-3)


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
    with pytest.raises(ValueError):
        linear_quant_bwd(x, x.t(), 0.1, 0.0, -128, 127)
    with pytest.raises(ValueError):
        linear_quant_bwd(x, x[:2], 0.1, 0.0, -128, 127)
    with pytest.raises(TypeError):
        floating_quant(x.double(), 1.0, 4, 3, -448.0, 448.0)
    with pytest.raises(ValueError):
        floating_quant(x, 1.0, 4, 23, -448.0, 448.0)
    with pytest.raises(ValueError):
        floating_quant(x, np.ones(3, np.float32), 4, 3, -448.0, 448.0,
                       channel_axis=1)
