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
from ppq_tpu_torch.kernels.paged_attention import slotmajor_window
from ppq_tpu_torch.kernels.quant import linear_quant_bwd_terms
from ppq_tpu_torch.quantization import qfunction

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


# The channelwise forward's routes (csrc/fake_quant.cu): the channel found
# once a float4, element by element where a float4 crosses a run's end, the
# element loop for an unaligned view.
CHANNEL_ROUTES = [
    ((64, 3, 7, 7), 0),        # conv1: inner 147, float4s cross runs
    ((1000,), 0),              # a bias: inner 1
    ((512, 1000), 1),          # the Gemm weight without transB: inner 1
    ((1, 4608), 0),            # one channel
    ((4096, 3, 3), 0),         # many channels, inner 9
    ((512, 512, 3, 3), 0),     # the largest weight: several loads a thread
    ((128, 64, 1, 1), 0),      # a 1x1 conv: inner 64
    ((3, 16, 40, 40), 1),      # an activation on axis 1: runs of 1600
    ((5, 7, 3), 1),            # inner 3
    ((5, 7, 2), 1),            # inner 2
    ((2, 3, 1030), 1),         # inner 1030: a long run, not a multiple of 4
]


@pytest.mark.parametrize('shape,axis', CHANNEL_ROUTES,
                         ids=lambda v: str(v).replace(' ', ''))
def test_fake_quant_channel_routes_bitwise_vs_plain(cuda, shape, axis):
    """Every rounding policy, codes on and off, asymmetric offsets that the
    kernel rounds, ties and NaNs, on each route; two calls bit-equal."""
    x, s, o, (qmin, qmax) = _case(shape, axis, True, seed=len(shape))
    xc = torch.from_numpy(x).to(cuda)
    st, ot = torch.from_numpy(s).to(cuda), torch.from_numpy(o).to(cuda)
    for policy in RoundingPolicy:
        for codes in (False, True):
            reset_launches()
            got = linear_quant(xc, st, ot, qmin, qmax, policy, axis, codes)
            assert LAUNCHES['fake_quant_channelwise'] == 1
            want = linear_quant_plain(xc, s, o, qmin, qmax, policy, axis,
                                      codes)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    again = linear_quant(xc, st, ot, qmin, qmax, policy, axis, codes)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize('shape,axis', [((512, 512, 3, 3), 0),
                                        ((64, 3, 7, 7), 0), ((512, 1000), 1)],
                         ids=['largest', 'crossing', 'inner1'])
def test_fake_quant_channel_unaligned_view(cuda, shape, axis):
    """A view that starts off a 16-byte boundary takes the element loop."""
    n = int(np.prod(shape))
    rng = np.random.RandomState(3)
    base = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(cuda)
    x = base[1:].view(shape)
    s = (rng.rand(shape[axis]) * 0.05 + 0.01).astype(np.float32)
    o = (rng.rand(shape[axis]) * 9 - 4).astype(np.float32)
    for codes in (False, True):
        got = linear_quant(x, s, o, 0, 255, RoundingPolicy.ROUND_HALF_EVEN,
                           axis, codes)
        want = linear_quant_plain(x, s, o, 0, 255,
                                  RoundingPolicy.ROUND_HALF_EVEN, axis, codes)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _hist_cases(cuda):
    rng = np.random.RandomState(11)
    low = (np.abs(rng.randn(1 << 20)) ** 3).astype(np.float32)
    low[rng.rand(low.size) < 0.6] = 0.0        # post-ReLU, piled low
    special = (rng.randn(40_003) * 3).astype(np.float32)
    special[::97] = np.nan
    special[1::89] = np.inf
    special[2::83] = -np.inf
    return {
        'zeros': (np.zeros(1 << 20, np.float32), 0.01),
        'one nonzero bin': (np.full(1 << 20, 0.125, np.float32), 0.01),
        'low bins': (low, float(low.max()) / 4096),
        'n % 4 == 3': (rng.randn(1_000_003).astype(np.float32), 4.0 / 4096),
        'nan and inf': (special, 10.0 / 4096),
    }


@pytest.mark.parametrize('case', ['zeros', 'one nonzero bin', 'low bins',
                                  'n % 4 == 3', 'nan and inf'])
@pytest.mark.parametrize('absolute', [True, False], ids=['abs', 'signed'])
def test_histogram_kernel_distributions(cuda, case, absolute):
    """The bin-0 register, the shared copies and the flush on inputs that
    load them differently; two calls give the same counts."""
    x, scale = _hist_cases(cuda)[case]
    xc = torch.from_numpy(x).to(cuda)
    for bins in (2048, 4096):
        got = histogram(xc, scale, bins, absolute=absolute)
        want = histogram_plain(xc, scale, bins, absolute=absolute)
        assert torch.equal(got, want)
        assert torch.equal(histogram(xc, scale, bins, absolute=absolute), got)
        assert int(got.sum()) == x.size


def test_histogram_kernel_unaligned_view_and_max_bins(cuda):
    from ppq_tpu_torch.kernels.histogram import MAX_BINS
    rng = np.random.RandomState(12)
    base = torch.from_numpy(np.abs(rng.randn(300_001)).astype(np.float32)).to(cuda)
    x = base[1:]
    for bins in (4096, MAX_BINS):
        scale = float(x.max()) / bins
        got = histogram(x, scale, bins)
        assert torch.equal(got, histogram_plain(x, scale, bins))
        assert int(got[bins - 1]) >= 1


def test_histogram_kernel_counts_past_32_bits(cuda):
    """Running counts above 2^32 in bin 0 (the register route) and in the
    other bins (the shared copies) grow by exactly this batch's counts."""
    x = torch.zeros(3 << 20, device=cuda)
    x[::3] = 0.5
    counts = torch.full((2048,), 3 * 2 ** 32 + 5, dtype=torch.int64,
                        device=cuda)
    for _ in range(2):
        histogram(x, 0.01, 2048, out=counts)
    assert int(counts[0]) == 3 * 2 ** 32 + 5 + 2 * (2 << 20)
    assert int(counts[50]) == 3 * 2 ** 32 + 5 + 2 * (1 << 20)
    assert int(counts[1]) == 3 * 2 ** 32 + 5


@pytest.mark.parametrize('scale', [1e-40, 3e38], ids=['subnormal', 'huge'])
def test_histogram_kernel_takes_the_quotient_where_the_product_is_unsafe(
        cuda, scale):
    """Where 1/scale or the scale is not a normal float (`fast_bin_ok`
    false), every bin is the IEEE quotient's, and still the plain
    version's."""
    rng = np.random.RandomState(13)
    v = (np.abs(rng.randn(100_003)) * min(scale * 3000, 1e37)).astype(
        np.float32)
    v[rng.rand(v.size) < 0.5] = 0.0
    v[::101] = np.nan
    x = torch.from_numpy(v).to(cuda)
    for absolute in (True, False):
        got = histogram(x, scale, 4096, absolute=absolute)
        assert torch.equal(got, histogram_plain(x, scale, 4096,
                                                absolute=absolute))
        assert int(got.sum()) == v.size


def _next_to_every_edge(scale, bins, width):
    """Groups of `bins` floats, one next to each bin edge k * scale: the
    edge rounded to float32 from float32 and from float64, and each of the
    `width` floats below and above it."""
    k = np.arange(1, bins + 1)
    for center in ((k.astype(np.float32) * np.float32(scale)),
                   (k * np.float64(scale)).astype(np.float32)):
        yield center
        up, down = center.copy(), center.copy()
        for _ in range(width):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(0))
            yield up
            yield down


@pytest.mark.parametrize('bins', [2048, 4096])
def test_histogram_product_bin_equals_the_quotient_next_to_every_edge(cuda,
                                                                      bins):
    """The kernel bins by the product with 1/scale where that is safe
    (csrc/histogram.cu `bin_fast`): for every float within 8 steps of every
    bin edge, at several scales, it gives the bin of the IEEE quotient.
    Each launch holds one float next to each edge, so every bin's count is
    known and no float sent to a wrong bin can hide behind another sent
    the other way. Negated floats too (bin 0 when signed)."""
    rng = np.random.RandomState(14)
    scales = [11.2 / bins, 0.0371, 2.0 ** -7, 3.0, 0.1234567, 1e-30, 7e29,
              *(10.0 ** rng.uniform(-6, 6, 6))]
    for scale in scales:
        scale = float(np.float32(scale))
        for v in _next_to_every_edge(scale, bins, 8):
            for x in (v, -v):
                xc = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                for absolute in (True, False):
                    got = histogram(xc, scale, bins, absolute=absolute)
                    want = histogram_plain(xc, scale, bins, absolute=absolute)
                    assert torch.equal(got, want), (scale, absolute)


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


def _device_launches(fn):
    """The kernels the card ran for fn(), by name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def _channel_bwd_case(cuda, shape, axis, misalign, seed):
    x, s, o, (qmin, qmax) = _case(shape, axis, True, seed)
    x = np.nan_to_num(x, nan=0.25)
    g = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    n = x.size
    xb = torch.zeros(n + misalign, device=cuda)
    gb = torch.zeros(n + misalign, device=cuda)
    xb[misalign:] = torch.from_numpy(x.reshape(-1)).to(cuda)
    gb[misalign:] = torch.from_numpy(g.reshape(-1)).to(cuda)
    return (xb[misalign:].view(shape), gb[misalign:].view(shape), s, o, qmin,
            qmax)


@pytest.mark.parametrize('shape,axis,misalign,splits', [
    ((512, 512, 3, 3), 0, 0, 1),       # one block a channel, float4s
    ((1000, 512), 0, 0, 1),
    ((64, 3, 7, 7), 0, 0, 1),          # inner 147: floats
    ((512, 512, 3, 3), 0, 1, 1),       # a view misaligned by one float
    ((32, 8, 56, 56), 1, 0, 25),       # few channels: splits, last-block fold
    ((32, 8, 56, 56), 1, 1, 33),
    ((512, 1000), 1, 0, 9),            # channels on the last axis: lanes
    ((512, 1000), 1, 1, 9),
    ((7, 3, 1000), 2, 0, 1),
], ids=['512x512x3x3', '1000x512', '64x3x7x7', 'misaligned', 'act-axis1',
        'act-axis1-misaligned', 'last-axis', 'last-axis-misaligned',
        'last-axis-3d'])
def test_fake_quant_bwd_channel_one_launch(cuda, shape, axis, misalign,
                                           splits):
    """Both branches of the channelwise backward: dx bit for bit, ds and do
    against the float64 sum of the plain terms, two calls bit-equal, one
    device launch a call."""
    from ppq_tpu_torch.kernels.quant import channelwise_bwd_plan
    x, g, s, o, qmin, qmax = _channel_bwd_case(cuda, shape, axis, misalign,
                                               seed=len(shape) + misalign)
    inner = int(np.prod(shape[axis + 1:]))
    plan = channelwise_bwd_plan(
        shape[axis], x.numel() // (shape[axis] * inner), inner, not misalign,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.splits == splits and plan.vec == (
        0 if inner == 1 else 4 if not misalign and inner % 4 == 0 else 1)
    dims = [i for i in range(len(shape)) if i != axis]
    for policy in (RoundingPolicy.ROUND_HALF_EVEN, RoundingPolicy.ROUND_HALF_UP,
                   RoundingPolicy.ROUND_DOWN):
        dx, ds, do = linear_quant_bwd(x, g, s, o, qmin, qmax, policy, axis)
        want, ds_e, do_e = linear_quant_bwd_terms(x, g, s, o, qmin, qmax,
                                                  policy, axis)
        assert torch.equal(dx.view(torch.int32), want.view(torch.int32))
        assert _sums_close(ds, ds_e, dims) and _sums_close(do, do_e, dims)
        again = linear_quant_bwd(x, g, s, o, qmin, qmax, policy, axis)
        for a, b in zip((dx, ds, do), again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # scales and offsets on the card, as LSQ trains them: nothing to copy
    s_dev, o_dev = torch.as_tensor(s, device=cuda), torch.as_tensor(o, device=cuda)
    launched = _device_launches(lambda: linear_quant_bwd(
        x, g, s_dev, o_dev, qmin, qmax, RoundingPolicy.ROUND_HALF_EVEN, axis))
    assert sum(launched.values()) == 1, launched


def test_fake_quant_bwd_channel_split_counts_change_between_calls(cuda):
    """Calls in a row whose split counts differ share the stream's
    workspace: each leaves the per-channel counters at 0, and every call
    agrees with the plain version."""
    from ppq_tpu_torch.kernels import quant
    shapes = ((32, 8, 56, 56), (4, 3, 64, 64), (4096, 40), (32, 8, 56, 56),
              (64, 40, 32, 32), (4096, 40))
    cases = [_channel_bwd_case(cuda, shape, 1, 0, seed)
             for seed, shape in enumerate(shapes)]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = [quant.channelwise_bwd_plan(x.shape[1], x.shape[0],
                                         x[0, 0].numel(), True, sms).splits
              for x, *_ in cases]
    assert splits == [25, 4, 128, 25, 7, 128]
    for x, g, s, o, qmin, qmax in cases:
        dx, ds, do = linear_quant_bwd(x, g, s, o, qmin, qmax, channel_axis=1)
        want, ds_e, do_e = linear_quant_bwd_terms(
            x, g, s, o, qmin, qmax, RoundingPolicy.ROUND_HALF_EVEN, 1)
        dims = [i for i in range(x.ndim) if i != 1]
        assert torch.equal(dx, want)
        assert _sums_close(ds, ds_e, dims)
        assert _sums_close(do, do_e, dims)
        torch.cuda.synchronize()
        for _, counters in quant._bwd_workspaces.values():
            assert not bool(counters.any())


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


# The 21 weights of the zoo ResNet-18 that path B trains channelwise, each
# on its own axis (conv weights on 0, the Gemm weight without transB on 1).
RESNET18_WEIGHTS = (
    [((64, 3, 7, 7), 0)] + [((64, 64, 3, 3), 0)] * 4
    + [((128, 64, 3, 3), 0)] + [((128, 128, 3, 3), 0)] * 3
    + [((128, 64, 1, 1), 0), ((256, 128, 3, 3), 0)]
    + [((256, 256, 3, 3), 0)] * 3
    + [((256, 128, 1, 1), 0), ((512, 256, 3, 3), 0)]
    + [((512, 512, 3, 3), 0)] * 3 + [((512, 256, 1, 1), 0), ((512, 1000), 1)])


@pytest.mark.parametrize('layout', [(4, 3, 448.0), (5, 2, 57344.0)],
                         ids=['e4m3', 'e5m2'])
@pytest.mark.parametrize('shape,axis', sorted(set(RESNET18_WEIGHTS))
                         + [((6, 5, 7), 1), ((5, 7, 3), 1)],
                         ids=lambda v: str(v).replace(' ', ''))
def test_floating_channel_kernel_at_path_weights(cuda, layout, shape, axis):
    """The channelwise body (row 6c) at every weight shape of path B, and at
    runs of 7 and 3 (float4s that cross a run's end, stepped element by
    element): bit-equal to the plain version with per-channel scales from
    each channel's absmax / qmax, and with scales that clip; two calls
    equal; one launch."""
    e, m, qmax = layout
    assert len(RESNET18_WEIGHTS) == 21
    x = torch.from_numpy(_float_case(shape, seed=sum(shape))).to(cuda)
    dims = [i for i in range(x.ndim) if i != axis]
    absmax = torch.nan_to_num(x.abs(), nan=0.0).amax(dim=dims)
    for scale in (absmax / qmax + 1e-12, absmax / qmax / 4 + 1e-12):
        reset_launches()
        got = floating_quant(x, scale, e, m, -qmax, qmax, axis)
        assert LAUNCHES['floating_quant'] == 1
        want = floating_quant_plain(x, scale, e, m, -qmax, qmax, axis)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        again = floating_quant(x, scale, e, m, -qmax, qmax, axis)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def test_floating_channel_kernel_unaligned_view(cuda):
    """A view off a 16-byte boundary takes the element loop."""
    shape = (64, 3, 7, 7)
    base = torch.from_numpy(_float_case((int(np.prod(shape)) + 1,), 3)).to(cuda)
    x = base[1:].view(shape)
    scale = torch.rand(64, device=cuda) + 0.2
    got = floating_quant(x, scale, 4, 3, -448.0, 448.0, 0)
    want = floating_quant_plain(x, scale, 4, 3, -448.0, 448.0, 0)
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


# ------------------------------------------------- the serving kernels ----

def _qmm_inputs(cuda, B, D, F, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, D, device=cuda, generator=gen).bfloat16()
    w = torch.randint(-127, 128, (D, F), device=cuda, generator=gen,
                      dtype=torch.int8)
    scale = torch.rand(F, device=cuda, generator=gen) * 0.01 + 0.001
    row = torch.rand(B, device=cuda, generator=gen) + 0.5
    res = torch.randn(B, F, device=cuda, generator=gen).bfloat16()
    return x, w, scale, row, res


def _assert_sum_close(got, want, x, w, scale, row):
    """The kernel and the plain version multiply the same bf16 operands
    exactly in f32 and differ in the order of the f32 sum: 1e-5 of the row's
    absolute mass sum |x||w| * scale * row (plus one bf16 step, 2^-7, where
    the output is bf16)."""
    mass = torch.matmul(x.float().abs(), w.float().abs()) * scale
    if row is not None:
        mass = mass * row.reshape(-1, 1)
    tol = 1e-5 * mass + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * want.float().abs()
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('has_row,has_res', [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize('B,D,F', [(128, 2048, 4096), (128, 2048, 2048),
                                   (128, 5632, 2048), (1, 256, 128),
                                   (37, 512, 384), (200, 256, 256)])
def test_qmm_int8_kernel_vs_plain(cuda, B, D, F, has_row, has_res, out):
    from ppq_tpu_torch.kernels import qmm_int8, qmm_int8_plain
    x, w, scale, row, res = _qmm_inputs(cuda, B, D, F, seed=B + F)
    row, res = (row if has_row else None), (res if has_res else None)
    reset_launches()
    got = qmm_int8(x, w, scale, out_dtype=out, row_scale=row, residual=res)
    assert LAUNCHES['qmm_int8'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_int8_plain(x, w, scale, out_dtype=torch.float32,
                          row_scale=row, residual=res)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (B, F)
    _assert_sum_close(got, want, x, w, scale, row)


def test_qmm_int8_kernel_f32_residual_and_lm_head_width(cuda):
    from ppq_tpu_torch.kernels import qmm_int8, qmm_int8_plain
    x, w, scale, row, res = _qmm_inputs(cuda, 128, 2048, 32768, seed=1)
    got = qmm_int8(x, w, scale, row_scale=row)
    want = qmm_int8_plain(x, w, scale, torch.float32, row_scale=row)
    _assert_sum_close(got, want, x, w, scale, row)
    x, w, scale, row, res = _qmm_inputs(cuda, 16, 256, 256, seed=2)
    got = qmm_int8(x, w, scale, torch.float32, residual=res.float())
    want = qmm_int8_plain(x, w, scale, torch.float32, residual=res.float())
    _assert_sum_close(got, want, x, w, scale, None)


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('has_row', [False, True])
@pytest.mark.parametrize('B,D,F', [(128, 2048, 5632), (3, 256, 128),
                                   (130, 512, 256)])
def test_qmm_gateup_kernel_vs_plain(cuda, B, D, F, has_row, out):
    """silu(g) * u has derivative of order 1 in g and u, so the sums'
    tolerance carries over: 1e-5 of (mass_g * |u| + mass_u * |g|) scaled by
    at most 1.1 (the slope of silu), plus a bf16 step for a bf16 output."""
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_gateup_plain
    x, w, scale, row, _ = _qmm_inputs(cuda, B, D, 2 * F, seed=B + F)
    row = row if has_row else None
    reset_launches()
    got = qmm_gateup(x, w, scale, out_dtype=out, row_scale=row)
    assert LAUNCHES['qmm_gateup'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_gateup_plain(x, w, scale, torch.float32, row_scale=row)
    torch.cuda.synchronize()
    both = torch.matmul(x.float(), w.float()) * scale
    mass = torch.matmul(x.float().abs(), w.float().abs()) * scale
    if row is not None:
        both, mass = both * row.reshape(-1, 1), mass * row.reshape(-1, 1)
    tol = 1.1e-5 * (mass[:, :F] * both[:, F:].abs()
                    + mass[:, F:] * both[:, :F].abs()) + 1e-6
    if out == torch.bfloat16:
        tol = tol + 2 ** -7 * want.abs()
    err = (got.float() - want).abs()
    assert got.dtype == out and tuple(got.shape) == (B, F)
    assert bool((err <= tol).all()), float((err / tol).max())


def _assert_gateup_close(got, want, x, w, scale, row):
    """Row 10's tolerance, as in test_qmm_gateup_kernel_vs_plain."""
    F = w.shape[1] // 2
    both = torch.matmul(x.float(), w.float()) * scale
    mass = torch.matmul(x.float().abs(), w.float().abs()) * scale
    if row is not None:
        both, mass = both * row.reshape(-1, 1), mass * row.reshape(-1, 1)
    tol = 1.1e-5 * (mass[:, :F] * both[:, F:].abs()
                    + mass[:, F:] * both[:, :F].abs()) + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


# split-K: shapes on which the INT8 bodies split the depth (S > 1) and
# shapes on which one block walks it alone (S = 1); test_splits_cover_both
# keeps both kinds in these lists
SPLIT_M = [1, 37, 128, 129, 200, 512]
SPLIT_DF = [(256, 128), (2048, 2048), (2048, 4096), (5632, 2048),
            (2048, 32768)]
SPLIT_GATEUP = [(128, 2048, 5632), (1, 2048, 5632), (37, 5632, 2048),
                (512, 2048, 5632), (200, 256, 128)]
# the INT4 bodies: D (unpacked) a multiple of 512
SPLIT_DF_INT4 = [(512, 128), (2048, 2048), (2048, 4096), (5632, 2048),
                 (2048, 32768)]
SPLIT_GATEUP_INT4 = [(128, 2048, 5632), (1, 2048, 5632), (37, 5632, 2048),
                     (512, 2048, 5632), (200, 512, 128), (3, 512, 8448)]


def test_splits_cover_both():
    from ppq_tpu_torch.kernels.qmm import _splits
    int8 = {_splits(D, F) > 1 for D, F in SPLIT_DF}
    gateup = {_splits(D, F, True) > 1 for _, D, F in SPLIT_GATEUP}
    int4 = {_splits(D, F, False, True) > 1 for D, F in SPLIT_DF_INT4}
    gateup4 = {_splits(D, F, True, True) > 1 for _, D, F in SPLIT_GATEUP_INT4}
    assert int8 == gateup == int4 == gateup4 == {True, False}


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('D,F', SPLIT_DF)
@pytest.mark.parametrize('M', SPLIT_M)
def test_qmm_int8_kernel_split_shapes(cuda, M, D, F, out):
    """Row 8 with the full epilogue (row scale and residual) at split and
    unsplit shapes, one launch each."""
    from ppq_tpu_torch.kernels import qmm_int8, qmm_int8_plain
    x, w, scale, row, res = _qmm_inputs(cuda, M, D, F, seed=M * 7 + D + F)
    reset_launches()
    got = qmm_int8(x, w, scale, out_dtype=out, row_scale=row, residual=res)
    assert LAUNCHES['qmm_int8'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_int8_plain(x, w, scale, torch.float32, row, res)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (M, F)
    _assert_sum_close(got, want, x, w, scale, row)


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('M,D,F', SPLIT_GATEUP)
def test_qmm_gateup_kernel_split_shapes(cuda, M, D, F, out):
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_gateup_plain
    x, w, scale, row, _ = _qmm_inputs(cuda, M, D, 2 * F, seed=M * 7 + D + F)
    reset_launches()
    got = qmm_gateup(x, w, scale, out_dtype=out, row_scale=row)
    assert LAUNCHES['qmm_gateup'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_gateup_plain(x, w, scale, torch.float32, row_scale=row)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (M, F)
    _assert_gateup_close(got, want, x, w, scale, row)


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('D,F', SPLIT_DF_INT4)
@pytest.mark.parametrize('M', SPLIT_M)
def test_qmm_int4_kernel_split_shapes(cuda, M, D, F, out):
    """Row 9 with the full epilogue at split and unsplit shapes, one launch
    each, held to the plain version with the unpacked weight's mass."""
    from ppq_tpu_torch.kernels import qmm_int4, qmm_int4_plain
    x, w, codes, scale, row, res = _int4_inputs(cuda, M, D, F,
                                                seed=M * 7 + D + F)
    reset_launches()
    got = qmm_int4(x, w, scale, out_dtype=out, row_scale=row, residual=res)
    assert LAUNCHES['qmm_int4'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_int4_plain(x, w, scale, torch.float32, row, res)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (M, F)
    _assert_sum_close(got, want, x, codes, scale, row)


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('M,D,F', SPLIT_GATEUP_INT4)
def test_qmm_gateup_int4_kernel_split_shapes(cuda, M, D, F, out):
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_gateup_plain
    x, w, codes, scale, row, _ = _int4_inputs(cuda, M, D, 2 * F,
                                              seed=M * 7 + D + F)
    reset_launches()
    got = qmm_gateup(x, w, scale, out_dtype=out, row_scale=row)
    assert LAUNCHES['qmm_gateup_int4'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_gateup_plain(x, w, scale, torch.float32, row_scale=row)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (M, F)
    _assert_gateup_close(got, want, x, codes, scale, row)


def test_qmm_split_calls_are_bit_equal(cuda):
    """The last block of a tile sums the partials in a fixed order and
    leaves the tile's counter at 0: two calls on the same inputs agree bit
    for bit, and so does a call after calls of other shapes (which reuse
    the workspace and the counters), and a call on some of the rows; for
    every body, INT8 and INT4."""
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_int4, qmm_int8
    from ppq_tpu_torch.kernels.qmm import _splits
    x, w, scale, row, res = _qmm_inputs(cuda, 128, 5632, 2048, seed=5)
    assert _splits(5632, 2048) > 1
    first = qmm_int8(x, w, scale, torch.float32, row, res)
    assert torch.equal(qmm_int8(x, w, scale, torch.float32, row, res), first)
    xg, wg, sg, rg, _ = _qmm_inputs(cuda, 128, 5632, 2 * 2048, seed=6)
    assert _splits(5632, 2048, True) > 1
    gate = qmm_gateup(xg, wg, sg, torch.float32, rg)
    x4, w4, _, s4, r4, res4 = _int4_inputs(cuda, 128, 5632, 2048, seed=10)
    assert _splits(5632, 2048, False, True) > 1
    first4 = qmm_int4(x4, w4, s4, torch.float32, r4, res4)
    assert torch.equal(qmm_int4(x4, w4, s4, torch.float32, r4, res4), first4)
    xg4, wg4, _, sg4, rg4, _ = _int4_inputs(cuda, 128, 5632, 2 * 2048,
                                            seed=11)
    assert _splits(5632, 2048, True, True) > 1
    gate4 = qmm_gateup(xg4, wg4, sg4, torch.float32, rg4)
    assert torch.equal(qmm_gateup(xg4, wg4, sg4, torch.float32, rg4), gate4)
    for M, D, F in ((37, 2048, 4096), (512, 2048, 2048), (1, 512, 128)):
        xo, wo, so, ro, reso = _qmm_inputs(cuda, M, D, F, seed=M)
        qmm_int8(xo, wo, so, torch.bfloat16, ro, reso)
        xo, wo, _, so, ro, reso = _int4_inputs(cuda, M, D, F, seed=M + 1)
        qmm_int4(xo, wo, so, torch.bfloat16, ro, reso)
    assert torch.equal(qmm_int8(x, w, scale, torch.float32, row, res), first)
    assert torch.equal(qmm_gateup(xg, wg, sg, torch.float32, rg), gate)
    assert torch.equal(qmm_int4(x4, w4, s4, torch.float32, r4, res4), first4)
    assert torch.equal(qmm_gateup(xg4, wg4, sg4, torch.float32, rg4), gate4)
    # S does not depend on M: each row sums in the same order in any batch
    assert torch.equal(qmm_int8(x[:37], w, scale, torch.float32, row[:37],
                                res[:37]), first[:37])
    assert torch.equal(qmm_gateup(xg[:1], wg, sg, torch.float32, rg[:1]),
                       gate[:1])
    assert torch.equal(qmm_int4(x4[:37], w4, s4, torch.float32, r4[:37],
                                res4[:37]), first4[:37])
    assert torch.equal(qmm_gateup(xg4[:1], wg4, sg4, torch.float32, rg4[:1]),
                       gate4[:1])
    torch.cuda.synchronize()


def test_qmm_int4_bodies_split_and_share_the_workspace(cuda):
    """The INT4 bodies split the depth at the decode shapes where the INT8
    ones do (wqkv, wo, w_down; the INT4 gate-up at 2048 -> 2 x 5632 takes
    one split, by its body's cost model), one launch a call, and take the
    same per-(device, stream) workspace and counters: an INT8 call after an
    INT4 call of the same split shape grows neither."""
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_int4, qmm_int8
    from ppq_tpu_torch.kernels import qmm as tqmm
    for D, F in ((2048, 4096), (2048, 2048), (5632, 2048)):
        assert tqmm._splits(D, F, False, True) > 1 and tqmm._splits(D, F) > 1
    assert tqmm._splits(2048, 5632, True, True) == 1
    tqmm._workspaces.clear()
    x, w, codes, scale, row, res = _int4_inputs(cuda, 128, 2048, 2048, seed=8)
    reset_launches()
    got = qmm_int4(x, w, scale, torch.float32, row, res)
    assert LAUNCHES['qmm_int4'] == 1 and sum(LAUNCHES.values()) == 1
    assert list(tqmm._workspaces) == [
        (x.device, torch.cuda.current_stream(x.device).cuda_stream)]
    (ws, counters), = tqmm._workspaces.values()
    assert ws.numel() * 4 == tqmm.workspace_bytes(128, 2048, 2048, False, True)
    qmm_int8(x, codes, scale, torch.float32, row, res)
    (ws_8, counters_8), = tqmm._workspaces.values()
    assert ws_8 is ws and counters_8 is counters
    x, wg, codes_g, sg, rg, _ = _int4_inputs(cuda, 128, 5632, 2 * 2048, seed=9)
    assert tqmm._splits(5632, 2048, True, True) > 1
    reset_launches()
    gate = qmm_gateup(x, wg, sg, torch.float32, rg)
    assert LAUNCHES['qmm_gateup_int4'] == 1 and sum(LAUNCHES.values()) == 1
    (ws_g, counters_g), = tqmm._workspaces.values()
    assert ws_g.numel() * 4 >= tqmm.workspace_bytes(128, 5632, 2048, True, True)
    qmm_gateup(x, codes_g, sg, torch.float32, rg)
    (ws_8, counters_8), = tqmm._workspaces.values()
    assert ws_8 is ws_g and counters_8 is counters_g
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(gate).all())
    assert not bool(counters_g.any())


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('n_arrays,B,CH,KV,Dh', [(32, 128, 32, 8, 128),
                                                 (3, 5, 7, 1, 128),
                                                 (130, 2, 3, 1, 128),
                                                 (5, 37, 4, 2, 128)])
def test_bank_write_kernel_bit_equal(cuda, n_arrays, B, CH, KV, Dh, dtype):
    from ppq_tpu_torch.kernels import (Bank, bank_write_inplace,
                                       bank_write_plain)
    gen = torch.Generator(device=cuda).manual_seed(n_arrays)

    def codes(shape):
        t = torch.randint(-128, 128, shape, device=cuda, generator=gen)
        return t.to(dtype)

    whole = [codes((B, 2 * CH, KV, Dh)) for _ in range(n_arrays)]
    want = [t.clone() for t in whole]
    news = [codes((B, 1, KV, Dh)) for _ in range(n_arrays)]
    for col in (0, CH - 1, 2):
        # the second half of each buffer, as the burst's chunk views are
        views = [t[:, CH:] for t in whole]
        reset_launches()
        got = bank_write_inplace(
            Bank(views), news,
            torch.tensor([col], dtype=torch.int32, device=cuda))
        assert LAUNCHES['bank_write'] == -(-n_arrays // 128)
        bank_write_plain(Bank([t[:, CH:] for t in want]), news, col)
        torch.cuda.synchronize()
        assert all(g is v for g, v in zip(got, views))
        for a, b in zip(whole, want):
            assert torch.equal(a, b)
    host_col = bank_write_inplace(Bank([t[:, :CH] for t in whole]), news, 1)
    bank_write_plain(Bank([t[:, :CH] for t in want]), news, 1)
    assert all(torch.equal(a, b) for a, b in zip(whole, want)) and host_col


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('col', [-1, 3, 1 << 20])
def test_bank_write_kernel_column_outside_writes_nothing(cuda, col, dtype):
    """A column outside the buffers, over two launches of 130 buffers:
    nothing is written and the fault word has bank_write's bit."""
    from ppq_tpu_torch.kernels import (Bank, bank_write_inplace, read_faults,
                                       reset_launches)
    gen = torch.Generator(device=cuda).manual_seed(7)
    bufs = [torch.randint(-128, 128, (2, 3, 1, 128), device=cuda,
                          generator=gen).to(dtype) for _ in range(130)]
    want = [t.clone() for t in bufs]
    news = [torch.ones(2, 1, 1, 128, dtype=dtype, device=cuda)
            for _ in range(130)]
    read_faults(cuda)
    reset_launches()
    bank_write_inplace(Bank(bufs), news,
                       torch.tensor([col], dtype=torch.int32, device=cuda))
    assert LAUNCHES['bank_write'] == 2
    assert read_faults(cuda) == ['bank_write: a column outside the buffers']
    assert all(torch.equal(a, b) for a, b in zip(bufs, want))


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('L,B,S,n,KV,Dh', [(16, 128, 64, 32, 8, 128),
                                           (2, 3, 16, 5, 1, 128),
                                           (1, 4, 8, 8, 2, 256)])
def test_window_write_kernel_bit_equal(cuda, L, B, S, n, KV, Dh, dtype):
    from ppq_tpu_torch.kernels import (window_write_inplace,
                                       window_write_plain)
    gen = torch.Generator(device=cuda).manual_seed(L + S)

    def codes(shape):
        t = torch.randint(-128, 128, shape, device=cuda, generator=gen)
        return t.to(dtype)

    slabs = [codes((L, B, S, KV, Dh)) for _ in range(2)]
    want = [t.clone() for t in slabs]
    news = [codes((L, B, n, KV, Dh)) for _ in range(2)]
    pos = torch.randint(0, S - n + 1, (B,), device=cuda, generator=gen,
                        dtype=torch.int32)
    reset_launches()
    got = window_write_inplace(slabs, news, pos)
    assert LAUNCHES['window_write'] == 1 and sum(LAUNCHES.values()) == 1
    window_write_plain(want, news, pos)
    torch.cuda.synchronize()
    assert all(g is s for g, s in zip(got, slabs))
    for a, b in zip(slabs, want):
        assert torch.equal(a, b)


def test_serving_kernels_refuse_what_they_do_not_take(cuda):
    from ppq_tpu_torch.kernels import (Bank, bank_write_inplace, qmm_gateup,
                                       qmm_int8, window_write_inplace)
    x, w, scale, _, _ = _qmm_inputs(cuda, 4, 128, 128, seed=0)
    with pytest.raises(ValueError):
        qmm_int8(x, w, scale)                           # D % 256
    with pytest.raises(TypeError):
        qmm_int8(x, w.float(), scale)
    with pytest.raises(ValueError):
        qmm_gateup(x, w, scale)
    buf = torch.zeros(2, 4, 1, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        bank_write_inplace(Bank([buf]), [buf[:, :1].float()], 0)
    with pytest.raises(ValueError, match='outside'):
        bank_write_inplace(Bank([buf]), [buf[:, :1].contiguous()], 4)
    x, w, scale, _, _ = _qmm_inputs(cuda, 4, 256, 128, seed=0)
    odd = torch.ones(129, device=cuda)[1:]             # 4 bytes past 16
    with pytest.raises(ValueError, match='aligned'):
        qmm_int8(x, w, odd)
    x, w, scale, _, _ = _qmm_inputs(cuda, 4, 256, 256, seed=0)
    with pytest.raises(ValueError, match='aligned'):
        qmm_gateup(x, w, torch.ones(257, device=cuda)[1:])
    slab = torch.zeros(1, 2, 8, 1, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        window_write_inplace([slab], [slab[:, :, :4].contiguous()],
                             torch.zeros(2, dtype=torch.int64, device=cuda))


def test_serving_engine_on_the_card(cuda):
    """The engine runs on the card by default, through the four kernels; a
    burst equals the same engine on the plain versions within the logits'
    tolerance (greedy tokens compared where they are not near-ties: at
    least 90 % equal)."""
    from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                       init_llama_params)
    cfg = LlamaConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, d_ff=512, max_seq_len=128, max_batch=4,
                      prefill_buckets=(16,), use_ragged_attention=False)
    engine = ServingEngine(cfg, init_llama_params(cfg, seed=0))
    assert engine.device.type == 'cuda' and cfg.use_kernel_matmul is True
    rng = np.random.default_rng(0)
    reqs = [Request(i, [int(t) for t in rng.integers(1, 512, size=5 + i)],
                    max_new_tokens=9) for i in range(6)]
    reset_launches()
    engine.run(reqs, sync_every=4)
    assert all(r.done and len(r.generated) == 9 for r in reqs)
    for name in ('qmm_int8', 'qmm_gateup', 'bank_write', 'window_write'):
        assert LAUNCHES[name] > 0, name


def test_serving_engine_raises_without_a_card_or_for_unported_settings():
    """Runs with or without a card: device='cpu' is the only way onto the
    CPU; W8A8 and MoE settings build, and a pipeline mesh (item 15b, not
    ported) raises."""
    from ppq_tpu_torch.serving import (LlamaConfig, ServingEngine,
                                       init_llama_params)
    small = dict(vocab_size=256, d_model=128, n_layers=1, n_heads=4,
                 n_kv_heads=2, d_ff=256, max_seq_len=64, max_batch=2,
                 prefill_buckets=(16,))
    params = init_llama_params(LlamaConfig(**small), device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ServingEngine(LlamaConfig(**small), params)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            init_llama_params(LlamaConfig(**small))
    for field, value in (('act_bits', 8), ('n_experts', 4)):
        cfg = LlamaConfig(**small)
        setattr(cfg, field, value)
        ServingEngine(cfg, init_llama_params(cfg, device='cpu'),
                      device='cpu')
    import types
    with pytest.raises(NotImplementedError, match='ROADMAP item 15b'):
        ServingEngine(LlamaConfig(**small), params,
                      mesh=types.SimpleNamespace(shape={'pp': 2}),
                      device='cpu')
    # the paged KV cache builds (head dim 128, blocks of 128)
    paged = dict(small, d_model=256, n_heads=2, n_kv_heads=1, max_seq_len=128)
    cfg = LlamaConfig(**paged, paged_kv=True)
    ServingEngine(cfg, init_llama_params(cfg, device='cpu'), device='cpu')


# --------------------------------- INT4 matmuls and ragged attention ----

def _int4_inputs(cuda, B, D, F, seed):
    from ppq_tpu_torch.kernels import pack_int4_splithalf
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, D, device=cuda, generator=gen).bfloat16()
    codes = torch.randint(-8, 8, (D, F), device=cuda, generator=gen,
                          dtype=torch.int8)
    scale = torch.rand(F, device=cuda, generator=gen) * 0.01 + 0.001
    row = torch.rand(B, device=cuda, generator=gen) + 0.5
    res = torch.randn(B, F, device=cuda, generator=gen).bfloat16()
    return x, pack_int4_splithalf(codes), codes, scale, row, res


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('has_row,has_res', [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize('B,D,F', [(128, 2048, 4096), (128, 2048, 2048),
                                   (128, 5632, 2048), (1, 512, 128),
                                   (37, 1024, 384), (200, 512, 256)])
def test_qmm_int4_kernel_vs_plain(cuda, B, D, F, has_row, has_res, out):
    """Row 9: the unpacked weight's mass is the tolerance's, as for row 8."""
    from ppq_tpu_torch.kernels import qmm_int4, qmm_int4_plain
    x, w, codes, scale, row, res = _int4_inputs(cuda, B, D, F, seed=B + F)
    row, res = (row if has_row else None), (res if has_res else None)
    reset_launches()
    got = qmm_int4(x, w, scale, out_dtype=out, row_scale=row, residual=res)
    assert LAUNCHES['qmm_int4'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_int4_plain(x, w, scale, out_dtype=torch.float32,
                          row_scale=row, residual=res)
    torch.cuda.synchronize()
    assert got.dtype == out and tuple(got.shape) == (B, F)
    _assert_sum_close(got, want, x, codes, scale, row)


@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('has_row', [False, True])
@pytest.mark.parametrize('B,D,F', [(128, 2048, 5632), (3, 512, 128),
                                   (130, 1024, 256)])
def test_qmm_gateup_int4_kernel_vs_plain(cuda, B, D, F, has_row, out):
    """Row 10's INT4 body, with row 10's tolerance on the unpacked weight."""
    from ppq_tpu_torch.kernels import qmm_gateup, qmm_gateup_plain
    x, w, codes, scale, row, _ = _int4_inputs(cuda, B, D, 2 * F, seed=B + F)
    row = row if has_row else None
    reset_launches()
    got = qmm_gateup(x, w, scale, out_dtype=out, row_scale=row)
    assert LAUNCHES['qmm_gateup_int4'] == 1 and sum(LAUNCHES.values()) == 1
    want = qmm_gateup_plain(x, w, scale, torch.float32, row_scale=row)
    torch.cuda.synchronize()
    both = torch.matmul(x.float(), codes.float()) * scale
    mass = torch.matmul(x.float().abs(), codes.float().abs()) * scale
    if row is not None:
        both, mass = both * row.reshape(-1, 1), mass * row.reshape(-1, 1)
    tol = 1.1e-5 * (mass[:, :F] * both[:, F:].abs()
                    + mass[:, F:] * both[:, :F].abs()) + 1e-6
    if out == torch.bfloat16:
        tol = tol + 2 ** -7 * want.abs()
    err = (got.float() - want).abs()
    assert got.dtype == out and tuple(got.shape) == (B, F)
    assert bool((err <= tol).all()), float((err / tol).max())


def _attention_case(cuda, B, KV, rep, S, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.int8:
        k = torch.randint(-128, 128, (2, B, S, KV, 128), device=cuda,
                          generator=gen, dtype=torch.int8)
        v = torch.randint(-128, 128, (2, B, S, KV, 128), device=cuda,
                          generator=gen, dtype=torch.int8)
        ks = torch.rand(2, B, S, KV, device=cuda, generator=gen) * 0.02 + 0.001
        vs = torch.rand(2, B, S, KV, device=cuda, generator=gen) * 0.02 + 0.001
    else:
        k = torch.randn(2, B, S, KV, 128, device=cuda, generator=gen).bfloat16()
        v = torch.randn(2, B, S, KV, 128, device=cuda, generator=gen).bfloat16()
        ks = vs = None
    q = torch.randn(B, KV, rep, 128, device=cuda, generator=gen).bfloat16()
    return q, k, v, ks, vs


def _assert_attention_close(got, want, q, k, v, ks, vs, lens):
    """The kernel against its plain version: s sums Dh exact products in
    another order (delta = 2e-5 of its absolute mass); p moves by 2 delta;
    l sums n p (2 n 2^-24); acc sums p * v_scale rounded to bf16, where a p
    that moved may round to the neighbouring bf16 number (2^-7). k, v: the
    slots' (B, S, KV, Dh); ks, vs (B, S, KV) or None."""
    B, KV, rep, Dh = q.shape
    S = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    kss = torch.ones(k.shape[:3], device=q.device) if ks is None else ks
    vss = torch.ones(k.shape[:3], device=q.device) if vs is None else vs
    valid = (torch.arange(S, device=q.device)[None] < lens[:, None].long())
    valid = valid[:, None, None, :]
    inv = 1.0 / np.sqrt(Dh)
    s = torch.einsum('bkrd,bskd->bkrs', qf, kf) * kss.transpose(1, 2)[:, :, None] * inv
    mass = torch.einsum('bkrd,bskd->bkrs', qf.abs(), kf.abs()) \
        * kss.transpose(1, 2)[:, :, None] * inv
    s = torch.where(valid, s, -torch.inf)
    m_ref = s.amax(-1).clamp_min(-1e30)
    p = torch.where(valid, torch.exp(s - m_ref[..., None]), 0.0)
    n = lens.float()[:, None, None]
    delta = 2e-5 * torch.where(valid, mass, 0.0).amax(-1) + 1e-6
    summ = 2 * n * 2.0 ** -24
    acc_mass = torch.einsum('bkrs,bskd->bkrd', p * vss.transpose(1, 2)[:, :, None],
                            vf.abs())
    (ga, gm, gl), (wa, wm, wl) = got, want
    assert bool(((gm - wm).abs() <= delta).all())
    assert bool(((gl - wl).abs() <= wl * (4 * delta + summ) + 1e-30).all())
    tol = acc_mass * (2.0 ** -7 + 4 * delta[..., None] + summ[..., None]) + 1e-6
    assert bool(((ga - wa).abs() <= tol).all())
    empty = lens == 0
    assert bool((ga[empty] == 0).all()) and bool((gl[empty] == 0).all())


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('blk,rep', [(32, 2), (128, 2), (256, 1), (512, 4)])
def test_paged_attention_fused_kernel_vs_plain(cuda, blk, rep, dtype):
    """Row 11 through a permuted block table, layered and one layer: empty
    slots, partial last blocks, a full window."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       read_faults, slotmajor_window)
    B, KV, S = 9, 2, 1024
    q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, S, dtype, blk + rep)
    pool, sc = slotmajor_window(k, v, ks, vs, S, blk)
    nb = S // blk
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(blk))
    pool = pool[:, torch.argsort(perm).to(cuda)].contiguous()
    sc = None if sc is None else sc[:, torch.argsort(perm).to(cuda)].contiguous()
    tables = perm.reshape(B, nb).to(torch.int32).to(cuda)
    lens = torch.tensor([0, 1, 15, 16, blk - 1, blk, blk + 3, 1000, S],
                        dtype=torch.int32, device=cuda)
    read_faults(cuda)
    for layer, p_, s_ in ((1, pool, sc), (None, pool[0], None if sc is None
                                          else sc[0])):
        reset_launches()
        got = paged_attention_decode_fused(q, p_, s_, tables, lens, layer,
                                           block_size=blk)
        assert LAUNCHES['paged_attention_fused'] == 1
        want = paged_attention_decode_fused_plain(q, p_, s_, tables, lens,
                                                  layer, block_size=blk)
        torch.cuda.synchronize()
        li = 0 if layer is None else layer
        _assert_attention_close(got, want, q, k[li], v[li],
                                None if ks is None else ks[li],
                                None if vs is None else vs[li], lens)
    assert read_faults(cuda) == []


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('blk,group,rep', [(32, 32, 2), (64, 4, 2),
                                           (256, 8, 4), (512, 2, 1)])
def test_paged_attention_grouped_kernel_vs_plain(cuda, blk, group, rep, dtype):
    """Row 12 over a block-major window: groups whose slots differ in depth
    (empty beside full), scales lane-padded below 128 columns."""
    from ppq_tpu_torch.kernels import (blockmajor_window,
                                       paged_attention_decode_grouped,
                                       paged_attention_decode_grouped_plain,
                                       read_faults)
    B, KV, cap = 64, 2, 1024 if blk >= 256 else 128
    q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, cap, dtype, blk + group)
    kv_bm, sc_bm = blockmajor_window(k, v, ks, vs, cap, blk)
    gen = torch.Generator(device=cuda).manual_seed(blk)
    lens = torch.randint(0, cap + 1, (B,), device=cuda, generator=gen,
                         dtype=torch.int32)
    lens[::7] = 0
    lens[1::9] = cap
    read_faults(cuda)
    reset_launches()
    got = paged_attention_decode_grouped(q, kv_bm, sc_bm, lens, 1,
                                         block_size=blk, group=group)
    assert LAUNCHES['paged_attention_grouped'] == 1
    want = paged_attention_decode_grouped_plain(q, kv_bm, sc_bm, lens, 1,
                                                block_size=blk, group=group)
    torch.cuda.synchronize()
    _assert_attention_close(got, want, q, k[1], v[1],
                            None if ks is None else ks[1],
                            None if vs is None else vs[1], lens)
    assert read_faults(cuda) == []


def _edge_lens(B, cap, device):
    """Fills that end inside a pass of 16 positions and on one, inside a
    stage of 64 and on one, and on the window, with empty slots, over B
    slots."""
    edges = [f for f in (0, 1, 5, 15, 16, 17, 31, 47, 63, 64, 65, 100, 127,
                         128, 129, 255, 256, 257, 511, 512) if f <= cap]
    return torch.tensor([(edges + [cap])[i % (len(edges) + 1)]
                         for i in range(B)], dtype=torch.int32, device=device)


def _both_calls(run, lens):
    """Two calls on the same inputs, bit-equal; returns the first."""
    got, again = run(lens), run(lens)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    return got


@pytest.mark.parametrize('grouped,cap,blk,fill', [
    (False, 512, 512, 512), (True, 32, 32, 16), (True, 512, 256, 16),
    (True, 512, 256, 512)], ids=['fused-512', 'grouped-32-fill16',
                                 'grouped-256-fill16', 'grouped-256-fill512'])
def test_paged_attention_kernels_at_path_shapes(cuda, grouped, cap, blk,
                                                fill):
    """Rows 11 and 12 at the paths' shapes (128 slots, 8 KV heads of 128,
    rep 2, int8 codes): path E's and F's fill 512 over one 512-block a slot
    and fill 16 over blocks of 32 in groups of 32, path G's blocks of 256 at
    fills 16 and 512; then the same windows at fills that end inside and on
    a pass and a stage. Two calls bit-equal, no fault."""
    from ppq_tpu_torch.kernels import (blockmajor_window, grouped_group_size,
                                       identity_block_tables,
                                       paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       paged_attention_decode_grouped,
                                       paged_attention_decode_grouped_plain,
                                       read_faults, slotmajor_window)
    B, KV, rep = 128, 8, 2
    q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, cap, torch.int8,
                                      cap + blk + fill)
    if grouped:
        kv, sc = blockmajor_window(k, v, ks, vs, cap, blk)
        G = grouped_group_size(B, blk, kv_dh=KV * 128, itemsize=1)
        run = lambda lens: paged_attention_decode_grouped(  # noqa: E731
            q, kv, sc, lens, 1, block_size=blk, group=G)
        plain = lambda lens: paged_attention_decode_grouped_plain(  # noqa: E731
            q, kv, sc, lens, 1, block_size=blk, group=G)
    else:
        kv, sc = slotmajor_window(k, v, ks, vs, cap, blk)
        tables = identity_block_tables(B, cap, blk, cuda)
        run = lambda lens: paged_attention_decode_fused(  # noqa: E731
            q, kv, sc, tables, lens, 1, block_size=blk)
        plain = lambda lens: paged_attention_decode_fused_plain(  # noqa: E731
            q, kv, sc, tables, lens, 1, block_size=blk)
    read_faults(cuda)
    for lens in (torch.full((B,), fill, dtype=torch.int32, device=cuda),
                 _edge_lens(B, cap, cuda)):
        got = _both_calls(run, lens)
        _assert_attention_close(got, plain(lens), q, k[1], v[1], ks[1],
                                vs[1], lens)
    assert read_faults(cuda) == []


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('rep', [1, 2, 4])
@pytest.mark.parametrize('grouped', [False, True], ids=['fused', 'grouped'])
def test_paged_attention_fills_inside_and_on_stages(cuda, grouped, rep,
                                                    dtype):
    """Rows 11 and 12 over shallow windows (one warp a head: blocks of 16
    and 32) and deep ones (blocks of 48 and 64; a stage straddles blocks of
    48), 3 KV heads (a thread block holds a slot's heads), at fills that end
    inside and on a pass and a stage, for each rep the kernel takes and both
    pool types; two calls bit-equal."""
    from ppq_tpu_torch.kernels import (blockmajor_window,
                                       identity_block_tables,
                                       paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       paged_attention_decode_grouped,
                                       paged_attention_decode_grouped_plain,
                                       slotmajor_window)
    B, KV = 40, 3
    for blk, cap in ((16, 48), (32, 64), (48, 288), (64, 512)):
        q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, cap, dtype,
                                          blk + rep)
        lens = _edge_lens(B, cap, cuda)
        if grouped:
            kv, sc = blockmajor_window(k, v, ks, vs, cap, blk)
            run = lambda lens: paged_attention_decode_grouped(  # noqa: E731
                q, kv, sc, lens, 1, block_size=blk, group=4)
            want = paged_attention_decode_grouped_plain(
                q, kv, sc, lens, 1, block_size=blk, group=4)
        else:
            kv, sc = slotmajor_window(k, v, ks, vs, cap, blk)
            tables = identity_block_tables(B, cap, blk, cuda)
            run = lambda lens: paged_attention_decode_fused(  # noqa: E731
                q, kv, sc, tables, lens, 1, block_size=blk)
            want = paged_attention_decode_fused_plain(
                q, kv, sc, tables, lens, 1, block_size=blk)
        got = _both_calls(run, lens)
        _assert_attention_close(got, want, q, k[1], v[1],
                                None if ks is None else ks[1],
                                None if vs is None else vs[1], lens)


def test_kernels_flag_inputs_out_of_range(cuda):
    """What only the card can check sets the fault word: a bank_write column
    past the buffers (nothing written), a window past the slab, a fill past
    the block table (cut there) and a table row outside the pool (read as
    empty)."""
    from ppq_tpu_torch.kernels import (Bank, bank_write_inplace,
                                       paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       read_faults, slotmajor_window,
                                       window_write_inplace)
    read_faults(cuda)
    buf = torch.zeros(2, 4, 1, 128, dtype=torch.int8, device=cuda)
    new = torch.ones(2, 1, 1, 128, dtype=torch.int8, device=cuda)
    bank_write_inplace(Bank([buf]), [new],
                       torch.tensor([4], dtype=torch.int32, device=cuda))
    assert not buf.any()
    assert read_faults(cuda) == ['bank_write: a column outside the buffers']
    slab = torch.zeros(1, 2, 8, 1, 128, dtype=torch.int8, device=cuda)
    window_write_inplace([slab], [torch.ones(1, 2, 4, 1, 128, dtype=torch.int8,
                                             device=cuda)],
                         torch.tensor([0, 5], dtype=torch.int32, device=cuda))
    assert slab[:, 0, :4].all() and not slab[:, 1].any()
    assert read_faults(cuda) == ['window_write: a window outside the slab']
    q, k, v, ks, vs = _attention_case(cuda, 2, 2, 2, 64, torch.int8, 0)
    pool, sc = slotmajor_window(k[0], v[0], ks[0], vs[0], 64, 32)
    tables = torch.tensor([[0, 1], [2, 99]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([500, 64], dtype=torch.int32, device=cuda)
    got = paged_attention_decode_fused(q, pool, sc, tables, lens,
                                       block_size=32)
    want = paged_attention_decode_fused_plain(q, pool, sc, tables, lens,
                                              block_size=32)
    assert set(read_faults(cuda)) == {
        'paged attention: a seq_lens entry outside [0, blocks * block size]',
        'paged attention: a block-table row outside the pool'}
    cut = torch.tensor([64, 32], dtype=torch.int32, device=cuda)
    _assert_attention_close(got, want, q, k[0], v[0], ks[0], vs[0], cut)


def test_serving_engine_default_is_ragged_on_the_card(cuda):
    """With no knob set the engine reads the frozen cache through the
    ragged kernels (grouped at shallow fills, per slot where every slot is
    deep), at INT8 and at INT4 weights (with an INT8 lm_head)."""
    from ppq_tpu_torch.kernels import read_faults
    from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                       init_llama_params)
    for bits in (8, 4):
        cfg = LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=1024, max_seq_len=256,
                          max_batch=4, prefill_buckets=(16, 128),
                          weight_bits=bits)
        engine = ServingEngine(cfg, init_llama_params(cfg, seed=0))
        assert cfg.use_ragged_attention is True and cfg.use_kernel_matmul
        rng = np.random.default_rng(0)
        reqs = [Request(i, [int(t) for t in rng.integers(1, 512, size=5 + 30 * i)],
                        max_new_tokens=9) for i in range(6)]
        reset_launches()
        engine.run(reqs, sync_every=4)
        assert all(r.done and len(r.generated) == 9 for r in reqs)
        assert LAUNCHES['paged_attention_grouped'] > 0
        names = ('qmm_int4', 'qmm_gateup_int4') if bits == 4 \
            else ('qmm_gateup',)
        for name in names + ('qmm_int8', 'bank_write', 'window_write'):
            assert LAUNCHES[name] > 0, name
        reset_launches()
        out = engine.benchmark_decode(steps=8, burst=8, repeats=1, fill=200)
        assert LAUNCHES['paged_attention_fused'] > 0
        assert LAUNCHES['paged_attention_grouped'] == 0
        assert out['tokens_per_sec'] > 0 and read_faults(cuda) == []


# ------------------------------------ the paged pool: rows 16 and 13 ----

def _pool_case(cuda, dtype, T, write_pos, MB=4, L=3, NB=24, BLK=128, KV=2,
               Dh=64, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    B = len(write_pos)
    if dtype == torch.int8:
        codes = lambda *s: torch.randint(-128, 128, s, device=cuda,  # noqa
                                         generator=gen, dtype=torch.int8)
    else:
        codes = lambda *s: torch.randn(*s, device=cuda,  # noqa
                                       generator=gen).bfloat16()
    pool = codes(L, NB, 2, BLK, KV * Dh)
    k, v = codes(L, B, T, KV, Dh), codes(L, B, T, KV, Dh)
    scale = ks = vs = None
    if dtype == torch.int8:
        scale = torch.rand(L, NB, 2, KV, BLK, device=cuda, generator=gen)
        ks = torch.rand(L, B, KV, T, device=cuda, generator=gen)
        # the prefill's layout: a transposed view
        vs = torch.rand(L, B, T, KV, device=cuda, generator=gen).transpose(2, 3)
        ks = ks.transpose(2, 3).contiguous().transpose(2, 3)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(seed))
    tables = (perm[:B * MB] + 1).reshape(B, MB).to(torch.int32).to(cuda)
    active = torch.ones(B, dtype=torch.bool, device=cuda)
    active[2 % B] = False
    wp = torch.tensor(write_pos, dtype=torch.int32, device=cuda)
    return pool, scale, k, v, ks, vs, tables, wp, active


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('T', [1, 32, 128, 300])
def test_pool_write_kernel_bit_equal(cuda, dtype, T):
    """Row 16 against its plain version bit for bit on the whole pool:
    aligned, mid-block, inactive, at-boundary and crossing windows (a
    window of 300 crosses two block boundaries), the trash row untouched."""
    from ppq_tpu_torch.kernels import (pool_write_inplace, pool_write_plain,
                                       read_faults)
    case = _pool_case(cuda, dtype, T, (0, 100, 120, 96, 127))
    pool, scale, k, v, ks, vs, tables, wp, active = case
    want_pool, want_scale = pool.clone(), None if scale is None else scale.clone()
    read_faults(cuda)
    reset_launches()
    pool_write_inplace(pool, scale, k, v, ks, vs, tables, wp, active)
    assert LAUNCHES['pool_write'] == 1 and sum(LAUNCHES.values()) == 1
    pool_write_plain(want_pool, want_scale, k, v, ks, vs, tables, wp, active)
    torch.cuda.synchronize()
    assert torch.equal(pool.view(torch.int8), want_pool.view(torch.int8))
    if scale is not None:
        assert torch.equal(scale, want_scale)
    assert read_faults(cuda) == []
    # every slot active, no mask given
    pool_write_inplace(pool, scale, k, v, ks, vs, tables, wp)
    pool_write_plain(want_pool, want_scale, k, v, ks, vs, tables, wp)
    assert torch.equal(pool.view(torch.int8), want_pool.view(torch.int8))


def test_pool_write_kernel_flags_what_lies_outside(cuda):
    """A window past the table's last column writes its fitting part and
    sets bit 16; a table row past the pool is skipped and sets bit 32; the
    plain version skips the same tokens."""
    from ppq_tpu_torch.kernels import (pool_write_inplace, pool_write_plain,
                                       read_faults)
    case = _pool_case(cuda, torch.int8, 32, (246, 0), MB=2)
    pool, scale, k, v, ks, vs, tables, wp, active = case
    active[:] = True
    tables[1, 0] = pool.shape[1] + 5
    want_pool, want_scale = pool.clone(), scale.clone()
    read_faults(cuda)
    pool_write_inplace(pool, scale, k, v, ks, vs, tables, wp, active)
    assert set(read_faults(cuda)) == {
        'pool_write: a position outside the block table',
        'pool_write: a block-table row outside the pool'}
    pool_write_plain(want_pool, want_scale, k, v, ks, vs, tables, wp, active)
    assert torch.equal(pool, want_pool) and torch.equal(scale, want_scale)
    row = int(tables[0, 1])
    assert torch.equal(pool[:, row, 0, 118:], k[:, 0, :10].reshape(3, 10, -1))


def _assert_ctx_close(got, want, q, k, v, ks, vs, lens, kb, vb, ksb, vsb,
                      step):
    """Row 13 against its plain version: s sums Dh exact products in another
    order (delta = 2e-5 of its absolute mass); p moves by 2 delta and may
    round to the neighbouring bf16 number (2^-7); l by 4 delta; the context
    acc / l by (sum |p v_eff| / l) (2^-7 + 8 delta). k, v: the slots'
    (B, S, KV, Dh); ks, vs (B, S, KV) or None; the buffer (B, n, KV, Dh)."""
    B, KV, rep, Dh = q.shape
    S, n = k.shape[1], kb.shape[1]
    keys = torch.cat([k.float(), kb.float()], 1)
    vals = torch.cat([v.float(), vb.float()], 1)
    ones = lambda m: torch.ones(B, m, KV, device=q.device)  # noqa
    kss = torch.cat([ones(S) if ks is None else ks,
                     ones(n) if ksb is None else ksb.transpose(1, 2)], 1)
    vss = torch.cat([ones(S) if vs is None else vs,
                     ones(n) if vsb is None else vsb.transpose(1, 2)], 1)
    valid = torch.cat([torch.arange(S, device=q.device)[None] < lens[:, None].long(),
                       (torch.arange(n, device=q.device) <= step)[None].expand(B, n)], 1)
    valid = valid[:, None, None, :]
    qf = q.float()
    s = torch.einsum('bkrd,bskd->bkrs', qf, keys) * kss.transpose(1, 2)[:, :, None] \
        / np.sqrt(Dh)
    mass = torch.einsum('bkrd,bskd->bkrs', qf.abs(), keys.abs()) \
        * kss.transpose(1, 2)[:, :, None] / np.sqrt(Dh)
    s = torch.where(valid, s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    delta = 2e-5 * torch.where(valid, mass, 0.0).amax(-1) + 1e-6
    spread = torch.einsum('bkrs,bskd->bkrd', p, vals.abs() * vss[..., None]) \
        / p.sum(-1)[..., None]
    tol = spread * (2.0 ** -7 + 8 * delta[..., None]) + 1e-6
    assert bool(((got - want).abs() <= tol).all()), \
        float(((got - want).abs() / tol).max())


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('blk,rep,step', [(128, 2, 17), (256, 2, 0),
                                          (256, 4, 31), (512, 1, 5)])
def test_paged_attention_buffered_kernel_vs_plain(cuda, blk, rep, step, dtype):
    """Row 13 over a fused pool's strided planes and over separate
    contiguous pools: empty slots, partial and full blocks, step 0 and the
    last column."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain,
                                       read_faults, slotmajor_window)
    B, KV, S, n = 9, 2, 1024, 32
    q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, S, dtype, blk + rep)
    fused, sc = slotmajor_window(k[0], v[0], None if ks is None else ks[0],
                                 None if vs is None else vs[0], S, blk)
    nb = S // blk
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(blk))
    fused = fused[torch.argsort(perm).to(cuda)].contiguous()
    sc = None if sc is None else sc[torch.argsort(perm).to(cuda)].contiguous()
    tables = perm.reshape(B, nb).to(torch.int32).to(cuda)
    lens = torch.tensor([0, 1, 15, 16, blk - 1, blk, blk + 3, 1000, S],
                        dtype=torch.int32, device=cuda)
    kb, vb = k[1, :, :n].reshape(B, n, -1), v[1, :, :n].reshape(B, n, -1)
    ksb = None if ks is None else ks[1, :, :n].transpose(1, 2).contiguous()
    vsb = None if vs is None else vs[1, :, :n].transpose(1, 2).contiguous()
    read_faults(cuda)
    planes = (fused[:, 0], fused[:, 1], None if sc is None else sc[:, 0],
              None if sc is None else sc[:, 1])
    separate = tuple(None if t is None else t.contiguous() for t in planes)
    for pools in (planes, separate):
        reset_launches()
        got = paged_attention_decode_buffered(q, *pools, tables, lens, kb,
                                              vb, ksb, vsb, step,
                                              block_size=blk)
        assert LAUNCHES['paged_attention_buffered'] == 1
        assert sum(LAUNCHES.values()) == 1
        want = paged_attention_decode_buffered_plain(
            q, *pools, tables, lens, kb, vb, ksb, vsb, step, block_size=blk)
        torch.cuda.synchronize()
        _assert_ctx_close(got, want, q, k[0], v[0],
                          None if ks is None else ks[0],
                          None if vs is None else vs[0], lens,
                          k[1, :, :n], v[1, :, :n], ksb, vsb, step)
    assert read_faults(cuda) == []


def _buffered_inputs(cuda, B, KV, rep, cap, blk, nbuf, dtype, seed):
    """Row 13's inputs: layer 0 of a case as a fused pool of `blk`-blocks
    through a permuted table, passed as its strided planes, and the first
    nbuf positions of layer 1 as the buffer, its scale rows a view with a
    slot stride of KV * (nbuf + 4). Returns (args without step, dense)."""
    q, k, v, ks, vs = _attention_case(cuda, B, KV, rep, max(cap, nbuf), dtype,
                                      seed)
    fused, sc = slotmajor_window(k[0], v[0], None if ks is None else ks[0],
                                 None if vs is None else vs[0], cap, blk)
    nb = cap // blk
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(seed))
    fused = fused[torch.argsort(perm).to(cuda)].contiguous()
    sc = None if sc is None else sc[torch.argsort(perm).to(cuda)].contiguous()
    tables = perm.reshape(B, nb).to(torch.int32).to(cuda)
    kb, vb = k[1, :, :nbuf].reshape(B, nbuf, -1), v[1, :, :nbuf].reshape(B, nbuf, -1)
    ksb = vsb = None
    if ks is not None:
        wide = torch.zeros(2, B, KV * nbuf + 4, device=cuda)
        ksb = wide[0, :, :KV * nbuf].view(B, KV, nbuf)
        vsb = wide[1, :, :KV * nbuf].view(B, KV, nbuf)
        ksb.copy_(ks[1, :, :nbuf].transpose(1, 2))
        vsb.copy_(vs[1, :, :nbuf].transpose(1, 2))
    planes = (fused[:, 0], fused[:, 1], None if sc is None else sc[:, 0],
              None if sc is None else sc[:, 1])
    dense = (k[0, :, :cap], v[0, :, :cap],
             None if ks is None else ks[0, :, :cap],
             None if vs is None else vs[0, :, :cap])
    return (q, *planes, tables), (kb, vb, ksb, vsb), dense, \
        (k[1, :, :nbuf], v[1, :, :nbuf])


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16],
                         ids=['int8', 'bf16'])
@pytest.mark.parametrize('rep', [1, 2, 4])
@pytest.mark.parametrize('blk,cap,nbuf', [(16, 32, 8), (16, 48, 16),
                                          (32, 128, 32), (64, 512, 48),
                                          (256, 512, 32)])
def test_paged_attention_buffered_stage_and_pass_ends(cuda, blk, cap, nbuf,
                                                      rep, dtype):
    """Row 13 at fills that end inside and on a pass and a stage of the
    pool (empty slots among them: a fill of 0 with step > 0) and at steps
    that do the same in the buffer's own pass grid, past its end (clamped)
    included, over a fused pool's strided planes with 3 KV heads (a thread
    block holds a slot's heads): one warp a head where the pool's window
    and the counted columns are 64 positions or fewer, two otherwise; buffer
    scales with a slot stride other than KV * nbuf. Two calls bit-equal,
    one launch, no fault."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain,
                                       read_faults)
    B, KV = 40, 3
    head, buf, dense, codes = _buffered_inputs(cuda, B, KV, rep, cap, blk,
                                               nbuf, dtype, blk + nbuf + rep)
    lens = _edge_lens(B, cap, cuda)
    read_faults(cuda)
    for step in sorted({0, 3, 4, 7, 8, 15, 16, 31, nbuf - 1, nbuf + 2}):
        reset_launches()
        args = (*head, lens, *buf[:2], *buf[2:], step)
        got = paged_attention_decode_buffered(*args, block_size=blk)
        again = paged_attention_decode_buffered(*args, block_size=blk)
        assert LAUNCHES['paged_attention_buffered'] == 2
        assert torch.equal(got, again)
        want = paged_attention_decode_buffered_plain(*args, block_size=blk)
        torch.cuda.synchronize()
        _assert_ctx_close(got, want, head[0], *dense, lens, *codes, buf[2],
                          buf[3], step)
    assert read_faults(cuda) == []


def test_paged_attention_buffered_at_path_g(cuda):
    """Row 13 at path G's shape (128 slots, 8 KV heads of 128, rep 2, blocks
    of 256, 32 buffer columns) at fills 512 and 16, steps 0 and 31: within
    the tolerance of its plain version, two calls bit-equal, no fault."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain,
                                       read_faults)
    B, KV, rep, cap, blk, nbuf = 128, 8, 2, 1024, 256, 32
    head, buf, dense, codes = _buffered_inputs(cuda, B, KV, rep, cap, blk,
                                               nbuf, torch.int8, 12)
    read_faults(cuda)
    for fill in (512, 16):
        lens = torch.full((B,), fill, dtype=torch.int32, device=cuda)
        for step in (0, 31):
            args = (*head, lens, *buf, step)
            got = paged_attention_decode_buffered(*args, block_size=blk)
            assert torch.equal(got, paged_attention_decode_buffered(
                *args, block_size=blk))
            want = paged_attention_decode_buffered_plain(*args, block_size=blk)
            _assert_ctx_close(got, want, head[0], *dense, lens, *codes,
                              buf[2], buf[3], step)
    assert read_faults(cuda) == []


def test_paged_serving_engine_on_the_card(cuda):
    """paged_kv on the card: run serves every request through the pool
    write and the grouped read, with prefix-cache hits whose last window's
    padding passes the table's end (trash columns there, no fault), returns
    every block, and reports no fault."""
    from ppq_tpu_torch.kernels import read_faults
    from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                       init_llama_params)
    cfg = LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=1024, max_seq_len=512, max_batch=4,
                      prefill_buckets=(16, 384), paged_kv=True,
                      kv_block_size=128, prefix_cache_blocks=8)
    engine = ServingEngine(cfg, init_llama_params(cfg, seed=0))
    rng = np.random.default_rng(0)
    head = [int(t) for t in rng.integers(1, 512, size=260)]
    reqs = [Request(i, ([int(t) for t in rng.integers(1, 512, size=5 + 30 * i)]
                        if i % 2 else head + [i]), max_new_tokens=9)
            for i in range(6)]
    read_faults(cuda)
    reset_launches()
    engine.run(reqs[:1], sync_every=4)
    engine.run(reqs[1:], sync_every=4)
    assert all(r.done and len(r.generated) == 9 for r in reqs)
    assert engine.prefix_cache.hits >= 2
    for name in ('qmm_int8', 'qmm_gateup', 'bank_write', 'pool_write',
                 'paged_attention_grouped'):
        assert LAUNCHES[name] > 0, name
    assert LAUNCHES['window_write'] == 0
    engine.prefix_cache.clear()
    assert engine._alloc.free_blocks == engine._alloc.num_blocks - 1
    out = engine.benchmark_decode(steps=8, burst=8, repeats=1, fill=200)
    assert out['tokens_per_sec'] > 0 and read_faults(cuda) == []


# ------------------------------------------------ captured decode bursts

_CAPTURE_CASES = {
    # (config fields, grouped kernel (None: the engine's gate), sampled)
    'dense': (dict(use_ragged_attention=False), None, False),
    'ragged_grouped': ({}, True, False),
    'ragged_per_slot': ({}, False, False),
    'int4': (dict(weight_bits=4), None, False),
    'paged': (dict(paged_kv=True, kv_block_size=128), None, False),
    'dense_sampled': ({}, None, True),
    'paged_sampled': (dict(paged_kv=True, kv_block_size=128), None, True),
}


def _capture_engine(extra):
    from ppq_tpu_torch.serving import (LlamaConfig, ServingEngine,
                                       init_llama_params)
    cfg = LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=1024, max_seq_len=256, max_batch=4,
                      prefill_buckets=(16, 128), **extra)
    return ServingEngine(cfg, init_llama_params(cfg, seed=0))


def _admitted(engine, sampled, seed=0):
    """Every slot admitted with a seeded prompt (fills 5 to 95), every
    other one sampling when `sampled`. Returns the current tokens."""
    from ppq_tpu_torch.serving import Request, SamplingParams
    engine._reset_cache()
    B = engine.cfg.max_batch
    engine.slot_len[:] = 0
    engine.slot_req = [None] * B
    rng = np.random.default_rng(seed)
    reqs = [Request(i, [int(t) for t in rng.integers(1, 512, size=5 + 30 * i)],
                    max_new_tokens=64,
                    sampling=SamplingParams(temperature=0.8, top_p=0.95)
                    if sampled and i % 2 else None) for i in range(B)]
    engine._admit_batch(list(enumerate(reqs)))
    return torch.tensor([r.generated[-1] for r in reqs], dtype=torch.int32,
                        device=engine.device)


def _one_burst(engine, n, cur, grouped):
    seq = engine._tensor(engine.slot_len, torch.int32)
    samp = engine._samp_arrays()
    if engine._paged:
        toks, _ = engine._paged_decode(n, cur, seq,
                                       list(range(engine.cfg.max_batch)),
                                       samp)
        return toks
    fills = [int(f) for f in engine.slot_len]
    bucket = engine._decode_bucket(max(fills))
    if grouped is None:
        grouped = engine._grouped_gate(fills, n, bucket)
    toks, _ = engine._build_decode_burst(n, bucket, grouped)(
        engine.params, engine.cache, cur, seq, samp)
    return toks


@pytest.mark.parametrize('case', list(_CAPTURE_CASES))
def test_captured_burst_equals_the_uncaptured_burst(cuda, case):
    """One burst of 8 from the same admitted state, as a replay of its CUDA
    graph and uncaptured, from the same generator state: the tokens and
    every byte of the cache (dense) or the pools (paged) equal. A sampled
    burst's two consecutive replays draw different tokens; each replay
    counts its launches once."""
    extra, grouped, sampled = _CAPTURE_CASES[case]
    engine = _capture_engine(extra)
    cur = _admitted(engine, sampled)
    start = {k: v.clone() for k, v in engine.cache.items()}

    def restore():
        for k, v in start.items():
            engine.cache[k].copy_(v)
    _one_burst(engine, 8, cur, grouped)         # uncaptured, then captured
    restore()
    assert engine.graph_captures == 1
    (graph,) = engine._graphs.values()
    reset_launches()
    engine._generator.manual_seed(11)
    toks_c = _one_burst(engine, 8, cur, grouped)
    assert {k: v for k, v in LAUNCHES.items() if v} \
        == graph.launches_per_replay
    cache_c = {k: v.clone() for k, v in engine.cache.items()}
    if sampled:
        restore()
        again = _one_burst(engine, 8, cur, grouped)
        assert not torch.equal(again[:, 1::2], toks_c[:, 1::2])
        assert torch.equal(again[:, 0::2], toks_c[:, 0::2])
    restore()
    engine._capture = False
    engine._generator.manual_seed(11)
    toks_u = _one_burst(engine, 8, cur, grouped)
    engine._capture = True
    assert engine.graph_captures == 1
    assert torch.equal(toks_c, toks_u)
    for k, v in cache_c.items():
        assert torch.equal(v, engine.cache[k]), k


def test_planned_loop_dispatches_without_a_host_sync(cuda):
    """The planned loop's dispatch (every prefill, every replayed burst and
    the download into pinned memory) makes no synchronizing call, once its
    burst shapes are captured; its tokens equal the synchronous loop's."""
    from ppq_tpu_torch.serving import Request
    engine = _capture_engine(dict(paged_kv=True, kv_block_size=128))
    rng = np.random.default_rng(3)

    def requests():
        return [Request(i, [int(t) for t in rng.integers(1, 512, size=20)],
                        max_new_tokens=9) for i in range(6)]
    warm = requests()
    engine.run(warm, sync_every=4)
    captures = engine.graph_captures
    dispatch = engine._dispatch_planned

    def strict(*args):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return dispatch(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    engine._dispatch_planned = strict
    rng = np.random.default_rng(3)
    planned = requests()
    engine.run(planned, sync_every=4)
    assert engine.graph_captures == captures
    rng = np.random.default_rng(3)
    synchronous = requests()
    engine.run(synchronous, sync_every=4, arrivals=[0.0] * 6)
    assert [r.generated for r in planned] == [r.generated for r in synchronous]
    assert engine._alloc.free_blocks == engine._alloc.num_blocks - 1


# ---------------------------------------------------- the compiled executor

def _quantized_small(dev, algo='percentile', prefer_compiled=True):
    """ResNet-18 (10 classes) at 4x3x32x32, quantized on the card with
    TPU_INT8 over 2 seeded batches: the compiled calibration by default."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.core import PPQ_TPU_CONFIG
    from ppq_tpu_torch.zoo import resnet18
    rng = np.random.RandomState(0)
    loader = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(2)]
    setting = QuantizationSettingFactory.default_setting()
    if algo != 'percentile':
        setting.quantize_activation_setting.calib_algorithm = algo
    graph = resnet18(num_classes=10, input_shape=[4, 3, 32, 32])
    saved = PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR
    PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = prefer_compiled
    try:
        quantize_graph(graph, loader, calib_steps=2, setting=setting,
                       platform=TargetPlatform.TPU_INT8, verbose=False,
                       device=dev)
    finally:
        PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = saved
    return graph, loader


@pytest.mark.parametrize('precision', ['int', 'highest', 'bf16'])
def test_captured_runner_equals_the_uncaptured_walk(cuda, precision):
    """A replay equals the same walk run uncaptured, bit for bit, call after
    call; a chain-2 capture equals two chain-1 replays; the capture holds
    row 1's launches."""
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.ir.morph import stem_space_to_depth
    torch.backends.cudnn.deterministic = True
    graph, loader = _quantized_small(cuda)
    stem_space_to_depth(graph)
    cg = compile_graph(graph, precision=precision)
    run, chained = cg.make_runner(), cg.make_runner(chain=2)
    for x in loader:
        got = run(x)[0]
        assert got.is_cuda and got.dtype == torch.float32
        assert torch.equal(got, run.walk(x)[0])
        assert torch.equal(got, run(x)[0])
    assert run.launches_per_replay['fake_quant_tensorwise'] > 0
    stacked = chained(np.stack(loader))[0]
    for i, x in enumerate(loader):
        assert torch.equal(stacked[i], run(x)[0])


def test_int_is_exact_on_the_card(cuda, monkeypatch):
    """Every lowered convolution's sums on the card equal an int64 product
    of the same codes, and the card's 'int' logits equal the CPU's bit for
    bit (integer sums exact in any order, the rest IEEE float32), with
    cuDNN's timed algorithm choice on: the contraction pins its own."""
    from ppq_tpu_torch.executor import compile_graph
    graph, loader = _quantized_small(cuda)
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', True)
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', False)
    cg = compile_graph(graph, precision='int')
    checked = []

    def probe(op, qx, qw, y):
        if op.type != 'Conv':
            return
        xs, ws = qx.double(), qw.double()
        p = [int(v) for v in op.attributes.get('pads', [0, 0, 0, 0])]
        s = [int(v) for v in op.attributes.get('strides', [1, 1])]
        # float64 holds these integer sums exactly (|sum| < 2^53)
        gold = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xs, (p[1], p[3], p[0], p[2])), ws,
            stride=s)
        assert torch.equal(y.double(), gold), op.name
        checked.append(op.name)

    cg.int_probe = probe
    card = cg._walk(cg.init_params(), cg._feed(loader[0]))[0]
    assert len(checked) == 20
    cpu = compile_graph(graph, precision='int', device='cpu')
    want = cpu.make_runner()(loader[0])[0]
    assert torch.equal(card.cpu(), want)
    assert cg.int_accum_risk == cpu.int_accum_risk


@pytest.mark.parametrize('precision', ['int', 'highest', 'bf16'])
def test_a_runner_keeps_the_qparams_it_was_captured_with(cuda, precision):
    """New scales written back drop the device scales the TQCs kept; a
    runner captured before holds them (nothing it reads is freed), replays
    its old output bit for bit after the allocator has handed out fresh
    memory, and a runner built after reads the new scales."""
    import gc
    import weakref
    from ppq_tpu_torch.executor import compile_graph
    graph, loader = _quantized_small(cuda)
    cg = compile_graph(graph, precision=precision)
    run = cg.make_runner()
    before = run(loader[0])[0]
    held = [t for pair in cg._device_qparams() for t in pair]
    ids, refs = {id(t) for t in held}, [weakref.ref(t) for t in held]
    del held
    qparams = cg.init_qparams()
    for q in qparams.values():
        q['scale'] = q['scale'] * 2
    cg.write_back_qparams(qparams)
    assert ids - {id(t) for pair in cg._device_qparams() for t in pair}
    gc.collect()
    assert all(ref() is not None for ref in refs)
    junk = [torch.full((64,), float('nan'), device=cuda) for _ in range(4096)]
    torch.cuda.synchronize()
    assert torch.equal(run(loader[0])[0], before)
    del junk
    assert not torch.equal(cg.make_runner()(loader[0])[0], before)


def test_absmax_hist_two_sweeps_equal_the_observer_histogram(cuda):
    """The compiled absmax_hist spec, sweep 1 (abs-max, placeholder scale)
    then sweep 2 captured anew at the real scale, folds the same int64
    counts over two batches as the eager KL observer's histogram."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.core import OBSERVER_KL_HIST_BINS, OBSERVER_MIN_SCALE
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.quantization.observers import KLObserver
    from ppq_tpu_torch.quantization.optim.fcalibration import (
        _activation_roots, _make_fold)
    from ppq_tpu_torch.zoo import resnet18
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(1)
    loader = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(2)]
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation = False
    graph = resnet18(num_classes=10, input_shape=[4, 3, 32, 32])
    quantize_graph(graph, loader, calib_steps=2, setting=setting,
                   platform=TargetPlatform.TPU_INT8, verbose=False,
                   device=cuda)
    targets = _activation_roots(graph)
    assert len(targets) == 41
    bins = OBSERVER_KL_HIST_BINS
    spec = {n: {'kind': 'absmax_hist', 'bins': bins} for n in targets}
    cg = compile_graph(graph)
    fn, params = cg.build_calibration_forward(spec), cg.init_params()
    fold = _make_fold({n: 'absmax_hist' for n in targets})
    ones = {n: np.float32(1.0) for n in targets}
    acc = None
    for x in loader:
        acc = fold(acc, fn(params, x, ones)[1])
    scales = {n: np.float32(max(float(acc[n][0]), OBSERVER_MIN_SCALE) / bins)
              for n in targets}
    acc2 = None
    for x in loader:
        acc2 = fold(acc2, fn(params, x, scales)[1])
    assert len(fn.captures) == (2 if cuda.type == 'cuda' else 0)
    observers = {n: KLObserver(cfgs[0]) for n, cfgs in targets.items()}
    executor = TorchExecutor(graph)
    names = sorted(targets)
    for phase in (1, 2):
        if phase == 2:
            for obs in observers.values():
                obs.start_phase2()
        for x in loader:
            for n, v in zip(names, executor.forward(x, output_names=names)):
                observers[n].observe(v)
    for n in names:
        assert observers[n]._hist_scale == float(scales[n]), n
        assert torch.equal(acc2[n][1], observers[n]._counts), n


@pytest.mark.parametrize('algo', ['percentile', 'kl'])
def test_compiled_calibration_equals_the_observer_path_on_the_card(cuda, algo):
    """The compiled calibration on the card against the observer path on
    the card: KL scales bit for bit, percentile within 2.5e-7 relative (two
    batches' quantiles summed in float32 on the card, in float64 on the
    host); KL's searches took the native library."""
    from ppq_tpu_torch.quantization import solvers
    before = dict(solvers.SEARCHES)
    compiled, _ = _quantized_small(cuda, algo)
    if algo == 'kl':
        assert solvers.SEARCHES['numpy'] == before['numpy']
        assert solvers.SEARCHES['native'] == before['native'] + 41
    observer, _ = _quantized_small(cuda, algo, prefer_compiled=False)
    n = 0
    for name, op in compiled.operations.items():
        if not hasattr(op, 'config'):
            continue
        for (var, a), (_, b) in zip(op.config_pairs(),
                                    observer.operations[name].config_pairs()):
            if var.is_parameter or not a.is_root or \
                    a.state.name != 'ACTIVATED':
                continue
            got, want = np.asarray(a.scale), np.asarray(b.scale)
            if algo == 'kl':
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2.5e-7)
            n += 1
    assert n == 41


# ------------------------------------------------ ingest and export (I) --

def _qdq_case(dtype, per_axis, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 16, 7, 9) * 3).astype(np.float32)
    x.reshape(-1)[:6] = [0.5, 1.5, -2.5, 1e3, -1e3, 0.0]
    if per_axis:
        scale = rng.uniform(0.01, 0.05, 16).astype(np.float32)
        zp = (rng.randint(0, 40, 16) if dtype == np.uint8
              else rng.randint(-20, 20, 16)).astype(dtype)
    else:
        scale = np.asarray(0.03, np.float32)
        zp = np.asarray(7 if dtype == np.uint8 else -3, dtype)
    return x, scale, zp


@pytest.mark.parametrize('per_axis', [False, True])
@pytest.mark.parametrize('dtype', [np.uint8, np.int8])
def test_quantize_linear_on_the_card_equals_its_twin(cuda, dtype, per_axis):
    """QuantizeLinear on a CUDA tensor launches row 1 (per-tensor) or row 2
    (per-axis) in their codes mode and gives the plain twin's integers."""
    from ppq_tpu_torch.executor.ops.default import (QuantizeLinear_forward,
                                                    quantize_linear_plain)
    import types
    x, scale, zp = _qdq_case(dtype, per_axis)
    op = types.SimpleNamespace(name='q', type='QuantizeLinear',
                               attributes={'axis': 1})
    xc = torch.from_numpy(x).to(cuda)
    reset_launches()
    got = QuantizeLinear_forward(op, [xc, torch.from_numpy(scale).to(cuda),
                                      zp])
    row = 'fake_quant_channelwise' if per_axis else 'fake_quant_tensorwise'
    assert LAUNCHES[row] == 1 and sum(LAUNCHES.values()) == 1
    want = quantize_linear_plain(
        xc, torch.from_numpy(scale).to(cuda),
        torch.from_numpy(zp.astype(np.float32)).to(cuda),
        1 if per_axis else None, got.dtype)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.from_numpy(zp).dtype
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), quantize_linear_plain(
        torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(zp.astype(np.float32)), 1 if per_axis else None,
        got.dtype))


def _exported(graph, tmp, tag):
    from ppq_tpu_torch import TargetPlatform, export_ppq_graph
    out = {}
    for platform, name in ((TargetPlatform.TPU_INT8, 'qdq.onnx'),
                           (TargetPlatform.NCNN_INT8, 'ncnn.onnx')):
        path = str(tmp / f'{tag}_{name}')
        export_ppq_graph(graph, platform, path, path + '.cfg')
        out[name] = (open(path, 'rb').read(), open(path + '.cfg', 'rb').read())
    return out


def test_export_after_card_quantization_equals_cpu(cuda, tmp_path):
    """A graph quantized on the card exports the same files as the same
    graph quantized on the CPU and given the card's parameters and TQCs
    (the exporters read the host scales)."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.interop import (load_parameters,
                                       load_quantization_configs,
                                       parameters_of, quantization_configs_of)
    from ppq_tpu_torch.zoo import tiny_cnn
    rng = np.random.RandomState(0)
    loader = [rng.randn(2, 3, 16, 16).astype(np.float32) for _ in range(2)]
    on_card = tiny_cnn(input_shape=(2, 3, 16, 16))
    quantize_graph(on_card, loader, calib_steps=2,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    on_cpu = tiny_cnn(input_shape=(2, 3, 16, 16))
    quantize_graph(on_cpu, loader, calib_steps=2,
                   platform=TargetPlatform.TPU_INT8, verbose=False,
                   device='cpu')
    load_parameters(on_cpu, parameters_of(on_card))
    load_quantization_configs(on_cpu, quantization_configs_of(on_card))
    for name, op in on_card.operations.items():
        if hasattr(op, '_fp32_params'):
            on_cpu.operations[name]._fp32_params = dict(op._fp32_params)
    assert _exported(on_card, tmp_path, 'card') == \
        _exported(on_cpu, tmp_path, 'cpu')


def test_reloaded_qdq_graph_on_the_card_matches_the_simulation(cuda,
                                                               tmp_path):
    """The exported QDQ file parsed and run on the card (eager and a
    'highest' runner) against the card's simulation of the source graph,
    under the JAX package's bounds (SNR < 1e-3, relative error < 5e-2);
    its QuantizeLinears launch row 1."""
    from ppq_tpu_torch import (TargetPlatform, TorchExecutor,
                               export_ppq_graph, load_onnx_graph)
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    graph, loader = _quantized_small(cuda)
    path = str(tmp_path / 'qdq.onnx')
    export_ppq_graph(graph, TargetPlatform.TPU_INT8, path)
    deployed = load_onnx_graph(path)
    reset_launches()
    dep = TorchExecutor(deployed).forward(loader[0])[0]
    assert LAUNCHES['fake_quant_tensorwise'] > 0
    sim = TorchExecutor(graph).forward(loader[0])[0]
    run = compile_graph(deployed, precision='highest').make_runner()
    for got in (dep, run(loader[0])[0]):
        assert got.is_cuda
        assert float(torch_snr_error(got, sim)) < 1e-3
        assert float((got - sim).abs().max() / sim.abs().max()) < 5e-2


# ------------------------------------------------- the op library, the zoo
# every case of tests/torch_op_cases.py (every op type of the table and the
# NXP Resize: TopK's ties, Resize in every mode, LSTM and GRU with
# sequence_lens, ScatterND on unique indices, NonZero, NMS, ...) on the card
# against the same op on the CPU, within the case's card tolerance
from torch_op_cases import CASES as OP_CASES  # noqa: E402


@pytest.mark.parametrize('case', OP_CASES, ids=[c.id for c in OP_CASES])
def test_op_case_on_the_card(cuda, case):
    from torch_op_cases import assert_close, run_port
    assert_close(run_port(case, cuda), run_port(case, 'cpu'), case.card,
                 case.id)


def test_ops_keep_card_tensors_on_the_card(cuda):
    """An op given a card tensor returns one there (host ops return host
    arrays); only NonZero and NonMaxSuppression read the card back."""
    from torch_op_cases import port_inputs
    from ppq_tpu_torch.core import TargetPlatform
    from ppq_tpu_torch.executor import ExecContext, resolve_forward
    from ppq_tpu_torch.ir import Operation
    host_ops = {'Shape', 'Size', 'ConstantOfShape', 'Range', 'NonZero',
                'NonMaxSuppression', 'Constant', 'Parameter',
                'PPQDeviceSwitch'}
    for case in OP_CASES:
        values = port_inputs(case, cuda)
        if case.op_type in host_ops or not any(
                isinstance(v, torch.Tensor) for v in values):
            continue
        op = Operation('c', case.op_type, attributes=case.attrs)
        op.outputs = [None] * case.n_out
        out = resolve_forward(
            TargetPlatform[case.platform or 'UNSPECIFIED'],
            case.op_type)(op, values, ExecContext(device=cuda))
        for o in (out if isinstance(out, (tuple, list)) else [out]):
            assert isinstance(o, torch.Tensor) and o.is_cuda, case.id


def test_small_bert_int_capture_equals_its_walk(cuda):
    """Small BERT (the JAX zoo test's widths) quantized on the card: the
    'int' runner's replay equals its uncaptured walk, bit for bit, and the
    captured walk launches row 1."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.zoo import bert_encoder
    rng = np.random.RandomState(0)
    loader = [rng.randn(2, 16, 64).astype(np.float32) for _ in range(2)]
    graph = bert_encoder(seq_len=16, d_model=64, n_heads=2, n_layers=2,
                         d_ff=128, batch=2)
    quantize_graph(graph, loader, calib_steps=2,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    cg = compile_graph(graph, precision='int')
    run = cg.make_runner()
    x = torch.as_tensor(loader[1], device=cuda)
    got = run(x)[0]
    assert run.launches_per_replay.get('fake_quant_tensorwise', 0) > 0
    assert torch.equal(got, run.walk(x)[0])
    # 16 MatMuls lowered: layer 1's K and V read the calibrated embeddings
    # too (14 while the compiled calibration left their inputs INITIAL;
    # ROADMAP.md queue 3, recorded difference 39)
    assert len(cg.int_lowered) == 16 and not cg.int_accum_risk


def _formatted_mobilenet():
    from ppq_tpu_torch import format_graph
    from ppq_tpu_torch.zoo import mobilenet_v2
    return format_graph(mobilenet_v2(width=0.5, num_classes=100,
                                     input_shape=[8, 3, 64, 64]))


def _float64_params(graph):
    for var in graph.variables.values():
        if var.is_parameter and var.has_value and \
                np.asarray(var.value).dtype == np.float32:
            var.value = np.asarray(var.value, np.float64)
    return graph


def test_equalization_on_the_card_equals_the_cpu(cuda):
    """LayerwiseEqualizationPass, as quantize_graph's prequant pipeline runs
    it on the card, against the same pass on the CPU: the rewritten weights
    and biases bit for bit (host numpy both), and the quantized graphs'
    weight scales bit for bit."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.zoo import mobilenet_v2
    rng = np.random.RandomState(2)
    loader = [rng.randn(8, 3, 64, 64).astype(np.float32) for _ in range(2)]
    graphs = []
    for device in (cuda, 'cpu'):
        setting = QuantizationSettingFactory.default_setting()
        setting.equalization = True
        graph = mobilenet_v2(width=0.5, num_classes=100,
                             input_shape=[8, 3, 64, 64])
        quantize_graph(graph, loader, calib_steps=2, setting=setting,
                       platform=TargetPlatform.TPU_INT8, verbose=False,
                       device=device)
        graphs.append(graph)
    on_card, on_cpu = graphs
    n = 0
    for name, op in on_cpu.operations.items():
        if op.type != 'Conv':
            continue
        other = on_card.operations[name]
        for var, cfg in op.config_pairs():
            if var.is_parameter and cfg.has_scale and \
                    op.inputs.index(var) == 1:
                twin = other.config.input_quantization_config[1]
                assert np.array_equal(np.asarray(twin.scale),
                                      np.asarray(cfg.scale)), name
                n += 1
    assert n > 20


def test_the_card_computes_with_rewritten_weights(cuda):
    """An executor and a runner on the card that ran before a prequant pass
    rewrote the weights: the executor uploads the new host arrays (its
    cache goes by the array), so it equals a fresh executor bit for bit; a
    runner closes over its parameters as they were, and a new one sees the
    new weights. The pass keeps the function: in float64 the output moves
    by less than 1e-5 of its largest value (in float32 the two forwards'
    own rounding is larger than that)."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.quantization.optim import LayerwiseEqualizationPass
    torch.backends.cudnn.deterministic = True
    graph = _formatted_mobilenet()
    x = torch.randn(8, 3, 64, 64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    executor = TorchExecutor(graph, device=cuda)
    old_runner = compile_graph(graph, device=cuda).make_runner()
    before = executor.forward(x)[0]
    old = old_runner(x)[0]
    LayerwiseEqualizationPass(iterations=10).optimize(graph)
    after = executor.forward(x)[0]
    assert torch.equal(after, TorchExecutor(graph, device=cuda).forward(x)[0])
    for name, (host, on_card) in executor._params.items():
        if isinstance(on_card, torch.Tensor) and on_card.is_floating_point():
            assert host is graph.variables[name].value
            assert torch.equal(on_card.cpu(), torch.as_tensor(host)), name
    assert not torch.equal(after, before)
    wide = [TorchExecutor(_float64_params(g.copy()), device=cuda).forward(
        x.double())[0] for g in (_formatted_mobilenet(), graph)]
    assert float((wide[1] - wide[0]).abs().max()) <= \
        1e-5 * float(wide[0].abs().max())
    assert torch.equal(old_runner(x)[0], old)
    fresh = compile_graph(graph, device=cuda).make_runner()(x)[0]
    assert torch.equal(fresh, compile_graph(graph, device=cuda)
                       .make_runner().walk(x)[0])
    assert not torch.equal(fresh, old)


# ------------------------- captured finetuning step, W8A8 and MoE ----

def test_lsq_captured_step_equals_uncaptured(cuda, monkeypatch):
    """LearnedStepSizePass on tiny_cnn on the card, once with every step
    after a block's first a CUDA-graph replay and once uncaptured: the
    trained weights, scales and offsets and Adam's state of every block, and
    the graph afterwards, bit for bit. cuDNN is held to its deterministic
    algorithms, without which two uncaptured runs differ too."""
    import copy

    import ppq_tpu_torch
    from ppq_tpu_torch.interop import quantization_configs_of
    from ppq_tpu_torch.quantization.optim import LearnedStepSizePass
    from ppq_tpu_torch.zoo import tiny_cnn
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    rng = np.random.RandomState(5)
    loader = [rng.randn(2, 3, 16, 16).astype(np.float32) for _ in range(4)]
    graph = tiny_cnn(input_shape=(2, 3, 16, 16))
    ppq_tpu_torch.quantize_graph(
        graph, loader, calib_steps=4,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False)
    runs = []
    for capture in (True, False):
        g = copy.deepcopy(graph)
        lsq = LearnedStepSizePass(block_size=2, steps=5, lr=1e-4,
                                  calib_steps=4)
        lsq.capture, lsq.keep_state = capture, True
        ppq_tpu_torch.manop(g, lsq, calib_dataloader=loader, verbose=False)
        runs.append((g, lsq.history))
    (ga, ha), (gb, hb) = runs
    assert len(ha) == len(hb) == 2
    for a, b in zip(ha, hb):
        assert a['replays'] == 4 and b['replays'] == 0
        assert a['launches_per_replay']['fake_quant_bwd_tensorwise'] > 0
        assert (a['pre_loss'], a['post_loss'], a['accepted']) \
            == (b['pre_loss'], b['post_loss'], b['accepted'])
        for part in ('params', 'qparams', 'adam'):
            flat_a = [v for v in _tensor_leaves(a['state'][part])]
            flat_b = [v for v in _tensor_leaves(b['state'][part])]
            assert len(flat_a) == len(flat_b) > 0
            assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    for name, var in ga.variables.items():
        if var.is_parameter:
            np.testing.assert_array_equal(var.value, gb.variables[name].value)
    ca, cb = quantization_configs_of(ga), quantization_configs_of(gb)
    for key, entry in ca.items():
        if entry['scale'] is not None:
            np.testing.assert_array_equal(entry['scale'], cb[key]['scale'])


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _tensor_leaves(tree[key])
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.parametrize('R,D,F', [(1, 64, 40), (5, 60, 36), (17, 256, 512),
                                   (130, 2048, 1024)])
def test_w8a8_product_on_card_equals_cpu_int32_sums(cuda, R, D, F):
    """The W8A8 prefill's int8 x int8 -> int32 product on the card
    (`torch._int_mm`, operands padded to its shape rules) against the CPU's
    exact integer product."""
    from ppq_tpu_torch.serving.model import int8_product
    gen = torch.Generator().manual_seed(R * 7 + D)
    q = torch.randint(-127, 128, (R, D), dtype=torch.int8, generator=gen)
    w = torch.randint(-128, 128, (D, F), dtype=torch.int8, generator=gen)
    want = int8_product(q, w)
    got = int8_product(q.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (R, F)
    assert torch.equal(got.cpu(), want)


def test_moe_ffn_on_card_vs_plain_cpu(cuda):
    """init_moe_params on the card equals the CPU's bit for bit; moe_ffn on
    the card (float32 einsums, TF32 off) within 1e-5 of the largest output
    of its CPU run."""
    from ppq_tpu_torch.executor import simulation_precision
    from ppq_tpu_torch.serving.moe import init_moe_params, moe_ffn
    cpu = init_moe_params(256, 512, 8, 2, seed=3, device='cpu')
    card = init_moe_params(256, 512, 8, 2, seed=3, device=cuda)
    for key in ('router', 'w_gate', 'w_up', 'w_down'):
        for a, b in zip(_tensor_leaves(cpu[key]), _tensor_leaves(card[key])):
            assert torch.equal(a, b.cpu())
    x = torch.randn(2, 7, 256, generator=torch.Generator().manual_seed(1))
    want = moe_ffn(x, cpu)
    with simulation_precision('highest'):
        got = moe_ffn(x.to(cuda), card).cpu()
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * want.abs().max())


# ------------------------------------- custom operators, QAT, deploy, alloc
@pytest.mark.parametrize('axis', [None, 0, 1])
def test_custom_operators_equal_their_plain_twins(cuda, axis):
    """The custom operators of kernels/ops.py on card tensors launch the
    kernels (one launch each) and give the plain versions' bits; on CPU
    tensors they are the plain versions."""
    x, s, o, (qmin, qmax) = _case((6, 5, 7, 9), axis, True, seed=3)
    for dev in (cuda, torch.device('cpu')):
        xc = torch.from_numpy(x).to(dev)
        st = torch.as_tensor(np.asarray(s, np.float32), device=dev)
        ot = torch.as_tensor(np.asarray(o, np.float32), device=dev)
        reset_launches()
        got = torch.ops.ppq_tpu_torch.linear_quant(
            xc, st, ot, float(qmin), float(qmax), 1, axis, False)
        fgot = torch.ops.ppq_tpu_torch.floating_quant(
            xc, st.abs() * 10, 4, 3, -448.0, 448.0, axis)
        torch.cuda.synchronize()
        assert sum(LAUNCHES.values()) == (2 if dev.type == 'cuda' else 0)
        want = linear_quant_plain(xc, st, ot, qmin, qmax,
                                  RoundingPolicy.ROUND_HALF_UP, axis)
        fwant = floating_quant_plain(xc, st.abs() * 10, 4, 3, -448.0, 448.0,
                                     axis)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(fgot.view(torch.int32), fwant.view(torch.int32))


def _qat_stack(dev):
    from ppq_tpu_torch import qat
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        qat.QConv2d(3, 8, 7, stride=2), torch.nn.ReLU(),
        qat.QConv2d(8, 16, 3, stride=2), torch.nn.ReLU(),
        torch.nn.Flatten(), qat.QLinear(16 * 4 * 4, 10))
    return model.to(dev)


def test_qat_step_on_the_card_equals_the_cpu(cuda):
    """A QConv2d / QLinear stack calibrated on the card seeds the CPU's
    scales (the first layer's bit for bit; behind a convolution within
    1e-5: cuDNN and the CPU sum in other orders). From the CPU's calibrated
    state, one SGD step on the card (rows 1 and 2 forward, 4 and 5
    backward), TF32 off, against the same step on the CPU: outputs,
    gradients and the stepped parameters within 1e-4 of their largest
    magnitude (the convolutions' and the LSQ scale sums' orders)."""
    from ppq_tpu_torch import qat
    from ppq_tpu_torch.executor import simulation_precision
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.randn(4, 3, 16, 16).astype(np.float32))
          for _ in range(3)]
    cpu = torch.device('cpu')
    with simulation_precision('highest'):
        seeded = []
        for dev in (cuda, cpu):
            model = _qat_stack(dev)
            qat.QATController().calibrate(model, [x.to(dev) for x in xs])
            seeded.append(torch.stack([m.act_scale.detach().cpu()
                                       for m in qat.qat_layers(model)]))
        assert seeded[0][0] == seeded[1][0]
        torch.testing.assert_close(seeded[0], seeded[1], rtol=1e-5, atol=0)
        state = model.state_dict()
        results = []
        for dev in (cuda, cpu):
            model = _qat_stack(dev)
            model.load_state_dict(state)
            reset_launches()
            opt = torch.optim.SGD(model.parameters(), lr=0.01)
            y = model(xs[0].to(dev))
            torch.mean(y ** 2).backward()
            grads = [p.grad.detach().cpu().clone()
                     for p in model.parameters()]
            opt.step()
            torch.cuda.synchronize()
            if dev.type == 'cuda':
                for name in ('fake_quant_tensorwise', 'fake_quant_channelwise',
                             'fake_quant_bwd_tensorwise',
                             'fake_quant_bwd_channelwise'):
                    assert LAUNCHES[name] >= 3, (name, dict(LAUNCHES))
            results.append((y.detach().cpu(), grads,
                            [p.detach().cpu() for p in model.parameters()]))
    (y_c, g_c, p_c), (y_h, g_h, p_h) = results
    for got, want in [(y_c, y_h)] + list(zip(g_c, g_h)) + list(zip(p_c, p_h)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_artifact_on_the_card_equals_the_runner(cuda, tmp_path):
    """A torch.export artifact of a card-quantized graph reloads on the
    card, launches the fake-quant kernels through the custom operators and
    equals the 'highest' runner bit for bit."""
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.utils import deploy
    torch.backends.cudnn.deterministic = True
    graph, loader = _quantized_small(cuda)
    path = str(tmp_path / 'model.pt2')
    deploy.export_compiled_artifact(graph, path, precision='highest')
    run = deploy.load_compiled_artifact(path)
    runner = compile_graph(graph, precision='highest').make_runner()
    for x in loader:
        reset_launches()
        got = run(x)[0]
        torch.cuda.synchronize()
        assert got.is_cuda and LAUNCHES['fake_quant_tensorwise'] > 0
        assert torch.equal(got, runner(x)[0])


def test_paged_engine_on_the_native_allocator_on_the_card(cuda, monkeypatch):
    """The engine's native allocator on the card: the tokens, and the block
    tables the engine uploads at every step, of the Python free list's run;
    every block back."""
    from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                       init_llama_params)
    cfg = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=1024, max_seq_len=512, max_batch=4,
               prefill_buckets=(16, 384), paged_kv=True, kv_block_size=128)
    params = init_llama_params(LlamaConfig(**cfg), seed=0)
    runs = []
    for native in ('1', '0'):
        monkeypatch.setenv('PPQ_TPU_NATIVE_ALLOC', native)
        engine = ServingEngine(LlamaConfig(**cfg), params)
        assert engine._alloc.backend == ('native' if native == '1'
                                         else 'python')
        rng = np.random.default_rng(0)
        reqs = [Request(i, [int(t) for t in rng.integers(1, 512,
                                                         size=5 + 70 * i)],
                        max_new_tokens=9) for i in range(6)]
        tables, alloc = [], engine._alloc
        read = alloc.tables
        alloc.tables = lambda: tables.append(read()) or tables[-1]
        engine.run(reqs, sync_every=4)
        assert all(r.done and len(r.generated) == 9 for r in reqs)
        assert alloc.free_blocks == alloc.num_blocks - 1
        runs.append(([r.generated for r in reqs], tables))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1]) > 0
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ tensor-parallel serving --

def test_tp_decode_on_the_card_two_ranks(cuda):
    """Two ranks share the card (gloo, collectives staged through the host)
    and serve a tp-2 engine, ragged read and paged cache: every rank takes
    the same tokens, each request's tokens are the one-card engine's up to
    a near-tie (the two candidates' one-card logits within 3e-2 of the
    largest |logit|, path D's limit), the probe logits within 3e-2, and
    the rank launched rows 8-12 and 14-16 on its shard."""
    import torch_dist_cases as cases
    from ppq_tpu_torch.parallel import spawn
    from ppq_tpu_torch.serving import (LlamaConfig, SamplingParams,
                                       ServingEngine, init_llama_params)
    base = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=1024, max_seq_len=256, max_batch=4,
                prefill_buckets=(16, 64))
    variants = [('ragged', base, [('dp', 1), ('tp', 2)], False, 4),
                ('paged', dict(base, paged_kv=True, kv_block_size=128),
                 [('dp', 1), ('tp', 2)], False, 4)]
    ranks = spawn(2, cases.serve, (variants, 7, 21, 'cuda'), device='cuda',
                  timeout=300)
    for name, fields, _, _, _ in variants:
        got = [r[name] for r in ranks]
        assert got[0]['tokens'] == got[1]['tokens']
        assert got[0]['backend'] == 'gloo' or torch.cuda.device_count() > 1
        cfg = LlamaConfig(**fields)
        one = ServingEngine(cfg, init_llama_params(cfg, seed=0),
                            sampling=SamplingParams(seed=3))
        reqs = cases._requests(7, cfg.vocab_size, 21)
        one.run(reqs, sync_every=4)
        want = cases._probe_logits(one, reqs[0].prompt)
        tol = 3e-2 * np.abs(want).max()
        np.testing.assert_allclose(got[0]['logits'], want, rtol=0, atol=tol)
        for r, b_seq in zip(reqs, got[0]['tokens']):
            for i, (a, b) in enumerate(zip(r.generated, b_seq)):
                if a != b:
                    lg = cases._probe_logits(one, r.prompt + b_seq[:i])
                    assert abs(lg[a] - lg[b]) <= 3e-2 * np.abs(lg).max()
                    break
        rows = ('qmm_int8', 'qmm_gateup', 'bank_write') + (
            ('pool_write', 'paged_attention_grouped') if name == 'paged'
            else ('window_write',))
        for g in got:
            for row in rows:
                assert g['launches'].get(row, 0) > 0, (name, row)
