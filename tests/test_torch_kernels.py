"""The port's kernels (ppq_tpu_torch.kernels) held against the JAX package.

On the CPU the port's wrappers run their kernels' plain versions; those are
held against `ppq_tpu`'s jnp path (bit for bit), against its Pallas kernels
in interpret mode, and against the observers' `jnp.bincount` (exact
counts). The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.core import RoundingPolicy as JaxRounding
from ppq_tpu.kernels import pallas_histogram, pallas_linear_quant
from ppq_tpu.quantization import qfunction as jax_qfunction
from ppq_tpu_torch.core import RoundingPolicy
from ppq_tpu_torch.kernels import histogram, linear_quant

POLICIES = list(RoundingPolicy)
MODES = {'tensor': None, 'axis0': 0, 'axis1': 1}
SHAPE = (6, 5, 7, 9)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _case(mode, asym, seed=0, pow2=True):
    """Inputs with exact half-way ties planted (scales are powers of two
    there, so (k + 0.5) * s is exact), values beyond the clip range, and
    random values; asymmetric cases carry fractional offsets, which the
    functions round."""
    rng = np.random.RandomState(seed)
    axis = MODES[mode]
    n_scales = 1 if axis is None else SHAPE[axis]
    if pow2:
        scale = 2.0 ** -rng.randint(2, 8, size=n_scales)
    else:
        scale = rng.rand(n_scales) * 0.05 + 0.003
    scale = scale.astype(np.float32)
    offset = (rng.rand(n_scales) * 60 - 30 if asym
              else np.zeros(n_scales)).astype(np.float32)
    s_b = scale if axis is None else scale.reshape(
        [-1 if i == axis else 1 for i in range(len(SHAPE))])
    x = (rng.randn(*SHAPE) * 60).astype(np.float32) * s_b
    ties = (rng.randint(-150, 150, size=SHAPE) + 0.5).astype(np.float32) * s_b
    pick = rng.rand(*SHAPE) < 0.3
    x = np.where(pick, ties, x).astype(np.float32)
    if axis is None:
        scale, offset = scale[0], offset[0]
    qmin, qmax = (0, 255) if asym else (-128, 127)
    return x, scale, offset, qmin, qmax, axis


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('policy', POLICIES, ids=lambda p: p.name)
def test_plain_fake_quant_bitwise_vs_jnp(policy, mode, asym):
    x, s, o, qmin, qmax, axis = _case(mode, asym)
    want = jax_qfunction.linear_fake_quant(
        x, s, o, qmin, qmax, JaxRounding(policy.value), channel_axis=axis)
    got = linear_quant(torch.from_numpy(x), s, o, qmin, qmax, policy, axis)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('policy', [RoundingPolicy.ROUND_HALF_EVEN,
                                    RoundingPolicy.ROUND_HALF_TOWARDS_ZERO],
                         ids=lambda p: p.name)
def test_plain_codes_and_nan_vs_jnp(policy, mode):
    x, s, o, qmin, qmax, axis = _case(mode, True, seed=1, pow2=False)
    x.reshape(-1)[::17] = np.nan
    want = jax_qfunction.linear_quant_codes(
        x, s, o, qmin, qmax, JaxRounding(policy.value), channel_axis=axis)
    got = linear_quant(torch.from_numpy(x), s, o, qmin, qmax, policy, axis,
                       codes=True)
    # a NaN stays a NaN through the clip, as in jnp.clip
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('policy', POLICIES, ids=lambda p: p.name)
def test_plain_vs_pallas_tensorwise(policy):
    """Pallas's tensorwise kernel multiplies by 1/s (quant.py:67-68). With a
    power-of-two scale 1/s is exact and the two agree bit for bit; with
    another scale they may differ, by one step, only where x * (1/s) and
    x / s are different floats (ROADMAP.md queue 3)."""
    for pow2 in (True, False):
        x, s, o, qmin, qmax, _ = _case('tensor', True, seed=2, pow2=pow2)
        want = np.asarray(pallas_linear_quant(
            x, s, o, qmin, qmax, JaxRounding(policy.value)))
        got = linear_quant(torch.from_numpy(x), s, o, qmin, qmax,
                           policy).numpy()
        differ = _bits(got) != _bits(want)
        if pow2:
            assert not differ.any()
        inv = np.float32(1) / np.float32(s)
        quotient_differs = (x * inv) != (x / np.float32(s))
        assert not (differ & ~quotient_differs).any()
        np.testing.assert_allclose(got[differ], want[differ], rtol=0,
                                   atol=float(s) * 1.0001)


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', ['axis0', 'axis1'])
def test_plain_vs_pallas_channelwise(mode, asym):
    x, s, o, qmin, qmax, axis = _case(mode, asym, seed=3, pow2=False)
    for policy in (RoundingPolicy.ROUND_HALF_EVEN, RoundingPolicy.ROUND_DOWN):
        want = pallas_linear_quant(x, s, o, qmin, qmax,
                                   JaxRounding(policy.value), axis)
        got = linear_quant(torch.from_numpy(x), s, o, qmin, qmax, policy, axis)
        np.testing.assert_array_equal(_bits(got), _bits(want))


# the channelwise layouts of the path's weights that the kernel walks
# another way: conv1 on axis 0 (inner 147), a bias (inner 1) and the Gemm
# weight without transB on axis 1 (inner 1)
CHANNEL_LAYOUTS = [((16, 3, 7, 7), 0), ((24,), 0), ((12, 40), 1)]


@pytest.mark.parametrize('shape,axis', CHANNEL_LAYOUTS,
                         ids=['inner147', 'bias', 'gemm_axis1'])
def test_plain_channelwise_layouts_bitwise_vs_jnp(shape, axis):
    rng = np.random.RandomState(6)
    c = shape[axis]
    scale = (rng.rand(c) * 0.05 + 0.003).astype(np.float32)
    offset = (rng.rand(c) * 60 - 30).astype(np.float32)
    s_b = scale.reshape([-1 if i == axis else 1 for i in range(len(shape))])
    x = ((rng.randn(*shape) * 60).astype(np.float32) * s_b).astype(np.float32)
    ties = (rng.randint(-150, 150, size=shape) + 0.5).astype(np.float32) * s_b
    x = np.where(rng.rand(*shape) < 0.3, ties, x).astype(np.float32)
    x.reshape(-1)[::13] = np.nan
    for policy in (RoundingPolicy.ROUND_HALF_EVEN, RoundingPolicy.ROUND_UP):
        for codes in (False, True):
            fn = (jax_qfunction.linear_quant_codes if codes
                  else jax_qfunction.linear_fake_quant)
            want = fn(x, scale, offset, 0, 255, JaxRounding(policy.value),
                      channel_axis=axis)
            got = linear_quant(torch.from_numpy(x), scale, offset, 0, 255,
                               policy, axis, codes=codes)
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _hist_input(n=40_000, seed=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 2).astype(np.float32)
    x[rng.rand(n) < 0.3] = 0.0        # a post-ReLU-like spike at bin 0
    x[:5] = [40.0, -40.0, np.inf, -np.inf, 1e30]
    return x


@pytest.mark.parametrize('absolute', [True, False], ids=['abs', 'signed'])
@pytest.mark.parametrize('bins', [2048, 4096])
def test_plain_histogram_vs_pallas(bins, absolute):
    x = _hist_input()
    scale = float(np.abs(x[5:]).max()) / bins
    want = np.asarray(pallas_histogram(x, scale, bins, absolute=absolute))
    got = histogram(torch.from_numpy(x), scale, bins, absolute=absolute)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# csrc/histogram.cu `bin_fast`, step by step in float32: the kernel is
# built with -fmad=false, so each of its operations rounds once, as numpy's
# float32 operations do. Keep it in step with the kernel.
def _product_bin(v, scale, bins, absolute, fallback=True):
    """The kernel's bin of each value: the integer part of fl(v * fl(1 /
    scale)), and the IEEE quotient's where the product lies within 2^-21 of
    itself from an integer (`fallback`)."""
    f = np.float32
    w = np.abs(v) if absolute else v
    with np.errstate(invalid='ignore', over='ignore'):
        p = np.minimum(np.fmax(w * (f(1) / f(scale)), f(0)), f(bins))
        t = p + f(12582912)                    # 1.5 * 2^23
        n = t - f(12582912)
        idx = t.view(np.int32).astype(np.int64) - 0x4B400000 - (n > p)
        near = (n >= 1) & (n < bins) & (np.abs(p - n) <= p * f(2.0 ** -21))
        quotient = np.nan_to_num(np.trunc(w / f(scale)), nan=0.0)
        ieee = np.clip(quotient, 0, bins - 1).astype(np.int64)
    return np.where(near & fallback, ieee, np.minimum(idx, bins - 1))


def _next_to_every_edge(scale, bins, width):
    """Every bin edge k * scale (rounded to float32 from float32 and from
    float64) and the `width` floats below and above each."""
    k = np.arange(1, bins + 1)
    centers = np.concatenate([k.astype(np.float32) * np.float32(scale),
                              (k * np.float64(scale)).astype(np.float32)])
    out, up, down = [centers], centers.copy(), centers.copy()
    for _ in range(width):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(0))
        out += [up, down]
    return np.concatenate(out)


@pytest.mark.parametrize('bins', [2048, 4096])
def test_product_bin_equals_the_jax_bin_value_by_value(bins):
    """The kernel's product bin against the JAX kernel's index,
    `clip((v / scale).astype(int32), 0, bins - 1)`, one value at a time:
    every float within 8 steps of every bin edge at 13 scales, and random
    values with NaN, infinities and negatives. Without the fallback to the
    quotient the same floats do disagree, so they reach the hard cases."""
    rng = np.random.RandomState(14)
    scales = [11.2 / bins, 0.0371, 2.0 ** -7, 3.0, 0.1234567, 1e-30, 7e29,
              *(10.0 ** rng.uniform(-6, 6, 6))]
    without_fallback = 0
    for scale in scales:
        scale = float(np.float32(scale))
        v = _next_to_every_edge(scale, bins, 8)
        spread = (rng.randn(20_000) * scale * bins / 3).astype(np.float32)
        spread[::97], spread[1::89], spread[2::83] = np.nan, np.inf, -np.inf
        for x in (v, -v, spread):
            for absolute in (True, False):
                xj = jnp.asarray(x)
                xj = jnp.abs(xj) if absolute else xj
                want = np.asarray(jnp.clip((xj / scale).astype(jnp.int32),
                                           0, bins - 1))
                got = _product_bin(x, scale, bins, absolute)
                np.testing.assert_array_equal(got, want)
                without_fallback += int(np.sum(
                    _product_bin(x, scale, bins, absolute, False) != want))
    assert without_fallback > 0


def test_plain_histogram_vs_observer_bincount_and_accumulates():
    """The KL observers' formula (quantization/observers.py:167-169), and
    counts added into a running int64 histogram."""
    bins = 4096
    x = _hist_input(seed=5)
    scale = float(np.abs(x[5:]).max()) / bins
    idx = jnp.clip((jnp.abs(jnp.asarray(x)) / scale).astype(jnp.int32),
                   0, bins - 1)
    want = np.asarray(jnp.bincount(idx, length=bins), np.int64)
    running = torch.full((bins,), 7, dtype=torch.int64)
    got = histogram(torch.from_numpy(x), scale, bins, out=running)
    assert got is running
    np.testing.assert_array_equal(got.numpy(), want + 7)
