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
