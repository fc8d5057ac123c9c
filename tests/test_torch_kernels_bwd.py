"""The plain versions of the port's backward and floating kernels
(ppq_tpu_torch.kernels) held against the JAX package.

On the CPU the port's wrappers run their kernels' plain versions. Those are
held against `ppq_tpu`'s Pallas kernels in interpret mode and against its jnp
path: `dx` and the floating forward bit for bit, the LSQ sums `ds` / `do`
within a stated tolerance (they are sums taken in another order). The CUDA
kernels themselves are held against the plain versions on the card, in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.core import RoundingPolicy as JaxRounding
from ppq_tpu.kernels import (pallas_floating_quant, pallas_floating_quant_bwd,
                             pallas_linear_quant_bwd)
from ppq_tpu.quantization import qfunction as jax_qfunction
from ppq_tpu_torch.core import RoundingPolicy
from ppq_tpu_torch.kernels import (floating_quant, floating_quant_bwd,
                                   linear_quant_bwd)
from ppq_tpu_torch.kernels.quant import (_BWD_LOADS, _BWD_THREADS,
                                         channelwise_bwd_plan,
                                         linear_quant_bwd_terms)

POLICIES = list(RoundingPolicy)
MODES = {'tensor': None, 'axis0': 0, 'axis1': 1}
SHAPE = (6, 5, 7, 9)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _case(mode, asym, seed=0, shape=SHAPE):
    """Values inside the range, beyond it on both sides and on exact
    half-way ties (power-of-two scales make (k + 0.5) * s exact), with a
    random output gradient; asymmetric cases carry fractional offsets."""
    rng = np.random.RandomState(seed)
    axis = MODES[mode]
    n_scales = 1 if axis is None else shape[axis]
    scale = (2.0 ** -rng.randint(2, 8, size=n_scales)).astype(np.float32)
    offset = (rng.rand(n_scales) * 60 - 30 if asym
              else np.zeros(n_scales)).astype(np.float32)
    s_b = scale if axis is None else scale.reshape(
        [-1 if i == axis else 1 for i in range(len(shape))])
    x = (rng.randn(*shape) * 90).astype(np.float32) * s_b
    ties = (rng.randint(-150, 150, size=shape) + 0.5).astype(np.float32) * s_b
    x = np.where(rng.rand(*shape) < 0.3, ties, x).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    if axis is None:
        scale, offset = scale[0], offset[0]
    qmin, qmax = (0, 255) if asym else (-128, 127)
    return x, g, scale, offset, qmin, qmax, axis


def _assert_sums_close(got, want, x, g, s, o, qmin, qmax, policy, axis):
    """ds and do against the other package's: both are float32 sums of the
    same per-element terms in different orders, so they agree to rtol 1e-5
    of the sum plus 1e-6 of the absolute mass of the terms (which covers a
    sum that cancels)."""
    _, ds_e, do_e = linear_quant_bwd_terms(
        torch.from_numpy(x), torch.from_numpy(g), s, o, qmin, qmax, policy,
        axis)
    dims = tuple(i for i in range(x.ndim) if i != axis) if axis is not None \
        else None
    for mine, theirs, terms in zip(got, want, (ds_e, do_e)):
        mass = np.abs(terms.numpy().astype(np.float64)).sum(axis=dims)
        exact = terms.numpy().astype(np.float64).sum(axis=dims)
        mine = np.asarray(mine, np.float64)
        assert np.all(np.abs(mine - np.asarray(theirs, np.float64))
                      <= 1e-5 * np.abs(exact) + 1e-6 * mass)
        assert np.all(np.abs(mine - exact)
                      <= 1e-5 * np.abs(exact) + 1e-6 * mass)


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('policy', POLICIES, ids=lambda p: p.name)
def test_plain_bwd_vs_jnp_vjp(policy, mode, asym):
    """Against `_linear_quant_bwd`, the jnp path's custom VJP."""
    x, g, s, o, qmin, qmax, axis = _case(mode, asym)
    want = jax_qfunction._linear_quant_bwd(
        float(qmin), float(qmax), JaxRounding(policy.value), axis,
        (jnp.asarray(x), jnp.asarray(s, jnp.float32),
         jnp.asarray(o, jnp.float32)), jnp.asarray(g))
    got = linear_quant_bwd(torch.from_numpy(x), torch.from_numpy(g), s, o,
                           qmin, qmax, policy, axis)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert tuple(got[1].shape) == np.shape(s) == tuple(got[2].shape)
    _assert_sums_close(got[1:], want[1:], x, g, s, o, qmin, qmax, policy, axis)


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('policy', [RoundingPolicy.ROUND_HALF_EVEN,
                                    RoundingPolicy.ROUND_HALF_UP,
                                    RoundingPolicy.ROUND_DOWN],
                         ids=lambda p: p.name)
def test_plain_bwd_vs_pallas(policy, mode, asym):
    """Against `pallas_linear_quant_bwd` in interpret mode, tensorwise and
    channelwise on axis 0 and axis 1."""
    x, g, s, o, qmin, qmax, axis = _case(mode, asym, seed=1)
    want = pallas_linear_quant_bwd(x, g, s, o, qmin, qmax,
                                   JaxRounding(policy.value), axis)
    got = linear_quant_bwd(torch.from_numpy(x), torch.from_numpy(g), s, o,
                           qmin, qmax, policy, axis)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    _assert_sums_close(got[1:], want[1:], x, g, s, o, qmin, qmax, policy, axis)


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('shape', [(64, 64, 3, 3), (1000, 512)],
                         ids=['64x64x3x3', '1000x512'])
def test_plain_bwd_vs_pallas_at_weight_shapes(shape, asym):
    """Against `pallas_linear_quant_bwd` in interpret mode at two of path
    B's weights on axis 0: a 3x3 conv and the classifier."""
    x, g, s, o, qmin, qmax, axis = _case('axis0', asym, seed=2, shape=shape)
    policy = RoundingPolicy.ROUND_HALF_EVEN
    want = pallas_linear_quant_bwd(x, g, s, o, qmin, qmax,
                                   JaxRounding(policy.value), axis)
    got = linear_quant_bwd(torch.from_numpy(x), torch.from_numpy(g), s, o,
                           qmin, qmax, policy, axis)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert tuple(got[1].shape) == (shape[0],) == tuple(got[2].shape)
    _assert_sums_close(got[1:], want[1:], x, g, s, o, qmin, qmax, policy, axis)


# the 21 weights of the zoo ResNet-18 that path B's LSQ trains channelwise,
# as (outer, channels, inner) in memory: conv1, the 16 3x3 convs and the 3
# downsample 1x1 convs on axis 0, and the classifier, stored (512, 1000)
# with its channels on axis 1
RESNET18_WEIGHTS = ([(1, 64, 3 * 49)] + [(1, 64, 64 * 9)] * 4
                    + [(1, 128, 64 * 9), (1, 128, 128 * 9), (1, 128, 64),
                       (1, 128, 128 * 9), (1, 128, 128 * 9)]
                    + [(1, 256, 128 * 9), (1, 256, 256 * 9), (1, 256, 128),
                       (1, 256, 256 * 9), (1, 256, 256 * 9)]
                    + [(1, 512, 256 * 9), (1, 512, 512 * 9), (1, 512, 256),
                       (1, 512, 512 * 9), (1, 512, 512 * 9)]
                    + [(512, 1000, 1)])
H100_SMS = 132


def _plan_invariants(plan, channels, outer, inner, aligned):
    if inner == 1:
        assert plan.vec == 0
        blocks, rows_a_pass = -(-channels // 32), 8 * _BWD_LOADS
        passes = -(-outer // rows_a_pass)
    else:
        assert plan.vec == (4 if aligned and inner % 4 == 0 else 1)
        blocks = channels
        passes = -(-(outer * inner // plan.vec) // (_BWD_THREADS * _BWD_LOADS))
    assert 1 <= plan.splits <= 65535
    assert plan.grid == (blocks, plan.splits)
    assert plan.splits <= max(1, passes)
    if blocks * plan.splits < 2 * H100_SMS:
        # short of the card only where the blocks have no more passes
        assert plan.splits in (max(1, passes), 65535)
    if plan.splits == 1:
        assert plan.partial_floats == 0 and plan.counters == 0
    else:
        assert plan.partial_floats == 2 * channels * plan.splits
        assert plan.counters == blocks


def test_channelwise_bwd_plan_at_path_b_weights():
    """Every path-B conv weight takes one block a channel (no workspace, no
    fold), in float4s but conv1 (inner 147); the classifier, channels on
    its last axis, takes 32-channel tiles over 9 splits of its rows."""
    assert len(RESNET18_WEIGHTS) == 21
    for outer, channels, inner in RESNET18_WEIGHTS:
        plan = channelwise_bwd_plan(channels, outer, inner, True, H100_SMS)
        _plan_invariants(plan, channels, outer, inner, True)
        if inner == 1:
            assert plan == (0, 9, (32, 9), 2 * 1000 * 9, 32)
        else:
            assert plan.splits == 1
            assert plan.vec == (1 if inner == 147 else 4)


@pytest.mark.parametrize('channels,outer,inner,aligned', [
    (8, 32, 56 * 56, True),        # axis 1 of a 32x8x56x56 activation
    (64, 32, 112 * 112, True),     # axis 1 of the first ReLU's output
    (3, 6, 7 * 9, True),           # inner not a multiple of 4
    (512, 1, 4608, False),         # a view misaligned by one float
    (1, 1, 2 ** 30, True),         # one channel, a billion elements
    (1, 1, 4, True),
    (1000, 512, 1, True),          # channels on the last axis
    (33, 1, 1, False),             # a vector along its own axis
    (5, 2 ** 26, 1, True),         # one tile, many rows
    (2 ** 31 - 1, 1, 1, True),     # the grid's x at its limit
    (2 ** 31 - 1, 1, 2, True),
])
def test_channelwise_bwd_plan_edges(channels, outer, inner, aligned):
    plan = channelwise_bwd_plan(channels, outer, inner, aligned, H100_SMS)
    _plan_invariants(plan, channels, outer, inner, aligned)


def test_channelwise_bwd_plan_splits_and_refuses_grids():
    plan = channelwise_bwd_plan(8, 32, 56 * 56, True, H100_SMS)
    assert plan.vec == 4 and plan.splits == 25 and plan.counters == 8
    assert plan.partial_floats == 2 * 8 * 25
    assert channelwise_bwd_plan(1, 1, 2 ** 30, True, H100_SMS).splits == 264
    # splits capped by the grid's y
    assert channelwise_bwd_plan(1, 2 ** 30, 2, True, 10 ** 6).splits == 65535
    with pytest.raises(ValueError):
        channelwise_bwd_plan(2 ** 31, 1, 1, True, H100_SMS)
    with pytest.raises(ValueError):
        channelwise_bwd_plan(0, 1, 1, True, H100_SMS)


def test_plain_bwd_nan_is_inside_and_vector_on_its_own_axis():
    """A NaN passes the gradient (it compares false to both bounds, as in
    jnp.where), and a bias vector quantized along its own axis keeps one
    term per channel."""
    x = np.array([0.3, np.nan, 900.0, -900.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    want = jax_qfunction._linear_quant_bwd(
        -128.0, 127.0, JaxRounding.ROUND_HALF_EVEN, None,
        (jnp.asarray(x), jnp.float32(0.5), jnp.float32(0.0)), jnp.asarray(g))
    dx, ds, do = linear_quant_bwd(torch.from_numpy(x), torch.from_numpy(g),
                                  np.float32(0.5), np.float32(0.0), -128, 127)
    np.testing.assert_array_equal(_bits(dx), _bits(want[0]))
    assert np.isnan(float(ds)) and np.isnan(float(want[1]))
    assert float(do) == float(want[2]) == 3.5
    s = np.array([0.5, 0.25, 0.125, 1.0], np.float32)
    x[1] = 0.1
    dx, ds, do = linear_quant_bwd(torch.from_numpy(x), torch.from_numpy(g), s,
                                  np.zeros(4, np.float32), -128, 127,
                                  channel_axis=0)
    want = pallas_linear_quant_bwd(x, g, s, np.zeros(4, np.float32), -128,
                                   127, JaxRounding.ROUND_HALF_EVEN, 0)
    assert ds.shape == do.shape == (4,)
    np.testing.assert_array_equal(_bits(dx), _bits(want[0]))
    np.testing.assert_array_equal(_bits(ds), _bits(want[1]))
    np.testing.assert_array_equal(_bits(do), _bits(want[2]))


# ---------------------------------------------------------------- floating

LAYOUTS = {'e4m3': (4, 3, 448.0), 'e5m2': (5, 2, 57344.0),
           'e3m4': (3, 4, 15.5)}


def _float_case(e, m, qmax, shape=(6, 5, 40), seed=0):
    """Values over many binades, with mantissa ties, the range ends, values
    beyond them, subnormals of the layout and both zeros planted."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 3)).astype(np.float32)
    flat = x.reshape(-1)
    bias = (1 << (e - 1)) - 1
    min_normal = 2.0 ** (1 - bias)
    step = 2.0 ** -m
    k = np.arange(64)
    flat[:64] = (1 + (k % (1 << m)) * step + step / 2) * 2.0 ** (k % 5 - 2)
    flat[64:72] = [qmax, -qmax, qmax * 1.5, -qmax * 1.5, 0.0, -0.0,
                   np.nextafter(np.float32(qmax), np.float32(0)),
                   min_normal]
    flat[72:136] = (rng.rand(64) * 2 - 1) * min_normal
    flat[136:144] = min_normal * step * np.array(
        [0.5, 1.0, 1.5, 2.5, -0.5, -1.5, 0.49, 0.51])
    return x


# weights whose runs (inner) are not a multiple of 4: conv1 on axis 0
# (147) and the Gemm weight without transB on axis 1 (1), the runs that the
# channelwise kernel steps element by element
FLOAT_WEIGHTS = {'conv1_axis0': ((64, 3, 7, 7), 0),
                 'gemm_axis1': ((512, 1000), 1)}


@pytest.mark.parametrize('mode', list(MODES) + list(FLOAT_WEIGHTS))
@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_plain_floating_bitwise_vs_pallas(layout, mode):
    """Against `pallas_floating_quant` in interpret mode (both bodies), and
    against the jnp path's generic bit arithmetic: bit for bit."""
    e, m, qmax = LAYOUTS[layout]
    if mode in FLOAT_WEIGHTS:
        shape, axis = FLOAT_WEIGHTS[mode]
        x = _float_case(e, m, qmax, shape)
    else:
        axis = MODES[mode]
        x = _float_case(e, m, qmax)
    rng = np.random.RandomState(7)
    scale = (np.float32(0.37) if axis is None
             else (rng.rand(x.shape[axis]) + 0.2).astype(np.float32))
    for s in (scale, np.float32(1.0) if axis is None else np.ones_like(scale)):
        want = pallas_floating_quant(x, s, e, m, -qmax, qmax, axis)
        got = floating_quant(torch.from_numpy(x), s, e, m, -qmax, qmax, axis)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        s_b = jax_qfunction._broadcast_shape(jnp.asarray(s), x.ndim, axis)
        generic = jax_qfunction._generic_float_round(
            jnp.clip(jnp.asarray(x) / s_b, -qmax, qmax), e, m) * s_b
        np.testing.assert_array_equal(_bits(got), _bits(generic))


@pytest.mark.parametrize('layout', ['e4m3', 'e5m2'])
def test_plain_floating_vs_jnp_fp8_cast(layout):
    """The jnp path casts E4M3 / E5M2 through XLA's fp8 types, one correct
    rounding. The kernel (Pallas and the port alike) cuts the mantissa first
    and then snaps to the subnormal grid. The two agree bit for bit from the
    smallest normal up; below it the double rounding may land one subnormal
    step away (ROADMAP.md queue 3)."""
    e, m, qmax = LAYOUTS[layout]
    x = _float_case(e, m, qmax, seed=3)
    bias = (1 << (e - 1)) - 1
    min_normal, min_sub = 2.0 ** (1 - bias), 2.0 ** (1 - bias - m)
    want = np.asarray(jax_qfunction.floating_fake_quant(
        x, jnp.float32(1.0), e, m, -qmax, qmax))
    got = floating_quant(torch.from_numpy(x), np.float32(1.0), e, m, -qmax,
                         qmax).numpy()
    normal = np.abs(x) >= min_normal
    np.testing.assert_array_equal(_bits(got[normal]), _bits(want[normal]))
    differ = _bits(got) != _bits(want)
    assert differ.any()      # the planted 1.5- and 2.5-step subnormals
    assert np.all(np.abs(got - want)[differ] <= min_sub)


def test_plain_floating_bwd_bitwise_vs_pallas():
    x = _float_case(4, 3, 448.0, seed=5)
    x.reshape(-1)[200] = np.nan
    g = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    for s in (np.float32(1.0), np.float32(0.37)):
        want = pallas_floating_quant_bwd(x, g, s, -448.0, 448.0)
        got = floating_quant_bwd(torch.from_numpy(x), torch.from_numpy(g), s,
                                 -448.0, 448.0)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got.reshape(-1)[200]) == 0.0      # a NaN is outside


def test_floating_gradient_of_jnp_path_differs():
    """`jax.grad` through the jnp E4M3 path rounds the cotangent to E4M3; the
    kernel's backward passes it unchanged. The port follows the kernel
    (ROADMAP.md queue 3)."""
    x = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    g = np.array([1e-4, 0.3, 1.1e-3, 0.7], np.float32)
    jnp_grad = jax.grad(lambda v: jnp.sum(jax_qfunction.floating_fake_quant(
        v, jnp.float32(1.0), 4, 3, -448.0, 448.0) * g))(jnp.asarray(x))
    rounded = np.asarray(jnp.asarray(g).astype(jnp.float8_e4m3fn)
                         .astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(jnp_grad), rounded)
    assert rounded[0] == 0 and rounded[1] == 0.3125 and rounded[3] == 0.6875
    kernel = pallas_floating_quant_bwd(x, g, 1.0, -448.0, 448.0)
    port = floating_quant_bwd(torch.from_numpy(x), torch.from_numpy(g),
                              np.float32(1.0), -448.0, 448.0)
    np.testing.assert_array_equal(np.asarray(kernel), g)
    np.testing.assert_array_equal(port.numpy(), g)
