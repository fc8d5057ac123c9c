"""The port's differentiable fake-quant functions and its DirectMSE observer
(ppq_tpu_torch.quantization) held against the JAX package, on the CPU.

`torch.autograd.grad` through the port's `linear_fake_quant` against
`jax.grad` through `ppq_tpu`'s: `dx` bit for bit, `dscale` / `doffset` as sums
in another order. Dynamic fake-quant and `linear_recover_codes` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.core import RoundingPolicy as JaxRounding
from ppq_tpu.core import TensorQuantizationConfig as JaxTQC
from ppq_tpu.core import QuantizationPolicy as JaxPolicy
from ppq_tpu.core import QuantizationProperty as JQP
from ppq_tpu.core import QuantizationStates as JaxStates
from ppq_tpu.quantization import observers as jax_observers
from ppq_tpu.quantization import qfunction as jq
from ppq_tpu_torch.core import (QuantizationPolicy, QuantizationProperty as QP,
                                QuantizationStates, RoundingPolicy,
                                TensorQuantizationConfig)
from ppq_tpu_torch.kernels import LAUNCHES
from ppq_tpu_torch.quantization import observers, qfunction as tq


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

SHAPE = (4, 6, 5, 7)
MODES = {'tensor': None, 'axis0': 0, 'axis1': 1}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _case(mode, asym, seed=0):
    rng = np.random.RandomState(seed)
    axis = MODES[mode]
    n = 1 if axis is None else SHAPE[axis]
    scale = (rng.rand(n) * 0.05 + 0.01).astype(np.float32)
    offset = (rng.rand(n) * 60 - 30 if asym else np.zeros(n)).astype(np.float32)
    s_b = scale if axis is None else scale.reshape(
        [-1 if i == axis else 1 for i in range(len(SHAPE))])
    x = (rng.randn(*SHAPE) * 90).astype(np.float32) * s_b
    w = rng.randn(*SHAPE).astype(np.float32)
    if axis is None:
        scale, offset = scale.reshape(()), offset.reshape(())
    return x, w, scale, offset, ((0, 255) if asym else (-128, 127)), axis


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('policy', [RoundingPolicy.ROUND_HALF_EVEN,
                                    RoundingPolicy.ROUND_HALF_UP,
                                    RoundingPolicy.ROUND_HALF_TOWARDS_ZERO],
                         ids=lambda p: p.name)
def test_linear_fake_quant_grad_vs_jax(policy, mode, asym):
    """loss = sum(fake_quant(x, s, o) * w): gradients in x, s and o."""
    x, w, s, o, (qmin, qmax), axis = _case(mode, asym)
    want_y, want = jax.value_and_grad(
        lambda x_, s_, o_: jnp.sum(jq.linear_fake_quant(
            x_, s_, o_, qmin, qmax, JaxRounding(policy.value), axis) * w),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(o))
    xt, st, ot = (torch.tensor(v, requires_grad=True) for v in (x, s, o))
    y = tq.linear_fake_quant(xt, st, ot, qmin, qmax, policy, axis)
    loss = torch.sum(y * torch.from_numpy(w))
    got = torch.autograd.grad(loss, (xt, st, ot))
    np.testing.assert_allclose(float(loss.detach()), float(want_y), rtol=1e-5)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert got[1].shape == st.shape and got[2].shape == ot.shape
    # sums of the same float32 terms in another order: rtol 1e-4 of the
    # largest gradient (a channel whose terms cancel has a small sum)
    for mine, theirs in zip(got[1:], want[1:]):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4,
                                   atol=1e-4 * np.abs(theirs).max())


def test_linear_fake_quant_needs_input_grad_cases():
    """Only the gradients asked for come back; without any, the call is the
    plain forward and records nothing."""
    x, w, s, o, (qmin, qmax), axis = _case('axis1', True, seed=1)
    xt, st, ot = (torch.tensor(v) for v in (x, s, o))
    y = tq.linear_fake_quant(xt, st, ot, qmin, qmax, channel_axis=axis)
    assert not y.requires_grad and y.grad_fn is None
    ref = y.clone()
    for wanted in ((True, False, False), (False, True, False),
                   (False, False, True), (True, True, True)):
        leaves = [t.clone().requires_grad_(flag)
                  for t, flag in zip((xt, st, ot), wanted)]
        y = tq.linear_fake_quant(*leaves, qmin, qmax, channel_axis=axis)
        assert torch.equal(y.detach(), ref)
        torch.sum(y * torch.from_numpy(w)).backward()
        for leaf, flag in zip(leaves, wanted):
            assert (leaf.grad is not None) == flag
            if flag:
                assert leaf.grad.shape == leaf.shape
    with torch.no_grad():
        leaves = [t.clone().requires_grad_(True) for t in (xt, st, ot)]
        y = tq.linear_fake_quant(*leaves, qmin, qmax, channel_axis=axis)
        assert y.grad_fn is None
    # host numbers and numpy scales still work beside a tensor that needs a
    # gradient
    xg = xt.clone().requires_grad_(True)
    y = tq.linear_fake_quant(xg, s, o, qmin, qmax, channel_axis=axis)
    y.sum().backward()
    assert xg.grad.shape == xg.shape


def test_linear_fake_quant_gradient_through_a_chain():
    """The Function composes: d/dw of a second fake-quant applied to
    conv-like arithmetic on the first, against jax.grad."""
    rng = np.random.RandomState(2)
    x = rng.randn(8, 16).astype(np.float32)
    w = (rng.randn(16, 4) * 0.2).astype(np.float32)
    sw = (np.abs(w).max(0) / 127).astype(np.float32)

    def jax_loss(w_, sw_, sa_):
        wq = jq.linear_fake_quant(w_, sw_, jnp.zeros_like(sw_), -128, 127,
                                  channel_axis=1)
        a = jq.linear_fake_quant(jnp.asarray(x) @ wq, sa_, jnp.float32(0),
                                 -128, 127)
        return jnp.mean(a ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(sw), jnp.float32(0.05))
    wt = torch.tensor(w, requires_grad=True)
    swt = torch.tensor(sw, requires_grad=True)
    sat = torch.tensor(np.float32(0.05), requires_grad=True)
    wq = tq.linear_fake_quant(wt, swt, torch.zeros_like(swt), -128, 127,
                              channel_axis=1)
    a = tq.linear_fake_quant(torch.from_numpy(x) @ wq, sat,
                             torch.zeros(()), -128, 127)
    got = torch.autograd.grad(torch.mean(a ** 2), (wt, swt, sat))
    # the matmuls sum in other orders: rtol 1e-4 of each gradient's largest
    for mine, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4,
                                   atol=1e-4 * np.abs(theirs).max())


@pytest.mark.parametrize('symmetric', [True, False], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
def test_dynamic_fake_quant_bitwise_vs_jax(mode, symmetric):
    x, _, _, _, _, axis = _case(mode, False, seed=3)
    qmin, qmax = (-128, 127) if symmetric else (0, 255)
    want = jq.dynamic_linear_fake_quant(jnp.asarray(x), qmin, qmax, symmetric,
                                        JaxRounding.ROUND_HALF_EVEN, axis)
    got = tq.dynamic_linear_fake_quant(torch.from_numpy(x), qmin, qmax,
                                       symmetric, RoundingPolicy.ROUND_HALF_EVEN,
                                       axis)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('asym', [False, True], ids=['sym', 'asym'])
@pytest.mark.parametrize('mode', list(MODES))
def test_linear_recover_codes_bitwise_vs_jax(mode, asym):
    x, _, s, o, (qmin, qmax), axis = _case(mode, asym, seed=4)
    fq = np.array(jq.linear_fake_quant(x, s, o, qmin, qmax,
                                       channel_axis=axis))
    want = jq.linear_recover_codes(fq, s, o, qmin, qmax, axis)
    got = tq.linear_recover_codes(torch.from_numpy(fq), s, o, qmin, qmax, axis)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    codes = tq.linear_quant_codes(torch.from_numpy(x), s, o, qmin, qmax,
                                  channel_axis=axis)
    np.testing.assert_array_equal(_bits(got), _bits(codes))


def test_floating_fake_quant_autograd():
    """dx is the kernel's STE; dscale, by plain reductions, agrees with a
    central difference of the loss where no value changes its grid point."""
    rng = np.random.RandomState(5)
    x = (rng.randn(64, 32) * 40).astype(np.float32)
    x[0, :4] = [500.0, -500.0, 448.0, 1e-4]
    w = rng.randn(64, 32).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(np.float32(1.0), requires_grad=True)
    y = tq.floating_fake_quant(xt, st, 4, 3, -448.0, 448.0)
    dx, ds = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), (xt, st))
    inside = np.abs(x) <= 448.0
    np.testing.assert_array_equal(dx.numpy(), np.where(inside, w, 0))
    q = y.detach().numpy().astype(np.float64)
    want = np.sum(w * (q - np.where(inside, x, 0)))
    np.testing.assert_allclose(float(ds), want, rtol=1e-4)
    # no gradient recorded: plain forward; channelwise gradient: refused
    with torch.no_grad():
        assert tq.floating_fake_quant(xt, st, 4, 3, -448.0, 448.0).grad_fn is None
    with pytest.raises(NotImplementedError):
        tq.floating_fake_quant(xt, torch.ones(64), 4, 3, -448.0, 448.0,
                               channel_axis=0)


def _fp8_cfgs():
    kw = dict(num_of_bits=8, quant_min=-448.0, quant_max=448.0,
              exponent_bits=4, observer_algorithm='floating')
    jc = JaxTQC(policy=JaxPolicy(JQP.PER_TENSOR | JQP.FLOATING | JQP.SYMMETRICAL),
                rounding=JaxRounding.ROUND_HALF_EVEN,
                state=JaxStates.INITIAL, **kw)
    tc = TensorQuantizationConfig(
        policy=QuantizationPolicy(QP.PER_TENSOR | QP.FLOATING | QP.SYMMETRICAL),
        rounding=RoundingPolicy.ROUND_HALF_EVEN,
        state=QuantizationStates.INITIAL, **kw)
    return jc, tc


@pytest.mark.parametrize('spread', [1e-3, 0.05, 1.0, 30.0, 3000.0])
def test_direct_mse_observer_picks_the_same_scale(spread):
    """Same samples, same 17 candidates, same first-best tie rule: weights
    and activations of very different magnitudes end on the same scale."""
    rng = np.random.RandomState(int(spread * 1000) % 97)
    batches = [(rng.randn(3, 50, 41) * spread).astype(np.float32)
               for _ in range(3)]
    jc, tc = _fp8_cfgs()
    jo, to = jax_observers.DirectMSEObserver(jc), observers.DirectMSEObserver(tc)
    for b in batches:
        jo.observe(b)
        to.observe(torch.from_numpy(b))
    jo.render_quantization_config()
    to.render_quantization_config()
    assert float(tc.scale) == float(jc.scale)
    assert tc.state.name == jc.state.name == 'ACTIVATED'


@pytest.mark.parametrize('shape,jax_stride,stride', [
    ((3, 50, 41), 1, 1), ((2, 64, 16, 16), 8, 9), ((4, 128, 768), 96, 97),
    ((32, 128, 768), 768, 769), ((8, 4096), 8, 9), ((2, 4096, 64), 128, 129),
    ((2, 5, 6, 7), 1, 1), ((4, 96, 77), 7, 8)])
def test_direct_mse_sample_reads_every_channel(shape, jax_stride, stride):
    """Queue 3, item 36: the JAX package samples every (size // 4096)-th
    element, which reads only last / gcd(stride, last) positions of the
    last axis (one channel of BERT-base's [32, 128, 768] activations); the
    port takes the next stride coprime with the last axis, and its sample
    reads every position. Where the JAX stride is coprime already, the two
    samples are the same elements."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jc, tc = _fp8_cfgs()
    jo, to = jax_observers.DirectMSEObserver(jc), observers.DirectMSEObserver(tc)
    jo.observe(x)
    to.observe(torch.from_numpy(x))
    flat = x.reshape(-1)
    np.testing.assert_array_equal(np.asarray(jo._samples[0]),
                                  flat[::jax_stride][:4096])
    np.testing.assert_array_equal(to._samples[0].numpy(),
                                  flat[::stride][:4096])
    assert observers.sample_stride(torch.from_numpy(x)) == stride
    columns = np.arange(0, flat.size, stride)[:4096] % shape[-1]
    assert len(set(columns)) == min(shape[-1], columns.size)
    jax_columns = np.arange(0, flat.size, jax_stride)[:4096] % shape[-1]
    assert len(set(jax_columns)) == shape[-1] // np.gcd(jax_stride, shape[-1])
    assert (stride == jax_stride) == (np.gcd(jax_stride, shape[-1]) == 1)


def test_ppq_fake_quant_dispatch_vs_jax():
    """The floating and dynamic branches of ppq_fake_quant and
    fake_quant_np."""
    rng = np.random.RandomState(6)
    x = (rng.randn(5, 33) * 20).astype(np.float32)
    jc, tc = _fp8_cfgs()
    for c, states in ((jc, JaxStates), (tc, QuantizationStates)):
        c.scale, c.offset, c.state = np.float32(0.5), np.float32(0), states.ACTIVATED
    before = dict(LAUNCHES)
    want = np.asarray(jq.ppq_fake_quant(jnp.asarray(x), jc))
    np.testing.assert_array_equal(
        _bits(tq.ppq_fake_quant(torch.from_numpy(x), tc)), _bits(want))
    np.testing.assert_array_equal(_bits(tq.fake_quant_np(x, tc)),
                                  _bits(jq.fake_quant_np(x, jc)))
    kw = dict(num_of_bits=8, quant_min=-128, quant_max=127,
              observer_algorithm='minmax')
    jd = JaxTQC(policy=JaxPolicy(JQP.PER_TENSOR | JQP.LINEAR | JQP.SYMMETRICAL
                                 | JQP.DYNAMIC),
                rounding=JaxRounding.ROUND_HALF_EVEN,
                state=JaxStates.ACTIVATED, **kw)
    td = TensorQuantizationConfig(
        policy=QuantizationPolicy(QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL
                                  | QP.DYNAMIC),
        rounding=RoundingPolicy.ROUND_HALF_EVEN,
        state=QuantizationStates.ACTIVATED, **kw)
    want = np.asarray(jq.ppq_fake_quant(jnp.asarray(x), jd))
    np.testing.assert_array_equal(
        _bits(tq.ppq_fake_quant(torch.from_numpy(x), td)), _bits(want))
    np.testing.assert_array_equal(_bits(tq.fake_quant_np(x, td)), _bits(want))
    # on the CPU no wrapper counts a launch: the plain versions ran
    assert dict(LAUNCHES) == before
