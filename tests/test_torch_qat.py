"""The port's QAT layers (ppq_tpu_torch/qat.py) held against the JAX
package's flax ones (ppq_tpu/qat.py), on the CPU.

Each case starts the port's layer from the flax variables carried across
(`interop.qat_params_from_flax`), on the same seeded batches:
  * calibrate then seed: the absmax statistics and the seeded activation
    scales bit for bit;
  * three steps of plain SGD (lr 0.01) on mean(y^2), the same in both:
    the loss each step within 1e-5 relative; the gradients of the weight,
    the bias and `act_scale` at the first step within 1e-5 of their
    largest magnitude (the weight's flows through the absmax scale into
    the weight, as jax.grad takes it through jnp.max); after three steps
    the parameters within 1e-4 relative of their largest magnitude and
    `act_scale` within 1e-3 relative. The packages' matmuls and
    convolutions sum in other orders, and the LSQ scale gradient is a sum
    over every element, where one code that flips moves it by a share of
    a step (measured: gradients 1e-7-8e-6, act_scale 1.7e-4 after three
    steps of the dense case).
QConv2d runs at stride 1 and stride 2 with 'SAME' padding (flax's TF rule,
padded explicitly here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu import qat as jqat
from ppq_tpu_torch import qat as tqat
from ppq_tpu_torch.interop import qat_params_from_flax, qat_params_to_flax

LR, STEPS = 0.01, 3
LOSS_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
PARAM_ATOL_SHARE, SCALE_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(kind, stride, seed):
    """(flax model in CALIBRATE, flax model in TRAIN, the port's layer,
    batches, numpy -> flax layout)."""
    rng = np.random.RandomState(seed)
    if kind == 'linear':
        xs = [rng.randn(4, 16).astype(np.float32) for _ in range(STEPS)]
        return (jqat.QDense(features=8, mode=jqat.CALIBRATE),
                jqat.QDense(features=8, mode=jqat.TRAIN),
                tqat.QLinear(16, 8), xs, lambda a: jnp.asarray(a))
    xs = [rng.randn(2, 5, 9, 9).astype(np.float32) for _ in range(STEPS)]
    make = lambda mode: jqat.QConv(features=6, kernel_size=(3, 3),  # noqa
                                   strides=(stride, stride), mode=mode)
    return (make(jqat.CALIBRATE), make(jqat.TRAIN),
            tqat.QConv2d(5, 6, 3, stride=stride), xs,
            lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)))


def _grads(layer, kind):
    """The port's gradients in the flax tree's layout."""
    w = layer.weight.grad.numpy()
    w = w.transpose(2, 3, 1, 0) if kind == 'conv' else w.T
    g = {'act_scale': layer.act_scale.grad.numpy()}
    if kind == 'conv':
        g['conv'] = {'kernel': w, 'bias': layer.bias.grad.numpy()}
    else:
        g.update(kernel=w, bias=layer.bias.grad.numpy())
    return g


def _close(got, want, atol_share, rtol=0.0, what=''):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_share * max(np.abs(w).max(), 1e-30),
            err_msg=f'{what} {jax.tree_util.keystr(path)}')


@pytest.mark.parametrize('kind,stride', [('linear', 1), ('conv', 1),
                                         ('conv', 2)])
def test_qat_layer_matches_flax(kind, stride):
    j_cal, j_train, layer, xs, to_jax = _case(kind, stride, seed=stride)
    variables = j_cal.init(jax.random.PRNGKey(stride), to_jax(xs[0]))
    qat_params_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                         {'': layer})
    # jitted calls: the same arithmetic as the eager ones, one compile
    calibrate = jax.jit(lambda v, b: j_cal.apply(v, b, mutable=['qat_stats']))
    seeded = jqat.QATController().calibrate(
        lambda v, b, mutable: calibrate(v, b), variables,
        [to_jax(x) for x in xs])
    tqat.QATController().calibrate(layer, [torch.from_numpy(x) for x in xs])
    assert layer.mode == tqat.TRAIN
    carried = qat_params_to_flax({'': layer})
    np.testing.assert_array_equal(carried['qat_stats']['absmax'],
                                  np.asarray(seeded['qat_stats']['absmax']))
    np.testing.assert_array_equal(carried['params']['act_scale'],
                                  np.asarray(seeded['params']['act_scale']))

    params, stats = seeded['params'], seeded['qat_stats']

    def loss_jax(p, x):
        y = j_train.apply({'params': p, 'qat_stats': stats}, x)
        return jnp.mean(y ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_jax))
    opt = torch.optim.SGD(layer.parameters(), lr=LR)
    for step, x in enumerate(xs):
        want_loss, want_grads = value_and_grad(params, to_jax(x))
        opt.zero_grad()
        y = layer(torch.from_numpy(x))
        if kind == 'conv':
            assert y.shape == (2, 6, -(-9 // stride), -(-9 // stride))
        loss = torch.mean(y ** 2)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=LOSS_RTOL)
        if step == 0:
            _close(_grads(layer, kind), want_grads, GRAD_ATOL_SHARE,
                   what='gradient')
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                        want_grads)
        opt.step()
    got = qat_params_to_flax({'': layer})['params']
    np.testing.assert_allclose(got['act_scale'], np.asarray(
        params['act_scale']), rtol=SCALE_RTOL)
    got.pop('act_scale')
    params = dict(params)
    params.pop('act_scale')
    _close(got, params, PARAM_ATOL_SHARE, what='after 3 steps')


def test_calibrate_mode_passes_through_and_records():
    """CALIBRATE returns the input as it is and keeps the running absmax;
    TRAIN quantizes it with act_scale (at least 1e-8)."""
    layer = tqat.QLinear(4, 2, mode=tqat.CALIBRATE)
    x = torch.tensor([[0.5, -3.0, 1.0, 2.0]])
    with torch.no_grad():
        layer(x)
        layer(x * 0.5)
    assert float(layer.absmax) == 3.0
    tqat.QATController().seed_scales(layer)
    assert float(layer.act_scale) == np.float32(3.0) / np.float32(127)
    with pytest.raises(ValueError):
        tqat.QLinear(4, 2, mode='eval')
    with pytest.raises(ValueError):
        tqat.QConv2d(4, 2, padding='FULL')
