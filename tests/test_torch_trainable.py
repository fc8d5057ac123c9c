"""The port's trainable compiled forward (`CompiledGraph.build_trainable_
forward`, executor/compile.py) held against the JAX package's on the CPU:
outputs, and gradients in every float parameter and in every root TQC's
scale and offset, against `jax.grad` through the JAX package's
`build_trainable_forward`.

tiny_cnn at 2x3x32x32 quantized by the JAX package under TPU_INT8
(channelwise weights, tensorwise activations), METAX_INT8_T (tensorwise
weights) and TPU_FP8 (E4M3, tensorwise), and ResNet-18 at the same shape
under TPU_INT8 (its 21 convolutions and 20 activation roots; the other two
platforms at ResNet-18 would add ~50 s under the suite); the port's graph of
the same seeded model carries the same TQCs (`ppq_tpu_torch.interop`). The
JAX package's FP8 sites run through its Pallas floating kernels in
interpret mode (forward and STE backward), as tests/test_torch_training.py
runs them; its linear sites through its jnp path, which its Pallas kernels
equal.

Tolerances. Outputs: rtol 1e-4 of the largest |output|. Gradients: each
within 1e-3 of its largest element (absolute) plus rtol 1e-3, as
test_torch_training.py holds a block's step-0 gradient; the two frameworks
sum convolutions in other orders, and a quantization code next to a
rounding tie may fall the other way, which moves a few elements of a
gradient by one step's worth.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.executor import compile as jax_compile
from ppq_tpu.executor.compile import CompiledGraph as JaxCompiledGraph
from ppq_tpu.executor.compile import _cfg_key as jax_cfg_key
from ppq_tpu.zoo import resnet18 as jax_resnet18
from ppq_tpu.zoo.vision import tiny_cnn as jax_tiny_cnn
from ppq_tpu_torch.api import QuantizationSettingFactory
from ppq_tpu_torch.executor.compile import CompiledGraph
from ppq_tpu_torch.executor.compile import _cfg_key
from ppq_tpu_torch.interop import (load_quantization_configs,
                                   quantization_configs_of)
from ppq_tpu_torch.quantization.optim import training as torch_training
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18
from ppq_tpu_torch.zoo import tiny_cnn as torch_tiny_cnn
from test_torch_training import _kernel_floating_fake_quant

SHAPE = (2, 3, 32, 32)
MODELS = {'tiny_cnn': (jax_tiny_cnn, torch_tiny_cnn),
          'resnet18': (jax_resnet18, torch_resnet18)}
PLATFORMS = ['TPU_INT8', 'METAX_INT8_T', 'TPU_FP8']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader():
    rng = np.random.RandomState(11)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(2)]


_PAIRS = {}


def _pair(model, platform):
    """The JAX graph quantized by the JAX package and the port's graph of
    the same seeded model carrying its TQCs; built once per module."""
    key = (model, platform)
    if key not in _PAIRS:
        jbuild, tbuild = MODELS[model]
        fp8 = platform == 'TPU_FP8'
        jg = jbuild(input_shape=list(SHAPE))
        ppq_tpu.quantize_graph(
            jg, _loader(), calib_steps=2,
            platform=ppq_tpu.TargetPlatform[platform],
            setting=JaxSettings.fp8_setting() if fp8 else None,
            verbose=False)
        tg = tbuild(input_shape=list(SHAPE))
        ppq_tpu_torch.quantize_graph(
            tg, _loader(), calib_steps=2,
            platform=ppq_tpu_torch.TargetPlatform[platform],
            setting=QuantizationSettingFactory.fp8_setting() if fp8
            else None, verbose=False, device='cpu')
        load_quantization_configs(tg, quantization_configs_of(jg))
        with torch_training._unbaked_parameters(tg):
            pass
        _PAIRS[key] = (jg, tg)
    return _PAIRS[key]


def _close(mine, theirs, what):
    theirs = np.asarray(theirs, np.float64)
    mine = np.zeros_like(theirs) if mine is None \
        else mine.detach().numpy().astype(np.float64)
    assert mine.shape == theirs.shape, what
    np.testing.assert_allclose(mine, theirs, rtol=1e-3,
                               atol=1e-3 * np.abs(theirs).max(), err_msg=what)


@pytest.mark.parametrize('model,platform',
                         [('tiny_cnn', p) for p in PLATFORMS]
                         + [('resnet18', 'TPU_INT8')])
def test_trainable_forward_outputs_and_gradients_vs_jax(model, platform,
                                                        monkeypatch):
    if platform == 'TPU_FP8':
        monkeypatch.setattr(jax_compile, 'floating_fake_quant',
                            _kernel_floating_fake_quant)
    jg, tg = _pair(model, platform)
    jg, tg = copy.deepcopy(jg), copy.deepcopy(tg)
    x = _loader()[1]
    name = list(jg.inputs)[0]
    with ppq_tpu.quantization.optim.training._unbaked_parameters(jg), \
            torch_training._unbaked_parameters(tg):
        jcg = JaxCompiledGraph(jg)
        jfwd = jcg.build_trainable_forward()
        p0, q0 = jcg.init_params(), jcg.init_qparams()
        want = np.asarray(jfwd(p0, q0, {name: jnp.asarray(x)})[0])
        cot = np.random.default_rng(3).standard_normal(want.shape) \
            .astype(np.float32)

        def loss(p, q):
            return jnp.sum(jfwd(p, q, {name: jnp.asarray(x)})[0] * cot)

        gp, gq = jax.grad(loss, argnums=(0, 1))(p0, q0)

        cg = CompiledGraph(tg, device='cpu')
        fwd = cg.build_trainable_forward()
        params = {k: v.clone().requires_grad_(True)
                  for k, v in cg.init_params().items()}
        qparams = {k: {kk: vv.clone().requires_grad_(True)
                       for kk, vv in v.items()}
                   for k, v in cg.init_qparams().items()}
        out = fwd(params, qparams, {name: torch.from_numpy(x)})[0]
        assert out.requires_grad
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        torch.sum(out * torch.from_numpy(cot)).backward()

    assert sorted(params) == sorted(p0)
    for k, v in params.items():
        _close(v.grad, gp[k], k)
    pairs = {}
    for jop, top in zip(jg.topological_sort(), tg.topological_sort()):
        assert jop.name == top.name
        if not hasattr(jop, 'config'):
            continue
        for jc, tc in zip(jop.config, top.config):
            jk, tk = jax_cfg_key(jc.dominated_by), _cfg_key(tc.dominated_by)
            assert (jk in gq) == (tk in qparams)
            if jk in gq:
                pairs[jk] = tk
    assert len(pairs) == len(gq) == len(qparams) > 0
    floating = {_cfg_key(c.dominated_by) for op in tg.operations.values()
                if hasattr(op, 'config') for c in op.config
                if c.dominated_by.policy.floating}
    moved = 0
    for jk, tk in pairs.items():
        _close(qparams[tk]['offset'].grad, gq[jk]['offset'], f'{tk} offset')
        if tk in floating:
            # the JAX package's floating kernels give the scale no gradient
            # (recorded difference 43); the port's is the LSQ-style sum
            assert torch.isfinite(qparams[tk]['scale'].grad).all()
            continue
        _close(qparams[tk]['scale'].grad, gq[jk]['scale'], f'{tk} scale')
        moved += int(np.abs(np.asarray(gq[jk]['scale'])).max() > 0)
    assert moved > 0 or platform == 'TPU_FP8'


def test_forward_with_gradient_runs_the_compiled_walk():
    """The executor's differentiable forward is the compiled trainable
    forward: the same outputs, and gradients reach the TQCs' scales when
    the caller hands qparams in."""
    _, tg = _pair('tiny_cnn', 'TPU_INT8')
    tg = copy.deepcopy(tg)
    x = torch.from_numpy(_loader()[0])
    with torch_training._unbaked_parameters(tg):
        executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
        cg = CompiledGraph(tg, device='cpu')
        qparams = {k: {kk: vv.clone().requires_grad_(True)
                       for kk, vv in v.items()}
                   for k, v in cg.init_qparams().items()}
        y = executor.forward_with_gradient(x, qparams=qparams)[0]
        want = cg.build_forward()(cg.init_params(), x)[0]
        assert torch.equal(y.detach(), want)
        y.square().mean().backward()
        assert any(v['scale'].grad is not None and
                   v['scale'].grad.abs().max() > 0 for v in qparams.values())
