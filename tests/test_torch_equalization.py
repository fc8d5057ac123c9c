"""The port's equalization passes (quantization/algorithm/equalization.py,
optim/equalization.py, optim/ssd.py) held against the JAX package's, on the
CPU.

MobileNetV2 at width 0.25 (1x3x32x32, 10 classes) and a small ResNet-18,
formatted (BatchNormalization folded into the convolutions), from the same
seeds in both packages. The passes compute in host numpy float32, step for
step as the JAX package does, so the rescaled weights and biases are the JAX
package's bit for bit. `quantize_graph` with LayerwiseEqualization (TPU_INT8,
per-channel weights) is compared by its TQCs; BASELINE.json's whole
MobileNetV2 configuration (KL and BiasCorrection too) runs on the card in
chip_smoke.py path K, and tests/test_torch_fcalibration.py and
tests/test_torch_training.py hold KL and BiasCorrection against the JAX
package.
"""

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.ir import format_graph as jax_format_graph
from ppq_tpu.quantization.algorithm import equalization as jax_eq_algo
from ppq_tpu.quantization.optim import equalization as jax_eq
from ppq_tpu.quantization.optim import fcalibration as jax_fcal
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.core import PPQ_TPU_CONFIG
from ppq_tpu_torch.quantization.algorithm import equalization as torch_eq_algo
from ppq_tpu_torch.quantization.optim import equalization as torch_eq

MOBILENET = dict(width=0.25, input_shape=(1, 3, 32, 32), num_classes=10)
R18 = dict(num_classes=10, input_shape=[1, 3, 32, 32])


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader(shape, n=2, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _formatted(name, kwargs):
    """The zoo graph of both packages, formatted as quantize_graph formats
    it before its prequant passes."""
    jg = jax_format_graph(getattr(jax_zoo, name)(**kwargs))
    tg = ppq_tpu_torch.format_graph(getattr(torch_zoo, name)(**kwargs))
    return jg, tg


def _assert_parameters_equal(jg, tg):
    assert sorted(jg.variables) == sorted(tg.variables)
    n = 0
    for name, var in jg.variables.items():
        if var.is_parameter and var.has_value:
            np.testing.assert_array_equal(
                np.asarray(tg.variables[name].value), np.asarray(var.value),
                err_msg=name)
            n += 1
    return n


def test_equalization_pairs_are_the_jax_packages():
    for name, kwargs in (('mobilenet_v2', MOBILENET), ('resnet18', R18)):
        jg, tg = _formatted(name, kwargs)
        want = [(p.upstream.name, p.downstream.name)
                for p in jax_eq_algo.find_equalization_pairs(jg)]
        got = [(p.upstream.name, p.downstream.name)
               for p in torch_eq_algo.find_equalization_pairs(tg)]
        assert got == want and got, name
    assert torch_eq_algo.RELAY_TYPES == jax_eq_algo.RELAY_TYPES


PASSES = {
    'layerwise': lambda m: m.LayerwiseEqualizationPass(iterations=10),
    'layerwise-bias': lambda m: m.LayerwiseEqualizationPass(
        iterations=3, including_bias=True, bias_multiplier=0.25),
    'activation': lambda m: m.ActivationEqualizationPass(iterations=4),
    'channel-split': lambda m: m.ChannelwiseSplitPass(iterations=2,
                                                      value_threshold=0.9),
}


@pytest.mark.parametrize('which', sorted(PASSES))
def test_equalized_weights_and_biases_bit_equal(which):
    """Each pass rewrites weights and biases on the host in float32 numpy,
    as the JAX package's does: every parameter bit for bit."""
    jg, tg = _formatted('mobilenet_v2', MOBILENET)
    before = {n: np.array(v.value) for n, v in tg.variables.items()
              if v.is_parameter and v.has_value}
    PASSES[which](jax_eq).optimize(jg)
    PASSES[which](torch_eq).optimize(tg)
    assert _assert_parameters_equal(jg, tg) > 0
    assert any(not np.array_equal(before[n], tg.variables[n].value)
               for n in before)


def test_equalization_keeps_the_function_and_the_executor_sees_it():
    """Equalization over relay ops that are positively homogeneous (no
    Clip in RELAY_TYPES) keeps the fp32 function: the output within 1e-5
    of its largest value. An executor that ran before the pass uploads the
    rewritten weights (its parameter cache goes by the host array), and
    gives what a fresh executor gives on the rewritten graph, bit for
    bit."""
    _, tg = _formatted('mobilenet_v2', MOBILENET)
    x = _loader(MOBILENET['input_shape'])[0]
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    before = executor.forward(x)[0].numpy()
    torch_eq.LayerwiseEqualizationPass(iterations=10).optimize(tg)
    reused = executor.forward(x)[0].numpy()
    fresh = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0]
    np.testing.assert_array_equal(reused, fresh.numpy())
    assert not np.array_equal(reused, before)
    assert np.abs(reused - before).max() <= 1e-5 * np.abs(before).max()


def _setting(factory):
    s = factory.default_setting()
    s.ssd_equalization = s.equalization = True
    s.equalization_setting.iterations = 10
    return s


@pytest.fixture(scope='module')
def quantized_mobilenet():
    """MobileNetV2 in both packages through quantize_graph with SSD
    equalization (equalization checked by the output's loss, rolled back on
    drift, with the quantizer's executor) and LayerwiseEqualization, each
    by its compiled calibration and by its observer path. (The JAX
    package's observer path first: its compiled path then reuses most of
    what that run compiled.)"""
    loader = _loader(MOBILENET['input_shape'])
    jax_graphs = {}
    for compiled in (False, True):
        jg = jax_zoo.mobilenet_v2(**MOBILENET)
        saved = jax_fcal.compiled_calibration_supported
        if not compiled:
            jax_fcal.compiled_calibration_supported = \
                lambda graph, method: False
        try:
            ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                                   platform=ppq_tpu.TargetPlatform.TPU_INT8,
                                   setting=_setting(JaxSettings),
                                   verbose=False)
        finally:
            jax_fcal.compiled_calibration_supported = saved
        jax_graphs[compiled] = jg
    graphs = {}
    for compiled in (True, False):
        tg = torch_zoo.mobilenet_v2(**MOBILENET)
        saved = PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR
        PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = compiled
        try:
            ppq_tpu_torch.quantize_graph(
                tg, loader, calib_steps=2,
                platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
                setting=_setting(TorchSettings), verbose=False, device='cpu')
        finally:
            PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = saved
        graphs[compiled] = tg
    return jax_graphs, graphs


def _sites(op):
    return (list(zip(op.inputs, op.config.input_quantization_config)) +
            list(zip(op.outputs, op.config.output_quantization_config)))


def test_quantize_with_equalization_matches_jax(quantized_mobilenet):
    """The TQCs after calibration. The port's compiled path against the
    JAX package's observer path: the same states, the per-channel weight
    scales (minmax of bit-equal equalized weights) and the weights
    themselves bit for bit, the activation scales within 5e-6 relative:
    oneDNN and XLA sum convolutions in other orders, and the difference
    grows with depth through MobileNetV2 (measured: 63 of 67 sites
    within 1e-6, the bar tests/test_torch_fcalibration.py holds on
    ResNet-18; conv_409, add_415, conv_465 and the last Gemm 1.06e-6 to
    2.6e-6, as far from the port's observer path as from its compiled
    one). The port's own two paths: the same states, the activation
    scales within 2.5e-7 (one float32 rounding of the summed quantiles).
    The JAX package's compiled path departs from its own observer path
    (ROADMAP.md queue 3, recorded difference 3: 6.1e-4 on ResNet-18; up to
    1.8e-2 here, at two batches of one image): pinned within 2e-2, with
    the same states and weight scales."""
    jax_graphs, graphs = quantized_mobilenet
    tg = graphs[True]
    for other, act_rtol in ((jax_graphs[False], 5e-6),
                            (jax_graphs[True], 2e-2),
                            (graphs[False], 2.5e-7)):
        weights = acts = 0
        for name, op in other.operations.items():
            mine = tg.operations[name]
            assert hasattr(op, 'config') == hasattr(mine, 'config'), name
            if not hasattr(op, 'config'):
                continue
            for idx, ((var, a), (_, b)) in enumerate(zip(_sites(op),
                                                         _sites(mine))):
                assert a.state.name == b.state.name, (name, var.name)
                if not a.has_scale or (op.type == 'Conv' and idx == 2):
                    continue
                if var.is_parameter:
                    np.testing.assert_array_equal(np.asarray(b.scale),
                                                  np.asarray(a.scale))
                    np.testing.assert_array_equal(
                        np.asarray(tg.variables[var.name].value),
                        np.asarray(var.value))
                    weights += 1
                else:
                    np.testing.assert_allclose(
                        np.asarray(b.scale), np.asarray(a.scale),
                        rtol=act_rtol, err_msg=f'{name} {var.name}')
                    acts += 1
        assert weights > 20 and acts > 20
