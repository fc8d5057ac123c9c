"""The port's main path (ppq_tpu_torch) held against the JAX package.

ResNet-18 at a small size (10 classes, 2x3x32x32, 2 calibration batches)
goes through `quantize_graph` and the simulated forward in both packages,
from the same seeded graph and data. The port runs on the CPU here, with
its kernels' plain versions.

The port carries RuntimeCalibrationPass's observer path; the JAX package's
compiled calibration (optim/fcalibration.py) is a later slice. So the JAX
side is run with its observer path, by making
`compiled_calibration_supported` answer False for the test. One test also
holds the port against the JAX default (compiled) calibration.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.quantization.optim import fcalibration
from ppq_tpu.zoo import resnet18 as jax_resnet18
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18

SHAPE = [2, 3, 32, 32]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loader():
    rng = np.random.RandomState(0)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(2)]


def _setting(factory, algo):
    s = factory.default_setting()
    if algo != 'percentile':
        s.quantize_activation_setting.calib_algorithm = algo
    return s


def _snr(pred, real):
    pred, real = np.asarray(pred, np.float64), np.asarray(real, np.float64)
    return float(((pred - real) ** 2).sum() / (real ** 2).sum())


def _jax_quantized(algo, observer_path=True):
    graph = jax_resnet18(num_classes=10, input_shape=SHAPE)
    saved = fcalibration.compiled_calibration_supported
    if observer_path:
        fcalibration.compiled_calibration_supported = lambda graph, method: False
    try:
        ppq_tpu.quantize_graph(graph, _loader(), calib_steps=2,
                               platform=ppq_tpu.TargetPlatform.TPU_INT8,
                               setting=_setting(JaxSettings, algo),
                               verbose=False)
    finally:
        fcalibration.compiled_calibration_supported = saved
    out = np.asarray(ppq_tpu.TPUExecutor(graph).forward(_loader()[0])[0])
    return graph, out


def _torch_quantized(algo):
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        graph, _loader(), calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
        setting=_setting(TorchSettings, algo), verbose=False, device='cpu')
    executor = ppq_tpu_torch.TorchExecutor(graph, device='cpu')
    return graph, executor.forward(_loader()[0])[0].numpy()


@pytest.fixture(scope='module', params=['percentile', 'kl'])
def both(request):
    algo = request.param
    return algo, _jax_quantized(algo), _torch_quantized(algo)


def _config_pairs(jax_graph, torch_graph):
    for name, op in jax_graph.operations.items():
        if not hasattr(op, 'config'):
            continue
        other = torch_graph.operations[name]
        assert hasattr(other, 'config'), name
        for side in ('input_quantization_config', 'output_quantization_config'):
            for idx, (a, b) in enumerate(zip(getattr(op.config, side),
                                             getattr(other.config, side))):
                yield op, side, idx, a, b


def test_slice_states_and_scales(both):
    algo, (jg, _), (tg, _) = both
    assert sorted(jg.operations) == sorted(tg.operations)
    n_weights = n_acts = 0
    for op, side, idx, a, b in _config_pairs(jg, tg):
        assert a.state.name == b.state.name, (op.name, side, idx)
        assert a.has_scale == b.has_scale, (op.name, side, idx)
        if not a.has_scale:
            continue
        if op.type in ('Conv', 'Gemm') and side.startswith('input') and idx == 1:
            # weights: minmax of the same host array, bit for bit
            np.testing.assert_array_equal(np.asarray(a.scale), np.asarray(b.scale))
            n_weights += 1
        elif op.type in ('Conv', 'Gemm') and idx == 2:
            continue    # bias scale = activation scale x weight scale
        else:
            # activations: XLA's and oneDNN's convolutions sum in other
            # orders, so observed values differ in the last bits; that moves
            # quantiles and abs-maxima by a few parts in 1e7
            np.testing.assert_allclose(np.asarray(b.scale), np.asarray(a.scale),
                                       rtol=1e-6)
            n_acts += 1
    assert n_weights == 21 and n_acts > 20


def test_slice_output_matches_jax(both):
    algo, (_, y_jax), (_, y_torch) = both
    assert y_torch.shape == y_jax.shape == (2, 10)
    assert np.isfinite(y_torch).all()
    # scales that differ in the 7th digit can flip a code at a grid tie, and
    # the flip cascades through 20 layers: the same bar, for the same
    # reason, as tests/test_int_exact_sim.py
    assert _snr(y_torch, y_jax) < 5e-3
    assert (y_torch.argmax(-1) == y_jax.argmax(-1)).all()


def test_slice_against_jax_compiled_calibration():
    """The JAX default (compiled) calibration computes the percentile in one
    jitted program; its activation scales differ from the observer path's
    by up to ~1e-3 relative, and the outputs stay within the SNR bar."""
    jg, y_jax = _jax_quantized('percentile', observer_path=False)
    tg, y_torch = _torch_quantized('percentile')
    for op, side, idx, a, b in _config_pairs(jg, tg):
        assert a.state.name == b.state.name, (op.name, side, idx)
        if a.has_scale and op.type in ('Conv', 'Gemm') and idx == 1 \
                and side.startswith('input'):
            np.testing.assert_array_equal(np.asarray(a.scale), np.asarray(b.scale))
        elif a.has_scale and not (op.type in ('Conv', 'Gemm') and idx == 2):
            np.testing.assert_allclose(np.asarray(b.scale), np.asarray(a.scale),
                                       rtol=5e-3)
    assert _snr(y_torch, y_jax) < 5e-3
    assert (y_torch.argmax(-1) == y_jax.argmax(-1)).all()


def test_carried_across_forward_matches_tpu_executor(both):
    """JAX-quantized parameters and TQCs go into the port's graph; the
    port's simulated forward alone is then held against TPUExecutor's, op by
    op: each op of the port gets TPUExecutor's values of its inputs."""
    algo, (jg, y_jax), (tg, _) = both
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    for op, side, idx, a, b in _config_pairs(jg, tg):
        assert a.state.name == b.state.name
        if a.has_scale:
            np.testing.assert_array_equal(np.asarray(a.scale), np.asarray(b.scale))
    x = _loader()[0]
    names = [v.name for op in jg.topological_sort() for v in op.outputs]
    ref = dict(zip(names, (np.asarray(v) for v in ppq_tpu.TPUExecutor(jg).forward(
        x, output_names=names))))
    ref['input'] = x
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    flipped = total = 0
    for op in tg.topological_sort():
        feed = {v.name: ref[v.name] for v in op.inputs if not v.is_parameter}
        outs = [v.name for v in op.outputs]
        got = executor.partial_graph_forward([op], feed, outs)
        cfgs = (op.config.output_quantization_config if hasattr(op, 'config')
                else [None] * len(outs))
        for name, y, cfg in zip(outs, got, cfgs):
            want, y = ref[name], y.numpy()
            diff = np.abs(y - want)
            if cfg is not None and cfg.is_active:
                # same inputs, same scales: a code differs only where
                # XLA's and oneDNN's summation orders put the value on two
                # sides of a rounding boundary, and then by one step
                step = float(np.max(cfg.scale))
                assert diff.max() <= step * (1 + 1e-6), name
                flipped += int((diff > 0).sum())
                total += diff.size
            else:
                # float outputs: summation order only, ~1e-7 relative
                np.testing.assert_allclose(y, want, rtol=0,
                                           atol=1e-5 * np.abs(want).max())
    assert total > 0 and flipped <= 1e-3 * total
    y = executor.forward(x)[0].numpy()
    assert _snr(y, y_jax) < 5e-3
    assert (y.argmax(-1) == y_jax.argmax(-1)).all()


def test_parameter_cache_follows_baking():
    """The executor uploads a parameter once per host array: a pass that
    assigns a new array (baking, DEQUANTIZE_GRAPH) is seen by the next
    forward."""
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        graph, _loader(), calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    executor = ppq_tpu_torch.TorchExecutor(graph, device='cpu')
    quantized = executor.forward(_loader()[0])[0]
    with ppq_tpu_torch.DEQUANTIZE_GRAPH(graph):
        fp32 = executor.forward(_loader()[0])[0]
    again = executor.forward(_loader()[0])[0]
    assert not torch.equal(quantized, fp32)
    assert torch.equal(quantized, again)
    fresh = ppq_tpu_torch.TorchExecutor(graph, device='cpu')
    with ppq_tpu_torch.DEQUANTIZE_GRAPH(graph):
        assert torch.equal(fresh.forward(_loader()[0])[0], fp32)


def test_no_silent_cpu(monkeypatch):
    """Entry points run on the card; without one and without a named
    device they raise and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppq_tpu_torch.TorchExecutor(graph)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppq_tpu_torch.quantize_graph(graph, _loader(), calib_steps=2)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppq_tpu_torch.manop(graph, [])
    # nothing was done to the graph before the refusal
    assert 'BatchNormalization' in {op.type for op in graph.operations.values()}


def test_import_hygiene():
    """The port and chip_smoke.py import neither JAX nor ppq_tpu."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ppq_tpu'] = None; "
            "import ppq_tpu_torch, ppq_tpu_torch.kernels, "
            "ppq_tpu_torch.interop, chip_smoke; print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
