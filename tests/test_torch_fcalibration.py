"""The port's compiled calibration (ppq_tpu_torch/quantization/optim/
fcalibration.py) held against its own observer path and against the JAX
package's two paths, on ResNet-18 at 2x3x32x32 with 2 calibration batches.

What is compared, and how close:
  * the port's compiled path against the port's observer path: minmax, KL
    and MSE bit for bit (the same walk, the same reductions, the same
    int64 counts and search); percentile within 2.5e-7 relative (the
    compiled path sums the per-batch quantiles in float32 on the device,
    the observer in float64 on the host: one float32 rounding of the sum);
  * against the JAX package's observer path (its compiled path switched
    off): within 1e-6 relative, the bar tests/test_torch_slice.py sets
    between the two observer paths (oneDNN and XLA sum convolutions in
    other orders);
  * against the JAX package's compiled path (its default): percentile and
    minmax within 1e-3 and 2e-3 relative, MSE within 2e-3, KL within 25 %:
    that path departs from the JAX package's own observer path by as much
    (ROADMAP.md queue 3 item 3; measured 6.1e-4, 1.55e-3, 1.55e-3 and 22 %).
"""

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.quantization.optim import fcalibration as jax_fcal
from ppq_tpu.zoo import resnet18 as jax_resnet18
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.core import PPQ_TPU_CONFIG
from ppq_tpu_torch.executor import TorchExecutor
from ppq_tpu_torch.quantization import solvers
from ppq_tpu_torch.quantization.optim import (CompiledCalibrationPass,
                                              RuntimeCalibrationPass,
                                              compiled_calibration_supported)
from ppq_tpu_torch.quantization.optim import fcalibration
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18

SHAPE = [2, 3, 32, 32]
ALGOS = ['minmax', 'percentile', 'kl', 'mse']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader():
    rng = np.random.RandomState(0)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(2)]


def _setting(factory, algo):
    s = factory.default_setting()
    if algo != 'percentile':
        s.quantize_activation_setting.calib_algorithm = algo
    return s


def _jax(algo, compiled):
    graph = jax_resnet18(num_classes=10, input_shape=SHAPE)
    saved = jax_fcal.compiled_calibration_supported
    if not compiled:
        jax_fcal.compiled_calibration_supported = lambda graph, method: False
    try:
        ppq_tpu.quantize_graph(graph, _loader(), calib_steps=2,
                               platform=ppq_tpu.TargetPlatform.TPU_INT8,
                               setting=_setting(JaxSettings, algo),
                               verbose=False)
    finally:
        jax_fcal.compiled_calibration_supported = saved
    return graph


def _torch(algo, compiled):
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    fcalibration.LAST_CALIBRATION_PROFILE.clear()
    saved = PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR
    PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = compiled
    try:
        ppq_tpu_torch.quantize_graph(
            graph, _loader(), calib_steps=2,
            platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
            setting=_setting(TorchSettings, algo), verbose=False,
            device='cpu')
    finally:
        PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = saved
    return graph, dict(fcalibration.LAST_CALIBRATION_PROFILE)


@pytest.fixture(scope='module', params=ALGOS)
def quantized(request):
    algo = request.param
    return (algo, _torch(algo, True), _torch(algo, False)[0],
            _jax(algo, False), _jax(algo, True))


def _activation_pairs(ga, gb):
    """(site, TQC a, TQC b) over the calibrated activation roots."""
    out = []
    for name, op in ga.operations.items():
        if not hasattr(op, 'config'):
            continue
        other = gb.operations[name]
        for side in ('input_quantization_config',
                     'output_quantization_config'):
            for idx, (a, b) in enumerate(zip(getattr(op.config, side),
                                             getattr(other.config, side))):
                var = (op.inputs if side.startswith('input')
                       else op.outputs)[idx]
                if var.is_parameter or not a.is_root or \
                        a.state.name != 'ACTIVATED':
                    continue
                out.append(((name, side, idx), a, b))
    return out


def _hold(ga, gb, rtol):
    pairs = _activation_pairs(ga, gb)
    assert len(pairs) == 41
    for where, a, b in pairs:
        assert a.state.name == b.state.name, where
        sa, sb = np.asarray(a.scale), np.asarray(b.scale)
        if rtol == 0:
            np.testing.assert_array_equal(sb, sa, err_msg=str(where))
        else:
            np.testing.assert_allclose(sb, sa, rtol=rtol, err_msg=str(where))
        np.testing.assert_array_equal(np.asarray(b.offset),
                                      np.asarray(a.offset))


def test_compiled_equals_the_port_observer_path(quantized):
    algo, (compiled, profile), observer, _, _ = quantized
    assert profile['batches'] == 2 and profile['images'] == 4
    assert ('search_s' in profile) == (algo in ('kl', 'mse'))
    _hold(observer, compiled, 2.5e-7 if algo == 'percentile' else 0)


def test_compiled_against_the_jax_observer_path(quantized):
    algo, (compiled, _), _, jax_observer, _ = quantized
    _hold(jax_observer, compiled, 1e-6)


def test_compiled_against_the_jax_compiled_path(quantized):
    algo, (compiled, _), _, _, jax_compiled = quantized
    _hold(jax_compiled, compiled, {'minmax': 2e-3, 'percentile': 1e-3,
                                   'mse': 2e-3, 'kl': 0.25}[algo])


def test_the_outputs_agree(quantized):
    """The compiled and the observer calibration give the same simulated
    forward: bit for bit where the scales are, else within the slice's
    bar."""
    algo, (compiled, _), observer, _, _ = quantized
    x = _loader()[0]
    a = TorchExecutor(compiled, device='cpu').forward(x)[0].numpy()
    b = TorchExecutor(observer, device='cpu').forward(x)[0].numpy()
    if algo == 'percentile':
        assert float(((a - b) ** 2).sum() / (b ** 2).sum()) < 5e-3
        assert (a.argmax(-1) == b.argmax(-1)).all()
    else:
        np.testing.assert_array_equal(a, b)


def test_kl_searches_take_the_native_library():
    if solvers._native() is None:
        pytest.skip('no C++ toolchain: the numpy twins search')
    before = dict(solvers.SEARCHES)
    _torch('kl', True)
    assert solvers.SEARCHES['numpy'] == before['numpy']
    assert solvers.SEARCHES['native'] - before['native'] == 41


class _Recorder(CompiledCalibrationPass):
    runs = 0

    def optimize(self, *args, **kwargs):
        _Recorder.runs += 1
        return super().optimize(*args, **kwargs)


@pytest.mark.parametrize('prefer,method,compiled', [
    (True, 'percentile', True), (True, 'minmax', True), (True, 'kl', True),
    (True, 'isotone', False), (False, 'percentile', False)])
def test_prefer_compiled_dispatch(monkeypatch, prefer, method, compiled):
    """RuntimeCalibrationPass hands a supported method to the compiled pass
    where prefer_compiled asks for it (the default), and calibrates through
    the observers otherwise."""
    monkeypatch.setattr(fcalibration, 'CompiledCalibrationPass', _Recorder)
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    assert compiled_calibration_supported(graph, method) == (
        method != 'isotone')
    assert RuntimeCalibrationPass().prefer_compiled
    setting = TorchSettings.default_setting()
    setting.quantize_activation = False
    ppq_tpu_torch.quantize_graph(
        graph, _loader(), calib_steps=2, setting=setting, verbose=False,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, device='cpu')
    # quantize_graph without activation calibration leaves the activation
    # TQCs INITIAL: calibrate them with the pass alone
    runs = _Recorder.runs
    RuntimeCalibrationPass(method=method, calib_steps=2,
                           prefer_compiled=prefer).optimize(
        graph, dataloader=_loader(),
        executor=TorchExecutor(graph, device='cpu'))
    assert (_Recorder.runs - runs == 1) == compiled
    assert any(cfg.state.name == 'ACTIVATED' and not var.is_parameter
               for op in graph.operations.values() if hasattr(op, 'config')
               for var, cfg in op.config_pairs())


@pytest.mark.parametrize('prefer', [True, False])
def test_quantize_graph_follows_the_global_switch(monkeypatch, prefer):
    """quantize_graph's calibration takes the compiled pass exactly where
    PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR asks for it: the one switch
    between the two paths."""
    monkeypatch.setattr(fcalibration, 'CompiledCalibrationPass', _Recorder)
    monkeypatch.setattr(PPQ_TPU_CONFIG, 'PREFER_COMPILED_EXECUTOR', prefer)
    runs = _Recorder.runs
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        graph, _loader(), calib_steps=2, verbose=False,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, device='cpu')
    assert (_Recorder.runs - runs == 1) == prefer
