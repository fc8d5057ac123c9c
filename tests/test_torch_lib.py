"""The port's PFL API (ppq_tpu_torch/lib.py) held against the JAX
package's (ppq_tpu/lib.py), on the CPU.

  * the factories build the same classes from the same registries;
  * QuantFunction on the same seeded values and configurations: linear
    tensorwise, channelwise, power-of-2 and asymmetric bit for bit (both
    divide by the scale); FP8 E4M3 tensorwise and per channel bit for bit
    where |x / s| is at least the smallest normal, and within one
    subnormal step below it (recorded difference 9: the JAX package's jnp
    cast rounds once, the port cuts the mantissa first);
  * ParameterQuant and TensorQuant on tiny_cnn quantized by both packages
    (observer paths, as tests/test_torch_platforms.py): the calibrated
    parameter scales bit for bit, the same consumers touched, and the
    forwards within 1e-5 of the largest |output|.
"""

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import lib as JPFL
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.quantization.optim import fcalibration as jax_fcal
from ppq_tpu_torch import lib as PFL
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.core import PPQ_TPU_CONFIG

SHAPE = (2, 3, 16, 16)
# E4M3's smallest normal and its subnormal step
E4M3_MIN_NORMAL, E4M3_SUB_STEP = 2.0 ** -6, 2.0 ** -9


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_pfl_factories():
    jg = jax_zoo.tiny_cnn(input_shape=SHAPE)
    tg = torch_zoo.tiny_cnn(input_shape=SHAPE)
    for pkg, lib, g in ((ppq_tpu, JPFL, jg), (ppq_tpu_torch, PFL, tg)):
        q = lib.Quantizer(pkg.TargetPlatform.TPU_INT8, g)
        assert q.target_platform == pkg.TargetPlatform.TPU_INT8
        assert lib.Dispatcher(g, 'conservative').dispatch()
        with pytest.raises(KeyError):
            lib.Dispatcher(g, 'no such dispatcher')
    names = {}
    for pkg, lib in ((ppq_tpu, JPFL), (ppq_tpu_torch, PFL)):
        platform = pkg.TargetPlatform.TPU_INT8
        cfg = lib.LinearQuantizationConfig(channel_axis=0)
        fcfg = lib.FloatingQuantizationConfig(channel_axis=0)
        names[lib] = (type(lib.Exporter(platform)).__name__,
                      type(lib.Parser('onnx')).__name__,
                      type(lib.Observer(cfg)).__name__,
                      type(lib.Pipeline([])).__name__,
                      int(cfg.policy), int(fcfg.policy), fcfg.num_of_bits,
                      fcfg.exponent_bits, sorted(lib.__all__))
    assert names[PFL] == names[JPFL]
    assert PFL.register_calibration_observer.__self__ is \
        ppq_tpu_torch.quantization.observers.OBSERVER_TABLE


def _configs(lib):
    """(label, config, values scale) of each QuantFunction case."""
    return [
        ('tensorwise', lib.LinearQuantizationConfig(), 1.0),
        ('channelwise', lib.LinearQuantizationConfig(channel_axis=0), 1.0),
        ('power_of_2', lib.LinearQuantizationConfig(channel_axis=0,
                                                    power_of_2=True), 1.0),
        ('asymmetric', lib.LinearQuantizationConfig(
            symmetrical=False, quant_min=0, quant_max=255), 1.0),
        ('fp8_tensorwise', lib.FloatingQuantizationConfig(
            calibration='minmax'), 1.0),
        ('fp8_channelwise', lib.FloatingQuantizationConfig(
            channel_axis=0, calibration='minmax'), 1.0),
    ]


@pytest.mark.parametrize('case', range(6),
                         ids=[c[0] for c in _configs(PFL)])
def test_quant_function_matches_jax(case):
    rng = np.random.RandomState(case)
    x = (rng.randn(8, 4, 3, 3) * np.exp(rng.randn(8, 1, 1, 1))).astype(
        np.float32) + (0.7 if case == 3 else 0.0)
    outs = []
    for lib in (JPFL, PFL):
        label, cfg, _ = _configs(lib)[case]
        obs = lib.Observer(cfg)
        obs.observe(x)
        obs.render_quantization_config()
        if lib is PFL:
            y = lib.QuantFunction(torch.from_numpy(x), cfg).numpy()
        else:
            y = np.asarray(lib.QuantFunction(x, cfg))
        outs.append((y, np.asarray(cfg.scale), np.asarray(cfg.offset)))
    (want, s_j, o_j), (got, s_t, o_t) = outs
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(o_t, o_j)
    if case < 4:
        np.testing.assert_array_equal(got, want)
        return
    scale = s_t if s_t.ndim == 0 else s_t.reshape(-1, 1, 1, 1)
    tiny = np.abs(x / scale) < E4M3_MIN_NORMAL
    np.testing.assert_array_equal(got[~tiny], want[~tiny])
    np.testing.assert_allclose((got / scale)[tiny], (want / scale)[tiny],
                               rtol=0, atol=E4M3_SUB_STEP)


@pytest.fixture
def quantized_pair(monkeypatch):
    monkeypatch.setattr(jax_fcal, 'compiled_calibration_supported',
                        lambda graph, method: False)
    monkeypatch.setattr(PPQ_TPU_CONFIG, 'PREFER_COMPILED_EXECUTOR', False)
    rng = np.random.RandomState(9)
    loader = [rng.randn(*SHAPE).astype(np.float32) for _ in range(2)]
    jg = jax_zoo.tiny_cnn(input_shape=SHAPE)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    tg = torch_zoo.tiny_cnn(input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    return jg, tg, loader[0]


def test_parameter_and_tensor_quant_match_jax(quantized_pair):
    """ParameterQuant with an FP8 per-channel and a power-of-2 config on
    the two convolutions' weights, TensorQuant with an asymmetric config
    on the head's input: the same scales, the same consumers, the same
    forward."""
    jg, tg, x = quantized_pair
    weights = [op.inputs[1].name for op in tg.operations.values()
               if op.type == 'Conv']
    head_in = next(op.inputs[0].name for op in tg.operations.values()
                   if op.type == 'Gemm')
    scales = []
    for lib, g in ((JPFL, jg), (PFL, tg)):
        fp8 = lib.FloatingQuantizationConfig(channel_axis=0,
                                             calibration='minmax')
        po2 = lib.LinearQuantizationConfig(channel_axis=0, power_of_2=True)
        touched = [lib.ParameterQuant(g, weights[0], fp8),
                   lib.ParameterQuant(g, weights[1], po2)]
        asym = lib.LinearQuantizationConfig(symmetrical=False, quant_min=0,
                                            quant_max=255)
        asym.scale, asym.offset = np.float32(0.05), np.float32(128.0)
        asym.state = type(asym.state).ACTIVATED
        touched.append(lib.TensorQuant(g, head_in, asym))
        scales.append((touched, np.asarray(fp8.scale), np.asarray(po2.scale)))
    (tj, fj, pj), (tt, ft, pt) = scales
    assert tt == tj == [1, 1, 1]
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(pt, pj)
    assert np.all(np.log2(pt) == np.round(np.log2(pt)))
    with pytest.raises(ValueError):
        PFL.ParameterQuant(tg, head_in, PFL.LinearQuantizationConfig())
    want = np.asarray(ppq_tpu.TPUExecutor(jg).forward(x)[0])
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
