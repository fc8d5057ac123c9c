"""Every platform quantizer of QUANTIZER_COLLECTION held against the JAX
package's, on the CPU.

tiny_cnn (2x3x16x16, 10 classes, the same seed in both packages) is
quantized by each of the 23 registered platforms with 3 seeded calibration
batches, through the observer path in both packages (the JAX package's
compiled calibration switched off, the port's `PREFER_COMPILED_EXECUTOR`
off): the JAX package's two calibration paths disagree with each other
(ROADMAP.md queue 3, recorded difference 3, KL by up to 22 %), and the
observer paths are the pair whose values agree. Per TQC:
  * state, policy, bit width, exponent bits, rounding, range and channel
    axis equal; offsets, and the scales that parameters take from their
    own values, bit for bit;
  * activation scales, and the bias scales derived from them (PASSIVE),
    within 1e-6 relative: the two quantile
    interpolations round differently in float32 (difference 25), and the
    activations behind a convolution differ by float32 summation order
    (difference 38); measured at most 1.5e-7;
  * the eager simulated outputs within 1e-5 of the largest |output|
    (measured 1.5e-7: a scale one ulp apart moves no code here).
"""

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.quantization import quantizer as jax_quantizer
from ppq_tpu.quantization.optim import fcalibration as jax_fcal
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.core import PPQ_TPU_CONFIG
from ppq_tpu_torch.quantization import quantizer as torch_quantizer

SHAPE = (2, 3, 16, 16)
SCALE_RTOL, OUTPUT_ATOL_SHARE = 1e-6, 1e-5
PLATFORMS = sorted(p.name for p in torch_quantizer.QUANTIZER_COLLECTION)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def batches():
    rng = np.random.RandomState(0)
    return ([rng.randn(*SHAPE).astype(np.float32) for _ in range(3)],
            rng.randn(*SHAPE).astype(np.float32))


@pytest.fixture
def observer_paths(monkeypatch):
    monkeypatch.setattr(jax_fcal, 'compiled_calibration_supported',
                        lambda graph, method: False)
    monkeypatch.setattr(PPQ_TPU_CONFIG, 'PREFER_COMPILED_EXECUTOR', False)


@pytest.fixture(scope='module')
def quantized(batches):
    """platform name -> (JAX graph, the port's graph), each quantized once
    for the module (the tests read them and change nothing)."""
    pairs = {}

    def get(name):
        if name not in pairs:
            pairs[name] = _quantize(name, batches[0])
        return pairs[name]
    return get


def _quantize(name, loader):
    jg = jax_zoo.tiny_cnn(num_classes=10, input_shape=SHAPE)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=len(loader),
                           platform=getattr(ppq_tpu.TargetPlatform, name),
                           verbose=False)
    tg = torch_zoo.tiny_cnn(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=len(loader),
        platform=getattr(ppq_tpu_torch.TargetPlatform, name), verbose=False,
        device='cpu')
    return jg, tg


def _sites(graph):
    out = {}
    for name, op in graph.operations.items():
        if not hasattr(op, 'config'):
            continue
        for side, variables in (('in', op.inputs), ('out', op.outputs)):
            cfgs = getattr(op.config, f'{side}put_quantization_config')
            for i, (var, cfg) in enumerate(zip(variables, cfgs)):
                out[(name, side, i)] = (var, cfg)
    return out


def _meta(cfg):
    return (cfg.state.name, int(cfg.policy), cfg.num_of_bits,
            cfg.exponent_bits, cfg.rounding.name, float(cfg.quant_min),
            float(cfg.quant_max), cfg.channel_axis, cfg.has_scale)


def _hold(jg, tg):
    """Every TQC of the port's graph against the JAX package's; returns the
    number of scales compared."""
    js, ts = _sites(jg), _sites(tg)
    assert js.keys() == ts.keys()
    held = 0
    for key, (var, a) in js.items():
        b = ts[key][1]
        assert _meta(a) == _meta(b), key
        if not a.has_scale:
            continue
        np.testing.assert_array_equal(np.asarray(b.offset),
                                      np.asarray(a.offset), err_msg=str(key))
        sa, sb = np.asarray(a.scale), np.asarray(b.scale)
        if var.is_parameter and not a.state.name.startswith('PASSIVE'):
            np.testing.assert_array_equal(sb, sa, err_msg=str(key))
        else:
            np.testing.assert_allclose(sb, sa, rtol=SCALE_RTOL, atol=0,
                                       err_msg=str(key))
        held += 1
    return held


@pytest.mark.parametrize('name', PLATFORMS)
def test_platform_tqcs_and_output_match_jax(name, batches, observer_paths,
                                            quantized):
    _, x = batches
    jg, tg = quantized(name)
    assert type(jax_quantizer.QUANTIZER_COLLECTION[
        getattr(ppq_tpu.TargetPlatform, name)]).__name__ == type(
        torch_quantizer.QUANTIZER_COLLECTION[
            getattr(ppq_tpu_torch.TargetPlatform, name)]).__name__
    held = _hold(jg, tg)
    assert held >= 3, held
    want = np.asarray(ppq_tpu.TPUExecutor(jg).forward(x)[0])
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        torch.from_numpy(x))[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=OUTPUT_ATOL_SHARE * np.abs(want).max())


def test_int4_weight_only_leaves_biases_passive_init(observer_paths,
                                                     quantized):
    """TPU_INT4_WEIGHT_ONLY's activations stay FP32, so no bias scale can be
    derived: both packages leave every bias TQC PASSIVE_INIT (a quirk held,
    not repaired), quantize the weights to 4 bits and bake them."""
    jg, tg = quantized('TPU_INT4_WEIGHT_ONLY')
    for graph in (jg, tg):
        biases = weights = 0
        for op in graph.operations.values():
            if not hasattr(op, 'config') or op.type not in ('Conv', 'Gemm'):
                continue
            cfgs = op.config.input_quantization_config
            assert cfgs[1].num_of_bits == 4 and \
                cfgs[1].state.name in ('BAKED', 'ACTIVATED'), op.name
            weights += 1
            if len(cfgs) > 2:
                assert cfgs[2].state.name == 'PASSIVE_INIT', op.name
                biases += 1
            assert cfgs[0].state.name == 'FP32', op.name
        assert weights == 3 and biases == 3
    assert [c.state.name for _, c in _sites(tg).values()] == \
        [c.state.name for _, c in _sites(jg).values()]


def test_nxp_rounds_half_up_in_the_forward(batches, observer_paths,
                                           quantized):
    """NXP_INT8 rounds half up (its quirk): every TQC carries
    ROUND_HALF_UP, and the forward through row 1's rounding code 1 equals
    the JAX package's bit for bit."""
    _, x = batches
    jg, tg = quantized('NXP_INT8')
    assert {c.rounding.name for _, c in _sites(tg).values()} == \
        {'ROUND_HALF_UP'}
    _hold(jg, tg)
    want = np.asarray(ppq_tpu.TPUExecutor(jg).forward(x)[0])
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_register_network_quantizer(batches, observer_paths, monkeypatch):
    """A user quantizer registered for a platform in both packages
    quantizes the same way."""
    loader, x = batches
    classes = {}
    for mod, pkg in ((jax_quantizer, ppq_tpu), (torch_quantizer,
                                                ppq_tpu_torch)):
        base = mod.QUANTIZER_COLLECTION[pkg.TargetPlatform.TENGINE_INT8]

        class MinMaxPerChannel(base):
            w_policy_bits = (pkg.QuantizationProperty.PER_CHANNEL |
                             pkg.QuantizationProperty.LINEAR |
                             pkg.QuantizationProperty.SYMMETRICAL)
            target_platform = pkg.TargetPlatform.EXTENSION

        monkeypatch.setitem(mod.QUANTIZER_COLLECTION,
                            pkg.TargetPlatform.EXTENSION,
                            mod.QUANTIZER_COLLECTION[
                                pkg.TargetPlatform.EXTENSION])
        mod.register_network_quantizer(MinMaxPerChannel,
                                       pkg.TargetPlatform.EXTENSION)
        classes[pkg] = MinMaxPerChannel
    jg, tg = _quantize('EXTENSION', loader)
    w = tg.operations['conv_2'].config.input_quantization_config[1]
    assert w.policy.per_channel and np.asarray(w.scale).size == 16
    _hold(jg, tg)
