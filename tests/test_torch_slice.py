"""The port's main path (ppq_tpu_torch) held against the JAX package.

ResNet-18 at a small size (10 classes, 2x3x32x32, 2 calibration batches)
goes through `quantize_graph` and the simulated forward in both packages,
from the same seeded graph and data, for TPU_INT8 and for TPU_FP8. The port runs on the CPU here, with
its kernels' plain versions.

Both packages default to the compiled calibration (optim/fcalibration.py),
and the JAX package's compiled path departs from its own observer path
(ROADMAP.md queue 3 item 3). So these tests hold the two observer paths
against each other: the JAX side by making `compiled_calibration_supported`
answer False, the port's by `PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = False`.
One test holds the two compiled (default) paths against each other;
tests/test_torch_fcalibration.py holds the port's compiled path itself.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
# torch.optim.Adam imports torch._dynamo at its first step, and that import
# scans sys.modules: do it now, before tests/test_torch_interop.py plants a
# stand-in `onnx` module without a __spec__ in this process
import torch._dynamo  # noqa: F401

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.quantization import observers as jax_observers
from ppq_tpu.quantization.optim import fcalibration
from ppq_tpu.zoo import resnet18 as jax_resnet18
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.core import PPQ_TPU_CONFIG
from ppq_tpu_torch.quantization import observers
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18

SHAPE = [2, 3, 32, 32]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module: with more, every convolution
    opens an OpenMP region whose workers spin at its barriers, and under a
    test run of several processes that stalls this module and takes the
    cores from the others. What is checked does not depend on it."""
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


def _torch_quantized(algo, observer_path=True):
    graph = torch_resnet18(num_classes=10, input_shape=SHAPE)
    saved = PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR
    PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = not observer_path
    try:
        ppq_tpu_torch.quantize_graph(
            graph, _loader(), calib_steps=2,
            platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
            setting=_setting(TorchSettings, algo), verbose=False,
            device='cpu')
    finally:
        PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = saved
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
    """The two default (compiled) calibrations: the JAX package's computes
    the percentile in one jitted program, and its activation scales differ
    from its observer path's by up to ~1e-3 relative (the port's compiled
    path equals its observer path to 2e-7); the outputs stay within the SNR
    bar."""
    jg, y_jax = _jax_quantized('percentile', observer_path=False)
    tg, y_torch = _torch_quantized('percentile', observer_path=False)
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


def _observe_at_the_ports_stride(self, value):
    """The JAX package's DirectMSEObserver.observe, sampling at the port's
    stride (`observers.sample_stride`, ROADMAP.md queue 3 item 36)."""
    value = np.asarray(value, np.float32)
    if sum(s.size for s in self._samples) < self._budget:
        step = observers.sample_stride(torch.empty(value.shape, device='meta'))
        self._samples.append(value.reshape(-1)[::step][:4096])


def _jax_fp8(ports_stride):
    graph = jax_resnet18(num_classes=10, input_shape=SHAPE)
    with pytest.MonkeyPatch.context() as mp:
        if ports_stride:
            mp.setattr(jax_observers.DirectMSEObserver, 'observe',
                       _observe_at_the_ports_stride)
        ppq_tpu.quantize_graph(graph, _loader(), calib_steps=2,
                               platform=ppq_tpu.TargetPlatform.TPU_FP8,
                               setting=JaxSettings.fp8_setting(),
                               verbose=False)
    return graph


@pytest.fixture(scope='module')
def torch_fp8():
    """The port's ResNet-18 quantized with TPU_FP8, once per module: tests
    that change it take a copy."""
    tg = torch_resnet18(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, _loader(), calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_FP8,
        setting=TorchSettings.fp8_setting(), verbose=False, device='cpu')
    return tg


@pytest.fixture(scope='module')
def both_fp8(torch_fp8):
    """The JAX package's graph sampled at the port's DirectMSE stride, the
    port's, and the JAX package's graph as it samples itself."""
    jg = _jax_fp8(ports_stride=True)
    y_jax = np.asarray(ppq_tpu.TPUExecutor(jg).forward(_loader()[0])[0])
    tg = torch_fp8
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    return ((jg, y_jax), (tg, executor.forward(_loader()[0])[0].numpy()),
            _jax_fp8(ports_stride=False))


def test_fp8_slice_states_and_scales(both_fp8, torch_fp8):
    """quantize_graph(TPU_FP8) with fp8_setting: E4M3 TQCs on the conv
    family, DirectMSE scales (powers of two) equal in both packages when
    both sample the same elements, biases on the linear grid act scale x
    weight scale. The port samples at a stride coprime with the last axis
    (queue 3 item 36): against the JAX package's own stride, which reads 2
    of 16 columns after the stem and 4 of 8 in layer 1 here, exactly one
    scale moves."""
    (jg, _), (tg, _), jg_own = both_fp8
    floating = scales = 0
    for op, side, idx, a, b in _config_pairs(jg, tg):
        assert a.state.name == b.state.name, (op.name, side, idx)
        assert int(a.policy) == int(b.policy)
        assert a.exponent_bits == b.exponent_bits
        assert (a.quant_min, a.quant_max) == (b.quant_min, b.quant_max)
        assert a.has_scale == b.has_scale
        if a.has_scale:
            np.testing.assert_array_equal(np.asarray(a.scale),
                                          np.asarray(b.scale))
            scales += 1
        if b.policy.floating and b.is_active or b.state.name == 'BAKED':
            floating += 1
            assert b.exponent_bits == 4 and b.num_of_bits == 8
    moved = [(op.name, side, idx, float(np.asarray(a.scale)),
              float(np.asarray(b.scale)))
             for op, side, idx, a, b in _config_pairs(jg_own, tg)
             if a.has_scale and not np.array_equal(np.asarray(a.scale),
                                                   np.asarray(b.scale))]
    assert len(moved) == 1, moved
    assert {op.type for op in tg.operations.values()
            if hasattr(op, 'config')} == {'Conv', 'Gemm'}
    assert floating >= 42 and scales >= 63
    # carried across with the interop helpers, the floating policy included
    fresh = copy.deepcopy(torch_fp8)
    carried = quantization_configs_of(jg)
    assert all(e['exponent_bits'] == 4 for (name, side, idx), e
               in carried.items() if side == 'in' and idx == 1)
    load_quantization_configs(fresh, carried)
    for op, side, idx, a, b in _config_pairs(jg, fresh):
        assert int(a.policy) == int(b.policy)
        assert a.exponent_bits == b.exponent_bits


def test_fp8_slice_output_matches_jax(both_fp8):
    (_, y_jax), (_, y_torch), _ = both_fp8
    assert y_torch.shape == y_jax.shape == (2, 10)
    assert np.isfinite(y_torch).all()
    assert _snr(y_torch, y_jax) < 5e-3
    assert (y_torch.argmax(-1) == y_jax.argmax(-1)).all()


def test_fp8_slice_finetunes(torch_fp8):
    """LSQ with frozen scales over the FP8 graph (the floating fake-quant's
    STE backward): every accepted block improved its loss against the fp32
    targets, scales stay as calibrated, and the forward stays finite. (The
    2x10 output sits on the E4M3 grid, too coarse for an end-to-end SNR
    claim at this size.)"""
    from ppq_tpu_torch.quantization.optim import LearnedStepSizePass
    tg = copy.deepcopy(torch_fp8)
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    x = _loader()[0]
    before = executor.forward(x)[0].numpy()
    scales = quantization_configs_of(tg)
    lsq = LearnedStepSizePass(is_scale_trainable=False, steps=5,
                              calib_steps=2, lr=1e-5)
    ppq_tpu_torch.manop(tg, lsq, calib_dataloader=_loader(), verbose=False,
                        device='cpu')
    assert len(lsq.history) == 9
    assert any(h['accepted'] for h in lsq.history)
    for h in lsq.history:
        assert h['accepted'] == (h['post_loss'] < h['pre_loss'])
    after = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0].numpy()
    assert np.isfinite(after).all() and not np.array_equal(after, before)
    for key, entry in quantization_configs_of(tg).items():
        if entry['scale'] is not None:
            np.testing.assert_array_equal(entry['scale'], scales[key]['scale'])


def test_fp8_lsq_takes_block_inputs_after_the_earlier_blocks_trained():
    """LSQ over the FP8 graph improves the output against the fp32 model
    (8x3x32x32, 100 classes, 16 steps at lr 1e-5: SNR 0.022 -> 0.011)
    because a block's quantized inputs are taken just before that block
    trains. With every block's inputs taken once, before any block is
    trained (the JAX package's protocol), every block's loss improves too,
    and the output gets worse (0.022 -> 0.024): a block learns to undo
    upstream error that the upstream blocks' training has since changed."""
    from ppq_tpu_torch.quantization.optim import training

    class InputsTakenOnce(training.LearnedStepSizePass):
        once = None

        def collect_inputs(self, graph, blocks, batches, executor):
            if self.once is None:
                every = training.BlockBuilder(graph).build(self.block_size)
                self.once = training.LearnedStepSizePass.collect_inputs(
                    graph, every, batches, executor)
            return self.once

    shape = [8, 3, 32, 32]
    rng = np.random.RandomState(0)
    loader = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    fp32 = ppq_tpu_torch.TorchExecutor(
        torch_resnet18(num_classes=100, input_shape=shape), device='cpu')
    refs = [fp32.forward(x)[0].numpy() for x in loader]

    # the three runs start from the same calibrated graph, quantized once
    calibrated = torch_resnet18(num_classes=100, input_shape=shape)
    ppq_tpu_torch.quantize_graph(
        calibrated, loader, calib_steps=4,
        platform=ppq_tpu_torch.TargetPlatform.TPU_FP8,
        setting=TorchSettings.fp8_setting(), verbose=False, device='cpu')

    def snr_after(lsq):
        graph = copy.deepcopy(calibrated)
        if lsq is not None:
            ppq_tpu_torch.manop(graph, lsq, calib_dataloader=loader,
                                verbose=False, device='cpu')
            assert len(lsq.history) == 9
            assert all(h['accepted'] for h in lsq.history)
        executor = ppq_tpu_torch.TorchExecutor(graph, device='cpu')
        return np.mean([_snr(executor.forward(x)[0].numpy(), r)
                        for x, r in zip(loader, refs)])

    kw = dict(is_scale_trainable=False, steps=16, lr=1e-5, calib_steps=4)
    before = snr_after(None)
    tuned = snr_after(training.LearnedStepSizePass(**kw))
    once = snr_after(InputsTakenOnce(**kw))
    assert 0.01 < before < 0.05
    assert tuned < 0.7 * before, (before, tuned)
    assert once > before * 0.95, (before, once)


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
    """The port (its parallel layer too), chip_smoke.py and the rank bodies
    of the multi-rank tests import neither JAX nor ppq_tpu."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ppq_tpu'] = None; "
            "import ppq_tpu_torch, ppq_tpu_torch.kernels, "
            "ppq_tpu_torch.interop, ppq_tpu_torch.parallel, "
            "ppq_tpu_torch.parallel._rank, "
            "ppq_tpu_torch.serving.ring_attention, "
            "ppq_tpu_torch.serving.pipeline, "
            "ppq_tpu_torch.serving.tensor_parallel, chip_smoke; "
            "sys.path.insert(0, 'tests'); import torch_dist_cases; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
