"""The port's analyses (quantization/analyse.py) and evaluation harnesses
(zoo/evaluate.py) held against the JAX package's, on the CPU.

tiny_cnn (4x3x16x16, 10 classes) is quantized by the JAX package and its
parameters and TQCs are carried into the port's graph of the same seeded
model, so both packages analyse the same quantized graph on the same
batches. Each whole-graph analysis runs on the port's compiled executor
(the graph compiles) and, with `compilable` answering no, on its eager
executor; the two give the same reports. The layerwise analysis runs the
eager executor, and its report equals the compiled executor's isolations.
Against the JAX package, reports agree within
float32 summation order: the packages' convolutions sum in other orders,
and a fake-quant code that lands on the other side of a rounding boundary
moves a per-layer error by one step of that layer's grid. As in the JAX
package, an analysis leaves the graph with its parameters un-baked
(`restore_graph_quantization` after `dequantize_graph`): the port's states
afterwards are the JAX package's.
"""

import copy

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.quantization import analyse as jax_analyse
from ppq_tpu.zoo import evaluate as jax_evaluate
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.executor.compile import CompiledGraph
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.ir import dequantize_graph, restore_graph_quantization
from ppq_tpu_torch.quantization import analyse
from ppq_tpu_torch.quantization.measure import torch_snr_error
from ppq_tpu_torch.zoo import evaluate

SHAPE = (4, 3, 16, 16)
# against the JAX package: the packages' convolutions sum in other orders,
# so a fake-quant code can land on the other side of a grid tie, and one
# flipped code moves a layer's noise power by up to ~1 % at this size
# (measured 0.74 %); the statistics of the quantized values by under 1e-5.
# The port's compiled reports against its eager ones: 1e-6.
METRIC_RTOL, STAT_RTOL, SAME_RTOL = 2e-2, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader(n=3, seed=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]


@pytest.fixture
def pair(quantized_pair):
    """A copy of quantized_pair for one test: an analysis leaves the graph
    un-baked."""
    return copy.deepcopy(quantized_pair)


@pytest.fixture(scope='module')
def quantized_pair():
    """(JAX graph, the port's graph carrying its parameters and TQCs,
    batches)."""
    loader = _loader()
    jg = jax_zoo.tiny_cnn(num_classes=10, input_shape=SHAPE)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=3,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    tg = torch_zoo.tiny_cnn(num_classes=10, input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=3,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    return jg, tg, loader


@pytest.fixture
def eager(monkeypatch):
    """The port's analyses on its eager executor."""
    monkeypatch.setattr(analyse, 'compilable', lambda graph: (False, []))


def _close(got, want, rtol):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=1e-12, err_msg=str(key))


def _states(graph):
    return {(name, i): cfg.state.name for name, op in graph.operations.items()
            if hasattr(op, 'config') for i, cfg in enumerate(op.config)}


@pytest.mark.parametrize('method', ['snr', 'cosine', 'mse'])
def test_graphwise_error_analyse(pair, method, monkeypatch):
    jg, tg, loader = pair
    want = jax_analyse.graphwise_error_analyse(jg, loader, steps=3,
                                               method=method, verbose=False)
    got = analyse.graphwise_error_analyse(tg, loader, steps=3, method=method,
                                          verbose=False, device='cpu')
    assert list(got) == list(want) and len(got) > 5
    _close(got, want, METRIC_RTOL)
    assert _states(tg) == _states(jg)     # restored as the JAX package does
    monkeypatch.setattr(analyse, 'compilable', lambda graph: (False, []))
    _close(analyse.graphwise_error_analyse(tg, loader, steps=3, method=method,
                                           verbose=False, device='cpu'),
           got, SAME_RTOL)


def test_layerwise_error_analyse(pair):
    """Every op isolated in the port; the JAX package's on three of them
    (each isolated op is two compiled programs there), and the port's
    scoped run equal to its whole run on those three."""
    jg, tg, loader = pair
    got = analyse.layerwise_error_analyse(tg, loader, steps=2, verbose=False,
                                          device='cpu')
    assert list(got) == [op.name for op in tg.topological_sort()
                         if hasattr(op, 'config')]
    some = [name for name in got
            if tg.operations[name].type in ('Conv', 'Gemm', 'Add')][:3]
    want = jax_analyse.layerwise_error_analyse(jg, loader, steps=2,
                                               interested_ops=some,
                                               verbose=False)
    _close({k: got[k] for k in some}, want, METRIC_RTOL)
    _close(analyse.layerwise_error_analyse(tg, loader, steps=2,
                                           interested_ops=some,
                                           verbose=False, device='cpu'),
           {k: got[k] for k in some}, SAME_RTOL)
    assert _states(tg) == _states(jg)


def test_layerwise_compiled_equals_eager(pair):
    """The layerwise analysis runs the eager executor; each op's isolated
    error equals the one the compiled executor gives for the same
    isolation."""
    _, tg, loader = pair
    some = [name for name, op in tg.operations.items()
            if hasattr(op, 'config')][:4]
    got = analyse.layerwise_error_analyse(
        tg, loader, steps=2, interested_ops=some, verbose=False,
        device='cpu')
    feeds = [{list(tg.inputs)[0]: x} for x in loader[:2]]
    want = {}
    dequantize_graph(tg)
    try:
        for name in some:
            op = tg.operations[name]
            names = [op.outputs[0].name]
            fp = CompiledGraph(tg, output_names=names,
                               device='cpu').make_runner()
            refs = [fp(feed)[0] for feed in feeds]
            op.restore_quantize_state()
            q = CompiledGraph(tg, output_names=names,
                              device='cpu').make_runner()
            want[name] = float(np.mean([
                float(torch_snr_error(q(feed)[0].reshape(1, -1),
                                      ref.reshape(1, -1)))
                for feed, ref in zip(feeds, refs)]))
            op.dequantize()
    finally:
        restore_graph_quantization(tg)
    _close(got, want, SAME_RTOL)


def test_statistical_variable_and_parameter_analyse(pair):
    jg, tg, loader = pair
    want = jax_analyse.statistical_analyse(jg, loader, steps=3)
    got = analyse.statistical_analyse(tg, loader, steps=3, device='cpu')
    assert [r['variable'] for r in got] == [r['variable'] for r in want]
    for a, b in zip(want, got):
        assert (a['op'], a['type']) == (b['op'], b['type'])
        for key in ('min', 'max', 'mean', 'std'):
            np.testing.assert_allclose(b[key], a[key], rtol=STAT_RTOL,
                                       atol=1e-7, err_msg=key)
    name = want[2]['variable']
    hist_want = jax_analyse.variable_analyse(jg, name, loader, steps=3)
    hist_got = analyse.variable_analyse(tg, name, loader, steps=3,
                                        device='cpu')
    assert hist_got.sum() == hist_want.sum()
    # a value on a bin edge may fall on either side of it
    assert np.abs(hist_got - hist_want).sum() <= 2
    assert analyse.parameter_analyse(tg) == \
        jax_analyse.parameter_analyse(jg)


def test_quantzoo_error_analyse(pair, eager):
    jg, tg, loader = pair
    want = jax_analyse.quantzoo_error_analyse(jg, loader, steps=3,
                                              verbose=False)
    got = analyse.quantzoo_error_analyse(tg, loader, steps=3, verbose=False,
                                         device='cpu')
    _close(got['per_layer'], want['per_layer'], METRIC_RTOL)
    for key in ('AQE', 'MQE', 'OQE'):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL)


def test_evaluate_classification(pair):
    """Top-1 and top-5 of the port's compiled and eager executors are the
    same, and the JAX package's."""
    jg, tg, loader = pair
    rng = np.random.RandomState(9)
    batches = [(x, rng.randint(0, 10, SHAPE[0])) for x in loader]
    want = jax_evaluate.evaluate_classification(jg, batches)
    compiled = evaluate.evaluate_classification(tg, batches, device='cpu')
    eager = evaluate.evaluate_classification(tg, batches, compiled=False,
                                             device='cpu')
    for key in ('top1', 'top5'):
        assert compiled[key] == eager[key] == want[key]
    assert compiled['images_per_sec'] > 0 and eager['images_per_sec'] > 0


@pytest.fixture(scope='module')
def power_of_2():
    """tiny_cnn quantized with TPU_POWER_OF_2 in both packages."""
    loader = _loader(n=2, seed=5)
    graphs = []
    for pkg, zoo in ((ppq_tpu, jax_zoo), (ppq_tpu_torch, torch_zoo)):
        g = zoo.tiny_cnn(num_classes=10, input_shape=SHAPE)
        kwargs = {'device': 'cpu'} if pkg is ppq_tpu_torch else {}
        pkg.quantize_graph(g, loader, calib_steps=2,
                           platform=pkg.TargetPlatform.TPU_POWER_OF_2,
                           verbose=False, **kwargs)
        graphs.append(g)
    return graphs[0], graphs[1], loader


def test_power_of_2_tqcs_match_jax(power_of_2):
    """The power-of-2 quantizer (QuantZoo's 'INT8_po2_per_tensor'): the
    same TQC states, policies and bit widths; every scale a power of two
    and the same as the JAX package's (the activation scales round the two
    compiled percentiles, 1e-3 apart at most, to the same power)."""
    jg, tg, _ = power_of_2
    n = 0
    for name, op in jg.operations.items():
        if not hasattr(op, 'config'):
            continue
        other = tg.operations[name]
        sites = list(zip(op.inputs, op.config.input_quantization_config,
                         other.config.input_quantization_config))
        sites += list(zip(op.outputs, op.config.output_quantization_config,
                          other.config.output_quantization_config))
        for idx, (var, a, b) in enumerate(sites):
            assert (a.state.name, int(a.policy), a.num_of_bits) == \
                (b.state.name, int(b.policy), b.num_of_bits), (name, var.name)
            if a.has_scale and not (op.type in ('Conv', 'Gemm') and
                                    idx == 2):
                s = np.asarray(b.scale, np.float64)
                assert np.all(np.log2(s) == np.round(np.log2(s)))
                np.testing.assert_array_equal(s, np.asarray(a.scale))
                n += 1
    assert n > 10


def test_quantzoo_benchmark():
    """The (model x scheme) matrix of both packages: the same records, and
    errors within the per-layer bar. FP8 runs DirectMSE, which samples at
    the port's stride (queue 3 item 36), so its scales, and so its errors,
    may differ: that scheme's are held within a quarter."""
    builders = {'tiny_cnn': lambda zoo: zoo.tiny_cnn(num_classes=10,
                                                     input_shape=SHAPE)}
    loaders = {'tiny_cnn': _loader(n=2, seed=6)}
    want = jax_evaluate.quantzoo_benchmark(
        {k: (lambda f=f: f(jax_zoo)) for k, f in builders.items()}, loaders,
        schemes=['INT8_po2_per_tensor', 'FP8_E4M3'], calib_steps=2,
        error_steps=2, verbose=False)
    got = evaluate.quantzoo_benchmark(
        {k: (lambda f=f: f(torch_zoo)) for k, f in builders.items()},
        loaders, calib_steps=2, error_steps=2, verbose=False, device='cpu')
    assert [(r['model'], r['scheme']) for r in got] == \
        [('tiny_cnn', k) for k in jax_evaluate.QUANTZOO_SCHEMES]
    assert list(evaluate.QUANTZOO_SCHEMES) == \
        list(jax_evaluate.QUANTZOO_SCHEMES)
    # the INT8 per-channel record is the QuantZoo metrics of a default
    # quantization, which test_quantzoo_error_analyse holds against the JAX
    # package's; the JAX package computes the other two here
    assert 0 <= got[0]['AQE'] <= got[0]['MQE'] and np.isfinite(got[0]['OQE'])
    for a, b in zip(want, got[1:]):
        rtol = 0.25 if a['scheme'] == 'FP8_E4M3' else 0.05
        for key in ('AQE', 'MQE', 'OQE'):
            assert 0 <= b[key] and np.isfinite(b[key])
            np.testing.assert_allclose(b[key], a[key], rtol=rtol,
                                       err_msg=(a['scheme'], key))
