"""The port's model zoo (ppq_tpu_torch/zoo) held against the JAX package's,
on the CPU (the builders and small BERT here; yolo_lite, crnn_ocr and
unet_lite in tests/test_torch_zoo_graphs.py).

Each of the 13 builders gives the JAX builder's graph: op types,
attributes, topology and parameters bit for bit. Small BERT (the JAX zoo
test's widths) in TPU_INT8 and TPU_FP8, `yolo_lite` (its Shape / Gather /
Concat chain dispatched to SOI), `crnn_ocr` (an LSTM) and `unet_lite` (a
ConvTranspose) go through `quantize_graph` in both packages from the same
seeded graph and data, each by its default (compiled) calibration: the same
TQC states, the weights' scales bit for bit and the activations' within the
two compiled percentiles' bar (the JAX package's differs from its observer
path by up to ~1e-3, ROADMAP.md queue 3 item 3); the simulated forwards
within the bar of tests/test_torch_slice.py. With the JAX package's TQCs
carried over, the compiled 'int' logits of small BERT and `unet_lite` equal
the JAX package's bit for bit, with the same lowered ops. BERT's eager
forward equals the JAX package's op by op.
"""

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/test_torch_frontends.py)

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.executor import compile_graph as jax_compile
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.executor import compile_graph
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from test_torch_frontends import _structure

# every builder of both zoos, at its defaults and at a second size
BUILDERS = [
    ('resnet18', {}), ('resnet18', dict(num_classes=10,
                                        input_shape=[1, 3, 32, 32])),
    ('tiny_cnn', {}), ('mobilenet_v2', {}), ('se_resnet_lite', {}),
    ('resnext_lite', {}), ('shufflenet_v2_lite', {}),
    ('bert_encoder', {}), ('bert_encoder', dict(seq_len=16, d_model=64,
                                                n_heads=2, n_layers=2,
                                                d_ff=128, batch=2)),
    ('mha_fused_encoder', {}), ('crnn_ocr', {}), ('yolo_lite', {}),
    ('deeplab_lite', {}), ('srcnn', {}), ('unet_lite', {}),
]
SMALL_BERT = dict(seq_len=16, d_model=64, n_heads=2, n_layers=2, d_ff=128)
# (builder, kwargs, input shape, platform)
QUANTIZED = {
    'bert-int8': ('bert_encoder', SMALL_BERT, (1, 16, 64), 'TPU_INT8'),
    'bert-fp8': ('bert_encoder', SMALL_BERT, (1, 16, 64), 'TPU_FP8'),
    'yolo': ('yolo_lite', dict(num_classes=10, in_size=32), (1, 3, 32, 32),
             'TPU_INT8'),
    'crnn': ('crnn_ocr', dict(seq_len=8, hidden=16, n_classes=11),
             (1, 1, 32, 32), 'TPU_INT8'),
    'unet': ('unet_lite', dict(in_size=32), (1, 3, 32, 32), 'TPU_INT8'),
}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module: with more, every convolution
    opens an OpenMP region whose workers spin at its barriers, and under a
    test run of several processes that stalls this module. What is checked
    does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_the_zoo_exports_every_builder():
    assert sorted(torch_zoo.__all__) == sorted(jax_zoo.__all__)
    assert len([n for n in torch_zoo.__all__ if n != 'NetBuilder']) == 13


@pytest.mark.parametrize('name,kwargs', BUILDERS,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(BUILDERS)])
def test_builder_gives_the_jax_graph(name, kwargs):
    want = _structure(getattr(jax_zoo, name)(**kwargs))
    got = _structure(getattr(torch_zoo, name)(**kwargs))
    assert got[0] == want[0]          # ops: type, attributes, wiring
    assert got[2] == want[2]          # graph inputs and outputs
    assert got[1].keys() == want[1].keys()
    for key in want[1]:               # parameters bit for bit
        assert got[1][key] == want[1][key], key


def _loader(shape, n=2):
    rng = np.random.RandomState(0)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope='module')
def quantized():
    """{key: (JAX graph, port graph, loader)}, each quantized by its
    package's default calibration, made on first use."""
    cache = {}

    def get(key):
        if key not in cache:
            builder, kwargs, shape, platform = QUANTIZED[key]
            loader = _loader(shape)
            fp8 = platform == 'TPU_FP8'
            jg = getattr(jax_zoo, builder)(**kwargs)
            ppq_tpu.quantize_graph(
                jg, loader, calib_steps=len(loader),
                platform=ppq_tpu.TargetPlatform[platform],
                setting=JaxSettings.fp8_setting() if fp8 else None,
                verbose=False)
            tg = getattr(torch_zoo, builder)(**kwargs)
            ppq_tpu_torch.quantize_graph(
                tg, loader, calib_steps=len(loader),
                platform=ppq_tpu_torch.TargetPlatform[platform],
                setting=TorchSettings.fp8_setting() if fp8 else None,
                verbose=False, device='cpu')
            cache[key] = (jg, tg, loader)
        return cache[key]
    return get


def _snr(pred, real):
    pred, real = np.asarray(pred, np.float64), np.asarray(real, np.float64)
    return float(((pred - real) ** 2).sum() / (real ** 2).sum())


def _later_readers_of_shared_inputs(graph):
    """Quantized ops that read a graph input after the first quantized op
    that reads it. The JAX package's compiled calibration calibrates that
    input's first root TQC only and leaves the others INITIAL (ROADMAP.md
    queue 3, recorded difference 39); the port calibrates each, as both
    packages' observer paths do (tests/test_torch_fcalibration.py)."""
    later = set()
    for name in graph.inputs:
        # in the graph's op order, the order the calibration walks
        readers = [op.name for op in graph.operations.values()
                   if hasattr(op, 'config') and
                   any(v.name == name for v in op.inputs)]
        later.update(readers[1:])
    return later


# the TQCs recorded difference 39 sets apart: small BERT's embeddings at
# layer 1's K and V MatMuls and its residual Add, and that Add's other input
TIED_BY_DIFFERENCE_39 = {'bert-int8': 4}


def hold_quantized(quantized, key):
    jg, tg, loader = quantized(key)
    assert sorted(jg.operations) == sorted(tg.operations)
    later = _later_readers_of_shared_inputs(tg)
    n_weights = n_acts = n_tied = 0
    for name, op in jg.operations.items():
        other = tg.operations[name]
        assert hasattr(op, 'config') == hasattr(other, 'config'), name
        if not hasattr(op, 'config'):
            assert op.platform.name == other.platform.name, name
            continue
        assert op.platform.name == other.platform.name, name
        for (var, a), b in zip(op.config_pairs(), other.config):
            if name in later and \
                    var.name in [v.name for v in other.inputs] and \
                    a.state.name != b.state.name:
                # recorded difference 39: the JAX compiled path leaves the
                # shared input's TQC INITIAL, the port calibrates it; an
                # Add aligns its inputs' scales, so its other input's state
                # follows the shared one's (OVERLAPPED on INITIAL in JAX,
                # PASSIVE in the port). Every other TQC of the op is held.
                if var.name in tg.inputs:
                    assert (a.state.name, b.state.name) == \
                        ('INITIAL', 'ACTIVATED'), (name, var.name)
                else:
                    assert other.type == 'Add', (name, var.name)
                    assert b.state.name != 'INITIAL', (name, var.name)
                n_tied += 1
                continue
            assert a.state.name == b.state.name, (name, var.name)
            assert a.has_scale == b.has_scale, (name, var.name)
            if not a.has_scale:
                continue
            if var.is_parameter and a.state.name == 'BAKED' and \
                    a.is_root:
                np.testing.assert_array_equal(np.asarray(b.scale),
                                              np.asarray(a.scale))
                n_weights += 1
            elif not var.is_parameter:
                np.testing.assert_allclose(np.asarray(b.scale),
                                           np.asarray(a.scale), rtol=5e-3)
                n_acts += 1
    assert n_weights > 0 and n_acts > 0
    assert n_tied == TIED_BY_DIFFERENCE_39.get(key, 0), n_tied
    y_jax = np.asarray(ppq_tpu.TPUExecutor(jg).forward(loader[0])[0])
    y = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        loader[0])[0].numpy()
    assert y.shape == y_jax.shape and np.isfinite(y).all()
    assert _snr(y, y_jax) < 5e-3
    if key == 'yolo':
        assert any(op.platform.name == 'SOI' for op in tg.operations.values())


@pytest.mark.parametrize('key', ['bert-int8', 'bert-fp8'])
def test_quantize_graph_matches_jax(quantized, key):
    hold_quantized(quantized, key)


def hold_int_logits(quantized, key):
    jg, _, loader = quantized(key)
    builder, kwargs, _, _ = QUANTIZED[key]
    tg = getattr(torch_zoo, builder)(**kwargs)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=len(loader),
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    name = list(jg.inputs)[0]
    jc = jax_compile(jg, precision='int')
    tc = compile_graph(tg, precision='int', device='cpu')
    jfn, jparams = jc.build_forward(), jc.init_params()    # one XLA compile
    tfn, tparams = tc.build_forward(), tc.init_params()
    for x in loader:
        want = np.asarray(jfn(jparams, {name: x})[0])
        got = tfn(tparams, {name: x})[0].numpy()
        np.testing.assert_array_equal(got, want)
    assert tc.int_lowered == jc.int_lowered and tc.int_lowered
    assert tc.int_coded == jc.int_coded
    assert tc.int_accum_risk == jc.int_accum_risk


def test_int_logits_equal_jax(quantized):
    hold_int_logits(quantized, 'bert-int8')


def test_bert_eager_forward_equals_jax_op_by_op(quantized):
    """With the JAX package's TQCs carried over, every intermediate value of
    the simulated forward: LayerNormalization, Softmax, Gelu and the
    products compute the same float32 numbers on this CPU."""
    jg, tg, loader = quantized('bert-int8')
    tg = tg.copy()           # the other tests read the port's own TQCs
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    names = [v.name for op in jg.topological_sort() for v in op.outputs]
    want = ppq_tpu.TPUExecutor(jg).forward(loader[1], output_names=names)
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        loader[1], output_names=names)
    for name, a, b in zip(names, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6, err_msg=name)


# the fake-quant sites of a quantized BERT forward: INT8 32 a layer and 4
# more in the first, where K, V and the residual Add read the embeddings
# (recorded difference 39: the JAX package's compiled calibration leaves
# those three INITIAL, and the Add's other input then PASSIVE-free), all
# tensorwise linear; FP8 18 a layer and 3 more, all tensorwise floating
# (chip_smoke.py path J asserts the same counts of rows 1 and 6t at
# BERT-base)
BERT_SITES = {'bert-int8': (('linear', 'tensorwise'), lambda n: 32 * n + 4),
              'bert-fp8': (('floating', 'tensorwise'), lambda n: 18 * n + 3)}


@pytest.mark.parametrize('key', sorted(BERT_SITES))
def test_bert_fake_quant_sites_per_forward(quantized, key, monkeypatch):
    from ppq_tpu_torch.quantization import qfunction
    _, tg, loader = quantized(key)
    calls = {}

    def counted(kind, fn):
        def call(x, *args, **kwargs):
            axis = args[5]                 # channel_axis, in both
            body = 'tensorwise' if axis is None else 'channelwise'
            calls[kind, body] = calls.get((kind, body), 0) + 1
            return fn(x, *args, **kwargs)
        return call

    monkeypatch.setattr(qfunction, 'linear_quant',
                        counted('linear', qfunction.linear_quant))
    monkeypatch.setattr(qfunction, 'floating_quant',
                        counted('floating', qfunction.floating_quant))
    ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(loader[0])
    body, sites = BERT_SITES[key]
    assert calls == {body: sites(SMALL_BERT['n_layers'])}
