"""The port's frontends and exporters (ppq_tpu_torch/frontends) held against
the JAX package's.

Small graphs from both zoos (tiny_cnn and resnext_lite at 2x3x16x16, the
same names and seeded weights) go through ONNX export and parse in both
packages; quantized graphs are carried across with interop/carry.py (the
JAX package's parameters, TQCs and baked fp32 parameters written into the
port's graph), and then both packages' QDQ, TensorRT, table and JSON files
must be the same bytes, the ONNX producer fields aside. The five ops an
exported or switched graph needs are held against the JAX package's on the
same inputs, QuantizeLinear bit for bit. The port runs on the CPU here,
with its kernels' plain versions.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
# torch.optim.Adam imports torch._dynamo at its first step, and that import
# scans sys.modules: do it before anything plants a stand-in `onnx` module
import torch._dynamo  # noqa: F401

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.executor.ops import default as jax_ops
from ppq_tpu.frontends import EXPORTER_COLLECTION as JAX_EXPORTERS
from ppq_tpu.frontends import PARSER_COLLECTION as JAX_PARSERS
from ppq_tpu.frontends import qtable as jax_qtable
from ppq_tpu.frontends.onnx import OnnxExporter as JaxOnnxExporter
from ppq_tpu.frontends.tensorrt import \
    TensorRTExporter_JSON as JaxTensorRTExporter_JSON
from ppq_tpu.zoo import resnext_lite as jax_resnext_lite
from ppq_tpu.zoo import tiny_cnn as jax_tiny_cnn
from ppq_tpu_torch import frontends
from ppq_tpu_torch.core import dumps_native, loads_native
from ppq_tpu_torch.executor.ops import default as torch_ops
from ppq_tpu_torch.frontends import qtable as torch_qtable
from ppq_tpu_torch.frontends.onnx import OnnxExporter, onnx_pb2
from ppq_tpu_torch.frontends.tensorrt import TensorRTExporter_JSON
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.quantization.measure import torch_snr_error
from ppq_tpu_torch.zoo import resnext_lite as torch_resnext_lite
from ppq_tpu_torch.zoo import tiny_cnn as torch_tiny_cnn

SHAPE = (2, 3, 16, 16)
MODELS = {'tiny_cnn': (jax_tiny_cnn, torch_tiny_cnn),
          'resnext_lite': (jax_resnext_lite, torch_resnext_lite)}
# (model, platform) pairs quantized in both packages and carried across
PAIRS = [('tiny_cnn', 'TPU_INT8'), ('tiny_cnn', 'ORT_INT8'),
         ('tiny_cnn', 'TPU_FP8'), ('resnext_lite', 'TPU_INT8')]
# the JAX package's bounds for a deployed QDQ graph against the simulation
# (tests/test_exporters.py:44-47, tests/test_qdq_hygiene.py:72-75)
QDQ_SNR_BOUND, QDQ_REL_BOUND = 1e-3, 5e-2


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


def _loader(n=2, seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(n)]


def normalized_onnx(path) -> bytes:
    """The file's ModelProto re-serialized with the producer fields cleared
    (`producer_name` is each package's own name)."""
    model = onnx_pb2.ModelProto()
    with open(path, 'rb') as f:
        model.ParseFromString(f.read())
    model.producer_name = ''
    model.producer_version = ''
    return model.SerializeToString()


def carry(jax_graph, torch_graph):
    """Write the JAX graph's parameters, TQCs and baked fp32 parameters
    into the port's graph of the same structure."""
    load_parameters(torch_graph, parameters_of(jax_graph))
    load_quantization_configs(torch_graph, quantization_configs_of(jax_graph))
    for name, op in jax_graph.operations.items():
        if hasattr(op, '_fp32_params'):
            torch_graph.operations[name]._fp32_params = {
                k: np.array(v, copy=True) for k, v in op._fp32_params.items()}


@pytest.fixture(scope='module')
def quantized():
    """{(model, platform): (jax graph, port graph carrying its qparams,
    loader)}, made on first use."""
    cache = {}

    def get(model, platform):
        if (model, platform) not in cache:
            jax_zoo, torch_zoo = MODELS[model]
            loader = _loader()
            jg = jax_zoo(input_shape=SHAPE)
            ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                                   platform=ppq_tpu.TargetPlatform[platform],
                                   verbose=False)
            tg = torch_zoo(input_shape=SHAPE)
            ppq_tpu_torch.quantize_graph(
                tg, loader, calib_steps=2,
                platform=ppq_tpu_torch.TargetPlatform[platform],
                verbose=False, device='cpu')
            carry(jg, tg)
            cache[(model, platform)] = (jg, tg, loader)
        return cache[(model, platform)]
    return get


def _structure(graph):
    """Ops (type, attributes, input and output names), graph inputs and
    outputs, and parameters as bytes: what a parse must reproduce."""
    def plain(v):
        if isinstance(v, np.ndarray):
            return ('array', v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if isinstance(v, (np.integer, np.floating)):
            return v.item()
        return v
    ops = {name: (op.type, {k: plain(v) for k, v in op.attributes.items()},
                  [v.name for v in op.inputs], [v.name for v in op.outputs])
           for name, op in graph.operations.items()}
    params = {name: (np.asarray(v.value).dtype.str, np.asarray(v.value).shape,
                     np.asarray(v.value).tobytes())
              for name, v in graph.variables.items()
              if v.is_parameter and v.has_value}
    io = ([(v.name, list(v.shape) if v.shape is not None else None,
            int(v.dtype)) for v in graph.inputs.values()],
          [v.name for v in graph.outputs.values()])
    return ops, params, io


# ------------------------------------------------------------------ ONNX --

@pytest.mark.parametrize('model', sorted(MODELS))
def test_fp32_onnx_bytes_equal(model, tmp_path):
    jax_zoo, torch_zoo = MODELS[model]
    JaxOnnxExporter().export(str(tmp_path / 'jax.onnx'),
                             jax_zoo(input_shape=SHAPE))
    OnnxExporter().export(str(tmp_path / 'torch.onnx'),
                          torch_zoo(input_shape=SHAPE))
    assert normalized_onnx(tmp_path / 'jax.onnx') == \
        normalized_onnx(tmp_path / 'torch.onnx')
    model_proto = onnx_pb2.ModelProto()
    model_proto.ParseFromString(open(tmp_path / 'torch.onnx', 'rb').read())
    assert model_proto.producer_name == 'ppq_tpu_torch'


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('model', sorted(MODELS))
def test_parse_in_both_packages(model, writer, tmp_path):
    """Either package's file parses in both to the same ops, attributes,
    shapes and bit-equal parameters."""
    jax_zoo, torch_zoo = MODELS[model]
    path = str(tmp_path / 'm.onnx')
    if writer == 'jax':
        JaxOnnxExporter().export(path, jax_zoo(input_shape=SHAPE))
    else:
        OnnxExporter().export(path, torch_zoo(input_shape=SHAPE))
    jg = ppq_tpu.load_onnx_graph(path)
    tg = ppq_tpu_torch.load_onnx_graph(path)
    assert _structure(jg) == _structure(tg)
    assert jg._detail['opset'].version == tg._detail['opset'].version
    assert _structure(tg)[1] == _structure(torch_zoo(input_shape=SHAPE))[1]


@pytest.mark.parametrize('model,platform', PAIRS)
def test_qdq_export_bytes_equal(quantized, model, platform, tmp_path):
    jg, tg, _ = quantized(model, platform)
    ppq_tpu.export_ppq_graph(jg, ppq_tpu.TargetPlatform[platform],
                             str(tmp_path / 'jax.onnx'))
    ppq_tpu_torch.export_ppq_graph(tg, ppq_tpu_torch.TargetPlatform[platform],
                                   str(tmp_path / 'torch.onnx'))
    assert normalized_onnx(tmp_path / 'jax.onnx') == \
        normalized_onnx(tmp_path / 'torch.onnx')


@pytest.mark.parametrize('model,platform', PAIRS)
def test_quant_config_json_equal(quantized, model, platform, tmp_path):
    jg, tg, _ = quantized(model, platform)
    ppq_tpu.export_ppq_graph(jg, ppq_tpu.TargetPlatform.ONNX,
                             str(tmp_path / 'jax.onnx'),
                             str(tmp_path / 'jax.json'))
    ppq_tpu_torch.export_ppq_graph(tg, ppq_tpu_torch.TargetPlatform.ONNX,
                                   str(tmp_path / 'torch.onnx'),
                                   str(tmp_path / 'torch.json'))
    jax_json = open(tmp_path / 'jax.json').read()
    assert json.loads(jax_json)
    assert jax_json == open(tmp_path / 'torch.json').read()
    assert normalized_onnx(tmp_path / 'jax.onnx') == \
        normalized_onnx(tmp_path / 'torch.onnx')


def test_tensorrt_exporters_equal(quantized, tmp_path):
    jg, tg, _ = quantized('tiny_cnn', 'TPU_INT8')
    JaxTensorRTExporter_JSON().export(str(tmp_path / 'jax.onnx'), jg)
    TensorRTExporter_JSON().export(str(tmp_path / 'torch.onnx'), tg)
    assert normalized_onnx(tmp_path / 'jax.onnx') == \
        normalized_onnx(tmp_path / 'torch.onnx')
    ranges = open(tmp_path / 'torch_trt_ranges.json').read()
    assert json.loads(ranges)['act_quant_info']
    assert open(tmp_path / 'jax_trt_ranges.json').read() == ranges
    assert frontends.EXPORTER_COLLECTION[
        ppq_tpu_torch.TargetPlatform.TRT_INT8].__name__ == \
        'TensorRTExporter_QDQ'


TABLES = ['NCNNExporter', 'SNPEExporter', 'MNNExporter', 'RKNNExporter',
          'AscendExporter', 'NXPExporter', 'PPLExporter', 'ExtensionExporter']


@pytest.mark.parametrize('exporter', TABLES)
def test_table_exporters_equal(quantized, exporter, tmp_path):
    jg, tg, _ = quantized('tiny_cnn', 'TPU_INT8')
    getattr(jax_qtable, exporter)().export(str(tmp_path / 'jax.onnx'), jg,
                                           str(tmp_path / 'jax.table'))
    getattr(torch_qtable, exporter)().export(str(tmp_path / 'torch.onnx'),
                                             tg, str(tmp_path / 'torch.table'))
    table = open(tmp_path / 'torch.table').read()
    assert table.strip()
    assert open(tmp_path / 'jax.table').read() == table
    assert normalized_onnx(tmp_path / 'jax.onnx') == \
        normalized_onnx(tmp_path / 'torch.onnx')


def test_tengine_table_equal(tmp_path):
    """Tengine takes per-tensor configs only; its table names TQCs by
    hash, which each process draws anew: the hashes are renumbered by
    first appearance before the tables are compared."""
    loader = _loader()
    jg = jax_tiny_cnn(input_shape=SHAPE)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                           platform=ppq_tpu.TargetPlatform.TENGINE_INT8,
                           verbose=False)
    tg = torch_tiny_cnn(input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TENGINE_INT8, verbose=False,
        device='cpu')
    carry(jg, tg)

    def renumbered(path):
        buf = json.load(open(path))
        ids = {}

        def num(h):
            return ids.setdefault(int(h), len(ids))
        for cfgs in buf['configs'].values():
            for entry in cfgs.values():
                entry['hash'] = num(entry['hash'])
                entry['dominator'] = num(entry['dominator'])
        buf['values'] = {num(k): v for k, v in buf['values'].items()}
        return buf
    jax_qtable.TengineExporter().export(str(tmp_path / 'jax.onnx'), jg,
                                        str(tmp_path / 'jax.json'))
    torch_qtable.TengineExporter().export(str(tmp_path / 'torch.onnx'), tg,
                                          str(tmp_path / 'torch.json'))
    assert renumbered(tmp_path / 'jax.json') == \
        renumbered(tmp_path / 'torch.json')
    assert renumbered(tmp_path / 'torch.json')['values']


@pytest.mark.parametrize('model,platform', PAIRS)
def test_exported_qdq_matches_simulation(quantized, model, platform,
                                         tmp_path):
    """The port's QDQ file, parsed and run by the port, against the port's
    simulation of the source graph, under the JAX package's bounds."""
    _, tg, loader = quantized(model, platform)
    path = str(tmp_path / 'qdq.onnx')
    ppq_tpu_torch.export_ppq_graph(tg, ppq_tpu_torch.TargetPlatform[platform],
                                   path)
    deployed = ppq_tpu_torch.load_onnx_graph(path)
    types_ = {op.type for op in deployed.operations.values()}
    assert {'QuantizeFloating', 'DequantizeFloating'} <= types_ \
        if platform == 'TPU_FP8' else \
        {'QuantizeLinear', 'DequantizeLinear'} <= types_
    sim = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(loader[0])[0]
    dep = ppq_tpu_torch.TorchExecutor(deployed,
                                      device='cpu').forward(loader[0])[0]
    assert float(torch_snr_error(dep, sim)) < QDQ_SNR_BOUND
    rel = float((dep - sim).abs().max() / (sim.abs().max() + 1e-9))
    assert rel < QDQ_REL_BOUND


@pytest.mark.parametrize('model', ['tiny_cnn', 'resnext_lite'])
def test_spec_evaluator_on_port_file(quantized, model, tmp_path):
    """tests/test_qdq_independent.py's evaluator (the ONNX spec's formulas,
    nothing of either package's executor) on the port's ORT QDQ file,
    against the port's simulation under that test's bound."""
    from test_qdq_independent import evaluate_proto
    _, tg, loader = quantized(model, 'TPU_INT8')
    path = str(tmp_path / 'qdq.onnx')
    ppq_tpu_torch.export_ppq_graph(tg, ppq_tpu_torch.TargetPlatform.ORT_INT8,
                                   path)
    sim = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        loader[0])[0].numpy()
    got = evaluate_proto(path, {'input': loader[0]})[0]
    assert got.shape == sim.shape
    err = float(np.abs(got - sim).max() / (np.abs(sim).max() + 1e-9))
    assert err < QDQ_REL_BOUND


@pytest.mark.parametrize('model', sorted(MODELS))
def test_quantize_onnx_model_matches_jax(model, tmp_path):
    """Both packages' quantize_onnx_model on the port's file: the same
    states, weight scales bit for bit, activation scales within the
    tolerance tests/test_torch_slice.py holds the two compiled calibrations
    to."""
    _, torch_zoo = MODELS[model]
    path = str(tmp_path / 'm.onnx')
    OnnxExporter().export(path, torch_zoo(input_shape=SHAPE))
    loader = _loader()
    jg = ppq_tpu.quantize_onnx_model(path, loader, calib_steps=2,
                                     verbose=False)
    tg = ppq_tpu_torch.quantize_onnx_model(path, loader, calib_steps=2,
                                           verbose=False, device='cpu')
    assert sorted(jg.operations) == sorted(tg.operations)
    assert same_qparams(jg, tg) > 2


def same_qparams(jg, tg, rtol=5e-3) -> int:
    """Hold the port's TQCs against the JAX package's: the same states,
    weight scales bit for bit, activation scales within `rtol` (by default
    the tolerance tests/test_torch_slice.py holds the two compiled
    calibrations to; biases follow from those). Returns the number of
    weights held."""
    jax_cfgs = quantization_configs_of(jg)
    torch_cfgs = quantization_configs_of(tg)
    assert jax_cfgs.keys() == torch_cfgs.keys() and jax_cfgs
    n_weights = 0
    for key, a in jax_cfgs.items():
        b = torch_cfgs[key]
        assert a['state'] == b['state'], key
        if a['scale'] is None:
            continue
        op = jg.operations[key[0]]
        if op.type in ('Conv', 'Gemm') and key[1] == 'in' and key[2] == 1:
            np.testing.assert_array_equal(a['scale'], b['scale'])
            n_weights += 1
        elif not (op.type in ('Conv', 'Gemm') and key[2] == 2):
            np.testing.assert_allclose(b['scale'], a['scale'], rtol=rtol)
    return n_weights


# ------------------------------------------------------------------- ops --

def _op(op_type, **attributes):
    return types.SimpleNamespace(name=f'{op_type.lower()}_0', type=op_type,
                                 attributes=attributes)


def _qdq_inputs(dtype, per_axis, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 4, 5, 3) * 3).astype(np.float32)
    # values on the grid's ties and past both ends of the type's range
    x[0, 0, 0, :] = [0.5, 1.5, -2.5]
    x[1, 1, 1, :] = [1e3, -1e3, 0.0]
    if per_axis:
        scale = rng.uniform(0.01, 0.05, 4).astype(np.float32)
        zp = rng.randint(0, 20, 4) if dtype == np.uint8 else \
            rng.randint(-10, 10, 4)
    else:
        scale = np.asarray(0.03, np.float32)
        zp = np.asarray(7 if dtype == np.uint8 else -3)
    return x, scale, zp.astype(dtype)


@pytest.mark.parametrize('per_axis', [False, True])
@pytest.mark.parametrize('dtype', [np.uint8, np.int8])
def test_quantize_linear_matches_jax(dtype, per_axis):
    x, scale, zp = _qdq_inputs(dtype, per_axis)
    op = _op('QuantizeLinear', axis=1)
    want = np.asarray(jax_ops.QuantizeLinear_forward(op, [x, scale, zp]))
    got = torch_ops.QuantizeLinear_forward(op, [torch.from_numpy(x), scale,
                                                zp]).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    # the op runs the fake-quant's codes mode; its twin is the ONNX formula
    tensor = lambda v: torch.as_tensor(np.asarray(v, np.float32))
    twin = torch_ops.quantize_linear_plain(
        torch.from_numpy(x), tensor(scale), tensor(zp), 1 if per_axis else
        None, torch.from_numpy(np.zeros(0, dtype)).dtype).numpy()
    np.testing.assert_array_equal(got, twin)
    info = np.iinfo(dtype)
    assert got.min() == info.min and got.max() == info.max


@pytest.mark.parametrize('per_axis', [False, True])
@pytest.mark.parametrize('dtype', [np.uint8, np.int8])
def test_dequantize_linear_matches_jax(dtype, per_axis):
    x, scale, zp = _qdq_inputs(dtype, per_axis, seed=1)
    op = _op('DequantizeLinear', axis=1)
    q = np.array(jax_ops.QuantizeLinear_forward(op, [x, scale, zp]))
    want = np.asarray(jax_ops.DequantizeLinear_forward(op, [q, scale, zp]))
    # a weight's integer codes are a host operand, uploaded to the device
    # the executor's context names; an activation's codes are a tensor
    ctx = torch_ops.ExecContext(device=torch.device('cpu'))
    for codes in (q, torch.from_numpy(q)):
        got = torch_ops.DequantizeLinear_forward(op, [codes, scale, zp], ctx)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match='names the device'):
        torch_ops.DequantizeLinear_forward(op, [q, scale, zp])


@pytest.mark.parametrize('per_axis', [False, True])
def test_floating_qdq_ops_match_jax(per_axis):
    x, scale, _ = _qdq_inputs(np.int8, per_axis, seed=2)
    offset = np.zeros_like(scale)
    attrs = dict(min=-448.0, max=448.0, exponent=4, mantissa=3)
    if per_axis:
        attrs['axis'] = 1
    q_op, dq_op = _op('QuantizeFloating', **attrs), \
        _op('DequantizeFloating', **attrs)
    want_q = np.asarray(jax_ops.QuantizeFloating_forward(q_op,
                                                         [x, scale, offset]))
    got_q = torch_ops.QuantizeFloating_forward(
        q_op, [torch.from_numpy(x), scale, offset]).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    want = np.asarray(jax_ops.DequantizeFloating_forward(
        dq_op, [want_q, scale, offset]))
    got = torch_ops.DequantizeFloating_forward(
        dq_op, [torch.from_numpy(got_q), scale, offset]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('direction', ['to_host', 'to_device'])
def test_device_switch_op(direction):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    op = _op('PPQDeviceSwitch', direction=direction)
    want = np.asarray(jax_ops.PPQDeviceSwitch_forward(op, [x]))
    ctx = torch_ops.ExecContext(device=torch.device('cpu'))
    got = torch_ops.PPQDeviceSwitch_forward(op, [torch.from_numpy(x)], ctx)
    if direction == 'to_host':
        assert isinstance(got, np.ndarray)
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        got = got.numpy()
        with pytest.raises(ValueError, match='names the device'):
            torch_ops.PPQDeviceSwitch_forward(op, [x])
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- native --

def test_native_checkpoint_roundtrip(quantized, tmp_path):
    _, tg, loader = quantized('tiny_cnn', 'TPU_INT8')
    path = str(tmp_path / 'm.native')
    frontends.NativeExporter().export(path, tg)
    re = ppq_tpu_torch.load_native_graph(path)
    a = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(loader[0])[0]
    b = ppq_tpu_torch.TorchExecutor(re, device='cpu').forward(loader[0])[0]
    assert torch.equal(a, b)
    assert quantization_configs_of(re).keys() == \
        quantization_configs_of(tg).keys()
    assert isinstance(ppq_tpu_torch.load_graph(path),
                      ppq_tpu_torch.BaseGraph)


def test_checkpoint_leaves_device_qparams_out(quantized):
    """A TQC's device copies of its scale and offset (qfunction
    `device_qparams`) stay out of a checkpoint: a file written on the card
    would otherwise pickle CUDA tensors."""
    _, tg, loader = quantized('tiny_cnn', 'TPU_INT8')
    ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(loader[0])
    kept = [cfg for op in tg.operations.values() if hasattr(op, 'config')
            for cfg in op.config if cfg._device_qparams]
    assert kept
    re = loads_native(dumps_native(tg))
    assert all(not cfg._device_qparams for op in re.operations.values()
               if hasattr(op, 'config') for cfg in op.config)
    assert kept[0]._device_qparams


# ------------------------------------------------------------- registry --

def test_registries_match_jax():
    assert {p.name: cls.__name__ for p, cls in JAX_EXPORTERS.items()} == \
        {p.name: cls.__name__
         for p, cls in frontends.EXPORTER_COLLECTION.items()}
    assert sorted(JAX_PARSERS) == sorted(frontends.PARSER_COLLECTION)


def test_register_network_exporter_and_parser():
    platform = ppq_tpu_torch.TargetPlatform.EXTENSION
    saved = frontends.EXPORTER_COLLECTION[platform]

    class Mine(torch_qtable.ExtensionExporter):
        table_suffix = '_mine.txt'
    try:
        frontends.register_network_exporter(Mine, platform)
        assert frontends.EXPORTER_COLLECTION[platform] is Mine
        frontends.register_network_parser(frontends.OnnxParser, 'mine')
        assert frontends.PARSER_COLLECTION['mine'] is frontends.OnnxParser
    finally:
        frontends.EXPORTER_COLLECTION[platform] = saved
        frontends.PARSER_COLLECTION.pop('mine', None)
    with pytest.raises(KeyError, match='No exporter'):
        ppq_tpu_torch.export_ppq_graph(torch_tiny_cnn(input_shape=SHAPE),
                                       ppq_tpu_torch.TargetPlatform.SOI,
                                       'unused.onnx')
