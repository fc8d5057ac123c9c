"""The port's interop copies (ppq_tpu_torch/interop/onnx_shim.py,
reference_parity.py) held against the JAX package's, on the CPU.

  * the same `make_*` calls build byte-equal ModelProtos in both shims
    (the schemas have their own names, recorded difference 33, but the
    wire format is one), `to_array` / `from_array` and attribute values
    agree, and both shims load the same .onnx file to the same bytes;
  * `install_onnx_shim` registers the `onnx` module and its submodules
    (taken out again here: a stand-in `onnx` breaks a later first import of
    torch._dynamo, recorded difference 34);
  * the parity harness's port leg on its seeded convnet writes the fp32
    ONNX file that the JAX package's exporter writes, and its weight
    scales are the weights' per-channel symmetric minmax bit for bit;
  * the head-to-head legs against the reference PPQ need its checkout at
    PPQ_REFERENCE_ROOT and skip without it, as tests/test_reference_parity.py
    does.
"""

import os
import sys

import torch._dynamo  # noqa: F401  (before any stand-in `onnx` module)

import numpy as np
import pytest
import torch

from ppq_tpu.interop import onnx_shim as jshim
from ppq_tpu_torch.interop import onnx_shim as tshim

_REF = os.environ.get('PPQ_REFERENCE_ROOT', '')
ARRAYS = [np.random.RandomState(0).randn(3, 4).astype(np.float32),
          np.arange(6, dtype=np.int64).reshape(2, 3),
          np.arange(5, dtype=np.int32), np.array([1, 0, 1], np.uint8),
          np.random.RandomState(1).randn(2).astype(np.float64),
          np.array([True, False])]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(shim):
    h = shim
    nodes = [
        h.make_node('Conv', ['x', 'w'], ['y'], name='conv', pads=[1, 1, 1, 1],
                    strides=[1, 1], kernel_shape=[3, 3]),
        h.make_node('Relu', ['y'], ['z'], name='relu'),
        h.make_node('Flatten', ['z'], ['out'], axis=1, doc_string='flat'),
    ]
    inits = [h.from_array(np.random.RandomState(2).randn(4, 2, 3, 3)
                          .astype(np.float32), 'w'),
             h.make_tensor('c', 7, [3], [1, 2, 3]),
             h.make_tensor('r', 1, [2], np.array([0.5, 2.0], np.float32)
                           .tobytes(), raw=True)]
    graph = h.make_graph(
        nodes, 'g', [h.make_tensor_value_info('x', 1, [1, 2, 4, 4])],
        [h.make_tensor_value_info('out', 1, [1, 64])], initializer=inits)
    return h.make_model(graph, opset_imports=[h.make_opsetid('', 13)])


def test_make_functions_build_byte_equal_models():
    j, t = _model(jshim), _model(tshim)
    assert t.SerializeToString() == j.SerializeToString()
    assert tshim.printable_graph(t.graph) == jshim.printable_graph(j.graph)
    for node_t, node_j in zip(t.graph.node, j.graph.node):
        for at, aj in zip(node_t.attribute, node_j.attribute):
            assert tshim.get_attribute_value(at) == \
                jshim.get_attribute_value(aj)
    for a in ARRAYS:
        pt, pj = tshim.from_array(a, 'a'), jshim.from_array(a, 'a')
        assert pt.SerializeToString() == pj.SerializeToString()
        np.testing.assert_array_equal(tshim.to_array(pt), a)
        np.testing.assert_array_equal(tshim.to_array(pj), jshim.to_array(pj))


def test_both_shims_load_the_same_file(tmp_path):
    path = str(tmp_path / 'm.onnx')
    tshim.save(_model(tshim), path)
    with open(path, 'rb') as f:
        data = f.read()
    assert tshim.load(path).SerializeToString() == data
    assert jshim.load(path).SerializeToString() == data
    assert tshim.load_model_from_string(data).SerializeToString() == data


def test_install_registers_the_onnx_modules(monkeypatch):
    names = ('onnx', 'onnx.helper', 'onnx.numpy_helper', 'onnx.mapping',
             'onnx.checker')
    for name in names:
        monkeypatch.delitem(sys.modules, name, raising=False)
    try:
        onnx = tshim.install_onnx_shim(force=True)
        assert all(sys.modules[name] is not None for name in names)
        assert onnx.__version__.endswith('ppq_tpu_torch_shim')
        assert onnx.helper.make_node is tshim.make_node
        assert onnx.numpy_helper.to_array is tshim.to_array
        assert onnx.mapping.TENSOR_TYPE_TO_NP_TYPE[1] == np.dtype('float32')
        assert tshim.install_onnx_shim() is onnx       # no-op once present
    finally:
        for name in names:
            sys.modules.pop(name, None)


def test_parity_harness_port_leg(monkeypatch, tmp_path):
    """The parity harness's port leg on its seeded convnet: the fp32 ONNX
    file it writes equals the JAX package's exporter's file of the JAX
    harness's convnet (producer fields aside, difference 30), the weight
    scales are the per-channel absmax / 127.5 of those weights bit for
    bit (the symmetric range over (qmax - qmin) / 2),
    and every quantized activation has its scale."""
    # the harnesses default the pure-python protobuf for the reference leg;
    # the variable is restored after the test
    monkeypatch.setenv('PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION',
                       os.environ.get('PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION',
                                      'upb'))
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
    from ppq_tpu.frontends.onnx.exporter import OnnxExporter
    from ppq_tpu.interop import reference_parity as jrp
    from ppq_tpu_torch.interop import reference_parity as trp
    rng = np.random.RandomState(7)
    loader = [rng.randn(4, 3, 16, 16).astype(np.float32) for _ in range(2)]
    jpath, tpath = str(tmp_path / 'j.onnx'), str(tmp_path / 't.onnx')
    ours = trp.run_ppq_tpu_torch(tpath, 'convnet', 4, loader, 'minmax')
    graph, _ = jrp.build_model('convnet', 4)
    OnnxExporter().export(jpath, graph)
    with open(jpath, 'rb') as fj, open(tpath, 'rb') as ft:
        model_j, model_t = jshim.load(fj), tshim.load(ft)
    for m in (model_j, model_t):
        m.producer_name = m.producer_version = ''        # difference 30
    assert model_t.SerializeToString() == model_j.SerializeToString()
    weights = {init.name: tshim.to_array(init)
               for init in model_t.graph.initializer}
    convs = [n for n in model_t.graph.node if n.op_type in ('Conv', 'Gemm')]
    assert ours['wt'] and len(ours['wt']) == len(convs)
    for node in convs:
        w = weights[node.input[1]]
        absmax = np.abs(w.astype(np.float64)).reshape(w.shape[0], -1).max(1)
        want = (absmax / 127.5).astype(np.float32)     # range / (255 / 2)
        np.testing.assert_array_equal(
            np.asarray(ours['wt'][f'{node.name}:w'], np.float32), want)
    assert ours['act'] and all(np.all(np.asarray(v) > 0)
                               for v in ours['act'].values())
    assert ours['q_out'].shape == ours['fp_out'].shape == (8, 10)


def test_reference_leg():
    if not os.path.isdir(os.path.join(_REF, 'ppq')):
        pytest.skip('reference PPQ checkout not available')
    import subprocess
    import json
    import tempfile
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'parity.json')
        proc = subprocess.run(
            [sys.executable, '-m', 'ppq_tpu_torch.interop.reference_parity',
             out, '--model', 'convnet', '--observer', 'minmax'], cwd=repo,
            env=dict(os.environ,
                     PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION='python'),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with open(out) as f:
            r = json.load(f)
    w = r['weight_scales']
    assert w['n_matched'] == w['n_ref'] > 0 and w['max_rel_diff'] == 0.0
