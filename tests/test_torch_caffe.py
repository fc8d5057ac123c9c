"""The port's Caffe frontend (ppq_tpu_torch/frontends/caffe) held against
the JAX package's.

The small nets of tests/test_caffe.py, cut to the layers whose ops the
port runs (its op table is the ResNet family's: ROADMAP.md queue 1 item 3),
parse in both packages to the same graph and run to the same outputs;
quantized nets carried across with interop/carry.py export to the same
prototxt text, caffemodel bytes and encodings JSON in every Caffe flavour.
A net with a layer the port does not run raises when it is parsed.
"""

import numpy as np
import pytest
import torch
# torch.optim.Adam imports torch._dynamo at its first step, and that import
# scans sys.modules: do it before anything plants a stand-in `onnx` module
import torch._dynamo  # noqa: F401
from google.protobuf import text_format

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.frontends import caffe as jax_caffe
from ppq_tpu_torch.api import load_caffe_graph, quantize_caffe_model
from ppq_tpu_torch.frontends import PARSER_COLLECTION
from ppq_tpu_torch.frontends import caffe as torch_caffe
from ppq_tpu_torch.interop import quantization_configs_of
from test_torch_frontends import _structure, carry

LENET = """
name: "lenet_like"
input: "data"
input_shape { dim: 2 dim: 1 dim: 16 dim: 16 }
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 stride: 1 }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 }
}
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer {
  name: "sum" type: "Eltwise" bottom: "conv2" bottom: "pool1" top: "sum"
  eltwise_param { operation: SUM }
}
layer {
  name: "gpool" type: "Pooling" bottom: "sum" top: "gpool"
  pooling_param { pool: AVE global_pooling: true }
}
layer { name: "flat" type: "Flatten" bottom: "gpool" top: "flat" }
layer {
  name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
  inner_product_param { num_output: 10 }
}
"""

# BatchNorm with Caffe's stored moving-average factor (a Scale layer after
# it would add a Mul, which the port does not run yet)
BN_NET = """
name: "bn_net"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 bias_term: false }
}
layer {
  name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
  batch_norm_param { use_global_stats: true eps: 1e-5 }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "gpool" type: "Pooling" bottom: "conv1" top: "gpool"
  pooling_param { pool: AVE global_pooling: true }
}
layer { name: "flat" type: "Flatten" bottom: "gpool" top: "flat" }
layer {
  name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
  inner_product_param { num_output: 4 }
}
"""

NETS = {'lenet': LENET, 'bn': BN_NET}
SHAPES = {'lenet': (2, 1, 16, 16), 'bn': (2, 3, 8, 8)}


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


def _blob(layer, value):
    blob = layer.blobs.add()
    blob.shape.dim.extend(value.shape)
    blob.data.extend(value.reshape(-1))


def _write_net(tmp, name):
    """prototxt + caffemodel with seeded blobs, written through the JAX
    package's schema (the wire format is the port's too)."""
    text = NETS[name]
    proto = tmp / f'{name}.prototxt'
    proto.write_text(text)
    net = jax_caffe.caffe_pb2.NetParameter()
    text_format.Merge(text, net)
    rng = np.random.RandomState(0)
    channels = {'data': SHAPES[name][1]}
    for layer in net.layer:
        cin = channels.get(layer.bottom[0]) if layer.bottom else None
        if layer.type == 'Convolution':
            p = layer.convolution_param
            k = p.kernel_size[0]
            _blob(layer, rng.randn(p.num_output, cin, k, k)
                  .astype(np.float32) * 0.3)
            if p.bias_term:
                _blob(layer, rng.randn(p.num_output).astype(np.float32) * 0.05)
            channels[layer.top[0]] = p.num_output
        elif layer.type == 'BatchNorm':
            _blob(layer, rng.randn(cin).astype(np.float32) * 0.1)
            _blob(layer, rng.uniform(0.5, 1.5, cin).astype(np.float32))
            _blob(layer, np.full(1, 0.5, np.float32))
            channels[layer.top[0]] = cin
        elif layer.type == 'InnerProduct':
            n = layer.inner_product_param.num_output
            _blob(layer, rng.randn(n, cin).astype(np.float32) * 0.3)
            _blob(layer, rng.randn(n).astype(np.float32) * 0.05)
        elif cin is not None:
            channels[layer.top[0]] = cin
    model = tmp / f'{name}.caffemodel'
    model.write_bytes(net.SerializeToString())
    return str(proto), str(model)


def _inputs(name, n=2, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPES[name]).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize('name', sorted(NETS))
def test_parse_in_both_packages(name, tmp_path):
    proto, model = _write_net(tmp_path, name)
    jg = jax_caffe.load_caffe_graph(proto, model)
    tg = load_caffe_graph(proto, model)
    assert _structure(jg) == _structure(tg)
    assert PARSER_COLLECTION['caffe'] is torch_caffe.CaffeParser


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_matches_jax(name, tmp_path):
    proto, model = _write_net(tmp_path, name)
    x = _inputs(name)[0]
    want = np.asarray(ppq_tpu.TPUExecutor(
        jax_caffe.load_caffe_graph(proto, model)).forward(x)[0])
    got = ppq_tpu_torch.TorchExecutor(load_caffe_graph(proto, model),
                                      device='cpu').forward(x)[0].numpy()
    # XLA's and oneDNN's convolutions sum in other orders
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope='module')
def quantized_lenet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('caffe')
    proto, model = _write_net(tmp, 'lenet')
    loader = _inputs('lenet')
    jg = jax_caffe.load_caffe_graph(proto, model)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    tg = quantize_caffe_model(proto, model, loader, calib_steps=2,
                              platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
                              verbose=False, device='cpu')
    carry(jg, tg)
    return jg, tg


@pytest.mark.parametrize('flavour', ['CaffeExporter', 'PPLDSPCaffeExporter',
                                     'PPLDSPTICaffeExporter',
                                     'SNPECaffeExporter'])
def test_quantized_export_equal(quantized_lenet, flavour, tmp_path):
    """Each Caffe flavour writes the same prototxt text, caffemodel bytes
    and (SNPE) encodings JSON in both packages."""
    jg, tg = quantized_lenet
    getattr(jax_caffe, flavour)().export(str(tmp_path / 'jax.prototxt'), jg)
    getattr(torch_caffe, flavour)().export(str(tmp_path / 'torch.prototxt'),
                                           tg)
    for suffix in ('.prototxt', '.caffemodel'):
        a = (tmp_path / f'jax{suffix}').read_bytes()
        assert a and a == (tmp_path / f'torch{suffix}').read_bytes()
    if flavour == 'SNPECaffeExporter':
        a = (tmp_path / 'jax_encodings.json').read_text()
        assert a == (tmp_path / 'torch_encodings.json').read_text()
    if flavour.startswith('PPLDSP'):
        assert 'quantize_param' in (tmp_path / 'torch.prototxt').read_text()


@pytest.mark.parametrize('name', sorted(NETS))
def test_export_and_parse_back(name, tmp_path):
    """The port's Caffe export of a parsed and formatted net (BatchNorm
    folded into its convolution: Caffe writes a BatchNormalization back as
    BatchNorm + Scale, and Scale parses to a Mul) parses back to a graph
    whose forward is the same, bit for bit."""
    proto, model = _write_net(tmp_path, name)
    g = ppq_tpu_torch.format_graph(load_caffe_graph(proto, model))
    x = _inputs(name)[0]
    ref = ppq_tpu_torch.TorchExecutor(g, device='cpu').forward(x)[0]
    out = str(tmp_path / 'exported.prototxt')
    torch_caffe.CaffeExporter().export(out, g)
    g2 = load_caffe_graph(out, str(tmp_path / 'exported.caffemodel'))
    got = ppq_tpu_torch.TorchExecutor(g2, device='cpu').forward(x)[0]
    assert torch.equal(got, ref)


def test_quantize_caffe_model_matches_jax(quantized_lenet, tmp_path):
    """quantize_caffe_model in both packages on the same files: the same
    states, weight scales bit for bit, activation scales within the
    tolerance of tests/test_torch_slice.py's compiled calibrations."""
    proto, model = _write_net(tmp_path, 'lenet')
    loader = _inputs('lenet')
    jg = ppq_tpu.api.quantize_caffe_model(proto, model, loader, calib_steps=2,
                                          verbose=False)
    tg = quantize_caffe_model(proto, model, loader, calib_steps=2,
                              verbose=False, device='cpu')
    a_cfgs, b_cfgs = quantization_configs_of(jg), quantization_configs_of(tg)
    assert a_cfgs.keys() == b_cfgs.keys()
    for key, a in a_cfgs.items():
        b = b_cfgs[key]
        assert a['state'] == b['state'], key
        if a['scale'] is None or key[2] == 2:
            continue
        if jg.operations[key[0]].type in ('Conv', 'Gemm') and \
                key[1] == 'in' and key[2] == 1:
            np.testing.assert_array_equal(a['scale'], b['scale'])
        else:
            np.testing.assert_allclose(b['scale'], a['scale'], rtol=5e-3)


def test_unported_layer_raises(tmp_path):
    """A Softmax layer maps to an op the port does not run yet: the parse
    says so instead of handing out a graph the executor cannot run."""
    proto = tmp_path / 'soft.prototxt'
    proto.write_text(LENET + """
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
""")
    with pytest.raises(NotImplementedError, match=r"Softmax.*queue 1, item 3"):
        load_caffe_graph(str(proto))
    assert 'Softmax' in {op.type for op in jax_caffe.load_caffe_graph(
        str(proto)).operations.values()}
