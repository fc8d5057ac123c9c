"""The port's API, working-directory helpers and deploy IR
(ppq_tpu_torch/api/interface.py, api/fsys.py, ir/deploy.py) held against
the JAX package's, in the style of tests/test_beginner_flow.py and
tests/test_deploy_and_experimental.py:15-56.

Graphs quantized in both packages from the same file are carried across
with interop/carry.py where the files they export must be the same bytes.
The port runs on the CPU here (`device='cpu'`); without that argument its
entry points raise when no card is present.
"""

import os
import sys

import numpy as np
import pytest
import torch
# torch.optim.Adam imports torch._dynamo at its first step, and that import
# scans sys.modules: do it before the JAX package's load_torch_model plants
# its stand-in `onnx` module in this process
import torch._dynamo  # noqa: F401

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import fsys as jax_fsys
from ppq_tpu_torch.api import fsys
from ppq_tpu_torch.frontends.native import NativeExporter
from ppq_tpu_torch.frontends.onnx import OnnxExporter
from ppq_tpu_torch.ir import (GraphCommand, GraphCommandType,
                              GraphDeviceSwitcher, RunnableGraph,
                              TrainableGraph, default_command_chain)
from ppq_tpu_torch.zoo import tiny_cnn
from test_torch_frontends import (_structure, carry, normalized_onnx,
                                  same_qparams)

SHAPE = [2, 3, 16, 16]


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


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    """<dir>/model.onnx (the port's export of tiny_cnn) + <dir>/data/*.npy."""
    wd = tmp_path_factory.mktemp('beginner')
    OnnxExporter().export(str(wd / 'model.onnx'), tiny_cnn(input_shape=SHAPE))
    rng = np.random.RandomState(3)
    os.makedirs(wd / 'data')
    for i in range(8):
        np.save(wd / 'data' / f'sample_{i}.npy',
                rng.randn(3, 16, 16).astype(np.float32))
    return wd


@pytest.fixture(scope='module')
def flow(workdir):
    """The working-directory quantize in both packages."""
    jg = ppq_tpu.api.quantize(
        str(workdir), ppq_tpu.api.QuantizationSettingFactory.default_setting(),
        input_shape=SHAPE, target_platform=ppq_tpu.TargetPlatform.TPU_INT8,
        calib_steps=4, verbose=False)
    tg = ppq_tpu_torch.quantize(
        str(workdir),
        ppq_tpu_torch.QuantizationSettingFactory.default_setting(),
        input_shape=SHAPE,
        target_platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
        calib_steps=4, verbose=False, device='cpu')
    return jg, tg


def _module():
    """A small torch module: conv, batch norm, ReLU, max pool, global
    average pool, flatten, linear (ops the port runs)."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2), torch.nn.AdaptiveAvgPool2d(1),
        torch.nn.Flatten(), torch.nn.Linear(8, 5))
    m[1].running_mean.uniform_(-0.1, 0.1)
    m[1].running_var.uniform_(0.5, 1.5)
    return m.eval()


# --------------------------------------------------------------- fsys --

def test_load_calibration_dataset_matches_jax(workdir):
    want = jax_fsys.load_calibration_dataset(str(workdir), input_shape=SHAPE,
                                             batchsize=2)
    got = fsys.load_calibration_dataset(str(workdir), input_shape=SHAPE,
                                        batchsize=2)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fsys_file_roundtrip(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = str(tmp_path / 'x.bin')
    jax_fsys.dump_to_file(path, arr)
    np.testing.assert_array_equal(fsys.load_from_file(path, shape=(3, 4)),
                                  arr)
    jpath = str(tmp_path / 'x.json')
    fsys.dump_to_file(jpath, {'a': 1}, binary=False)
    assert jax_fsys.load_from_file(jpath, binary=False) == {'a': 1}


# ------------------------------------------------------- working dir --

def test_quantize_working_directory_matches_jax(flow):
    jg, tg = flow
    assert same_qparams(jg, tg) > 0


def test_export_working_directory_matches_jax(flow, tmp_path):
    """`export` writes <dir>/quantized (QDQ ONNX) and <dir>/quantized.json;
    with the JAX graph's qparams carried across, both packages' files are
    the same bytes, the producer fields aside."""
    jg, tg = flow
    tg = tg.copy(copy_value=True)
    carry(jg, tg)
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'torch').mkdir()
    ppq_tpu.api.export(str(tmp_path / 'jax'), jg,
                       ppq_tpu.TargetPlatform.TPU_INT8)
    ppq_tpu_torch.export(str(tmp_path / 'torch'), tg,
                         ppq_tpu_torch.TargetPlatform.TPU_INT8)
    assert sorted(os.listdir(tmp_path / 'torch')) == \
        ['quantized', 'quantized.json']
    assert normalized_onnx(tmp_path / 'jax' / 'quantized') == \
        normalized_onnx(tmp_path / 'torch' / 'quantized')
    assert (tmp_path / 'jax' / 'quantized.json').read_text() == \
        (tmp_path / 'torch' / 'quantized.json').read_text()


def test_dump_and_compare_internal_results(flow, tmp_path):
    jg, tg = flow
    x = np.random.RandomState(5).randn(*SHAPE).astype(np.float32)
    d1, d2, dj = (str(tmp_path / k) for k in ('a', 'b', 'jax'))
    fsys.dump_internal_results(tg, x, d1, device='cpu')
    fsys.dump_internal_results(tg, x, d2, device='cpu')
    jax_fsys.dump_internal_results(jg, x, dj)
    assert sorted(os.listdir(d1)) == sorted(os.listdir(dj))
    same = fsys.compare_cosine_similarity_between_results(d1, d2)
    assert same and all(v == pytest.approx(1.0, abs=1e-6)
                        for v in same.values() if v is not None)
    across = fsys.compare_cosine_similarity_between_results(dj, d1)
    assert all(v > 0.999 for v in across.values() if v is not None)


# ------------------------------------------------------------ loaders --

def test_load_graph_by_extension(workdir, tmp_path):
    g = ppq_tpu_torch.load_graph(str(workdir / 'model.onnx'))
    path = str(tmp_path / 'm.native')
    NativeExporter().export(path, g)
    assert _structure(ppq_tpu_torch.load_graph(path)) == _structure(g)
    with pytest.raises(ValueError, match='Cannot infer graph format'):
        ppq_tpu_torch.load_graph(str(tmp_path / 'm.prototxt'))


def test_quantize_native_model(workdir, tmp_path):
    path = str(tmp_path / 'm.native')
    NativeExporter().export(path, tiny_cnn(input_shape=SHAPE))
    loader = fsys.load_calibration_dataset(str(workdir), SHAPE, batchsize=2)
    g = ppq_tpu_torch.quantize_native_model(path, loader, calib_steps=2,
                                            verbose=False, device='cpu')
    assert any(isinstance(op, ppq_tpu_torch.QuantableOperation)
               for op in g.operations.values())


def test_load_torch_model_matches_jax():
    """Both packages' load_torch_model parse the same graph; the port's
    forward is the module's; the port takes its stand-in `onnx` module
    out of sys.modules again."""
    module = _module()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 8, 8)
                         .astype(np.float32))
    had_onnx = 'onnx' in sys.modules
    tg = ppq_tpu_torch.api.load_torch_model(module, x[:1])
    assert ('onnx' in sys.modules) == had_onnx
    jg = ppq_tpu.api.load_torch_model(module, x[:1])
    assert _structure(tg) == _structure(jg)
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0]
    with torch.no_grad():
        want = module(x)
    # the exporter folds the batch norm into the convolution
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_quantize_torch_model(monkeypatch):
    """Both packages' quantize_torch_model on the same module and loader:
    the same ops and TQCs. The JAX package takes its observer path here: its
    compiled percentile moves the 20-value Gemm output's scale by 0.5 %,
    while the port's compiled calibration equals the observer path; held
    to tests/test_torch_slice.py's observer-path bar."""
    from ppq_tpu.quantization.optim import fcalibration
    monkeypatch.setattr(fcalibration, 'compiled_calibration_supported',
                        lambda graph, method: False)
    module = _module()
    rng = np.random.RandomState(1)
    loader = [rng.randn(2, 3, 8, 8).astype(np.float32) for _ in range(2)]
    g = ppq_tpu_torch.api.quantize_torch_model(module, loader, calib_steps=2,
                                               verbose=False, device='cpu')
    jg = ppq_tpu.api.quantize_torch_model(module, loader, calib_steps=2,
                                          verbose=False)
    assert {k: op.type for k, op in g.operations.items()} == \
        {k: op.type for k, op in jg.operations.items()}
    assert same_qparams(jg, g, rtol=1e-6) == 2
    y = ppq_tpu_torch.TorchExecutor(g, device='cpu').forward(loader[0])[0]
    with torch.no_grad():
        want = module(torch.from_numpy(loader[0]))
    assert y.shape == want.shape and torch.isfinite(y).all()


# ------------------------------------------------------------- deploy --

def test_runnable_graph_roundtrip():
    g = tiny_cnn(input_shape=SHAPE)
    before = {k: v.copy() for k, v in g.parameters().items()}
    rg = RunnableGraph(g).deploy(device='cpu')
    name = next(iter(before))
    assert isinstance(rg.device_value(name), torch.Tensor)
    rg.retrieve()
    assert rg.device_value(name) is None
    for k, v in g.parameters().items():
        np.testing.assert_array_equal(v, before[k])


def test_trainable_graph_state_dict():
    g = tiny_cnn(input_shape=SHAPE)
    tg = TrainableGraph(g)
    state = tg.state_dict()
    jax_state = ppq_tpu.ir.TrainableGraph(
        ppq_tpu.zoo.tiny_cnn(input_shape=SHAPE)).state_dict()
    assert sorted(state) == sorted(jax_state)
    name = next(iter(state))
    g.variables[name].value = np.zeros_like(state[name])
    tg.load_state_dict(state)
    np.testing.assert_array_equal(g.variables[name].value, state[name])


def _switched_graphs():
    """tiny_cnn dispatched for TPU_INT8 in both packages, its Flatten put on
    the host side (SOI), so that the switcher has two edges to cut."""
    jg = ppq_tpu.ir.format_graph(ppq_tpu.zoo.tiny_cnn(input_shape=SHAPE))
    ppq_tpu.dispatch_graph(jg, ppq_tpu.TargetPlatform.TPU_INT8)
    tg = ppq_tpu_torch.format_graph(tiny_cnn(input_shape=SHAPE))
    ppq_tpu_torch.dispatch_graph(tg, ppq_tpu_torch.TargetPlatform.TPU_INT8)
    for g, soi in ((jg, ppq_tpu.TargetPlatform.SOI),
                   (tg, ppq_tpu_torch.TargetPlatform.SOI)):
        next(op for op in g.operations.values()
             if op.type == 'Flatten').platform = soi
    return jg, tg


def test_device_switcher_matches_jax():
    jg, tg = _switched_graphs()
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    ref = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0]
    n_jax = ppq_tpu.ir.GraphDeviceSwitcher(jg).insert_switcher()
    sw = GraphDeviceSwitcher(tg)
    n = sw.insert_switcher()
    assert n == n_jax == 2
    assert sorted(jg.operations) == sorted(tg.operations)
    want = np.asarray(ppq_tpu.TPUExecutor(jg).forward(x)[0])
    got = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0]
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert sw.remove_switcher() == n
    assert torch.equal(
        ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0], ref)


def test_deploy_commands():
    """The deploy and switcher commands route to ir/deploy.py."""
    _, tg = _switched_graphs()
    chain = default_command_chain(tg)
    rg = chain(GraphCommand(GraphCommandType.DEPLOY_TO_DEVICE, device='cpu'))
    assert isinstance(rg, RunnableGraph) and rg.device_value(
        next(iter(tg.parameters()))) is not None
    assert isinstance(chain(GraphCommand(GraphCommandType.DEPLOY_TO_CPU)),
                      RunnableGraph)
    assert chain(GraphCommand(GraphCommandType.INSERT_SWITCHER)) == 2
    assert chain(GraphCommand(GraphCommandType.REMOVE_SWITCHER)) == 2


# ------------------------------------------------- the card by default --

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.mark.parametrize('entry', ['quantize_onnx_model', 'quantize',
                                   'deploy', 'deploy_command',
                                   'dump_internal_results'])
def test_entry_points_run_on_the_card(entry, workdir, tmp_path, monkeypatch):
    """Without `device`, each entry point asks for the card and raises when
    there is none: nothing falls back to the CPU."""
    _no_card(monkeypatch)
    g = tiny_cnn(input_shape=SHAPE)
    loader = [np.zeros(SHAPE, np.float32)]
    calls = {
        'quantize_onnx_model': lambda: ppq_tpu_torch.quantize_onnx_model(
            str(workdir / 'model.onnx'), loader, calib_steps=1,
            verbose=False),
        'quantize': lambda: ppq_tpu_torch.quantize(
            str(workdir),
            ppq_tpu_torch.QuantizationSettingFactory.default_setting(),
            input_shape=SHAPE,
            target_platform=ppq_tpu_torch.TargetPlatform.TPU_INT8,
            calib_steps=1, verbose=False),
        'deploy': lambda: RunnableGraph(g).deploy(),
        'deploy_command': lambda: default_command_chain(g)(
            GraphCommand(GraphCommandType.DEPLOY_TO_DEVICE)),
        'dump_internal_results': lambda: fsys.dump_internal_results(
            g, loader[0], str(tmp_path / 'dump')),
    }
    with pytest.raises(RuntimeError, match='runs on a CUDA card'):
        calls[entry]()


def test_public_api_matches_jax():
    """Every name of the JAX package's API is the port's too, but for the
    Pallas-kernel switches (the port launches its kernel or raises) and
    the executor's name."""
    skip = {'ENABLE_PALLAS_KERNEL', 'DISABLE_PALLAS_KERNEL'}
    assert set(ppq_tpu.api.__all__) - skip <= set(ppq_tpu_torch.api.__all__)
    assert not skip & set(ppq_tpu_torch.api.__all__)
    top = set(ppq_tpu.__all__) - {'TPUExecutor'}
    assert top <= set(ppq_tpu_torch.__all__)
