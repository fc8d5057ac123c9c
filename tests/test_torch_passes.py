"""The port's other passes (quantization/optim/morph.py, vendor.py,
experimental.py, extension.py) held against the JAX package's, on the CPU.

Graph rewrites (the morphs, MetaxGemmSplitPass, MatrixFactorizationPass)
are compared as graphs: op types, names, attributes, wiring and parameters
bit for bit. Passes over quantized graphs start from tiny_cnn (2x3x16x16)
quantized by the JAX package, with its parameters and TQCs carried into the
port's graph of the same seeded model, so both packages start from the same
state; their TQCs are then compared: states, rounding, dominance, and scales
bit for bit where the pass computes them in numpy, or within the bar of the
two compiled percentiles (1e-3 relative, tests/test_torch_fcalibration.py)
where it calibrates. Every settings flag of the two pipeline builders builds
the JAX package's passes with the JAX package's arguments.
"""

import copy

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.ir import format_graph as jax_format_graph
from ppq_tpu.quantization import optim as jax_optim
from ppq_tpu.quantization.quantizer import QUANTIZER_COLLECTION as JAX_QUANTIZERS
from ppq_tpu.zoo.builder import NetBuilder as JaxBuilder
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.api import QuantizationSettingFactory as TorchSettings
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.quantization import optim as torch_optim
from ppq_tpu_torch.quantization.quantizer import \
    QUANTIZER_COLLECTION as TORCH_QUANTIZERS
from ppq_tpu_torch.zoo.builder import NetBuilder as TorchBuilder
from test_torch_frontends import _structure

TINY = dict(input_shape=(2, 3, 16, 16))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader(shape, n=2, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def test_the_port_exports_every_pass():
    assert set(jax_optim.__all__) <= set(torch_optim.__all__)
    for name in jax_optim.__all__:
        assert getattr(torch_optim, name).__name__ == \
            getattr(jax_optim, name).__name__


# ------------------------------------------------------------ rewrites ----

def _gru(builder_cls):
    """A one-layer GRU with bias and initial state (the JAX package's
    tests/test_gru_decompose.py graph)."""
    T, N, I, H = 3, 1, 4, 4
    rng = np.random.RandomState(3)
    b = builder_cls('gru', 3)
    x = b.input('x', [T, N, I])
    empty = b.g.create_variable(name='seq_lens_empty', is_parameter=True)
    inputs = [x, b.param(rng.randn(1, 3 * H, I) * 0.4),
              b.param(rng.randn(1, 3 * H, H) * 0.4),
              b.param(rng.randn(1, 6 * H) * 0.2), empty,
              b.param(rng.randn(1, N, H) * 0.5)]
    y, yh = b.op('GRU', inputs, n_out=2, hidden_size=H,
                 linear_before_reset=1)
    b.output(y)
    b.output(yh)
    return b.g


def _gemm(builder_cls):
    """Gemm with transB=0 and a bias, and a MatMul on a weight."""
    b = builder_cls('gemms', 2)
    x = b.input('x', [4, 32])
    w = b.param(b.rng.randn(32, 16) * 0.1)
    y = b.op('Gemm', [x, w, b.param(b.rng.randn(16) * 0.1)], transB=0)
    y = b.op('MatMul', [y, b.param(b.rng.randn(16, 12) * 0.1)])
    b.output(y)
    return b.g


def _linear_resize(graph):
    """yolo_lite with its Resize ops asking for linear, half-pixel
    resizing: what NXPResizeModeChangePass rewrites."""
    for op in graph.operations.values():
        if op.type == 'Resize':
            op.attributes['mode'] = 'linear'
            op.attributes['coordinate_transformation_mode'] = 'half_pixel'
    return graph


GRAPHS = {
    'tiny_cnn': (lambda: jax_format_graph(jax_zoo.tiny_cnn(**TINY)),
                 lambda: ppq_tpu_torch.format_graph(
                     torch_zoo.tiny_cnn(**TINY))),
    'resnet18': (lambda: jax_zoo.resnet18(num_classes=10,
                                          input_shape=[1, 3, 32, 32]),
                 lambda: torch_zoo.resnet18(num_classes=10,
                                            input_shape=[1, 3, 32, 32])),
    'yolo': (lambda: _linear_resize(jax_zoo.yolo_lite(num_classes=10,
                                                       in_size=32)),
             lambda: _linear_resize(torch_zoo.yolo_lite(num_classes=10,
                                                        in_size=32))),
    'gru': (lambda: _gru(JaxBuilder), lambda: _gru(TorchBuilder)),
    'gemm': (lambda: _gemm(JaxBuilder), lambda: _gemm(TorchBuilder)),
}

# (graph, pass factory over an optim module, what the pass must change)
REWRITES = {
    'horizontal-split': ('tiny_cnn', lambda m: m.HorizontalLayerSplitPass(
        value_threshold=0.5), lambda ops: any(t == 'Add' and n.endswith(
            '_sum') for n, t in ops)),
    'gru-split': ('gru', lambda m: m.GRUSplitPass(),
                  lambda ops: 'GRU' not in {t for _, t in ops}),
    'ncnn-gemm': ('gemm', lambda m: m.NCNNFormatGemmPass(), None),
    'nxp-resize': ('yolo', lambda m: m.NXPResizeModeChangePass(), None),
    'stem-space-to-depth': ('resnet18', lambda m: m.StemSpaceToDepthPass(),
                            lambda ops: 'SpaceToDepth' in {t for _, t in ops}
                            or 'DepthToSpace' in {t for _, t in ops}
                            or 'Reshape' in {t for _, t in ops}),
    'metax-gemm-split': ('resnet18', lambda m: m.MetaxGemmSplitPass(),
                         lambda ops: 'Gemm' not in {t for _, t in ops}),
    'matrix-factorization': ('gemm', lambda m: m.MatrixFactorizationPass(
        rank_ratio=0.5), lambda ops: sum(n.endswith(('_svd_1', '_svd_2'))
                                         for n, _ in ops) == 2),
    'extension': ('tiny_cnn', lambda m: m.ExtensionPass(), None),
}


@pytest.mark.parametrize('which', sorted(REWRITES))
def test_rewrite_gives_the_jax_graph(which):
    """The graph after the pass in both packages: op types, names,
    attributes, wiring, graph inputs and outputs, and every parameter bit
    for bit (the SVD factors too: both packages factor with numpy). The
    port then runs the rewritten graph; where the pass keeps the function,
    its output is the one before within float32 rounding (the split halves
    and the decompositions sum in another order)."""
    graph, make, changed = REWRITES[which]
    jg, tg = (f() for f in GRAPHS[graph])
    before = _structure(tg)
    x = _loader(list(next(iter(tg.inputs.values())).shape), n=1)[0]
    y_before = [v.numpy() for v in
                ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)]
    make(jax_optim).optimize(jg)
    make(torch_optim).optimize(tg)
    want, got = _structure(jg), _structure(tg)
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[1].keys() == want[1].keys()
    for key in want[1]:
        assert got[1][key] == want[1][key], key
    if changed is not None:
        assert changed([(n, op[0]) for n, op in got[0].items()])
    elif which != 'extension':
        assert got != before
    else:
        assert got == before
    y = [v.numpy() for v in
         ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)]
    assert all(np.isfinite(v).all() for v in y)
    if which not in ('matrix-factorization', 'nxp-resize'):
        for a, b in zip(y_before, y):
            np.testing.assert_allclose(b, a, rtol=1e-5,
                                       atol=1e-5 * np.abs(a).max())


def _matmul_name(graph):
    return next(n for n, op in graph.operations.items()
                if op.type == 'MatMul')


def test_matrix_factorization_products():
    """The factors of each package multiply back to the same product, and
    at full rank to the weight (singular vectors are defined only up to
    sign; the products are not)."""
    for ratio in (0.5, 1.0):
        jg, tg = (f() for f in GRAPHS['gemm'])
        name = _matmul_name(tg)
        w = np.asarray(tg.operations[name].inputs[1].value, np.float64)
        jax_optim.MatrixFactorizationPass(rank_ratio=ratio).optimize(jg)
        torch_optim.MatrixFactorizationPass(rank_ratio=ratio).optimize(tg)
        prods = []
        for g in (jg, tg):
            a = np.asarray(g.variables[f'{name}_svd_a'].value, np.float64)
            b = np.asarray(g.variables[f'{name}_svd_b'].value, np.float64)
            prods.append(a @ b)
        np.testing.assert_array_equal(prods[1], prods[0])
        if ratio == 1.0:
            np.testing.assert_allclose(prods[1], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


# ----------------------------------------------------- quantized graphs ---

@pytest.fixture(scope='module')
def quantized_pair():
    """tiny_cnn quantized by the JAX package (TPU_INT8, its default
    calibration) and the port's graph of the same model carrying the same
    parameters and TQCs."""
    loader = _loader(TINY['input_shape'], n=4)
    jg = jax_zoo.tiny_cnn(**TINY)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=4,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    tg = torch_zoo.tiny_cnn(**TINY)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=4,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    return jg, tg, loader


def _tqcs(graph):
    """Per (op, side, index): state, rounding, whether it is a root, its
    dominator's site, and its scale."""
    site = {}
    for name, op in graph.operations.items():
        if hasattr(op, 'config'):
            for side in ('input_quantization_config',
                         'output_quantization_config'):
                for i, cfg in enumerate(getattr(op.config, side)):
                    site[id(cfg)] = (name, side[:2], i)
    out = {}
    for name, op in graph.operations.items():
        if not hasattr(op, 'config'):
            continue
        for side in ('input_quantization_config',
                     'output_quantization_config'):
            for i, cfg in enumerate(getattr(op.config, side)):
                out[name, side[:2], i] = (
                    cfg.state.name, cfg.rounding.name, cfg.is_root,
                    site.get(id(cfg.dominated_by)),
                    np.asarray(cfg.scale) if cfg.has_scale else None)
    return out


def _hold_tqcs(jg, tg, rtol=0.0):
    want, got = _tqcs(jg), _tqcs(tg)
    assert want.keys() == got.keys()
    for key, a in want.items():
        b = got[key]
        assert b[:4] == a[:4], key
        if a[4] is None:
            assert b[4] is None, key
        elif rtol == 0:
            np.testing.assert_array_equal(b[4], a[4], err_msg=str(key))
        else:
            np.testing.assert_allclose(b[4], a[4], rtol=rtol,
                                       err_msg=str(key))
    return want


VENDOR = {
    'nxp-input-rounding': lambda m: m.NxpInputRoundingRefinePass(),
    'nxp-quantize-fusion': lambda m: m.NxpQuantizeFusionPass(),
    'add-conv-relu-merge': lambda m: m.PPLCudaAddConvReluMerge(),
    'dsp-ti-recalibration': lambda m: m.PPLDSPTIReCalibrationPass(
        calib_steps=4),
}


@pytest.mark.parametrize('which', sorted(VENDOR))
def test_vendor_pass_gives_the_jax_tqcs(quantized_pair, which):
    """Each vendor pass over the same quantized graph: the same TQC states,
    rounding and dominance; the scales bit for bit, or within the compiled
    percentiles' bar where the pass calibrates again. The port's forward
    stays finite."""
    jg, tg, loader = copy.deepcopy(quantized_pair)
    before = _tqcs(tg)
    ppq_tpu.manop(jg, VENDOR[which](jax_optim), calib_dataloader=loader,
                  verbose=False)
    ppq_tpu_torch.manop(tg, VENDOR[which](torch_optim),
                        calib_dataloader=loader, verbose=False, device='cpu')
    after = _hold_tqcs(jg, tg, 1e-3 if which == 'dsp-ti-recalibration'
                       else 0.0)
    # the quantizer's fusion already made the one Add -> Relu tail share
    # its output site, and QuantizeFusionPass finds nothing left to fuse:
    # those two passes must leave the TQCs as they were
    if which not in ('nxp-quantize-fusion', 'add-conv-relu-merge'):
        assert any(after[k][:4] != before[k][:4] or (
            after[k][4] is not None and
            not np.array_equal(after[k][4], before[k][4])) for k in after)
    else:
        assert all(after[k][:4] == before[k][:4] for k in after)
    y = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        loader[0])[0].numpy()
    assert np.isfinite(y).all()


def test_learning_to_calib_makes_the_jax_choices(quantized_pair):
    """LearningToCalibPass samples each calibrated activation with the same
    seeded indices in both packages and searches the same multipliers: the
    same multiplier for every TQC, so the scales come out bit for bit."""
    jg, tg, loader = copy.deepcopy(quantized_pair)
    base = _tqcs(tg)
    ppq_tpu.manop(jg, jax_optim.LearningToCalibPass(calib_steps=4),
                  calib_dataloader=loader, verbose=False)
    ppq_tpu_torch.manop(tg, torch_optim.LearningToCalibPass(calib_steps=4),
                        calib_dataloader=loader, verbose=False, device='cpu')
    after = _hold_tqcs(jg, tg)
    moved = [k for k, v in after.items()
             if v[4] is not None and not np.array_equal(v[4], base[k][4])]
    assert moved


# ------------------------------------------------------------ settings ----

def _simple(obj):
    return {k: v for k, v in vars(obj).items()
            if v is None or isinstance(v, (bool, int, float, str))}


FLAGS = ['weight_split', 'ssd_equalization', 'equalization',
         'channel_split', 'bias_correct', 'lsq_optimization',
         'blockwise_reconstruction', 'extension']


@pytest.mark.parametrize('flag', FLAGS)
def test_every_setting_flag_builds_its_pipeline(flag):
    """A setting with the flag on builds both pipelines (the prequant one
    and the main one) with the JAX package's passes, in its order and with
    its arguments; before this slice the port's quantizer failed on the
    flags of the equalization, split and extension passes."""
    jg, tg = (f() for f in GRAPHS['tiny_cnn'])
    pipelines = []
    for factory, quantizers, graph in (
            (JaxSettings, JAX_QUANTIZERS, jg),
            (TorchSettings, TORCH_QUANTIZERS, tg)):
        setting = factory.default_setting()
        setattr(setting, flag, True)
        quantizer = next(cls for platform, cls in quantizers.items()
                         if platform.name == 'TPU_INT8')(graph)
        pipelines.append([p for build in (quantizer.build_prequant_pipeline,
                                          quantizer.build_quant_pipeline)
                          for p in build(setting)])
    want, got = pipelines
    assert [type(p).__name__ for p in got] == [type(p).__name__ for p in want]
    for a, b in zip(want, got):
        assert _simple(b) == _simple(a), type(a).__name__


def test_weight_split_through_quantize_graph():
    """quantize_graph with weight_split on a graph it splits: the port binds
    its executor to the split graph before tracing and quantizes it; the
    split halves and their Add carry quantization configs, and the output
    stays within the INT8 bar of the fp32 model. The JAX package traces
    with the op order it bound before the split and raises (ROADMAP.md
    queue 3, recorded difference 41)."""
    from ppq_tpu.quantization.measure import torch_snr_error as jax_snr
    loader = _loader([1, 3, 32, 32], n=2)
    settings = []
    for factory in (JaxSettings, TorchSettings):
        setting = factory.default_setting()
        setting.weight_split = True
        setting.weight_split_setting.value_threshold = 0.5
        settings.append(setting)
    jg = jax_zoo.resnet18(num_classes=10, input_shape=[1, 3, 32, 32])
    with pytest.raises(RuntimeError, match='_sum'):
        ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                               setting=settings[0], verbose=False)
    fp32 = ppq_tpu_torch.TorchExecutor(
        torch_zoo.resnet18(num_classes=10, input_shape=[1, 3, 32, 32]),
        device='cpu').forward(loader[0])[0].numpy()
    tg = torch_zoo.resnet18(num_classes=10, input_shape=[1, 3, 32, 32])
    ppq_tpu_torch.quantize_graph(tg, loader, calib_steps=2,
                                 setting=settings[1], verbose=False,
                                 device='cpu')
    split = [n for n in tg.operations if n.endswith('_split')]
    assert split and all(hasattr(tg.operations[n], 'config') for n in split)
    y = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(
        loader[0])[0].numpy()
    assert float(jax_snr(y.reshape(1, -1), fp32.reshape(1, -1))) < 1e-2
