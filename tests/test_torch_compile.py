"""The port's compiled executor (ppq_tpu_torch/executor/compile.py) held
against the JAX package's (ppq_tpu/executor/compile.py), on the CPU.

Both graphs come from the same seeded zoo model; the JAX graph is quantized
with TPU_INT8 and its parameters and TQCs are carried into the port's graph
(`interop`), so that both walk the same graph with the same qparams. On the
CPU the port runs its kernels' plain versions and no capture (a CUDA graph
needs the card: tests/test_torch_cuda.py holds the captures there).

    'int'             bit for bit, with the same int_lowered, int_coded and
                      int_accum_risk: every contraction sums integers
                      exactly, the rest is the same float32 arithmetic;
    'highest'         bit for bit equal to the port's eager executor, and
                      within the slice's bar of the JAX package's (oneDNN
                      and XLA sum convolutions in other orders: a code can
                      flip at a grid tie and the flip travels);
    'bf16', 'default' within stated bars of the JAX package's (bf16
                      rounding of every stored tensor, in other orders).
"""

import numpy as np
import pytest
import torch

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.core import QuantizationStates as JaxStates
from ppq_tpu.executor import compile_graph as jax_compile
from ppq_tpu.ir.morph import stem_space_to_depth as jax_stem
from ppq_tpu.zoo.vision import resnet18 as jax_resnet18
from ppq_tpu.zoo.vision import tiny_cnn as jax_tiny_cnn
from ppq_tpu_torch.core import QuantizationStates
from ppq_tpu_torch.executor import CompiledGraph, compilable, compile_graph
from ppq_tpu_torch.executor import DEFAULT_BACKEND_TABLE
from ppq_tpu_torch.executor.compile import INT_EXACT_TYPES
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.ir.morph import stem_space_to_depth
from ppq_tpu_torch.quantization import qfunction
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18
from ppq_tpu_torch.zoo import tiny_cnn as torch_tiny_cnn


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


def _loader(shape, seed=3, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _pair(name):
    """(JAX graph, port graph, inputs): the JAX graph quantized, the port's
    carrying its parameters and TQCs."""
    if name == 'tiny':
        shape = (2, 3, 16, 16)
        jg = jax_tiny_cnn(input_shape=shape)
        tg = torch_tiny_cnn(input_shape=shape)
    else:
        shape = (2, 3, 32, 32)
        jg = jax_resnet18(num_classes=10, input_shape=shape)
        tg = torch_resnet18(num_classes=10, input_shape=shape)
    loader = _loader(shape)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    return jg, tg, loader


@pytest.fixture(scope='module')
def tiny():
    return _pair('tiny')


@pytest.fixture(scope='module')
def r18():
    return _pair('r18')


def _jax_forward(graph, x, **kw):
    cg, (out,) = _jax_forwards(graph, [x], **kw)
    return cg, out


def _torch_forward(graph, x, **kw):
    cg, (out,) = _torch_forwards(graph, [x], **kw)
    return cg, out


def _jax_forwards(graph, xs, **kw):
    """One compiled program (one trace and XLA compile) run on each input."""
    cg = jax_compile(graph, **kw)
    fn, params = cg.build_forward(), cg.init_params()
    return cg, [np.asarray(fn(params, {'input': x})[0]) for x in xs]


def _torch_forwards(graph, xs, **kw):
    cg = compile_graph(graph, device='cpu', **kw)
    fn, params = cg.build_forward(), cg.init_params()
    return cg, [fn(params, {'input': x})[0].numpy() for x in xs]


def _snr(pred, real):
    pred, real = np.asarray(pred, np.float64), np.asarray(real, np.float64)
    return float(((pred - real) ** 2).sum() / (real ** 2).sum())


@pytest.mark.parametrize('model', ['tiny', 'r18'])
def test_int_bit_equal_to_jax(model, request):
    jg, tg, loader = request.getfixturevalue(model)
    jc, wants = _jax_forwards(jg, loader, precision='int')
    tc, gots = _torch_forwards(tg, loader, precision='int')
    for got, want in zip(gots, wants):
        np.testing.assert_array_equal(got, want)
    assert tc.int_lowered == jc.int_lowered
    assert tc.int_coded == jc.int_coded
    assert tc.int_accum_risk == jc.int_accum_risk
    eligible = [op.name for op in tg.operations.values()
                if hasattr(op, 'config') and op.type in INT_EXACT_TYPES]
    assert sorted(tc.int_lowered) == sorted(eligible)
    if model == 'r18':
        # 21 lowered contractions, codes carried through the relus, pools
        # and residual adds; 11 3x3 convs whose worst case passes 2^24
        assert (len(tc.int_lowered), len(tc.int_coded),
                len(tc.int_accum_risk)) == (21, 19, 11)


def _int64_gold(x_codes, w_codes, op):
    """The convolution of integer codes in int64, by unfolding."""
    x = torch.from_numpy(x_codes.astype(np.int64))
    w = torch.from_numpy(w_codes.astype(np.int64))
    p = [int(v) for v in op.attributes.get('pads', [0, 0, 0, 0])]
    s = [int(v) for v in op.attributes.get('strides', [1, 1])]
    x = torch.nn.functional.pad(x, (p[1], p[3], p[0], p[2]))
    oc, ic, kh, kw = w.shape
    cols = x.unfold(2, kh, s[0]).unfold(3, kw, s[1])   # N C Ho Wo kh kw
    n, _, ho, wo = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(n, ho, wo, ic * kh * kw)
    y = cols @ w.reshape(oc, -1).T                      # int64 product
    return y.permute(0, 3, 1, 2).numpy()


@pytest.mark.parametrize('model', ['tiny', 'r18'])
def test_int_contractions_equal_int64_gold(model, request):
    """Every lowered convolution's sums of codes equal an int64 unfold and
    product of the same codes, bit for bit (the ResNet's risky 3x3 convs
    included: their sums stay under 2^24 on this data)."""
    _, tg, loader = request.getfixturevalue(model)
    cg = compile_graph(tg, precision='int', device='cpu')
    seen = []

    def probe(op, qx, qw, y):
        if op.type != 'Conv':
            return
        gold = _int64_gold(qx.numpy(), qw.numpy(), op)
        got = y.numpy().astype(np.float64)
        assert np.all(got == np.round(got)), op.name
        np.testing.assert_array_equal(got.astype(np.int64), gold,
                                      err_msg=op.name)
        seen.append(op.name)

    cg.int_probe = probe
    cg.build_forward()(cg.init_params(), {'input': loader[0]})
    assert len(seen) == len([op for op in tg.operations.values()
                             if op.type == 'Conv'])


@pytest.mark.parametrize('precision,bar', [('highest', 5e-3), ('default', 5e-3),
                                           ('bf16', 2e-2)])
def test_float_precisions_against_jax(r18, precision, bar):
    jg, tg, loader = r18
    _, wants = _jax_forwards(jg, loader, precision=precision)
    _, gots = _torch_forwards(tg, loader, precision=precision)
    for got, want in zip(gots, wants):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        assert _snr(got, want) < bar
        assert (got.argmax(-1) == want.argmax(-1)).all()


def test_highest_equals_the_eager_executor(r18):
    _, tg, loader = r18
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    run = compile_graph(tg, device='cpu').make_runner()
    for x in loader:
        np.testing.assert_array_equal(run(x)[0].numpy(),
                                      executor.forward(x)[0].numpy())


def test_bf16_stores_parameters_in_bf16(r18):
    _, tg, loader = r18
    cg = compile_graph(tg, precision='bf16', device='cpu')
    params = cg.init_params()
    assert params and all(v.dtype == torch.bfloat16 for v in params.values())
    assert cg.make_runner()(loader[0])[0].dtype == torch.float32


def test_int_accum_guard(r18):
    """Under the guard the risky contractions keep the float path: the same
    ops as the JAX package's, and the same logits bit for bit."""
    jg, tg, loader = r18
    jc, want = _jax_forward(jg, loader[0], precision='int',
                            int_accum_guard=True)
    tc, got = _torch_forward(tg, loader[0], precision='int',
                             int_accum_guard=True)
    assert tc.int_accum_risk == jc.int_accum_risk and tc.int_accum_risk
    assert not set(tc.int_lowered) & set(tc.int_accum_risk)
    assert tc.int_lowered == jc.int_lowered
    np.testing.assert_array_equal(got, want)


def test_qparam_writeback(tiny):
    _, tg, _ = tiny
    graph = tg.copy(copy_value=True)
    cg = compile_graph(graph, device='cpu')
    qparams = cg.init_qparams()
    assert qparams
    bumped = {k: {'scale': v['scale'] * 2.0, 'offset': v['offset']}
              for k, v in qparams.items()}
    cg.write_back_qparams(bumped)
    fresh = cg.init_qparams()
    for k in qparams:
        np.testing.assert_array_equal(fresh[k]['scale'].numpy(),
                                      qparams[k]['scale'].numpy() * 2.0)
    # the walk reads the written scales, not a stale device copy
    x = {'input': _loader((2, 3, 16, 16))[0]}
    before = compile_graph(tg, device='cpu').make_runner()(x)[0]
    after = compile_graph(graph, device='cpu').make_runner()(x)[0]
    assert not torch.equal(before, after)


@pytest.mark.parametrize('precision', ['int', 'highest'])
def test_device_qparams_that_a_capture_holds(tiny, precision):
    """What a capture holds after it is recorded (`_device_qparams`): every
    device scale and offset that the walk read, the very tensors the TQCs'
    roots keep; write-back drops the roots' own."""
    _, tg, loader = tiny
    graph = tg.copy(copy_value=True)
    cg = compile_graph(graph, device='cpu', precision=precision)
    cg.make_runner()(loader[0])
    held = {id(t) for pair in cg._device_qparams() for t in pair}
    read = [cfg for op in graph.operations.values() if hasattr(op, 'config')
            for var, cfg in op.config_pairs()
            if cfg.is_active and not var.is_parameter]
    assert read
    for cfg in read:
        pair = qfunction.device_qparams(cfg, 'cpu')
        assert {id(pair[0]), id(pair[1])} <= held, cfg
    cg.write_back_qparams(cg.init_qparams())
    assert not any(cfg.dominated_by._device_qparams for cfg in read)


def test_integer_contractions_pin_cudnn(tiny, monkeypatch):
    """Each contraction over integer codes runs with cuDNN's timed
    algorithm choice off and TF32 on, whatever the caller set, and the
    caller's flags are back after it; the other ops keep the caller's."""
    _, tg, loader = tiny
    seen = []
    conv = DEFAULT_BACKEND_TABLE['Conv']

    def recording_conv(op, values, ctx=None):
        seen.append((torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32))
        return conv(op, values, ctx)

    monkeypatch.setitem(DEFAULT_BACKEND_TABLE, 'Conv', recording_conv)
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', True)
    cg = compile_graph(tg, device='cpu', precision='int')
    cg.make_runner()(loader[0])
    lowered = [op for op in cg._order
               if op.type == 'Conv' and op.name in cg.int_lowered]
    assert lowered and len(seen) == len(
        [op for op in cg._order if op.type == 'Conv'])
    assert seen.count((False, True)) == len(lowered)
    assert torch.backends.cudnn.benchmark
    seen.clear()
    compile_graph(tg, device='cpu', precision='highest').make_runner()(
        loader[0])
    assert seen and all(s == (True, False) for s in seen)


def _reset_sites(graph, states, n=3):
    """Turn the first n activated root activation TQCs (the graph input's
    first) back to INITIAL: the sites a calibration walk observes."""
    names = []
    for op in graph.topological_sort():
        if not hasattr(op, 'config'):
            continue
        for var, cfg in op.config_pairs():
            if var.is_parameter or len(names) >= n or var.name in names:
                continue
            if cfg.is_root and cfg.state == states.ACTIVATED:
                cfg.state = states.INITIAL
                names.append(var.name)
    return names


SPECS = {
    'minmax': {'kind': 'minmax'},
    'percentile': {'kind': 'percentile', 'percentile': 0.99},
    'quantile_bisect': {'kind': 'quantile_bisect', 'percentile': 0.99},
    'absmax': {'kind': 'absmax'},
    'hist': {'kind': 'hist', 'bins': 2048},
    'absmax_hist': {'kind': 'absmax_hist', 'bins': 2048},
    'hist_signed': {'kind': 'hist_signed', 'bins': 2048},
}


@pytest.mark.parametrize('kind', list(SPECS))
def test_collect_stat_kinds_against_jax(tiny, kind):
    """Each stat kind of build_calibration_forward on the same sites. At the
    graph input both walks see the same numbers, and every kind agrees bit
    for bit (counts exactly); at the sites behind a convolution the values
    differ in their last bits (other summation orders), so statistics within
    1e-5 relative and counts within 1e-3 of the elements."""
    jg0, tg0, loader = tiny
    jg, tg = jg0.copy(copy_value=True), tg0.copy(copy_value=True)
    jnames = _reset_sites(jg, JaxStates)
    tnames = _reset_sites(tg, QuantizationStates)
    assert jnames == tnames and jnames[0] == 'input'
    spec = {n: dict(SPECS[kind]) for n in tnames}
    ranges = None
    if kind == 'hist':
        hist_scales = {n: 0.01 for n in tnames}
    else:
        hist_scales = None
    if kind == 'absmax_hist':
        ranges = {n: np.float32(0.005) for n in tnames}
    if kind == 'hist_signed':
        ranges = {n: (np.float32(-3.0), np.float32(0.003)) for n in tnames}
    x = loader[0]
    jc = jax_compile(jg)
    j_args = (jc.init_params(), {'input': x}) + ((ranges,) if ranges else ())
    _, jstats = jc.build_calibration_forward(spec, hist_scales)(*j_args)
    tc = compile_graph(tg, device='cpu')
    _, tstats = tc.build_calibration_forward(spec, hist_scales)(
        tc.init_params(), {'input': x}, ranges)
    assert sorted(jstats) == sorted(tstats) == sorted(tnames)
    for name in tnames:
        want = jstats[name] if isinstance(jstats[name], tuple) \
            else (jstats[name],)
        got = tstats[name] if isinstance(tstats[name], tuple) \
            else (tstats[name],)
        for w, g in zip(want, got):
            w, g = np.asarray(w), g.numpy()
            if g.dtype == np.int64:           # counts
                assert g.sum() == w.sum()
                if name == 'input':
                    np.testing.assert_array_equal(g, w)
                else:
                    assert np.abs(g - w).sum() <= 1e-3 * w.sum()
            elif name == 'input':
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_stem_rewrite_on_the_compiled_path(r18):
    """stem_space_to_depth (Reshape, Transpose, a stride-1 stem) leaves the
    'int' logits unchanged bit for bit (integer sums in another order) and
    'highest' within 1e-5; the port's rewritten graph equals the JAX
    package's in 'int'."""
    jg0, tg0, loader = r18
    jg, tg = jg0.copy(copy_value=True), tg0.copy(copy_value=True)
    x = loader[0]
    _, int_before = _torch_forward(tg, x, precision='int')
    _, fp_before = _torch_forward(tg, x)
    assert stem_space_to_depth(tg) == 1 and jax_stem(jg) == 1
    assert stem_space_to_depth(tg) == 0
    stem = [op for op in tg.operations.values() if op.type == 'Conv'
            and op.inputs[1].value.shape[1] == 12]
    assert len(stem) == 1 and stem[0].inputs[0].source_op.type == 'Reshape'
    tc, int_after = _torch_forward(tg, x, precision='int')
    _, fp_after = _torch_forward(tg, x)
    np.testing.assert_array_equal(int_after, int_before)
    assert np.abs(fp_after - fp_before).max() <= \
        1e-5 * np.abs(fp_before).max()
    jc, want = _jax_forward(jg, x, precision='int')
    np.testing.assert_array_equal(int_after, want)
    assert tc.int_lowered == jc.int_lowered


def test_chain_runner_equals_chain1_calls(r18):
    _, tg, loader = r18
    cg = compile_graph(tg, precision='int', device='cpu')
    one, chained = cg.make_runner(), cg.make_runner(chain=2)
    stacked = chained(np.stack(loader))[0]
    assert stacked.shape == (2, 2, 10)
    for i, x in enumerate(loader):
        assert torch.equal(stacked[i], one(x)[0])
    with pytest.raises(ValueError):
        chained(loader[0][None])


def test_compilable_and_data_dependent_ops(tiny):
    _, tg, _ = tiny
    assert compilable(tg) == (True, [])
    graph = tg.copy(copy_value=True)
    next(iter(graph.operations.values())).type = 'NonZero'
    ok, bad = compilable(graph)
    assert not ok and len(bad) == 1
    with pytest.raises(ValueError):
        CompiledGraph(graph, device='cpu')


def test_op_spans_and_output_names_against_jax(tiny):
    """A contiguous op span (the blockwise passes' unit) and an inner output
    compile as in the JAX package: the same inputs and outputs, the same
    values bit for bit in 'int'."""
    from ppq_tpu.executor import CompiledGraph as JaxCompiledGraph
    jg, tg, loader = tiny
    jorder = [op.name for op in jg.topological_sort()]
    torder = [op.name for op in tg.topological_sort()]
    assert jorder == torder
    names = torder[2:6]
    jc = JaxCompiledGraph(jg, op_span=[jg.operations[n] for n in names],
                          precision='int')
    tc = CompiledGraph(tg, op_span=[tg.operations[n] for n in names],
                       precision='int', device='cpu')
    assert tc._input_names == jc._input_names and \
        tc.output_names == jc.output_names
    inner = tc._input_names[0]
    full = compile_graph(tg, output_names=[inner], device='cpu')
    x = full.build_forward()(full.init_params(), {'input': loader[0]})[0]
    jx = jax_compile(jg, output_names=[inner])
    jxv = np.asarray(jx.build_forward()(jx.init_params(),
                                        {'input': loader[0]})[0])
    np.testing.assert_array_equal(x.numpy(), jxv)
    got = tc.build_forward()(tc.init_params(), {inner: x})
    want = jc.build_forward()(jc.init_params(), {inner: jxv})
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
