"""The port's deployment utilities (ppq_tpu_torch/utils/deploy.py, flops.py,
ema.py) held against the JAX package's, on the CPU.

tiny_cnn (2x3x16x16) is quantized by the JAX package with TPU_INT8 and its
parameters and TQCs are carried into the port's graph of the same model
(`interop.carry`), so both packages deploy the same quantized graph:
  * the port's artifact (a torch.export program, weights baked in) reloads
    and runs bit for bit the port's own compiled runner, at 'highest' and
    at 'int', and keeps every fake-quant site as one custom operator;
  * its output against the JAX package's StableHLO artifact within 1e-5 of
    the largest |output| (the packages' convolutions sum in other orders:
    recorded difference 38; measured under 1e-6);
  * `benchmark_graph` gives the JAX package's row keys, `profile_graph`
    writes a trace, `graph_flops` equals the JAX count and EMARecorder the
    JAX recorder.
"""

import os

import numpy as np
import pytest
import torch

import ppq_tpu
from ppq_tpu import zoo as jax_zoo
from ppq_tpu.api import format_graph as jax_format_graph
from ppq_tpu.utils import EMARecorder as JaxEMARecorder
from ppq_tpu.utils import deploy as jax_deploy
from ppq_tpu.utils import flops as jax_flops
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.api import format_graph
from ppq_tpu_torch.executor.compile import compile_graph
from ppq_tpu_torch.interop import (load_parameters, load_quantization_configs,
                                   parameters_of, quantization_configs_of)
from ppq_tpu_torch.utils import EMARecorder, deploy, flops

SHAPE = (2, 3, 16, 16)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def pair():
    rng = np.random.RandomState(0)
    loader = [rng.randn(*SHAPE).astype(np.float32) for _ in range(2)]
    jg = jax_zoo.tiny_cnn(input_shape=SHAPE)
    ppq_tpu.quantize_graph(jg, loader, calib_steps=2,
                           platform=ppq_tpu.TargetPlatform.TPU_INT8,
                           verbose=False)
    tg = torch_zoo.tiny_cnn(input_shape=SHAPE)
    import ppq_tpu_torch
    ppq_tpu_torch.quantize_graph(
        tg, loader, calib_steps=2,
        platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
        device='cpu')
    load_parameters(tg, parameters_of(jg))
    load_quantization_configs(tg, quantization_configs_of(jg))
    return jg, tg, loader


def _active_sites(graph):
    return sum(cfg.is_active for op in graph.operations.values()
               if hasattr(op, 'config') for cfg in op.config)


@pytest.mark.parametrize('precision', ['highest', 'int'])
def test_artifact_roundtrip_bit_exact(pair, tmp_path, precision):
    _, tg, loader = pair
    path = str(tmp_path / 'model.pt2')
    assert deploy.export_compiled_artifact(tg, path, precision=precision,
                                           device='cpu') == path
    assert os.path.getsize(path) > 1000
    run = deploy.load_compiled_artifact(path)
    assert run.precision == precision
    runner = compile_graph(tg, precision=precision, device='cpu').make_runner()
    for x in loader:
        got = run({list(tg.inputs)[0]: x})[0]
        assert torch.equal(got, runner(x)[0])
        assert torch.equal(run(x)[0], got)
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == 'call_function']
    sites = targets.count('ppq_tpu_torch.linear_quant.default')
    assert sites > 0
    if precision == 'highest':
        # the plain version's arithmetic is nowhere in the program ('int'
        # divides and rounds its own codes around the contractions)
        assert sites == _active_sites(tg)
        assert not any('round' in t or 'div' in t for t in targets)


def test_artifact_against_the_jax_artifact(pair, tmp_path):
    jg, tg, loader = pair
    jpath, tpath = str(tmp_path / 'model.stablehlo'), str(tmp_path / 'm.pt2')
    jax_deploy.export_compiled_artifact(jg, jpath, precision='highest')
    deploy.export_compiled_artifact(tg, tpath, precision='highest',
                                    device='cpu')
    jrun = jax_deploy.load_compiled_artifact(jpath)
    trun = deploy.load_compiled_artifact(tpath)
    name = list(tg.inputs)[0]
    for x in loader:
        want = np.asarray(jrun({name: x})[0])
        got = trun({name: x})[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_benchmark_and_profile(pair, tmp_path):
    jg, tg, _ = pair
    rows = deploy.benchmark_graph(tg, batch_sizes=(2, 4), iters=2, warmup=1,
                                  device='cpu')
    want = jax_deploy.benchmark_graph(jg, batch_sizes=(2,), iters=1,
                                      warmup=0)
    assert [sorted(r) for r in rows] == [sorted(want[0])] * 2
    assert [r['batch'] for r in rows] == [2, 4]
    for r in rows:
        assert r['items_per_sec'] > 0 and r['latency_ms'] > 0
        assert r['mfu'] is None                  # no card peak on the CPU
    logdir = str(tmp_path / 'prof')
    assert deploy.profile_graph(tg, logdir, iters=2, device='cpu') == logdir
    trace = os.path.join(logdir, 'trace.json')
    assert os.path.getsize(trace) > 100


def test_flops_and_ema():
    tg = format_graph(torch_zoo.tiny_cnn(input_shape=list(SHAPE)))
    jg = jax_format_graph(jax_zoo.tiny_cnn(input_shape=list(SHAPE)))
    x = np.zeros(SHAPE, np.float32)
    want = jax_flops.graph_flops(jg, inputs=x)
    assert flops.graph_flops(tg, inputs=x) == want > 0
    assert [flops.op_flops(op) for op in tg.operations.values()] == \
        [jax_flops.op_flops(op) for op in jg.operations.values()]
    assert flops.device_peak_flops(device='cpu') is None
    assert flops.mfu(1e9, 100.0, device='cpu') is None
    assert set(flops.PRECISION_MATH) == {'highest', 'default', 'int', 'bf16'}


@pytest.mark.parametrize('name, precision, peak', [
    ('NVIDIA H100 80GB HBM3', 'highest', 67e12),
    ('NVIDIA H100 80GB HBM3', 'default', 495e12),
    ('NVIDIA H100 80GB HBM3', 'int', 495e12),
    ('NVIDIA H100 80GB HBM3', 'bf16', 989e12),
    ('NVIDIA H100 PCIe', 'default', None),
    ('NVIDIA H100 NVL', 'bf16', None),
])
def test_peak_by_card_name_and_runner_precision(monkeypatch, name, precision,
                                                peak):
    """The MFU denominator is the listed card's peak for the math the
    runner's precision computes in; a card named otherwise gets none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: name)
    dtype = flops.PRECISION_MATH[precision]
    assert flops.device_peak_flops(dtype) == peak
    want = None if peak is None else 2e9 * 100.0 / peak
    assert flops.mfu(2e9, 100.0, dtype) == want
    mine, theirs = EMARecorder(0.9), JaxEMARecorder(0.9)
    with pytest.raises(ValueError):
        mine.value
    for v in np.random.RandomState(0).rand(20):
        assert mine.push(v) == theirs.push(v)
    assert mine.value == theirs.value
