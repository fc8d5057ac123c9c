"""The port's native solver library (ppq_tpu_torch/utils/native.py, a copy
of csrc/solvers.cc built with g++) held against the JAX package's
(ppq_tpu/utils/native.py) and against the port's numpy twins, on seeded
histograms; and the device copies of the qparams that ppq_fake_quant reads
(quantization/qfunction.py `device_qparams`)."""

import numpy as np
import pytest
import torch

from ppq_tpu.utils.native import native_solvers as jax_native_solvers
from ppq_tpu_torch.core import (PPQ_TPU_CONFIG, QP, QuantizationPolicy,
                                QuantizationStates, TensorQuantizationConfig)
from ppq_tpu_torch.quantization import qfunction, solvers
from ppq_tpu_torch.utils import native


@pytest.fixture(scope='module')
def libs():
    ours, theirs = native.native_solvers(), jax_native_solvers()
    if ours is None or theirs is None:
        pytest.skip('no C++ toolchain')
    return ours, theirs


def _histograms():
    """Seeded |x| histograms: decays of three lengths at 2048 and 4096
    bins, and a post-ReLU spike in bin 0."""
    rng = np.random.RandomState(0)
    out = []
    for n in (2048, 4096):
        for decay in (80.0, 300.0, 900.0):
            out.append(np.floor(np.abs(rng.randn(n))
                                * np.exp(-np.arange(n) / decay) * 1000))
        spike = np.floor(np.abs(rng.randn(n)) * np.exp(-np.arange(n) / 200.0)
                         * 500)
        spike[0] = 1e6
        out.append(spike)
    return out


def _numpy_only(fn, *args):
    saved = PPQ_TPU_CONFIG.USING_NATIVE_SOLVER
    PPQ_TPU_CONFIG.USING_NATIVE_SOLVER = False
    try:
        return fn(*args)
    finally:
        PPQ_TPU_CONFIG.USING_NATIVE_SOLVER = saved


@pytest.mark.parametrize('case', range(8))
def test_library_picks_the_jax_library_bin(libs, case):
    ours, theirs = libs
    hist = _histograms()[case]
    for levels, interval in ((128, 8), (128, 1), (64, 4)):
        assert ours.kl_search(hist, levels, interval) == \
            theirs.kl_search(hist, levels, interval)
        assert ours.mse_search(hist, 0.01, levels, interval) == \
            theirs.mse_search(hist, 0.01, levels, interval)
    assert ours.compute_mse_loss(hist, 0, 1, len(hist)) == \
        theirs.compute_mse_loss(hist, 0, 1, len(hist))
    values = np.random.RandomState(case).randn(257)
    np.testing.assert_array_equal(ours.isotone(values), theirs.isotone(values))


@pytest.mark.parametrize('case', range(8))
def test_searches_route_through_the_library(libs, case):
    """kl_threshold_search and mse_threshold_search run the library (the
    SEARCHES count says so) and pick the bin of their numpy twins and of
    the JAX package's default search."""
    from ppq_tpu.quantization import solvers as jax_solvers
    hist = _histograms()[case]
    before = dict(solvers.SEARCHES)
    kl = solvers.kl_threshold_search(hist, 128)
    mse = solvers.mse_threshold_search(hist, 0.01, 128)
    assert solvers.SEARCHES['native'] == before['native'] + 2
    assert solvers.SEARCHES['numpy'] == before['numpy']
    assert kl == _numpy_only(solvers.kl_threshold_search, hist, 128) == \
        jax_solvers.kl_threshold_search(hist, 128)
    assert mse == _numpy_only(solvers.mse_threshold_search, hist, 0.01,
                              128) == \
        jax_solvers.mse_threshold_search(hist, 0.01, 128)


def test_a_failed_build_warns_and_takes_numpy(monkeypatch, tmp_path):
    monkeypatch.setattr(native, '_lib_cache', None)
    monkeypatch.setattr(native, '_build_failed', False)
    monkeypatch.setattr(native, '_SRC', str(tmp_path / 'missing.cc'))
    monkeypatch.setattr(native, '_SO', str(tmp_path / 'lib.so'))
    monkeypatch.setattr(native, '_BUILD_DIR', str(tmp_path))
    warned = []
    monkeypatch.setattr(native, 'ppq_warning', warned.append)
    assert native.native_solvers() is None
    assert warned and 'falling back to numpy' in warned[0]
    hist = _histograms()[0]
    want = _numpy_only(solvers.kl_threshold_search, hist, 128)
    before = dict(solvers.SEARCHES)
    assert solvers.kl_threshold_search(hist, 128) == want
    assert solvers.SEARCHES['numpy'] == before['numpy'] + 1


def _tqc(scale, offset=0.0, asym=False):
    bits = QP.PER_TENSOR | QP.LINEAR | (QP.ASYMMETRICAL if asym
                                        else QP.SYMMETRICAL)
    return TensorQuantizationConfig(
        policy=QuantizationPolicy(int(bits)), quant_min=0 if asym else -128,
        quant_max=255 if asym else 127, scale=np.float32(scale),
        offset=np.float32(offset), state=QuantizationStates.ACTIVATED)


def test_device_qparams_are_kept_per_root_and_follow_changes():
    x = torch.from_numpy(np.random.RandomState(0).randn(64)
                         .astype(np.float32))
    root, site = _tqc(0.02), _tqc(0.5)
    site.dominated_by = root                  # site: OVERLAPPED under root
    site.state = QuantizationStates.PASSIVE
    s1, o1 = qfunction.device_qparams(site, 'cpu')
    assert float(s1) == np.float32(0.02) and float(o1) == 0
    # kept on the root: the same tensors for both configs and every call
    assert qfunction.device_qparams(root, 'cpu')[0] is s1
    assert qfunction.device_qparams(site, 'cpu')[0] is s1
    y1 = qfunction.ppq_fake_quant(x, site)
    # a new scale on the dominator reaches the dominated site, not stale
    root.scale = np.float32(0.05)
    s2, _ = qfunction.device_qparams(site, 'cpu')
    assert s2 is not s1 and float(s2) == np.float32(0.05)
    y2 = qfunction.ppq_fake_quant(x, site)
    want = torch.clamp(torch.round(x / 0.05), -128, 127) * np.float32(0.05)
    assert torch.equal(y2, want.to(torch.float32))
    assert not torch.equal(y1, y2)
    # an offset and a state change each drop the copy
    for change in (lambda: setattr(root, 'offset', np.float32(0.0)),
                   lambda: setattr(root, 'state',
                                   QuantizationStates.ACTIVATED)):
        before = qfunction.device_qparams(root, 'cpu')[0]
        change()
        assert not root._device_qparams
        assert qfunction.device_qparams(root, 'cpu')[0] is not before
    # a domination change: detached, the site reads its own scale again
    site.detach()
    assert float(qfunction.device_qparams(site, 'cpu')[0]) == \
        np.float32(0.5)


def test_device_qparams_offsets_by_policy():
    """A symmetric site under an asymmetric root reads the root's scale and
    a zero offset; the root its own offset."""
    root = _tqc(0.1, offset=3.0, asym=True)
    site = _tqc(0.5)
    site.dominated_by = root
    s, o = qfunction.device_qparams(root, 'cpu')
    assert float(o) == 3.0
    s0, o0 = qfunction.device_qparams(site, 'cpu')
    assert float(s0) == np.float32(0.1) and float(o0) == 0.0
