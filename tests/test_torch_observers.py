"""The port's observers and threshold searches held against the JAX
package's, on the same numpy inputs. The port reduces on the CPU here."""

import numpy as np
import pytest
import torch

from ppq_tpu.core import PPQ_TPU_CONFIG
from ppq_tpu.core import QuantizationPolicy as JaxPolicy
from ppq_tpu.core import TensorQuantizationConfig as JaxTQC
from ppq_tpu.quantization import observers as jax_observers
from ppq_tpu.quantization import solvers as jax_solvers
from ppq_tpu_torch.core import PPQ_TPU_CONFIG as TORCH_CONFIG
from ppq_tpu_torch.core import QP, QuantizationPolicy, TensorQuantizationConfig
from ppq_tpu_torch.quantization import observers, solvers

PER_TENSOR = int(QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL)
PER_CHANNEL = int(QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL)
ASYM_TENSOR = int(QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL)


def _pair(policy_bits, algo, channel_axis=None, qmin=-128, qmax=127):
    kw = dict(num_of_bits=8, quant_min=qmin, quant_max=qmax,
              observer_algorithm=algo, channel_axis=channel_axis)
    return (JaxTQC(policy=JaxPolicy(policy_bits), **kw),
            TensorQuantizationConfig(policy=QuantizationPolicy(policy_bits), **kw))


def _batches(seed, shape=(4, 16, 9, 9), n=3, relu=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.randn(*shape) * rng.rand() * 3).astype(np.float32)
        out.append(np.maximum(x, 0) if relu else x)
    return out


def _observe(algo, policy_bits, batches, channel_axis=None, **kw):
    jcfg, tcfg = _pair(policy_bits, algo, channel_axis, **kw)
    jobs = jax_observers.build_observer(jcfg)
    tobs = observers.build_observer(tcfg)
    for phase in (1, 2):
        for b in batches:
            jobs.observe(b)
            tobs.observe(torch.from_numpy(b))
        if phase == 1 and not hasattr(jobs, 'start_phase2'):
            break
        if phase == 1:
            jobs.start_phase2()
            tobs.start_phase2()
    jobs.render_quantization_config()
    tobs.render_quantization_config()
    return jobs, tobs, jcfg, tcfg


@pytest.mark.parametrize('case', [
    (PER_TENSOR, None), (PER_CHANNEL, 0), (PER_CHANNEL, 1), (ASYM_TENSOR, None)],
    ids=['tensor', 'channel0', 'channel1', 'asym'])
def test_minmax_bitwise(case):
    bits, axis = case
    qmin, qmax = (0, 255) if bits == ASYM_TENSOR else (-128, 127)
    _, _, jcfg, tcfg = _observe('minmax', bits, _batches(0), axis,
                                qmin=qmin, qmax=qmax)
    np.testing.assert_array_equal(tcfg.scale, jcfg.scale)
    np.testing.assert_array_equal(tcfg.offset, jcfg.offset)
    assert tcfg.state.name == jcfg.state.name == 'ACTIVATED'


def test_minmax_on_host_parameter():
    """Parameters arrive as host numpy arrays, as in ParameterQuantizePass."""
    w = np.random.RandomState(1).randn(8, 3, 3, 3).astype(np.float32)
    jcfg, tcfg = _pair(PER_CHANNEL, 'minmax', 0)
    for cfg, mod in ((jcfg, jax_observers), (tcfg, observers)):
        obs = mod.build_observer(cfg)
        obs.observe(w)
        obs.render_quantization_config()
    np.testing.assert_array_equal(tcfg.scale, jcfg.scale)


@pytest.mark.parametrize('case', [
    (PER_TENSOR, None, (4, 16, 9, 9)), (PER_CHANNEL, 1, (4, 16, 9, 9)),
    (PER_TENSOR, None, (3, 7, 11)), (ASYM_TENSOR, None, (2, 8, 5, 5))],
    ids=['tensor', 'channel1', 'odd', 'asym'])
def test_percentile_matches_jnp_quantile(case):
    """Two order statistics by top-k, interpolated with jnp's float32
    position and weights: equal up to the interpolation's rounding (the
    weights may multiply in another order), so rtol 1e-6."""
    bits, axis, shape = case
    qmin, qmax = (0, 255) if bits == ASYM_TENSOR else (-128, 127)
    jobs, tobs, jcfg, tcfg = _observe('percentile', bits,
                                      _batches(2, shape), axis,
                                      qmin=qmin, qmax=qmax)
    np.testing.assert_allclose(tobs._hi_sum, jobs._hi_sum, rtol=1e-6)
    np.testing.assert_allclose(tobs._lo_sum, jobs._lo_sum, rtol=1e-6)
    np.testing.assert_allclose(tcfg.scale, jcfg.scale, rtol=1e-6)


@pytest.mark.parametrize('q', [0.0, 0.5, 0.9999, 1.0, 1e-4])
def test_quantile_rows_edges(q):
    import jax.numpy as jnp
    x = np.random.RandomState(3).randn(3, 1001).astype(np.float32)
    want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=1))
    got = observers.quantile_rows(torch.from_numpy(x), q)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize('algo', ['kl', 'mse'])
@pytest.mark.parametrize('relu', [False, True], ids=['signed', 'relu'])
def test_hist_observers_same_histogram_and_bin(algo, relu):
    jobs, tobs, jcfg, tcfg = _observe(algo, PER_TENSOR,
                                      _batches(4, relu=relu))
    # identical histograms (exact counts), identical clip search
    assert tobs._hist_scale == jobs._hist_scale
    np.testing.assert_array_equal(tobs._hist, jobs._hist)
    np.testing.assert_array_equal(tcfg.scale, jcfg.scale)


def _test_histograms():
    rng = np.random.RandomState(5)
    out = []
    for n in (2048, 4096):
        for decay in (80.0, 300.0, 900.0):
            h = np.abs(rng.randn(n)) * np.exp(-np.arange(n) / decay) * 1000
            out.append(np.floor(h))
        spike = np.floor(np.abs(rng.randn(n)) * np.exp(-np.arange(n) / 200.0)
                         * 500)
        spike[0] = 1e6                            # post-ReLU zero bin
        out.append(spike)
    return out


def test_numpy_searches_pick_the_reference_default_bin():
    """The port's numpy KL/MSE searches (its native library switched off
    here; tests/test_torch_solvers.py holds the library itself). The JAX
    package's default is its native library when that builds
    (USING_NATIVE_SOLVER), else the same numpy code: on these histograms
    both pick the same bin."""
    assert PPQ_TPU_CONFIG.USING_NATIVE_SOLVER
    saved = TORCH_CONFIG.USING_NATIVE_SOLVER
    TORCH_CONFIG.USING_NATIVE_SOLVER = False
    try:
        for hist in _test_histograms():
            assert solvers.kl_threshold_search(hist, 128) == \
                jax_solvers.kl_threshold_search(hist, 128)
            assert solvers.mse_threshold_search(hist, 0.01, 128) == \
                jax_solvers.mse_threshold_search(hist, 0.01, 128)
    finally:
        TORCH_CONFIG.USING_NATIVE_SOLVER = saved
