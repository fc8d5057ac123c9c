"""Ring attention (`ppq_tpu_torch/serving/ring_attention.py`) and the GPipe
forward (`serving/pipeline.py`) on gloo ranks on the CPU, held against the
JAX package's `sequence_parallel_attention` and `pipeline_forward` on the
conftest's virtual devices, on the inputs of tests/test_ring_attention.py
and tests/test_pipeline.py.

One world of four ranks (`parallel.spawn`, 120 s timeout) runs every case
for the module; the rank bodies are in tests/torch_dist_cases.py, which
imports no JAX. Tolerances are the JAX tests' own: ring attention 2e-5
(the two frameworks sum the float32 products in other orders), the
pipeline rtol 1e-4 / atol 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ppq_tpu.serving import pipeline as jpipeline
from ppq_tpu.serving import ring_attention as jring
from ppq_tpu_torch.parallel import spawn
from ppq_tpu_torch.serving.ring_attention import reference_attention
import torch_dist_cases as cases

# (ranks, sequence length, causal)
RING = [(2, 16, True), (4, 32, True), (2, 16, False), (4, 32, False)]
# (stages, layers, microbatches), as tests/test_pipeline.py:31
PIPE = [(2, 4, 2), (4, 8, 4), (4, 8, 8)]


def _qkv(T, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, T, 4, 16).astype(np.float32) for _ in range(3)]


def _layers(n, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [{'w': (rng.randn(d, d) * 0.2).astype(np.float32),
             'b': (rng.randn(d) * 0.1).astype(np.float32)} for _ in range(n)]


def _x():
    return np.random.RandomState(1).randn(8, 16).astype(np.float32)


@pytest.fixture(scope='module')
def started():
    """Every case on one world of four ranks, started in a thread while
    this process computes the JAX references: per rank, (ring outputs,
    pipeline outputs)."""
    ring_cases = [(n, *_qkv(T, i), causal)
                  for i, (n, T, causal) in enumerate(RING)]
    pipe_cases = [(s, m, _layers(n), _x()) for s, n, m in PIPE]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, 4, cases.ring_and_pipeline,
                          (ring_cases, pipe_cases), device='cpu',
                          timeout=120)


@pytest.fixture(scope='module')
def jax_references(started):
    """The JAX package's ring attention and pipeline outputs, jitted (one
    compile, where the eager shard_map dispatches op by op)."""
    ring = []
    for i, (n, T, causal) in enumerate(RING):
        q, k, v = _qkv(T, i)
        mesh = Mesh(np.array(jax.devices()[:n]), ('sp',))
        ring.append(np.asarray(jax.jit(
            lambda *a, mesh=mesh, causal=causal:
            jring.sequence_parallel_attention(*a, mesh, causal=causal))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))))
    pipe = []
    for stages, n_layers, micro in PIPE:
        mesh = Mesh(np.array(jax.devices()[:stages]), ('pp',))
        stacked = jpipeline.stack_layer_params(
            [{k: jnp.asarray(v) for k, v in l.items()}
             for l in _layers(n_layers)])
        pipe.append(np.asarray(jax.jit(
            lambda p, x, mesh=mesh, micro=micro: jpipeline.pipeline_forward(
                p, x, _jax_block, mesh, microbatches=micro))(
            stacked, jnp.asarray(_x()))))
    return ring, pipe


@pytest.fixture(scope='module')
def world(started, jax_references):
    return started.result()


@pytest.mark.parametrize('case', range(len(RING)),
                         ids=[f'sp{n}-T{T}-{"causal" if c else "full"}'
                              for n, T, c in RING])
def test_ring_attention_vs_jax(world, jax_references, case):
    n, T, causal = RING[case]
    q, k, v = _qkv(T, case)
    want = jax_references[0][case]
    # rank i holds the i-th chunk of the sequence; ranks outside the mesh
    # hold nothing
    parts = [w[0][case] for w in world]
    assert all(p is None for p in parts[n:])
    got = np.concatenate(parts[:n], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


def test_reference_attention_vs_jax():
    q, k, v = _qkv(32, 7)
    for causal in (True, False):
        want = np.asarray(jring.reference_attention(q, k, v, causal=causal))
        got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _jax_block(lp, x):
    return jax.nn.gelu(x @ lp['w'] + lp['b'])


@pytest.mark.parametrize('case', range(len(PIPE)),
                         ids=[f'{s}stages-{n}layers-{m}mb'
                              for s, n, m in PIPE])
def test_pipeline_forward_vs_jax(world, jax_references, case):
    stages, n_layers, micro = PIPE[case]
    want = jax_references[1][case]
    outs = [w[1][case] for w in world]
    assert all(o is None for o in outs[stages:])
    for got in outs[:stages]:
        # every stage ends with the last stage's outputs
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
