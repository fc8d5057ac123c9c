"""The port's native host libraries held against the JAX package's, on the
CPU: the paged-KV block allocator (the repository's csrc/allocator.cc, built
unedited into ppq_tpu_torch/csrc/build/) and the prefetching npy loader
(csrc/dataloader.cc).

  * the allocator on tests/test_native_allocator.py's randomized schedule,
    beside the JAX package's native and Python allocators: the same tables,
    free counts and errors after every step; exhaustion all or nothing; the
    over-max error;
  * a paged engine on it: the same tokens and block tables as on the
    Python free list, every block back after the run;
  * NpyLoader: every dtype bit for bit the JAX package's loader's (and
    np.load's), in submit order, re-iterable; a bad file raises;
  * `load_calibration_dir` into `quantize_graph`: the same scales as the
    same batches from memory.
Both libraries build with g++; where the toolchain is missing, the tests
that need them skip (decided inside each test).
"""

import numpy as np
import pytest
import torch

import ppq_tpu_torch
from ppq_tpu.serving.paged import BlockAllocator as JaxBlockAllocator
from ppq_tpu.utils import dataio as jax_dataio
from ppq_tpu.utils.native import native_alloc as jax_native_alloc
from ppq_tpu_torch import zoo as torch_zoo
from ppq_tpu_torch.serving import LlamaConfig, Request, ServingEngine
from ppq_tpu_torch.serving import init_llama_params
from ppq_tpu_torch.serving.paged import BlockAllocator
from ppq_tpu_torch.utils import (NpyLoader, load_calibration_dir,
                                 native_alloc, native_dataio)

ARRAYS = [
    np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32),
    np.random.RandomState(1).randn(2, 7).astype(np.float64),
    np.arange(24, dtype=np.int64).reshape(2, 3, 4),
    np.arange(10, dtype=np.int32),
    (np.random.RandomState(2).rand(5, 5) * 255).astype(np.uint8),
    (np.random.RandomState(5).rand(3, 2) * 200 - 100).astype(np.int8),
    np.asarray(3.5, np.float32),
    np.random.RandomState(3).randn(8).astype(np.float16),
    np.random.RandomState(6).rand(4, 4) > 0.5,
    np.asfortranarray(np.random.RandomState(7).randn(3, 5).astype(
        np.float32)),
]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module (see tests/test_torch_slice.py):
    what is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _need(lib, what):
    if lib is None:
        pytest.skip(f'no C++ toolchain for the {what}')


def _write(tmp_path, arrays, stem='batch'):
    paths = []
    for i, a in enumerate(arrays):
        path = tmp_path / f'{stem}_{i:03d}.npy'
        np.save(str(path), a)
        paths.append(str(path))
    return paths


# ------------------------------------------------------------ allocator ---

def test_allocator_schedule_matches_the_jax_allocators():
    _need(native_alloc(), 'allocator')
    kw = dict(num_blocks=33, max_batch=8, max_blocks_per_seq=4,
              block_size=128)
    mine = BlockAllocator(native=True, **kw)
    assert mine.backend == 'native'
    others = [JaxBlockAllocator(native=False, **kw)]
    if jax_native_alloc() is not None:
        others.append(JaxBlockAllocator(native=True, **kw))
    rng = np.random.RandomState(0)
    for step in range(500):
        slot = int(rng.randint(0, 8))
        if rng.rand() < 0.6:
            tokens = int(rng.randint(1, 4 * 128 + 1))
            errors = []
            for alloc in [mine] + others:
                try:
                    alloc.ensure(slot, tokens)
                    errors.append(None)
                except (MemoryError, ValueError) as e:
                    errors.append(type(e))
            assert len(set(errors)) == 1, (step, errors)
        else:
            for alloc in [mine] + others:
                alloc.release(slot)
        for other in others:
            assert mine.free_blocks == other.free_blocks, step
            np.testing.assert_array_equal(mine.tables(), other.tables())
            assert mine.slot_block_ids(slot) == other.slot_block_ids(slot)


@pytest.mark.parametrize('native', [True, False])
def test_allocator_exhaustion_and_over_max(native):
    if native:
        _need(native_alloc(), 'allocator')
    alloc = BlockAllocator(4, 2, 8, 128, native=native)
    assert alloc.backend == ('native' if native else 'python')
    alloc.ensure(0, 2 * 128)
    before, free = alloc.tables().copy(), alloc.free_blocks
    with pytest.raises(MemoryError):
        alloc.ensure(1, 3 * 128)
    assert alloc.free_blocks == free == 1
    np.testing.assert_array_equal(alloc.tables(), before)
    with pytest.raises(ValueError):
        alloc.ensure(1, 9 * 128)
    alloc.release(0)
    assert alloc.free_blocks == 3


def test_paged_engine_on_the_native_allocator(monkeypatch):
    """The engine on the native allocator (PPQ_TPU_NATIVE_ALLOC=1): its run
    gives the Python free list's tokens and the same block tables at every
    step, and returns every block."""
    _need(native_alloc(), 'allocator')
    cfg = dict(vocab_size=97, d_model=256, n_layers=2, n_heads=2,
               n_kv_heads=1, d_ff=256, max_seq_len=256, max_batch=4,
               prefill_buckets=(16,), kv_block_size=128)
    params = init_llama_params(LlamaConfig(**cfg, paged_kv=True), seed=0,
                               device='cpu')
    runs = []
    for native in ('1', '0'):
        monkeypatch.setenv('PPQ_TPU_NATIVE_ALLOC', native)
        eng = ServingEngine(LlamaConfig(**cfg, paged_kv=True), params,
                            device='cpu')
        assert eng._alloc.backend == ('native' if native == '1'
                                      else 'python')
        rng = np.random.RandomState(0)
        reqs = [Request(i, rng.randint(1, 96, 12 + 30 * i).tolist(),
                        max_new_tokens=5) for i in range(3)]
        tables, alloc = [], eng._alloc
        read = alloc.tables
        alloc.tables = lambda: tables.append(read()) or tables[-1]
        eng.run(reqs, sync_every=4)
        assert all(r.done and len(r.generated) == 5 for r in reqs)
        assert alloc.free_blocks == alloc.num_blocks - 1
        runs.append(([r.generated for r in reqs], tables))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1]) > 0
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- npy loader ---

def test_npy_loader_matches_the_jax_loader(tmp_path):
    _need(native_dataio(), 'npy loader')
    paths = _write(tmp_path, ARRAYS)
    loader = NpyLoader(paths, prefetch=3, threads=2)
    assert loader.native and len(loader) == len(ARRAYS)
    want = list(jax_dataio.NpyLoader(paths, prefetch=3, threads=2))
    for _ in range(2):                        # re-iterable
        got = list(loader)
        assert len(got) == len(ARRAYS)
        for g, w, ref in zip(got, want, ARRAYS):
            assert g.dtype == w.dtype == ref.dtype
            assert g.shape == w.shape == ref.shape
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, ref)
    python = list(NpyLoader(paths, native=False))
    for g, ref in zip(python, ARRAYS):
        np.testing.assert_array_equal(g, ref)


def test_npy_loader_order_and_bad_file(tmp_path):
    _need(native_dataio(), 'npy loader')
    paths = _write(tmp_path, [np.full((3, 3), i, np.int32)
                              for i in range(40)])
    got = list(NpyLoader(paths, prefetch=4, threads=4))
    assert [int(g[0, 0]) for g in got] == list(range(40))
    bad = tmp_path / 'junk.npy'
    bad.write_bytes(b'not an npy file at all')
    for loader in (NpyLoader, jax_dataio.NpyLoader):
        with pytest.raises(IOError):
            list(loader([str(bad)], native=True))


def test_load_calibration_dir_feeds_quantize_graph(tmp_path):
    _need(native_dataio(), 'npy loader')
    rng = np.random.RandomState(4)
    batches = [rng.randn(2, 3, 16, 16).astype(np.float32) for _ in range(3)]
    _write(tmp_path, batches)
    (tmp_path / 'notes.txt').write_text('not a batch')
    graphs = []
    for loader in (load_calibration_dir(str(tmp_path)), batches):
        g = torch_zoo.tiny_cnn(input_shape=(2, 3, 16, 16))
        ppq_tpu_torch.quantize_graph(
            g, loader, calib_steps=3,
            platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, verbose=False,
            device='cpu')
        graphs.append(g)
    assert len(load_calibration_dir(str(tmp_path), limit=2)) == 2
    n = 0
    for name, op in graphs[0].operations.items():
        if not hasattr(op, 'config'):
            continue
        for a, b in zip(op.config, graphs[1].operations[name].config):
            assert a.state == b.state
            if a.has_scale:
                np.testing.assert_array_equal(np.asarray(a.scale),
                                              np.asarray(b.scale))
                n += 1
    assert n > 10
    torch.testing.assert_close(
        ppq_tpu_torch.TorchExecutor(graphs[0], device='cpu').forward(
            torch.from_numpy(batches[0]))[0],
        ppq_tpu_torch.TorchExecutor(graphs[1], device='cpu').forward(
            torch.from_numpy(batches[0]))[0], rtol=0, atol=0)
