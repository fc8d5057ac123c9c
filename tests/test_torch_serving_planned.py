"""The rest of the serving engine of ppq_tpu_torch against ppq_tpu on the
CPU: the planned run loop (dense, paged with the prefix cache), the serving
benchmarks, `prewarm_decode` and the in-place cache reset.

The same seeded weights go into both packages. The planned loop is held bit
for bit against the port's own synchronous loop (the same decisions, the
same programs), and against the JAX package's tokens by the near-tie rule
of tests/test_torch_serving.py (bf16 activations round differently in the
two frameworks). Each JAX engine runs its requests once, for every test.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu_torch.interop import llama_params_from_numpy
from ppq_tpu_torch.serving import LlamaConfig, Request, ServingEngine
from ppq_tpu_torch.serving import model as tmodel

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=256, max_seq_len=128, max_batch=4, prefill_buckets=(16, 64))
# head dim 128 and blocks of 128 (the paged path's kernels); a 160 bucket
# takes a whole 128-token shared prefix and its tail in one prefill
PAGED = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
             n_kv_heads=1, d_ff=512, max_seq_len=256, max_batch=4,
             prefill_buckets=(16, 160), kv_block_size=128,
             prefix_cache_blocks=8)
CONFIGS = {'dense': TINY, 'paged': PAGED}
LOGIT_TOL = 2e-2
SYNC = 4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors here are small. With one thread PyTorch opens no OpenMP
    region, whose idle workers would otherwise spin on the cores that the
    other test processes need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def _configs(kind):
    size = CONFIGS[kind]
    jcfg = jconfig.LlamaConfig(**size)
    jcfg.use_pallas_matmul, jcfg.use_ragged_attention = False, False
    tcfg = LlamaConfig(**size)
    if kind == 'paged':
        jcfg.paged_kv, jcfg.ragged_interpret = True, True
        tcfg.paged_kv = True
    return jcfg, tcfg


_PARAMS = {}


def _params(kind):
    """(JAX parameters, the port's) from one seed, built once."""
    if kind not in _PARAMS:
        jcfg, _ = _configs(kind)
        jp = jmodel.init_llama_params(jcfg, seed=0)
        _PARAMS[kind] = jp, llama_params_from_numpy(_np_tree(jp), device='cpu')
    return _PARAMS[kind]


def _port(kind):
    return ServingEngine(_configs(kind)[1], _params(kind)[1], device='cpu')


def _jax(kind):
    return jengine.ServingEngine(_configs(kind)[0], _params(kind)[0])


def _requests(cls, kind):
    """More requests than slots, no eos. Dense: prompts of 3 to 60 tokens
    and one of 70 (over the last bucket: the chunked prefill). Paged: six
    prompts sharing a 128-token prefix (one block), so that the second
    wave adopts the first wave's cached block."""
    rng = np.random.default_rng(5)
    if kind == 'dense':
        lengths = [int(n) for n in rng.integers(3, 61, size=7)]
        lengths[2] = 70
        return [cls(i, [int(t) for t in rng.integers(1, 256, size=n)],
                    max_new_tokens=int(rng.integers(4, 13)))
                for i, n in enumerate(lengths)]
    prefix = [int(t) for t in rng.integers(1, 256, size=128)]
    return [cls(i, prefix + [int(t) for t in rng.integers(
                1, 256, size=int(rng.integers(5, 21)))],
                max_new_tokens=int(rng.integers(4, 9)))
            for i in range(6)]


_JAX_RUNS = {}


def _jax_run(kind):
    """The JAX engine's `run` of `_requests` (its planned loop), once:
    (requests, prefix hits, prefix misses)."""
    if kind not in _JAX_RUNS:
        eng = _jax(kind)
        reqs = _requests(jengine.Request, kind)
        eng.run(reqs, sync_every=SYNC)
        pc = eng.prefix_cache
        _JAX_RUNS[kind] = (reqs, pc and pc.hits, pc and pc.misses)
    return _JAX_RUNS[kind]


def _reference_logits(kind, params, tcfg, sequence):
    """The port's dense forward over the whole sequence: its next token's
    logits."""
    cfg = LlamaConfig(**dict(CONFIGS[kind], max_seq_len=512))
    cfg.use_kernel_matmul, cfg.norm_folded = False, tcfg.norm_folded
    T = len(sequence)
    cache = tmodel.init_kv_cache(cfg, 1, 'cpu')
    logits, _ = tmodel.forward(
        params, cache, torch.tensor([sequence], dtype=torch.int32),
        torch.arange(T, dtype=torch.int32)[None],
        torch.zeros(1, dtype=torch.int32),
        torch.full((1,), T, dtype=torch.int32), cfg)
    return logits[0, -1].numpy()


# ------------------------------------------------------------- the loop ----

class _Planned(Exception):
    pass


class _Synchronous(Exception):
    pass


@pytest.mark.parametrize('case', ['budget', 'one_eos', 'sync_1', 'arrivals',
                                  'no_requests'])
def test_run_takes_the_planned_loop_where_the_jax_package_does(case):
    """`run` takes `_run_planned` exactly where the JAX package does: no
    eos in any request, sync_every > 1, no arrivals (and some requests)."""
    took = []
    for eng, cls in ((_jax('dense'), jengine.Request),
                     (_port('dense'), Request)):
        reqs = [cls(i, [3, 4, 5], max_new_tokens=4) for i in range(2)]
        kw = dict(sync_every=SYNC)
        if case == 'one_eos':
            reqs[1].eos_id = 7
        elif case == 'sync_1':
            kw['sync_every'] = 1
        elif case == 'arrivals':
            kw['arrivals'] = [0.0, 0.0]
        elif case == 'no_requests':
            reqs = []

        def planned(*args, **kwargs):
            raise _Planned

        def admit(*args, **kwargs):
            raise _Synchronous
        eng._run_planned, eng._admit_batch = planned, admit
        try:
            eng.run(reqs, **kw)
            took.append('returned')
        except _Planned:
            took.append('planned')
        except _Synchronous:
            took.append('synchronous')
    assert took[0] == took[1]
    assert (took[0] == 'planned') == (case == 'budget')


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_planned_tokens_equal_the_synchronous_loop(kind):
    """The planned loop's tokens are the synchronous loop's bit for bit (the
    sync loop taken through arrivals all at 0, which admits alike): every
    request finishes with its whole budget, every slot and block is free
    after, and the prefix cache counts alike."""
    out = []
    for arrivals in (None, [0.0] * 6 if kind == 'paged' else [0.0] * 7):
        eng = _port(kind)
        reqs = _requests(Request, kind)
        eng.run(reqs, sync_every=SYNC, arrivals=arrivals)
        assert all(r.done and len(r.generated) == r.max_new_tokens
                   and all(0 <= t < 256 for t in r.generated) for r in reqs)
        assert all(r is None for r in eng.slot_req) and not eng.slot_len.any()
        if kind == 'paged':
            held = len(eng.prefix_cache.index)
            assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1 - held
            eng.prefix_cache.clear()
            assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
        out.append(([r.generated for r in reqs],
                    eng.prefix_cache and (eng.prefix_cache.hits,
                                          eng.prefix_cache.misses)))
    assert out[0] == out[1]


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_planned_tokens_against_jax(kind):
    """The port's planned run against the JAX package's on the same weights
    and requests: the greedy tokens by the near-tie rule (where a token
    differs, both candidates lie within the logit tolerance of each other
    and of the top, and that request's comparison ends there); on the
    paged engine the same prefix hits and misses (4 misses in the first
    wave, which matches before it inserts; 2 hits in the second)."""
    jreqs, jhits, jmisses = _jax_run(kind)
    eng = _port(kind)
    treqs = _requests(Request, kind)
    eng.run(treqs, sync_every=SYNC)
    compared = equal = 0
    for a, b in zip(jreqs, treqs):
        assert len(a.generated) == len(b.generated) == b.max_new_tokens
        for i, (x, y) in enumerate(zip(a.generated, b.generated)):
            compared += 1
            if x == y:
                equal += 1
                continue
            logits = _reference_logits(kind, eng.params, eng.cfg,
                                       b.prompt + b.generated[:i])
            scale = LOGIT_TOL * np.abs(logits).max()
            assert abs(logits[x] - logits[y]) <= scale
            assert logits.max() - min(logits[x], logits[y]) <= scale
            break
    assert equal >= 0.8 * compared
    if kind == 'paged':
        assert (eng.prefix_cache.hits, eng.prefix_cache.misses) \
            == (jhits, jmisses) == (2, 4)
        held = len(eng.prefix_cache.index)
        assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1 - held


# ---------------------------------------------------------- benchmarks -----

@pytest.mark.parametrize('seed', [0, 3])
def test_mixed_requests_are_the_jax_packages(seed):
    """The mixed and open-loop workload: the same numpy stream gives the
    same prompts, lengths, budgets, eos and sampling."""
    jreqs, jlens = _jax('dense')._mixed_requests(40, 24, 12, 2, seed)
    treqs, tlens = _port('dense')._mixed_requests(40, 24, 12, 2, seed)
    np.testing.assert_array_equal(jlens, tlens)
    for a, b in zip(jreqs, treqs):
        assert (a.rid, a.prompt, a.max_new_tokens, a.eos_id) \
            == (b.rid, b.prompt, b.max_new_tokens, b.eos_id)
        assert (a.sampling is None) == (b.sampling is None)
        if a.sampling is not None:
            assert (a.sampling.temperature, a.sampling.top_p,
                    a.sampling.seed) == (b.sampling.temperature,
                                         b.sampling.top_p, b.sampling.seed)


def _visits(eng, paged):
    """Record each burst the engine's prewarm would run (slot 0's fill,
    the burst length, its shape and whether it samples) without running
    it."""
    seen = []
    B = eng.cfg.max_batch
    if paged:
        def paged_decode(n, *args, samp=None):
            # the JAX package passes a key before the active slots
            seen.append((int(eng.slot_len[0]), n, len(args[-1]),
                         samp is None))
            return torch.zeros((n, B)), eng.cache
        eng._paged_decode = paged_decode
    else:
        def stub(n, bucket, grouped=True):
            def fn(params, cache, tokens, seq, *rest):
                seen.append((int(eng.slot_len[0]), n, bucket, grouped,
                             rest[-1] is None))
                return torch.zeros((n, B)), cache
            return fn
        eng._build_decode_burst = stub
    return seen


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_prewarm_decode_visits_the_jax_ladder(kind):
    """prewarm_decode walks the JAX package's fill ladder (16, 48, 96, 192,
    384, 768, cap), greedy and sampled, burst shape for burst shape, and
    leaves the slots empty and every block free."""
    paged = kind == 'paged'
    visits = []
    for eng in (_jax(kind), _port(kind)):
        seen = _visits(eng, paged)
        eng.prewarm_decode(200, 8)
        eng.prewarm_decode(40, 4, with_sampling=False)
        visits.append(seen)
        assert not eng.slot_len.any()
        if paged:
            assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1
    assert visits[0] == visits[1]
    cap = CONFIGS[kind]['max_seq_len'] - 8 - 2
    assert [v[0] for v in visits[1][::2]][:3] == [16, 48, 96] \
        and visits[1][-3][0] == min(200, cap)


def _check_latencies(out):
    for k in ('ttft_p50_ms', 'ttft_p99_ms', 'tpot_p50_ms', 'tpot_p99_ms'):
        assert k in out and out[k] > 0, (k, out)
    assert out['ttft_p99_ms'] >= out['ttft_p50_ms']
    assert out['tpot_p99_ms'] >= out['tpot_p50_ms']


def _jax_keys(method, *args, **kwargs):
    """The keys the JAX package's benchmark returns, its engine's `run`
    and warm-up stubbed (each request generates its budget at once): the
    keys come from the benchmark's own code."""
    eng = _jax('dense')

    def run(reqs, sync_every=1, progress=False, arrivals=None):
        t0 = time.perf_counter()
        for i, r in enumerate(reqs):
            r.t_submit = t0 + (arrivals[i] if arrivals else 0.0)
            r.t_first, r.t_done = r.t_submit + 1e-3, r.t_submit + 2e-3
            r.generated = [1] * r.max_new_tokens
            r.done = True
        return reqs
    eng.run = run
    eng._warm_serving = lambda *a, **k: None
    out = getattr(eng, method)(*args, **kwargs)
    if 'rate_points' in out:
        return sorted(out), [sorted(p) for p in out['rate_points']]
    return sorted(out)


def test_benchmark_serving_keys_and_invariants():
    """benchmark_serving (the planned loop) returns the JAX version's keys,
    with positive rates and generated <= total tokens."""
    eng = _port('dense')
    out = eng.benchmark_serving(n_requests=6, prompt_len=8, max_new_tokens=6,
                                sync_every=SYNC)
    assert sorted(out) == _jax_keys('benchmark_serving', 6, 8, 6, SYNC)
    assert out['requests_per_sec'] > 0 and out['wall_s'] > 0
    assert 0 < out['generated_tokens_per_sec'] <= out['total_tokens_per_sec']
    assert all(r is None for r in eng.slot_req) and not eng.slot_len.any()


def test_mixed_benchmark_keys_and_latency_percentiles():
    """tests/test_serving.py's mixed case on the port: the JAX version's
    keys, and TTFT / TPOT percentiles, p99 >= p50."""
    kw = dict(n_requests=6, mean_prompt=8, max_new_tokens=6, sync_every=SYNC)
    out = _port('dense').benchmark_serving_mixed(**kw)
    assert sorted(out) == _jax_keys('benchmark_serving_mixed', **kw)
    _check_latencies(out)


def test_open_loop_benchmark_keys_and_queueing_latency():
    """tests/test_serving.py's open-loop case: TTFT from the scheduled
    arrival, the offered rate reported, the JAX version's keys."""
    kw = dict(rate_rps=500.0, n_requests=8, mean_prompt=8, max_new_tokens=4,
              sync_every=SYNC)
    out = _port('dense').benchmark_serving_open(**kw)
    assert sorted(out) == _jax_keys('benchmark_serving_open', **kw)
    assert out['offered_rate_rps'] == 500.0 and out['completed_rps'] > 0
    _check_latencies(out)


def test_open_loop_sweep_keys_and_steady_state_window():
    """tests/test_serving.py's sweep case: per-point windows that exclude
    warm-up and drain, the sustained flag, sustainable_rps the largest
    sustained rate; the JAX version's keys, the sweep's and each point's."""
    kw = dict(rates=[4.0, 8.0], duration_s=1.0, mean_prompt=8,
              max_new_tokens=4, sync_every=SYNC)
    eng = _port('dense')
    out = eng.benchmark_serving_open_sweep(**kw)
    assert (sorted(out), [sorted(p) for p in out['rate_points']]) \
        == _jax_keys('benchmark_serving_open_sweep', **kw)
    assert len(out['rate_points']) == 2
    for p in out['rate_points']:
        assert 0 < p['window_s'] <= p['wall_s'] + 1e-6
        assert p['offered_in_window_rps'] > 0
    sustained = [p['offered_rps'] for p in out['rate_points']
                 if p['sustained']]
    assert out['sustainable_rps'] == max(sustained, default=0.0)


# ------------------------------------------------------ the cache reset ----

def _drain(alloc):
    """Every slot grown one block at a time to its most, in slot order: the
    block each step takes, or where the pool ran out, then the tables. With
    a pool the slots can hold whole, this reads the allocator's whole free
    list in order, on either backend."""
    taken = []
    for slot in range(alloc.max_batch):
        for n in range(1, alloc.max_blocks_per_seq + 1):
            try:
                alloc.ensure(slot, n * alloc.block_size)
            except MemoryError:
                taken.append(('exhausted', slot, n))
                continue
            taken.append(alloc.slot_block_ids(slot)[-1])
    return taken, alloc.tables().tolist(), alloc.free_blocks


def _reset_and_new(kind):
    """An engine after a run and `_reset_cache`, and a new engine."""
    eng = _port(kind)
    eng.run(_requests(Request, kind)[:3], sync_every=SYNC)
    addresses = [t.data_ptr() for t in eng.cache.values()]
    assert any(bool(t.any()) for t in eng.cache.values())
    eng._reset_cache()
    fresh = _port(kind)
    assert [t.data_ptr() for t in eng.cache.values()] == addresses
    for key, t in fresh.cache.items():
        assert torch.equal(eng.cache[key], t)
    return eng, fresh


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_reset_cache_in_place_gives_a_new_caches_values(kind):
    """`_reset_cache` (recorded difference 42) leaves the values a new cache
    has, in the same tensors, and a paged engine's allocator and prefix
    cache as new ones are."""
    eng, fresh = _reset_and_new(kind)
    if kind == 'paged':
        assert eng._alloc.backend == fresh._alloc.backend
        if eng._alloc.backend == 'python':
            assert eng._alloc.free == fresh._alloc.free
        np.testing.assert_array_equal(eng._alloc.tables(),
                                      fresh._alloc.tables())
        assert eng.prefix_cache is not None and not eng.prefix_cache.index \
            and eng.prefix_cache.hits == eng.prefix_cache.misses == 0
        # and the whole list in its order, as it is handed out
        assert _drain(eng._alloc) == _drain(fresh._alloc)


def test_reset_cache_in_place_gives_a_new_native_allocator(monkeypatch):
    """The same reset on the native allocator (PPQ_TPU_NATIVE_ALLOC=1),
    whose free list is not readable from Python: drained, the reset one
    hands out the whole list in a new one's order."""
    from ppq_tpu_torch.utils.native import native_alloc
    if native_alloc() is None:
        pytest.skip('the native allocator did not build (no g++)')
    monkeypatch.setenv('PPQ_TPU_NATIVE_ALLOC', '1')
    eng, fresh = _reset_and_new('paged')
    assert eng._alloc.backend == fresh._alloc.backend == 'native'
    assert eng._alloc.free_blocks == fresh._alloc.free_blocks
    np.testing.assert_array_equal(eng._alloc.tables(), fresh._alloc.tables())
    assert _drain(eng._alloc) == _drain(fresh._alloc)
