"""The serving engine's pipeline (pp) and sequence (sp) meshes
(`ppq_tpu_torch/serving/pipeline.py`, the sp paths of `serving/paged.py`
and `serving/model.py`, the engine's mesh branches) on gloo ranks on the
CPU, held against the JAX package: the legs of MULTICHIP_r05.json that
BASELINE.json's decoder configuration needs, dense pp 2 (leg 5), dense sp 2
(leg 6), paged pp 2 (8), paged sp 2 x tp 2 (9), paged dp 2 x sp 2 with the
dp-grouped prefix cache (10) and paged pp 2 x sp 2 (11).

The model: 4 layers, d_model 256 as 2 heads of 128 (the paged path's head
dim), 2 kv heads (one a rank at tp 2), d_ff 256, vocab 256, max_seq_len
256, blocks of 128, 4 slots, prefill bucket 64. Five requests: two of 150
tokens (they stream in chunks and cross the 128-position boundary of a
two-way sequence shard; the fifth repeats the first), three short ones; in
the paged sp legs a slot's blocks lie on both shards.

What is compared, and how close:
  * `GroupedBlockAllocator` and `GroupedPrefixCache` against the JAX
    classes, call for call: block ids, tables, free counts, hits and misses
    bit for bit;
  * `paged_decode_sp` on sp 2 and dp 2 x sp 2 against the JAX package's
    unsharded read (`paged_decode_xla`, jitted) of the whole pool: the
    normalized output within atol = rtol = 2e-2 and m within rtol 1e-2
    (tests/test_engine_pp_sp.py's); a slot no shard holds gives the empty
    triple (acc 0, l 0: recorded difference 14); the shard's blocks
    compacted, a trash row a rank (difference 57);
  * the staged paged prefill and chunk on pp 2 and pp 2 x sp 2 against the
    JAX single-device `prefill_paged` / `prefill_chunk_paged` (jitted): the
    logits within 5e-2 of the largest |logit| (that file's TOL), the first
    layer's written pool blocks within one int8 level (a deeper layer's
    codes carry the two packages' bf16 drift, up to 4 levels at layer 3 on
    one card); every layer's within one level of the port's one-card
    prefill and chunk (measured: equal), scales within rtol 2.4e-2;
  * a dense prefill and three single steps on pp 2 (`forward_staged`) and
    on a sequence-sharded cache (sp 2) against the JAX `forward` (jitted):
    the same logit bound; the cache codes within one level, layer 0 against
    the JAX package and against the port's one-card forward, and every
    layer of the stages against the port's one card (measured: equal;
    the staged paths are the one-card functions on a stage, difference 55;
    the sequence shards' reads merge partial softmaxes, difference 56);
  * every leg's engine `run` against the JAX single-device engine's tokens
    (one run, shared by the legs), under tests/test_torch_serving.py's
    near-tie rule: where a token differs, the two candidates' logits (the
    port on one process) are within 2e-2 of the largest |logit| of each
    other, and that request's comparison ends there; the probe logits (one
    forward over the first prompt, staged or sharded as the leg) within 2e-2
    of the largest |logit| of the JAX engine's; every rank's tokens equal.
One world of four ranks (`parallel.spawn`, device 'cpu' named, 240 s
timeout) runs every case, two-rank ones two at a time on the rank pairs
(0, 1) and (2, 3), while this process computes the JAX references, each
jitted (no JAX staged or sp function runs); the rank bodies are in
tests/torch_pp_sp_cases.py (no JAX).
"""

import functools
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu.serving import paged as jpaged
from ppq_tpu_torch.parallel import spawn
from ppq_tpu_torch.serving import (LlamaConfig, ServingEngine,
                                   init_llama_params)
from ppq_tpu_torch.serving import paged as tpaged
import torch_dist_cases
import torch_pp_sp_cases as cases

BASE = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=2, n_kv_heads=2,
            d_ff=256, max_seq_len=256, max_batch=4, prefill_buckets=(64,))
PAGED = dict(paged_kv=True, kv_block_size=128)
# name: (config fields, mesh axes, first rank)
LEGS = {
    'sp2tp2_paged': (dict(PAGED), [('sp', 2), ('tp', 2)], 0),
    'dp2sp2_paged': (dict(PAGED, prefix_cache_blocks=8),
                     [('dp', 2), ('sp', 2)], 0),
    'pp2sp2_paged': (dict(PAGED), [('pp', 2), ('sp', 2)], 0),
    'pp2_dense': (dict(use_ragged_attention=True), [('pp', 2)], 0),
    'sp2_dense': (dict(use_ragged_attention=True), [('sp', 2)], 2),
    'pp2_paged': (dict(PAGED), [('pp', 2)], 0),
    'sp2_plain': (dict(use_ragged_attention=False), [('sp', 2)], 2),
}
TOL, LOGIT_TOL = 5e-2, 2e-2
SEED = 2

# paged_decode_sp: 2 layers, 8 blocks of 128 (4 a shard at sp 2, 2 at
# dp 2 x sp 2); slot 0 and 2 cross shards, slot 3 lies on shard 0 alone,
# slot 4 holds nothing
DEC_TABLES = np.array([[1, 6], [3, 4], [7, 2], [2, 3], [5, 1]], np.int32)
DEC_LENS = np.array([200, 129, 256, 256, 0], np.int32)
# the staged paged prefill: slot s holds blocks s + 1 and s + 5 (10 blocks,
# 5 a shard at sp 2: every second block on the other shard); 100 tokens,
# then a chunk of 64 that crosses into the second block
PF_TABLES = np.array([[1, 5], [2, 6], [3, 7], [4, 8]], np.int32)
PF_BLOCKS, PF_T0, PF_T1 = 10, 100, 64


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _decode_inputs():
    rng = np.random.RandomState(0)
    L, NB, BLK, KV, Dh = 2, 8, 128, 2, 128
    kv = rng.randint(-127, 128, (L, NB, 2, BLK, KV * Dh)).astype(np.int8)
    sc = (rng.rand(L, NB, 2, KV, BLK) * 0.02).astype(np.float32)
    q = rng.randn(len(DEC_LENS), KV, 2, Dh).astype(np.float32)
    return q, kv, sc


def _prefill_inputs():
    rng = np.random.RandomState(3)
    return (rng.randint(1, 256, (4, PF_T0)).astype(np.int32),
            rng.randint(1, 256, (4, PF_T1)).astype(np.int32))


def _dense_inputs():
    rng = np.random.RandomState(4)
    return (rng.randint(1, 256, (4, 150)).astype(np.int32),
            [rng.randint(1, 256, 4).astype(np.int32) for _ in range(3)])


def _module_cases():
    q, kv, sc = _decode_inputs()
    toks0, toks1 = _prefill_inputs()
    prompt, steps = _dense_inputs()
    paged = dict(BASE, **PAGED)
    dec = ('decode_sp', q, kv, sc, DEC_TABLES, DEC_LENS)
    pf = ('staged_paged', paged, SEED, toks0, toks1, PF_TABLES, PF_BLOCKS)
    dense = ('dense_steps', BASE, SEED, prompt, steps)
    return [('decode_dp2sp2', [('dp', 2), ('sp', 2)], 0, dec),
            ('staged_pp2sp2', [('pp', 2), ('sp', 2)], 0, pf),
            ('decode_sp2', [('sp', 2)], 0, dec),
            ('staged_pp2', [('pp', 2)], 2, pf),
            ('dense_pp2', [('pp', 2)], 0, dense),
            ('dense_sp2', [('sp', 2)], 2, dense)]


@pytest.fixture(scope='module')
def started():
    """The world, started in a thread: the JAX references are computed
    while its ranks run."""
    legs = [(name, axes, first, (dict(BASE, **fields),))
            for name, (fields, axes, first) in LEGS.items()]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, 4, cases.world, (_module_cases(), legs),
                          device='cpu', timeout=240)


@pytest.fixture(scope='module')
def world(started, jax_engine, jax_modules):
    out = {}
    for rank in started.result():
        for name, res in rank.items():
            out.setdefault(name, {})[rank['rank']] = res
    return out


def _jax_cfg(**extra):
    cfg = jconfig.LlamaConfig(**BASE, **extra)
    return cfg


@pytest.fixture(scope='module')
def jax_engine(started):
    """The JAX single-device engine on the legs' requests: its tokens, and
    its logits after the first prompt (jitted forward)."""
    cfg = _jax_cfg()
    eng = jengine.ServingEngine(cfg, jmodel.init_llama_params(cfg, seed=0))
    reqs = [jengine.Request(r.rid, r.prompt, r.max_new_tokens)
            for r in cases.requests(BASE['vocab_size'])]
    eng.run(reqs, sync_every=4)
    seq = reqs[0].prompt
    T = len(seq)
    fwd = jax.jit(functools.partial(jmodel.forward, cfg=cfg))
    logits, _ = fwd(eng.params, jmodel.init_kv_cache(cfg, 1),
                    jnp.asarray([seq], jnp.int32),
                    jnp.arange(T, dtype=jnp.int32)[None],
                    jnp.zeros(1, jnp.int32), jnp.full((1,), T, jnp.int32))
    return [list(r.generated) for r in reqs], np.asarray(logits)[0, -1]


@pytest.fixture(scope='module')
def jax_modules(started):
    """The JAX references of the module cases, every one jitted."""
    out = {}
    q, kv, sc = _decode_inputs()
    L, NB = kv.shape[:2]
    read = jax.jit(jpaged.paged_decode_xla)
    flat_kv = jnp.asarray(kv.reshape((L * NB,) + kv.shape[2:]))
    flat_sc = jnp.asarray(sc.reshape((L * NB,) + sc.shape[2:]))
    out['decode'] = [tuple(np.asarray(t) for t in read(
        jnp.asarray(q), flat_kv, flat_sc, jnp.asarray(DEC_TABLES + li * NB),
        jnp.asarray(DEC_LENS))) for li in range(L)]

    cfg = _jax_cfg(**PAGED)
    params = jmodel.init_llama_params(cfg, seed=SEED)
    toks0, toks1 = _prefill_inputs()
    B = toks0.shape[0]
    tables, active = jnp.asarray(PF_TABLES), jnp.ones((B,), bool)
    pre = jax.jit(functools.partial(jpaged.prefill_paged, cfg=cfg))
    chunk = jax.jit(functools.partial(jpaged.prefill_chunk_paged,
                                      prefix_blocks=1, cfg=cfg))
    l0, pools = pre(params, jpaged.init_paged_pools(cfg, PF_BLOCKS),
                    jnp.asarray(toks0), jnp.full((B,), PF_T0, jnp.int32),
                    tables, active)
    l1, pools = chunk(params, pools, jnp.asarray(toks1),
                      jnp.full((B,), PF_T0, jnp.int32), tables, active)
    out['staged'] = (np.asarray(l0), np.asarray(l1),
                     {k: np.asarray(v) for k, v in pools.items()})

    cfg = _jax_cfg()
    params = jmodel.init_llama_params(cfg, seed=SEED)
    prompt, steps = _dense_inputs()
    B, T = prompt.shape
    fwd = jax.jit(functools.partial(jmodel.forward, params, cfg=cfg))
    cache = jmodel.init_kv_cache(cfg, B)
    logits, cache = fwd(cache, jnp.asarray(prompt),
                        jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None],
                                         (B, T)),
                        jnp.zeros((B,), jnp.int32), jnp.full((B,), T, jnp.int32))
    dense = [np.asarray(logits)]
    seq = jnp.full((B,), T, jnp.int32)
    for cur in steps:
        logits, cache = fwd(cache, jnp.asarray(cur)[:, None], seq[:, None],
                            seq, seq + 1)
        dense.append(np.asarray(logits))
        seq = seq + 1
    out['dense'] = (dense, {k: np.asarray(v) for k, v in cache.items()})
    return out


# ---------------------------------------------------------------- modules --
def test_grouped_allocator_and_prefix_cache_match_jax():
    """The dp-grouped allocator and prefix cache, call for call against the
    JAX classes: the same block ids, tables, free counts, refusals, hits
    and misses."""
    args = (16, 4, 4)
    ja = jpaged.GroupedBlockAllocator(*args, block_size=128, groups=2,
                                      native=False)
    ta = tpaged.GroupedBlockAllocator(*args, block_size=128, groups=2)
    jc = jpaged.GroupedPrefixCache(ja, 128, 4)
    tc = tpaged.GroupedPrefixCache(ta, 128, 4)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 97, 300).tolist()

    def both(name, *a, **k):
        want = getattr(ja, name)(*a, **k)
        got = getattr(ta, name)(*a, **k)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want, (name, a)
        assert ta.free_blocks == ja.free_blocks
        np.testing.assert_array_equal(ta.tables(), ja.tables())
    both('ensure', 0, 300)
    both('ensure', 2, 200)
    assert all(1 <= b < 8 for b in ta.slot_block_ids(0))
    assert all(9 <= b < 16 for b in ta.slot_block_ids(2))
    assert ta.tables()[3][0] == 8
    for cache in (jc, tc):
        cache.insert(prompt, (ja if cache is jc else ta).slot_block_ids(0),
                     slot=0)
    both('release', 0)
    both('ensure', 1, 100)
    for slot in (1, 3, 0):
        assert tc.match(prompt, slot=slot) == jc.match(prompt, slot=slot)
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses) == (2, 1)
    shared = ta.slot_block_ids(1)
    for alloc in (ja, ta):
        with pytest.raises(ValueError, match='dp group'):
            alloc.adopt(3, shared)
    both('adopt', 0, tc.match(prompt, slot=0))
    both('ensure', 0, 300)
    both('slot_block_ids', 0)
    both('retain', [9])
    both('unref', [9])
    both('release', 2)
    for cache in (jc, tc):
        cache.clear()
    both('release', 0)
    both('release', 1)
    assert ta.free_blocks == 14


@pytest.mark.parametrize('case', ['decode_sp2', 'decode_dp2sp2'])
def test_paged_decode_sp_matches_unsharded_read(world, jax_modules, case):
    """Every rank's merged read equals the unsharded one: the normalized
    output and the global max; the slot that no shard holds is the empty
    triple on every rank."""
    want = jax_modules['decode']
    ranks = world[case]
    assert len(ranks) == (4 if 'dp' in case else 2)
    live = DEC_LENS > 0
    first = ranks[min(ranks)]
    for (ga, gm, gl), (ra, rm, rl) in zip(first, want):
        np.testing.assert_allclose(
            ga[live] / gl[live][..., None], ra[live] / rl[live][..., None],
            atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(gm[live], rm[live], rtol=1e-2)
        assert not np.any(ga[~live]) and not np.any(gl[~live])
        assert np.all(gm[~live] == np.float32(-1e30))
    for got in ranks.values():
        for a, b in zip(got, first):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _global_pools(ranks, axes):
    """The global pools from the ranks' slices: stage s holds layers
    [s*per, (s+1)*per), sp shard i blocks [i*nb, (i+1)*nb) at local rows
    1 .. nb."""
    shape = dict(axes)
    pp, sp = shape.get('pp', 1), shape.get('sp', 1)
    parts = {}
    for rank, res in ranks.items():
        i = rank - min(ranks)
        s, j = (i // sp, i % sp)
        for k, v in res[2].items():
            per = v.shape[0]
            nb = v.shape[1] - 1 if sp > 1 else v.shape[1]
            out = parts.setdefault(k, np.zeros((per * pp, nb * sp)
                                               + v.shape[2:], v.dtype))
            out[s * per:(s + 1) * per, j * nb:(j + 1) * nb] = \
                v[:, 1:] if sp > 1 else v
    return parts


_ONE_POOLS = {}


def _one_card_pools():
    """The port's one-card prefill and chunk on the staged cases' inputs."""
    if not _ONE_POOLS:
        cfg = LlamaConfig(**BASE, **PAGED)
        cfg.use_kernel_matmul = False
        params = init_llama_params(cfg, seed=SEED, device='cpu')
        toks0, toks1 = _prefill_inputs()
        B = toks0.shape[0]
        pools = tpaged.init_paged_pools(cfg, PF_BLOCKS, 'cpu')
        tables, active = torch.from_numpy(PF_TABLES), torch.ones(B, dtype=torch.bool)
        start = torch.full((B,), PF_T0, dtype=torch.int32)
        with torch.no_grad():
            tpaged.prefill_paged(params, pools, torch.from_numpy(toks0), start,
                                 tables, active, cfg)
            tpaged.prefill_chunk_paged(params, pools, torch.from_numpy(toks1),
                                       start, tables, active, 1, cfg)
        _ONE_POOLS.update({k: v.numpy() for k, v in pools.items()})
    return _ONE_POOLS


@pytest.mark.parametrize('case,axes', [
    ('staged_pp2', [('pp', 2)]),
    ('staged_pp2sp2', [('pp', 2), ('sp', 2)])])
def test_staged_paged_prefill_and_chunk_match_single_device(
        world, jax_modules, case, axes):
    """prefill_staged_paged then prefill_chunk_staged_paged: the logits on
    every rank within TOL of the JAX single-device prefill and chunk, and
    the pool blocks the two wrote (every layer, on every shard) within one
    int8 level."""
    l0, l1, pools = jax_modules['staged']
    ranks = world[case]
    for res in ranks.values():
        for got, want in ((res[0], l0), (res[1], l1)):
            assert np.abs(got - want).max() < TOL * max(np.abs(want).max(),
                                                         1.0)
    got = _global_pools(ranks, axes)
    rows = np.unique(PF_TABLES)
    # against the JAX package: layer 0, whose inputs are the embeddings (a
    # deeper layer's codes carry the two packages' bf16 drift, 4 levels at
    # layer 3 on one card too, which tests/test_torch_paged.py bounds);
    # against the port's one-card prefill and chunk: every layer
    for ref, layers in ((pools, slice(0, 1)), (_one_card_pools(),
                                               slice(None))):
        codes = np.abs(got['kv'][layers, rows].astype(np.int32)
                       - ref['kv'][layers, rows].astype(np.int32))
        assert codes.max() <= 1
        want = ref['kv_scale'][layers, rows]
        written = want > 0
        assert np.array_equal(got['kv_scale'][layers, rows] > 0, written)
        np.testing.assert_allclose(got['kv_scale'][layers, rows][written],
                                   want[written], rtol=2.4e-2)


@pytest.mark.parametrize('case', ['dense_pp2', 'dense_sp2'])
def test_dense_staged_and_sequence_sharded_steps(world, jax_modules, case):
    """A 150-token prefill and three single steps through forward_staged
    (pp 2) and through a cache whose positions are split at 128 (sp 2):
    the logits within TOL of the JAX forward's, the cache codes within one
    level."""
    want, cache = jax_modules['dense']
    ranks = world[case]
    for res in ranks.values():
        for got, ref in zip(res[0], want):
            assert np.abs(got - ref).max() < TOL * max(np.abs(ref).max(), 1.0)
    parts = [ranks[r][1] for r in sorted(ranks)]
    axis = 0 if 'pp' in case else 2
    # layer 0 against the JAX package; against the port on one card every
    # layer of the stages (as the staged paged case), layer 0 of the
    # sequence shards (their attention merges two partial softmaxes, each
    # rounded on its own, so a deeper layer's codes drift as the two
    # packages' do: 4 levels at layer 3)
    deep = slice(None) if 'pp' in case else slice(0, 1)
    for ref, layers in ((cache, slice(0, 1)), (_one_card_cache(), deep)):
        for k in ('k', 'v'):
            got = np.concatenate([p[k] for p in parts], axis=axis)
            assert np.abs(got[layers].astype(np.int32)
                          - ref[k][layers].astype(np.int32)).max() <= 1
        np.testing.assert_allclose(
            np.concatenate([p['k_scale'] for p in parts], axis=axis)[layers],
            ref['k_scale'][layers], rtol=2.4e-2)


_ONE_CACHE = {}


def _one_card_cache():
    """The port's one-card forward on the dense cases' inputs: its cache."""
    if not _ONE_CACHE:
        from ppq_tpu_torch.serving import model as tmodel
        cfg = LlamaConfig(**BASE)
        cfg.use_kernel_matmul = False
        params = init_llama_params(cfg, seed=SEED, device='cpu')
        prompt, steps = _dense_inputs()
        B, T = prompt.shape
        cache = tmodel.init_kv_cache(cfg, B, 'cpu')
        seq = torch.full((B,), T, dtype=torch.int32)
        with torch.no_grad():
            tmodel.forward(params, cache, torch.from_numpy(prompt),
                           torch.arange(T, dtype=torch.int32)[None]
                           .expand(B, T), torch.zeros(B, dtype=torch.int32),
                           seq, cfg)
            for cur in steps:
                tmodel.forward(params, cache, torch.from_numpy(cur)[:, None],
                               seq[:, None], seq, seq + 1, cfg)
                seq = seq + 1
        _ONE_CACHE.update({k: v.numpy() for k, v in cache.items()})
    return _ONE_CACHE


# ------------------------------------------------------------------- legs --
_ONE = {}


def _one_process():
    if 'engine' not in _ONE:
        cfg = LlamaConfig(**BASE)
        _ONE['engine'] = ServingEngine(
            cfg, init_llama_params(cfg, seed=0, device='cpu'), device='cpu')
    return _ONE['engine']


@pytest.mark.parametrize('name', list(LEGS))
def test_legs_vs_jax_engine(world, jax_engine, name):
    want_tokens, want_logits = jax_engine
    got = world[name][LEGS[name][2]]
    np.testing.assert_allclose(got['logits'], want_logits, rtol=0,
                               atol=LOGIT_TOL * np.abs(want_logits).max())
    reqs = cases.requests(BASE['vocab_size'])
    compared = 0
    for prompt, a_seq, b_seq in zip([r.prompt for r in reqs], want_tokens,
                                    got['tokens']):
        assert len(a_seq) == len(b_seq)
        for i, (a, b) in enumerate(zip(a_seq, b_seq)):
            compared += 1
            if a == b:
                continue
            logits = torch_dist_cases._probe_logits(_one_process(),
                                                    prompt + b_seq[:i])
            scale = LOGIT_TOL * np.abs(logits).max()
            assert abs(logits[a] - logits[b]) <= scale, (name, i)
            assert logits.max() - min(logits[a], logits[b]) <= scale
            break
    assert compared >= len(reqs)


def test_every_rank_takes_the_same_tokens(world):
    for name, (_, axes, _) in LEGS.items():
        ranks = world[name]
        assert len(ranks) == int(np.prod([s for _, s in axes])), name
        first = ranks[min(ranks)]
        for r in ranks.values():
            assert r['tokens'] == first['tokens'], name
            np.testing.assert_array_equal(r['logits'], first['logits'])


def test_rank_caches_pools_and_blocks(world):
    """A pp stage holds half the layers, an sp rank half the positions or
    blocks (and its trash row), a tp rank its kv heads; in the paged sp
    legs a slot's blocks lay on two shards, every block came back, and on
    dp x sp the prompt repeated on the first request's dp row adopted its
    cached block."""
    for name, (fields, axes, _) in LEGS.items():
        shape = dict(axes)
        pp, sp, tp = (shape.get(a, 1) for a in ('pp', 'sp', 'tp'))
        dp = shape.get('dp', 1)
        for r in world[name].values():
            assert r['heads'] == (2 // tp, 2 // tp, 4 // pp), name
            if 'paged_kv' in fields:
                blocks = r['blocks']
                nb = blocks // (sp * dp) + (1 if sp > 1 else 0)
                assert r['cache']['kv'][:2] == (4 // pp, nb), name
                assert r['cache']['kv'][-1] == 256 // tp
                assert r['spans'] == (2 if sp > 1 else 1), name
                held = 1 if fields.get('prefix_cache_blocks') else 0
                assert r['free'] == blocks - dp - held, name
            else:
                assert r['cache']['k'][:3] == (4 // pp, 4, 256 // sp), name
    dpsp = world['dp2sp2_paged'][0]
    assert dpsp['prefix_kind'] == 'GroupedPrefixCache'
    assert dpsp['prefix'] == (1, 4)


def test_sharded_reads_refuse_a_bucket():
    """A sequence-sharded cache is read whole: a read bucket would slice
    the sharded axis (the engine buckets nothing on an 'sp' mesh)."""
    from ppq_tpu_torch.serving import model as tmodel
    cfg = LlamaConfig(**BASE)
    mesh = types.SimpleNamespace(shape={'sp': 2}, index=lambda a: 0,
                                 group=lambda a: None)
    cache = tmodel.init_kv_cache(LlamaConfig(**dict(BASE, max_seq_len=128)),
                                 4, 'cpu')
    assert tmodel.seq_shard(cache, mesh, cfg).size == 128
    with pytest.raises(ValueError, match='read whole'):
        tmodel.burst_forward(init_llama_params(cfg, seed=0, device='cpu'),
                             cache, torch.zeros(4, dtype=torch.int32),
                             torch.ones(4, dtype=torch.int32), 2, cfg,
                             lambda lg, i: lg.argmax(-1), s_limit=64,
                             sp_mesh=mesh)
