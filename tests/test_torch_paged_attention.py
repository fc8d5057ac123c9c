"""Ragged decode attention of ppq_tpu_torch against ppq_tpu on the CPU: the
paged-attention kernels (rows 11 and 12 of the kernel table) and their
layout glue, then the ragged branch of `burst_forward` and the engine that
chooses between the two kernels.

The JAX kernels run in interpret mode; the port's wrappers, given CPU
tensors, run the plain versions that the CUDA kernels are held against on
the card. The glue is a copy and is compared bit for bit.

Tolerances of the triple (acc, m, l), from the inputs (`_assert_triple`):
  * s is a sum of Dh exact bf16 x code products in f32, summed in another
    order: 2e-5 of its absolute mass sum |q||k| * k_scale / sqrt(Dh) (the
    m tolerance, delta);
  * p = exp(s - m) then moves by 2 delta relative, plus exp's last bit;
  * l sums n such p in another order: l * (2 delta + 2 n 2^-24);
  * acc sums p * v_scale ROUNDED TO BF16 times v: a p that moved may round
    to the neighbouring bf16 number (2^-7 relative), so sum |p vs v| *
    (2^-7 + 4 delta + 2 n 2^-24).
acc is compared only where l > 0: a slot with no filled position returns
acc = 0 in the port and what happens to lie in fast memory in the JAX
kernel. The measured differences are far inside (m equal, l and acc within
a few 1e-7 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.kernels import paged_attention as jpa
from ppq_tpu.kernels import qmm as jqmm
from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu_torch.interop import (kv_cache_to_numpy,
                                   llama_params_from_numpy)
from ppq_tpu_torch.kernels import LAUNCHES
from ppq_tpu_torch.kernels import paged_attention as tpa
from ppq_tpu_torch.serving import LlamaConfig, Request, ServingEngine
from ppq_tpu_torch.serving import model as tmodel

# the ragged path needs head_dim and max_seq_len multiples of 128
RAGGED = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=1024, max_seq_len=256, max_batch=4,
              prefill_buckets=(16, 128))
# the whole-slice tolerances of tests/test_torch_serving.py
LOGIT_TOL, CODE_SHARE, CODE_STEP, SCALE_RTOL = 2e-2, 0.06, 3, 2.4e-2


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors here are small. With one thread PyTorch opens no OpenMP
    region, whose idle workers would otherwise spin on the cores that the
    other test processes need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bf16(a):
    """float32 values that bf16 holds exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _cache(seed, L, B, S, KV, Dh, dtype):
    """A contiguous cache of random codes (int8 with scales) or bf16
    values (no scales)."""
    rng = np.random.default_rng(seed)
    if dtype == 'int8':
        k = rng.integers(-128, 128, size=(L, B, S, KV, Dh)).astype(np.int8)
        v = rng.integers(-128, 128, size=(L, B, S, KV, Dh)).astype(np.int8)
        ks = (rng.random((L, B, S, KV)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((L, B, S, KV)) * 0.02 + 0.001).astype(np.float32)
        return k, v, ks, vs
    k = _bf16(rng.standard_normal((L, B, S, KV, Dh)).astype(np.float32))
    v = _bf16(rng.standard_normal((L, B, S, KV, Dh)).astype(np.float32))
    return k, v, None, None


def _jnp(a, like=None):
    if a is None:
        return None
    if a.dtype == np.float32 and like == 'bf16':
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a)


def _tt(a, like=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if like == 'bf16' else t


def _query(seed, B, KV, rep, Dh):
    rng = np.random.default_rng(seed)
    return _bf16(rng.standard_normal((B, KV, rep, Dh)).astype(np.float32))


def _assert_triple(got, want, q, k, v, ks, vs, lens):
    """got, want: (acc, m, l) as numpy; q (B, KV, rep, Dh); k, v: the slots'
    dense (B, S, KV, Dh) codes or values; ks, vs (B, S, KV) or None; lens
    (B,) after clamping. See the module's docstring."""
    B, KV, rep, Dh = q.shape
    S = k.shape[1]
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    ks = np.ones(k.shape[:3]) if ks is None else ks.astype(np.float64)
    vs = np.ones(k.shape[:3]) if vs is None else vs.astype(np.float64)
    valid = (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]
    inv = 1.0 / np.sqrt(Dh)
    s = np.einsum('bkrd,bskd->bkrs', q, k) * ks.transpose(0, 2, 1)[:, :, None] * inv
    mass = np.einsum('bkrd,bskd->bkrs', np.abs(q), np.abs(k)) \
        * ks.transpose(0, 2, 1)[:, :, None] * inv
    s = np.where(valid, s, -np.inf)
    live = lens > 0
    m_ref = np.where(live[:, None, None], s.max(-1), -1e30)
    p = np.where(valid, np.exp(s - m_ref[..., None]), 0.0)
    n = lens[:, None, None].astype(np.float64)
    delta = 2e-5 * np.where(valid, mass, 0.0).max(-1) + 1e-6
    summ = 2 * n * 2.0 ** -24
    acc_mass = np.einsum('bkrs,bskd->bkrd', p * vs.transpose(0, 2, 1)[:, :, None],
                         np.abs(v))
    g_acc, g_m, g_l = (np.asarray(a, np.float64) for a in got)
    w_acc, w_m, w_l = (np.asarray(a, np.float64) for a in want)
    assert g_acc.shape == w_acc.shape == q.shape
    assert np.all(np.abs(g_m - w_m) <= delta)
    assert np.all(np.abs(g_l - w_l) <= w_l * (4 * delta + summ) + 1e-30)
    tol = acc_mass * (2.0 ** -7 + 4 * delta[..., None] + summ[..., None]) + 1e-6
    lv = (w_l > 0)[..., None]
    assert np.all(np.where(lv, np.abs(g_acc - w_acc) <= tol, True))
    # the empty slots: m = -1e30, l = 0 in both, and acc = 0 in the port
    assert np.all(g_m[~live] == np.float32(-1e30)) and np.all(g_l[~live] == 0)
    assert np.all(g_acc[~live] == 0)


# ------------------------------------------------------------- glue ------

@pytest.mark.parametrize('B,S,blk', [(4, 256, 128), (3, 64, 32), (1, 512, 512)])
def test_identity_block_tables_bit_equal(B, S, blk):
    want = np.asarray(jpa.identity_block_tables(B, S, blk))
    got = tpa.identity_block_tables(B, S, blk, device='cpu')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_identity_block_tables_runs_on_the_card_unless_told(monkeypatch):
    """Like every entry point of the port: the card unless the caller names
    another device, and without a card it raises instead of taking the
    CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpa.identity_block_tables(2, 256, 128)
    got = tpa.identity_block_tables(2, 256, 128, device='cpu')
    assert got.device.type == 'cpu'
    assert got.tolist() == [[0, 1], [2, 3]]


@pytest.mark.parametrize('layered', [True, False], ids=['layered', 'one-layer'])
@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
@pytest.mark.parametrize('cap,blk', [(256, 128), (64, 64), (128, 32), (256, 256)])
def test_window_repacks_bit_equal(cap, blk, dtype, layered):
    """blockmajor_window against the JAX package's; slotmajor_window
    against the stacked layout the JAX `burst_forward` builds inline."""
    k, v, ks, vs = _cache(cap + blk, 2, 3, 256, 2, 128, dtype)
    if not layered:
        k, v = k[1], v[1]
        ks, vs = (None, None) if ks is None else (ks[1], vs[1])
    jkv, jsc = jpa.blockmajor_window(_jnp(k, dtype), _jnp(v, dtype), _jnp(ks),
                                     _jnp(vs), cap, blk)
    tkv, tsc = tpa.blockmajor_window(_tt(k, dtype), _tt(v, dtype), _tt(ks),
                                     _tt(vs), cap, blk)
    np.testing.assert_array_equal(tkv.float().numpy(),
                                  np.asarray(jkv.astype(jnp.float32)))
    assert (jsc is None) == (tsc is None)
    if tsc is not None:
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    # the fused kernel's slot-major pool: rows b * NBp + j
    L = k.shape[0] if layered else 1
    kk, vv = (k, v) if layered else (k[None], v[None])
    nbp = cap // blk
    want = np.stack([kk[:, :, :cap].reshape(L, -1, blk, 256),
                     vv[:, :, :cap].reshape(L, -1, blk, 256)], axis=2)
    tkv, tsc = tpa.slotmajor_window(_tt(k, dtype), _tt(v, dtype), _tt(ks),
                                    _tt(vs), cap, blk)
    np.testing.assert_array_equal(tkv.float().numpy(),
                                  want if layered else want[0])
    if ks is not None:
        sk, sv = (ks, vs) if layered else (ks[None], vs[None])
        sw = np.stack([sk[:, :, :cap].reshape(L, 3 * nbp, blk, 2).transpose(0, 1, 3, 2),
                       sv[:, :, :cap].reshape(L, 3 * nbp, blk, 2).transpose(0, 1, 3, 2)],
                      axis=2)
        np.testing.assert_array_equal(tsc.numpy(), sw if layered else sw[0])


def test_grouped_group_size_equal():
    for batch in (1, 3, 4, 8, 12, 96, 128, 256):
        for blk in (32, 64, 128, 256, 512):
            for kv_dh, itemsize in ((1024, 1), (256, 1), (1024, 2), (4096, 1)):
                assert tpa.grouped_group_size(batch, blk, kv_dh, itemsize) == \
                    jpa.grouped_group_size(batch, blk, kv_dh, itemsize)
    assert tpa.grouped_group_size(128, 32) == 32        # the path's G at fill 16


def test_merge_attention_and_reference():
    rng = np.random.default_rng(3)
    B, KV, rep, Dh = 3, 2, 2, 128
    parts_np = []
    for i in range(3):
        acc = rng.standard_normal((B, KV, rep, Dh)).astype(np.float32)
        m = rng.standard_normal((B, KV, rep)).astype(np.float32) * 3
        l = (rng.random((B, KV, rep)) + 0.5).astype(np.float32)
        if i == 1:               # an empty part: no positions
            acc[:] = 0.0
            m[:] = -1e30
            l[:] = 0.0
        parts_np.append((acc, m, l))
    want = np.asarray(jpa.merge_attention(
        [tuple(jnp.asarray(a) for a in p) for p in parts_np]))
    got = tpa.merge_attention([tuple(torch.from_numpy(a) for a in p)
                               for p in parts_np]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the dense twin over separate pools and a permuted table
    k, v, ks, vs = _cache(5, 1, 1, 24 * 32, KV, Dh, 'int8')
    k_pool, v_pool = k[0, 0].reshape(24, 32, KV * Dh), v[0, 0].reshape(24, 32, KV * Dh)
    k_sc = ks[0, 0].reshape(24, 32, KV).transpose(0, 2, 1).copy()
    v_sc = vs[0, 0].reshape(24, 32, KV).transpose(0, 2, 1).copy()
    tables = rng.permutation(24).reshape(B, 8).astype(np.int32)
    lens = np.array([0, 100, 256], np.int32)
    q = _query(6, B, KV, rep, Dh)
    want = jpa.paged_attention_reference(
        jnp.asarray(q), *(jnp.asarray(a) for a in (k_pool, v_pool, k_sc, v_sc,
                                                    tables, lens)),
        block_size=32)
    got = tpa.paged_attention_reference(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in
                               (k_pool, v_pool, k_sc, v_sc, tables, lens)),
        block_size=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-5)


# ----------------------------------------------------------- kernels -----

def _dense(k, v, ks, vs, layer, cap):
    """The slots' (B, cap, KV, Dh) views of one layer of the cache."""
    pick = (lambda a: None if a is None else a[layer, :, :cap])
    return pick(k), pick(v), pick(ks), pick(vs)


@pytest.mark.parametrize('layered', [True, False], ids=['layered', 'one-layer'])
@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
@pytest.mark.parametrize('blk', [32, 128, 256])
def test_fused_vs_pallas(blk, dtype, layered):
    """Row 11 through a permuted block table (true paging: no slot's blocks
    are its own rows): slots with fill 0, a partial last block, a full
    window, and one ending on a block boundary."""
    B, KV, rep, Dh, S = 4, 2, 2, 128, 256
    cap = 256 if blk >= 128 else 128
    nbp = cap // blk
    k, v, ks, vs = _cache(blk, 2, B, S, KV, Dh, dtype)
    pool, sc = tpa.slotmajor_window(_tt(k, dtype), _tt(v, dtype), _tt(ks),
                                    _tt(vs), cap, blk)
    perm = np.random.default_rng(blk).permutation(B * nbp)
    inv = np.argsort(perm)
    pool = pool[:, torch.from_numpy(inv)].contiguous()      # row perm[i] <- i
    sc = None if sc is None else sc[:, torch.from_numpy(inv)].contiguous()
    tables = perm.reshape(B, nbp).astype(np.int32)
    lens = np.array([0, cap - 5, cap, min(2 * blk, cap)], np.int32)
    lens[1] = max(lens[1], 1)
    q = _query(blk + 1, B, KV, rep, Dh)
    layer = 1
    if not layered:
        pool = pool[layer]
        sc = None if sc is None else sc[layer]
    pool_np = pool.float().numpy() if dtype == 'bf16' else pool.numpy()
    jpool = _jnp(pool_np, dtype)
    jsc = None if sc is None else jnp.asarray(sc.numpy())
    want = jpa.paged_attention_decode_fused(
        jnp.asarray(q, jnp.bfloat16), jpool, jsc, jnp.asarray(tables),
        jnp.asarray(lens), layer=layer if layered else None,
        block_size=blk, interpret=True)
    before = dict(LAUNCHES)
    got = tpa.paged_attention_decode_fused(
        torch.from_numpy(q).bfloat16(), pool, sc, torch.from_numpy(tables),
        torch.from_numpy(lens), layer=layer if layered else None,
        block_size=blk)
    assert LAUNCHES == before          # a CPU tensor launches nothing
    _assert_triple([a.numpy() for a in got], want, q,
                   *_dense(k, v, ks, vs, layer, cap), lens)


@pytest.mark.parametrize('layered', [True, False], ids=['layered', 'one-layer'])
@pytest.mark.parametrize('dtype', ['int8', 'bf16'])
@pytest.mark.parametrize('blk', [32, 128, 256])
def test_grouped_vs_pallas(blk, dtype, layered):
    """Row 12 over a block-major window, groups of 4 whose slots differ in
    depth: a slot with fill 0 beside a deep one, partial last blocks, and a
    group whose deepest fill ends mid-block."""
    B, KV, rep, Dh, S = 8, 2, 2, 128, 256
    cap = 256 if blk >= 128 else 128
    G = 4
    k, v, ks, vs = _cache(blk + 7, 2, B, S, KV, Dh, dtype)
    kv_bm, sc_bm = tpa.blockmajor_window(_tt(k, dtype), _tt(v, dtype),
                                         _tt(ks), _tt(vs), cap, blk)
    lens = np.array([0, cap, 3, blk + 1, 17, 1, cap - 9, 2 * blk - 1],
                    np.int32)
    lens = np.minimum(lens, cap)
    q = _query(blk + 2, B, KV, rep, Dh)
    layer = 0
    if not layered:
        kv_bm = kv_bm[layer]
        sc_bm = None if sc_bm is None else sc_bm[layer]
    pool_np = kv_bm.float().numpy() if dtype == 'bf16' else kv_bm.numpy()
    want = jpa.paged_attention_decode_grouped(
        jnp.asarray(q, jnp.bfloat16), _jnp(pool_np, dtype),
        None if sc_bm is None else jnp.asarray(sc_bm.numpy()),
        jnp.asarray(lens), layer=layer if layered else None, block_size=blk,
        group=G, interpret=True)
    got = tpa.paged_attention_decode_grouped(
        torch.from_numpy(q).bfloat16(), kv_bm, sc_bm, torch.from_numpy(lens),
        layer=layer if layered else None, block_size=blk, group=G)
    _assert_triple([a.numpy() for a in got], want, q,
                   *_dense(k, v, ks, vs, layer, cap), lens)


def test_fused_equals_grouped_and_reference():
    """The two kernels' plain versions compute one function: on the same
    window they agree to the last bit, and with the dense twin within the
    tolerance above (which rounds no p). The dense twin has no empty-slot
    convention (its l counts the masked positions there), so every slot
    holds a position."""
    B, KV, rep, Dh, cap, blk = 4, 2, 2, 128, 256, 64
    k, v, ks, vs = _cache(11, 1, B, cap, KV, Dh, 'int8')
    lens = torch.tensor([1, 64, 200, 256], dtype=torch.int32)
    q = torch.from_numpy(_query(12, B, KV, rep, Dh)).bfloat16()
    pool, sc = tpa.slotmajor_window(*(_tt(a) for a in (k, v, ks, vs)), cap, blk)
    tables = tpa.identity_block_tables(B, cap, blk, device='cpu')
    fused = tpa.paged_attention_decode_fused(q, pool, sc, tables, lens, 0,
                                             block_size=blk)
    bm, sbm = tpa.blockmajor_window(*(_tt(a) for a in (k, v, ks, vs)), cap, blk)
    grouped = tpa.paged_attention_decode_grouped(q, bm, sbm, lens, 0,
                                                 block_size=blk, group=2)
    for a, b in zip(fused, grouped):
        assert torch.equal(a, b)
    k_pool = pool[0, :, 0]
    v_pool = pool[0, :, 1]
    ref = tpa.paged_attention_reference(q.float(), k_pool, v_pool,
                                        sc[0, :, 0], sc[0, :, 1], tables, lens,
                                        block_size=blk)
    _assert_triple([a.numpy() for a in fused], [a.numpy() for a in ref],
                   q.float().numpy(), *_dense(k, v, ks, vs, 0, cap),
                   lens.numpy())


def test_out_of_range_inputs_read_as_documented():
    """A fill past the table is cut at its end; a table row outside the
    pool reads as an empty block (the kernel also flags both on the card)."""
    B, KV, rep, Dh, blk = 2, 2, 2, 128, 32
    k, v, ks, vs = _cache(13, 1, B, 64, KV, Dh, 'int8')
    pool, sc = tpa.slotmajor_window(*(_tt(a) for a in (k, v, ks, vs)), 64, blk)
    tables = tpa.identity_block_tables(B, 64, blk, device='cpu')
    q = torch.from_numpy(_query(14, B, KV, rep, Dh)).bfloat16()
    over = tpa.paged_attention_decode_fused(
        q, pool, sc, tables, torch.tensor([999, -3], dtype=torch.int32), 0,
        block_size=blk)
    fit = tpa.paged_attention_decode_fused(
        q, pool, sc, tables, torch.tensor([64, 0], dtype=torch.int32), 0,
        block_size=blk)
    for a, b in zip(over, fit):
        assert torch.equal(a, b)
    bad = tables.clone()
    bad[0, 1] = 77
    skipped = tpa.paged_attention_decode_fused(
        q, pool, sc, bad, torch.tensor([64, 0], dtype=torch.int32), 0,
        block_size=blk)
    first = tpa.paged_attention_decode_fused(
        q, pool, sc, tables, torch.tensor([32, 0], dtype=torch.int32), 0,
        block_size=blk)
    for a, b in zip(skipped, first):
        assert torch.equal(a, b)


# -------------------------------------------------------------- slice -----

def _np_tree(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def _configs(kernel=False, **extra):
    jcfg = jconfig.LlamaConfig(**RAGGED, **extra)
    jcfg.use_pallas_matmul, jcfg.use_ragged_attention = kernel, True
    jcfg.ragged_interpret = True
    tcfg = LlamaConfig(**RAGGED, **extra)
    tcfg.use_kernel_matmul, tcfg.use_ragged_attention = kernel, True
    return jcfg, tcfg


def _kernel_path(monkeypatch):
    """The JAX package's matmuls through its Pallas kernels in interpret
    mode (`qmatmul` looks them up at call time)."""
    for name in ('qmm_int8', 'qmm_int4', 'qmm_gateup'):
        monkeypatch.setattr(jqmm, name, functools.partial(
            getattr(jqmm, name), interpret=True))


_PREFILLED = {}


def _prefilled_pair(kernel, seed=0, **extra):
    """Both packages' fused params and their caches after the same masked
    128-token prefill (slot 2 inactive: its rows stay empty). Built once
    per arguments; every caller gets its own copy of the port's cache,
    which a burst writes in place."""
    key = (kernel, seed, tuple(sorted(extra.items())))
    if key not in _PREFILLED:
        _PREFILLED[key] = _build_prefilled_pair(kernel, seed, **extra)
    pair, (jc, tc) = _PREFILLED[key]
    return pair, (jc, {k: v.clone() for k, v in tc.items()})


def _build_prefilled_pair(kernel, seed, **extra):
    jcfg, tcfg = _configs(kernel, **extra)
    jp = jmodel.init_llama_params(jcfg, seed=seed)
    tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
    jp, tp = jmodel.fuse_decode_params(jp, jcfg), tmodel.fuse_decode_params(tp, tcfg)
    B, T = 4, 128
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    active = np.array([True, True, False, True])
    zeros, full = np.zeros(B, np.int32), np.full(B, T, np.int32)
    _, jc = jax.jit(lambda *a, active: jmodel.forward(*a, jcfg, active=active))(
        jp, jmodel.init_kv_cache(jcfg, B), *(jnp.asarray(a) for a in
                                             (tokens, pos, zeros, full)),
        active=jnp.asarray(active))
    tc = tmodel.init_kv_cache(tcfg, B, 'cpu')
    tmodel.forward(tp, tc, *(torch.from_numpy(a) for a in
                             (tokens, pos, zeros, full)), tcfg,
                   active=torch.from_numpy(active))
    return (jcfg, jp, tcfg, tp), (jc, tc)


def _burst_both(pair, caches, seq, cur, forced, s_limit, prefer_grouped):
    """Teacher-forced ragged burst in both packages: step i is fed
    forced[i] whatever the logits say."""
    jcfg, jp, tcfg, tp = pair
    n = forced.shape[0]
    seen = {}

    def keep(step, logits):
        seen[int(step)] = np.asarray(logits)

    def jselect(logits, key):
        jax.debug.callback(keep, key[0], logits, ordered=True)
        return jnp.asarray(forced)[key[0]]

    keys = jnp.stack([jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros(n, jnp.uint32)], axis=1)
    jtoks, jc = jax.jit(lambda p, c, t, s, k: jmodel.burst_forward(
        p, c, t, s, k, jcfg, jselect, s_limit=s_limit, ragged=True,
        ragged_interpret=True, prefer_grouped=prefer_grouped))(
            jp, caches[0], jnp.asarray(cur), jnp.asarray(seq), keys)
    jax.effects_barrier()
    tseen = {}

    def tselect(logits, step):
        tseen[step] = logits.numpy().copy()
        return torch.from_numpy(forced[step])

    ttoks, tc = tmodel.burst_forward(
        tp, caches[1], torch.from_numpy(cur), torch.from_numpy(seq), n, tcfg,
        tselect, s_limit=s_limit, ragged=True, prefer_grouped=prefer_grouped)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    return ([seen[i] for i in range(n)], [tseen[i] for i in range(n)],
            (jc, tc))


def _assert_logits_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def _assert_caches_close(jcache, tcache):
    tn = kv_cache_to_numpy(tcache)
    for key in ('k', 'v'):
        a = np.asarray(jcache[key]).astype(np.int32)
        b = tn[key].astype(np.int32)
        assert (a != b).mean() <= CODE_SHARE
        assert np.abs(a - b).max() <= CODE_STEP
    for key in ('k_scale', 'v_scale'):
        np.testing.assert_allclose(tn[key], np.asarray(jcache[key]),
                                   rtol=SCALE_RTOL, atol=1e-8)


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('prefer_grouped', [True, False],
                         ids=['grouped', 'fused'])
def test_ragged_burst_forward_teacher_forced(prefer_grouped, kernel,
                                             monkeypatch):
    """burst_forward(ragged=True) against the JAX package's, both kernels
    (a 128 window: grouped RBLK 64 with G 4, or fused RBLK 128), mixed fills
    over a prefill that wrote 128 rows (the rows past each fill hold data
    that must stay masked), slot 2 empty."""
    if kernel:
        _kernel_path(monkeypatch)
    pair, caches = _prefilled_pair(kernel)
    seq = np.array([100, 40, 0, 127], np.int32)
    rng = np.random.default_rng(5)
    n = 4
    cur = rng.integers(0, 256, size=4).astype(np.int32)
    forced = rng.integers(0, 256, size=(n, 4)).astype(np.int32)
    jl, tl, caches = _burst_both(pair, caches, seq, cur, forced, 128,
                                 prefer_grouped)
    for want, got in zip(jl, tl):
        _assert_logits_close(got, want)
    _assert_caches_close(*caches)


def test_ragged_burst_against_dense_burst():
    """Inside the port the ragged read and the dense read of the same cache
    are one attention: logits within the slice tolerance, the same cache
    codes up to the slice's share, on a window that takes the grouped
    kernel with two blocks a slot."""
    _, tcfg = _configs()
    pair, caches = _prefilled_pair(False, seed=3)
    tp = pair[3]
    seq = torch.tensor([100, 40, 0, 127], dtype=torch.int32)
    cur = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    out = {}
    for ragged in (True, False):
        cache = {k: v.clone() for k, v in caches[1].items()}
        seen = []

        def select(logits, step, seen=seen):
            seen.append(logits.clone())
            return torch.argmax(logits, -1).to(torch.int32) * 0 + step
        toks, cache = tmodel.burst_forward(tp, cache, cur, seq, 4, tcfg,
                                           select, s_limit=128, ragged=ragged)
        out[ragged] = (seen, cache)
    for a, b in zip(out[True][0], out[False][0]):
        _assert_logits_close(a.numpy(), b.numpy())
    for key in ('k', 'v'):
        a, b = out[True][1][key].int(), out[False][1][key].int()
        assert (a != b).float().mean() <= CODE_SHARE
        assert (a - b).abs().max() <= CODE_STEP


def test_engine_grouped_gate_and_ragged_run():
    """The engine resolves ragged attention on with a card only; with it
    set, `run` chooses the kernel by `_grouped_gate` and gives the JAX
    engine's greedy tokens (a near-tie that bf16 noise decides may end a
    request's comparison)."""
    jcfg, tcfg = _configs()
    jcfg.use_pallas_matmul = tcfg.use_kernel_matmul = None
    jp = jmodel.init_llama_params(jcfg, seed=0)
    teng = ServingEngine(tcfg, llama_params_from_numpy(_np_tree(jp), device='cpu'),
                         device='cpu')
    jeng = jengine.ServingEngine(jcfg, jp)
    assert tcfg.use_ragged_attention is True and tcfg.use_kernel_matmul is False
    auto = LlamaConfig(**RAGGED)
    ServingEngine(auto, teng.params, device='cpu')
    assert auto.use_ragged_attention is False           # no card: dense read
    for fills, n, bucket in (([16, 20], 4, 32), ([100, 120], 4, 128),
                             ([97, 120], 8, 128), ([10, 200], 4, 256),
                             ([], 4, 64), ([5], 4, None)):
        assert teng._grouped_gate(fills, n, bucket) == \
            jeng._grouped_gate(fills, n, bucket)
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(1, 256, size=size)]
               for size in (5, 70, 100, 12, 90)]
    jreqs = [jengine.Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jeng.run(jreqs, sync_every=3)
    teng.run(treqs, sync_every=3)
    assert {k[2] for k in teng._decode_burst} == {k[2] for k in jeng._decode_burst}
    compared = equal = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == 6
        for a, b in zip(jr.generated, tr.generated):
            compared += 1
            if a != b:
                break
            equal += 1
    assert equal >= 0.8 * compared
