"""The paged KV cache of ppq_tpu_torch against ppq_tpu on the CPU: the block
allocator, the pool write (row 16 of the kernel table), the buffered paged
attention (row 13), the paged prefills and burst, the engine with and
without the prefix cache.

The JAX package's Pallas kernels run in interpret mode (`ragged_interpret`,
`write_kv_window(..., use_kernel=True, interpret=True)`); the port's
wrappers, given CPU tensors, run the plain versions that the CUDA kernels
are held against on the card. Integer codes, tables and allocation orders
are compared bit for bit; float outputs within the tolerances stated where
they are used (the whole-model ones are tests/test_torch_serving.py's:
bf16 activations round differently in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.kernels import paged_attention as jpa
from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu.serving import paged as jpaged
from ppq_tpu_torch.interop import (block_allocator_from,
                                   llama_params_from_numpy,
                                   paged_pools_from_numpy,
                                   paged_pools_to_numpy)
from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                   paged_attention_decode_buffered_plain,
                                   pool_write_inplace, pool_write_plain)
from ppq_tpu_torch.serving import LlamaConfig, Request, ServingEngine
from ppq_tpu_torch.serving import model as tmodel
from ppq_tpu_torch.serving import paged as tpaged

# head dim 128 (the paged path's kernels), blocks of 128, two blocks a slot
PAGED = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
             n_kv_heads=1, d_ff=512, max_seq_len=256, max_batch=4,
             prefill_buckets=(16,), kv_block_size=128)
# the whole-slice tolerances of tests/test_torch_serving.py
LOGIT_TOL, CODE_SHARE, CODE_STEP = 2e-2, 0.06, 3


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


def _configs(**extra):
    """The paged configuration for both packages: the JAX engine reads its
    pool through the interpreted Pallas kernels, the port on the CPU through
    the kernels' plain versions."""
    size = dict(PAGED, **extra)
    jcfg = jconfig.LlamaConfig(**size)
    jcfg.paged_kv, jcfg.ragged_interpret = True, True
    jcfg.use_pallas_matmul, jcfg.use_ragged_attention = False, False
    tcfg = LlamaConfig(**size, paged_kv=True)
    return jcfg, tcfg


# ------------------------------------------------------------ allocator ----

def test_allocator_tables_bit_equal_after_the_same_schedule():
    """A seeded admit / grow / retire / adopt / retain / unref schedule:
    tables, free counts and errors equal after every action."""
    kw = dict(num_blocks=33, max_batch=8, max_blocks_per_seq=4,
              block_size=128)
    j = jpaged.BlockAllocator(native=False, **kw)
    t = tpaged.BlockAllocator(native=True, **kw)     # csrc/allocator.cc
    rng = np.random.RandomState(0)
    for step in range(400):
        slot = int(rng.randint(0, 8))
        action = rng.rand()
        if action < 0.55:
            tokens = int(rng.randint(1, 5 * 128))
            errors = []
            for alloc in (j, t):
                try:
                    alloc.ensure(slot, tokens)
                    errors.append(None)
                except (MemoryError, ValueError) as e:
                    errors.append(type(e))
            assert errors[0] is errors[1], step
        elif action < 0.7:
            donor = int(rng.randint(0, 8))
            blocks = j.slot_block_ids(donor)
            if blocks and not j.slot_block_ids(slot) and donor != slot:
                for alloc in (j, t):
                    alloc.adopt(slot, blocks[:1])
        elif action < 0.8:
            blocks = j.slot_block_ids(slot)
            if blocks:
                for alloc in (j, t):
                    alloc.retain(blocks[:1])
                    alloc.unref(blocks[:1])
        else:
            j.release(slot)
            t.release(slot)
        assert j.free_blocks == t.free_blocks, step
        np.testing.assert_array_equal(j.tables(), t.tables())
        assert j.slot_block_ids(slot) == t.slot_block_ids(slot)
    carried = block_allocator_from(j)
    np.testing.assert_array_equal(carried.tables(), j.tables())
    assert carried.free == j.free and carried._refs == j._refs


def test_allocator_exhaustion_is_all_or_nothing():
    for alloc in (jpaged.BlockAllocator(4, 2, 8, 128, native=False),
                  tpaged.BlockAllocator(4, 2, 8, 128)):
        alloc.ensure(0, 2 * 128)
        before = alloc.tables().copy()
        with pytest.raises(MemoryError):
            alloc.ensure(1, 3 * 128)
        assert alloc.free_blocks == 1
        np.testing.assert_array_equal(alloc.tables(), before)
        with pytest.raises(ValueError):
            alloc.ensure(1, 9 * 128)


# ----------------------------------------------------------- pool write ----

def _write_case(int8, T=32, write_pos=(0, 100, 120, 96, 127), MB=4):
    """test_qmm_paged_kernels.py's pool-write inputs: aligned, mid-block,
    inactive, at-boundary and crossing windows over a permuted table."""
    rng = np.random.default_rng(0)
    L, NB, BLK, KV, Dh = 3, 24, 128, 2, 64
    B = len(write_pos)
    dt = np.int8 if int8 else np.float32
    kv = rng.integers(-100, 100, (L, NB, 2, BLK, KV * Dh)).astype(dt)
    pools = {'kv': kv}
    if int8:
        pools['kv_scale'] = rng.random((L, NB, 2, KV, BLK)).astype(np.float32)
    k = rng.integers(-100, 100, (L, B, T, KV, Dh)).astype(dt)
    v = rng.integers(-100, 100, (L, B, T, KV, Dh)).astype(dt)
    ks = rng.random((L, B, KV, T)).astype(np.float32) if int8 else None
    vs = rng.random((L, B, KV, T)).astype(np.float32) if int8 else None
    tables = (rng.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB) \
        .astype(np.int32)
    active = np.array([True, True, False, True, True])[:B]
    return pools, k, v, ks, vs, tables, np.asarray(write_pos, np.int32), active


def _jax_write(case, use_kernel):
    pools, k, v, ks, vs, tables, wp, act = case
    jd = jnp.bfloat16 if pools['kv'].dtype == np.float32 else jnp.int8
    jp = {'kv': jnp.asarray(pools['kv'], jd)}
    if 'kv_scale' in pools:
        jp['kv_scale'] = jnp.asarray(pools['kv_scale'])
    out = jpaged.write_kv_window(
        jp, jnp.asarray(k, jd), jnp.asarray(v, jd),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), jnp.asarray(tables),
        jnp.asarray(wp), jnp.asarray(act), use_kernel=use_kernel,
        interpret=True)
    return {key: np.asarray(val.astype(jnp.float32) if val.dtype == jnp.bfloat16
                            else val) for key, val in out.items()}


def _port_write(case, plain=False):
    pools, k, v, ks, vs, tables, wp, act = case
    tp = paged_pools_from_numpy(pools, device='cpu')
    dt = tp['kv'].dtype
    write = pool_write_plain if plain else pool_write_inplace
    write(tp['kv'], tp.get('kv_scale'), torch.from_numpy(k).to(dt),
          torch.from_numpy(v).to(dt),
          None if ks is None else torch.from_numpy(ks),
          None if vs is None else torch.from_numpy(vs),
          torch.from_numpy(tables), torch.from_numpy(wp),
          torch.from_numpy(act))
    return paged_pools_to_numpy(tp)


@pytest.mark.parametrize('T', [32, 300], ids=['window32', 'window300'])
@pytest.mark.parametrize('int8', [True, False], ids=['int8', 'bf16'])
def test_pool_write_bit_equal_to_the_jax_writers_on_rows_past_the_trash(
        int8, T):
    """Row 16 against the JAX package's Pallas writer (a window of at most
    a block) and its XLA scatter (any window), bit for bit on every row but
    the trash row 0, which the JAX package fills with the inactive slot's
    tokens and the port leaves alone."""
    case = _write_case(int8, T=T)
    got = _port_write(case)
    assert all(np.array_equal(got[key], _port_write(case, plain=True)[key])
               for key in got)
    writers = (False, True) if T <= 128 else (False,)
    for use_kernel in writers:
        want = _jax_write(case, use_kernel)
        for key in want:
            assert np.array_equal(got[key][:, 1:], want[key][:, 1:]), \
                (key, use_kernel)
            assert np.array_equal(got[key][:, 0], case[0][key][:, 0].astype(
                got[key].dtype))                   # the trash row untouched


def test_pool_write_past_the_table_pins_the_pallas_clamp():
    """A window that crosses the table's last column: the Pallas writer
    clamps its second block to the first, so the tokens past the end wrap
    into the start of the last block (ROADMAP queue 3 item 17); the port
    writes them nowhere, as the JAX package's scatter does."""
    T = 32
    case = _write_case(True, T=T, write_pos=(246,), MB=2)
    pools, k, v, ks, vs, tables, wp, act = case
    kernel, scatter = _jax_write(case, True), _jax_write(case, False)
    got = _port_write(case)
    row, cut = tables[0, 1], 256 - 246            # 10 tokens fit
    KVDh = k.shape[-1] * k.shape[-2]
    wrapped = k[:, 0, cut:].reshape(3, T - cut, KVDh)
    np.testing.assert_array_equal(kernel['kv'][:, row, 0, :T - cut], wrapped)
    np.testing.assert_array_equal(kernel['kv'][:, row, 0, 118:128],
                                  k[:, 0, :cut].reshape(3, cut, KVDh))
    for key in got:
        np.testing.assert_array_equal(got[key][:, 1:], scatter[key][:, 1:])
    np.testing.assert_array_equal(got['kv'][:, row, 0, :T - cut],
                                  pools['kv'][:, row, 0, :T - cut])


# ----------------------------------------------- row 13: buffered read ----

def _buffered_case(int8):
    """test_qmm_paged_kernels.py's buffered-attention inputs: an empty slot,
    a partial block, a slot over two blocks, step 17 of a 32-column
    buffer."""
    rng = np.random.default_rng(7)
    B, KV, rep, Dh, BLK, MB, n = 3, 2, 2, 128, 128, 2, 32
    NB = B * MB + 1
    q = (rng.standard_normal((B, KV, rep, Dh)) * 0.4).astype(np.float32)
    if int8:
        codes = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa
        scales = lambda *s: ((rng.random(s) + .5) * .02).astype(np.float32)  # noqa
        kp, vp = codes(NB, BLK, KV * Dh), codes(NB, BLK, KV * Dh)
        ks, vs = scales(NB, KV, BLK), scales(NB, KV, BLK)
        kb, vb = codes(B, n, KV * Dh), codes(B, n, KV * Dh)
        ksb, vsb = scales(B, KV, n), scales(B, KV, n)
    else:
        bf = lambda *s: np.asarray(jnp.asarray(  # noqa
            rng.standard_normal(s) * .5, jnp.bfloat16).astype(jnp.float32))
        kp, vp, kb, vb = (bf(NB, BLK, KV * Dh), bf(NB, BLK, KV * Dh),
                          bf(B, n, KV * Dh), bf(B, n, KV * Dh))
        ks = vs = ksb = vsb = None
    tbl = np.arange(1, B * MB + 1, dtype=np.int32).reshape(B, MB)
    lens = np.asarray([0, 5, 200], np.int32)
    return q, kp, vp, ks, vs, tbl, lens, kb, vb, ksb, vsb, 17


def _ctx_tolerance(q, k, v, ks, vs, lens, step, kb, vb, ksb, vsb):
    """Row 13's context against another evaluation of the same arithmetic:
    s sums Dh exact bf16 x code products in another order (delta = 2e-5 of
    its absolute mass, as for rows 11 and 12); p moves by 2 delta and may
    then round to the neighbouring bf16 number (2^-7 relative), so each
    term of acc moves by |p v_eff| (2^-7 + 4 delta); l by 4 delta. The
    context acc / l then moves by (sum |p v_eff| / l) (2^-7 + 8 delta)."""
    B, KV, rep, Dh = q.shape
    S = k.shape[1]
    n = kb.shape[1]
    qf = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    keys = np.concatenate([k, kb.reshape(B, n, KV, Dh)], 1).astype(np.float64)
    vals = np.concatenate([v, vb.reshape(B, n, KV, Dh)], 1).astype(np.float64)
    if ks is not None:
        kscale = np.concatenate([ks, ksb.transpose(0, 2, 1)], 1)
        vscale = np.concatenate([vs, vsb.transpose(0, 2, 1)], 1)
    else:
        kscale = vscale = np.ones((B, S + n, KV))
    valid = np.concatenate([np.arange(S)[None] < lens[:, None],
                            np.broadcast_to(np.arange(n) <= step, (B, n))], 1)
    s = np.einsum('bkrd,bskd->bkrs', qf, keys) \
        * kscale.transpose(0, 2, 1)[:, :, None] / np.sqrt(Dh)
    mass = np.einsum('bkrd,bskd->bkrs', np.abs(qf), np.abs(keys)) \
        * kscale.transpose(0, 2, 1)[:, :, None] / np.sqrt(Dh)
    s = np.where(valid[:, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1)
    delta = 2e-5 * np.where(valid[:, None, None], mass, 0).max(-1)
    veff = np.abs(vals) * vscale[..., None]
    spread = np.einsum('bkrs,bskd->bkrd', p, veff.transpose(0, 1, 2, 3)) / l[..., None]
    return spread * (2.0 ** -7 + 8 * delta[..., None]) + 1e-6


def _dense_slots(kp, vp, ks, vs, tbl):
    B, MB = tbl.shape
    BLK, KVDh = kp.shape[1:]
    KV = ks.shape[1] if ks is not None else KVDh // 128
    k = kp[tbl].reshape(B, MB * BLK, KV, KVDh // KV)
    v = vp[tbl].reshape(B, MB * BLK, KV, KVDh // KV)
    if ks is None:
        return k, v, None, None
    return (k, v, ks[tbl].transpose(0, 1, 3, 2).reshape(B, MB * BLK, KV),
            vs[tbl].transpose(0, 1, 3, 2).reshape(B, MB * BLK, KV))


# the cases the CUDA kernel walks apart: fills on a block's end, the
# buffer's last column, step 0 beside an empty slot, and buffer scale rows
# with a slot stride other than KV * n (a view into a wider array)
BUFFERED_CASES = {
    'block-end': dict(lens=[128, 256, 127]),
    'last-column': dict(step=31),
    'step0-empty': dict(lens=[0, 0, 5], step=0),
    'slot-stride': dict(slot_pad=4),
}


@pytest.mark.parametrize(
    'int8,variant',
    [(True, None), (False, None)]
    + [(int8, v) for v in BUFFERED_CASES for int8 in (True, False)
       if int8 or v != 'slot-stride'],
    ids=['int8', 'bf16'] + [f'{"int8" if int8 else "bf16"}-{v}'
                            for v in BUFFERED_CASES for int8 in (True, False)
                            if int8 or v != 'slot-stride'])
def test_buffered_attention_plain_vs_pallas(int8, variant):
    """Row 13's plain version against the Pallas kernel in interpret mode,
    in f32 within _ctx_tolerance; the wrapper on CPU tensors is the plain
    version, and separate-pool views of a fused pool give the same
    context."""
    case = _buffered_case(int8)
    q, kp, vp, ks, vs, tbl, lens, kb, vb, ksb, vsb, step = case
    change = BUFFERED_CASES.get(variant, {})
    lens = np.asarray(change.get('lens', lens), np.int32)
    step = change.get('step', step)
    jd = jnp.int8 if int8 else jnp.bfloat16
    want = np.asarray(jpa.paged_attention_decode_buffered(
        jnp.asarray(q), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), jnp.asarray(tbl),
        jnp.asarray(lens), jnp.asarray(kb, jd), jnp.asarray(vb, jd),
        None if ksb is None else jnp.asarray(ksb),
        None if vsb is None else jnp.asarray(vsb), step, interpret=True))
    td = torch.int8 if int8 else torch.bfloat16
    t = lambda a, d=None: None if a is None else torch.from_numpy(  # noqa
        np.ascontiguousarray(a)).to(d or torch.from_numpy(a).dtype)
    args = (t(q).bfloat16(), t(kp, td), t(vp, td), t(ks), t(vs), t(tbl),
            t(lens), t(kb, td), t(vb, td), t(ksb), t(vsb), step)
    pad = change.get('slot_pad')
    if pad:
        # the same scales as rows of (B, KV * n + pad): slot stride KV*n+pad
        B, KV, n = ksb.shape
        wide = torch.zeros(2, B, KV * n + pad)
        wide[:, :, :KV * n] = torch.stack([args[9], args[10]]).reshape(2, B, -1)
        views = wide[:, :, :KV * n].reshape(2, B, KV, n)
        assert views[0].stride(0) == KV * n + pad
        args = args[:9] + (views[0], views[1], step)
    got = paged_attention_decode_buffered(*args).numpy()
    plain = paged_attention_decode_buffered_plain(*args).numpy()
    np.testing.assert_array_equal(got, plain)
    tol = _ctx_tolerance(q, *_dense_slots(kp, vp, ks, vs, tbl), lens, step,
                         kb, vb, ksb, vsb)
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) / tol))
    # the fused pool's planes, passed as strided views
    fused = torch.stack([args[1], args[2]], dim=1)             # (NB,2,BLK,.)
    scales = None if ks is None else torch.stack([args[3], args[4]], dim=1)
    again = paged_attention_decode_buffered(
        args[0], fused[:, 0], fused[:, 1],
        None if scales is None else scales[:, 0],
        None if scales is None else scales[:, 1], *args[5:])
    assert torch.equal(again, torch.from_numpy(got))


# --------------------------------------------------- prefills and burst ----

_PAIR = {}


def _pair():
    """(jcfg, JAX params, tcfg, the port's params carried across), built
    once: init and the JAX engine's compiles dominate."""
    if not _PAIR:
        jcfg, tcfg = _configs()
        jp = jmodel.init_llama_params(jcfg, seed=0)
        tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
        _PAIR['params'] = (jcfg, jp, tcfg, tp)
    return _PAIR['params']


def _assert_codes_close(got, want, rows):
    a = got[:, rows].astype(np.int32)
    b = want[:, rows].astype(np.int32)
    assert (a != b).mean() <= CODE_SHARE and np.abs(a - b).max() <= CODE_STEP


def test_prefill_paged_and_chunk_against_jax():
    """prefill_paged then prefill_chunk_paged (a gathered prefix of one
    block plus a causal window that crosses into the second block) on the
    same weights and tables: logits within the slice's tolerance, the
    written pool rows' layer-1 codes bit-equal, later layers' within the
    carried share (the JAX side writes through its interpreted Pallas
    writer)."""
    jcfg, jp, tcfg, tp = _pair()
    jf, tf = jmodel.fuse_decode_params(jp, jcfg), \
        tmodel.fuse_decode_params(tp, tcfg)
    tcfg.use_kernel_matmul = False
    B, T, nb = 4, 16, 9
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, 256, (B, T)).astype(np.int32)
    lengths = np.array([16, 9, 3, 12], np.int32)
    active = np.array([True, True, False, True])
    tables = np.array([[3, 4], [1, 2], [0, 0], [8, 5]], np.int32)
    jpools = jpaged.init_paged_pools(jcfg, nb)
    tpools = tpaged.init_paged_pools(tcfg, nb, device='cpu')
    jl, jpools = jpaged.prefill_paged(
        jf, jpools, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(active), jcfg, use_kernel=True,
        interpret=True)
    tl, tpools = tpaged.prefill_paged(
        tf, tpools, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(tables), torch.from_numpy(active), tcfg)
    want, got = np.asarray(jl), tl.numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    jn = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
          for k, v in jpools.items()}
    tn = paged_pools_to_numpy(tpools)
    rows = [1, 3, 4, 8]
    np.testing.assert_array_equal(tn['kv'][0, rows], jn['kv'][0, rows])
    _assert_codes_close(tn['kv'], jn['kv'], rows)
    np.testing.assert_allclose(tn['kv_scale'][:, rows], jn['kv_scale'][:, rows],
                               rtol=2.4e-2, atol=1e-8)

    chunk = rng.integers(1, 256, (B, 128)).astype(np.int32)
    write_pos = np.array([16, 120, 0, 12], np.int32)
    jl, jpools = jpaged.prefill_chunk_paged(
        jf, jpools, jnp.asarray(chunk), jnp.asarray(write_pos),
        jnp.asarray(tables), jnp.asarray(active), 1, jcfg, use_kernel=True,
        interpret=True)
    tl, tpools = tpaged.prefill_chunk_paged(
        tf, tpools, torch.from_numpy(chunk), torch.from_numpy(write_pos),
        torch.from_numpy(tables), torch.from_numpy(active), 1, tcfg)
    want, got = np.asarray(jl), tl.numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    jn = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
          for k, v in jpools.items()}
    tn = paged_pools_to_numpy(tpools)
    rows = [1, 2, 3, 4, 5, 8]
    _assert_codes_close(tn['kv'], jn['kv'], rows)
    assert (tn['kv'][0, rows] != jn['kv'][0, rows]).mean() <= 1e-3


def test_burst_against_jax_and_row_13_against_the_composition():
    """burst_forward_paged against the JAX package's, teacher-forced with
    the JAX burst's tokens from the same pools: logits within the slice's
    tolerance. At every step and layer (`observe`) row 13's plain version,
    given the step's query, pool planes and buffers with the step's own
    column written, gives the composition's context within
    _ctx_tolerance."""
    jcfg, jp, tcfg, tp = _pair()
    jf, tf = jmodel.fuse_decode_params(jp, jcfg), \
        tmodel.fuse_decode_params(tp, tcfg)
    tcfg.use_kernel_matmul = False
    B, nb, n = 4, 9, 4
    rng = np.random.default_rng(4)
    jpools = jpaged.init_paged_pools(jcfg, nb)
    tables = np.array([[3, 4], [1, 2], [7, 6], [8, 5]], np.int32)
    tokens = rng.integers(1, 256, (B, 16)).astype(np.int32)
    lengths = np.array([16, 9, 3, 12], np.int32)
    _, jpools = jpaged.prefill_paged(
        jf, jpools, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.ones(B, bool), jcfg, use_kernel=True,
        interpret=True)
    tpools = paged_pools_from_numpy(
        {k: np.asarray(v) for k, v in jpools.items()}, device='cpu')
    cur = rng.integers(1, 256, B).astype(np.int32)
    seen = []

    def select(logits, key):
        jax.debug.callback(lambda lg: seen.append(np.asarray(lg)), logits,
                           ordered=True)
        return jnp.argmax(logits, -1).astype(jnp.int32)
    jtoks, _ = jpaged.burst_forward_paged(
        jf, jpools, jnp.asarray(cur), jnp.asarray(lengths), jnp.asarray(tables),
        jax.random.split(jax.random.PRNGKey(0), n), jcfg, select,
        ragged_interpret=True, use_kernel=True, read_limit=32)
    forced = torch.from_numpy(np.asarray(jtoks))
    mine, probes = [], []

    def tselect(logits, step):
        mine.append(logits.numpy())
        return forced[step]

    def observe(at):
        li = at['layer']
        kb, vb = at['kbuf'].clone(), at['vbuf'].clone()
        kb[:, at['step']], vb[:, at['step']] = at['k'], at['v']
        ksb, vsb = at['ksb'].clone(), at['vsb'].clone()
        ksb[:, :, at['step']], vsb[:, :, at['step']] = at['ks'], at['vs']
        B_, n_ = kb.shape[:2]
        ctx = paged_attention_decode_buffered(
            at['q'], tpools['kv'][li, :, 0], tpools['kv'][li, :, 1],
            tpools['kv_scale'][li, :, 0], tpools['kv_scale'][li, :, 1],
            at['tables'], at['seq_lens'], kb.reshape(B_, n_, -1),
            vb.reshape(B_, n_, -1), ksb, vsb, at['step'], block_size=128)
        probes.append((li, at, ctx, (kb, vb, ksb, vsb)))
    tpaged.burst_forward_paged(tf, tpools, torch.from_numpy(cur),
                               torch.from_numpy(lengths),
                               torch.from_numpy(tables), n, tcfg, tselect,
                               read_limit=32, observe=observe)
    for a, b in zip(mine, seen):
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(b).max()
    assert len(probes) == n * tcfg.n_layers
    # the burst's own rows lie past the fills, which the tolerance masks
    planes = paged_pools_to_numpy(tpools)
    for li, at, ctx, (kb, vb, ksb, vsb) in probes:
        step = at['step']
        kp, vp = planes['kv'][li, :, 0], planes['kv'][li, :, 1]
        ks, vs = planes['kv_scale'][li, :, 0], planes['kv_scale'][li, :, 1]
        dense = _dense_slots(kp, vp, ks, vs, tables)
        lens = lengths.copy()
        k_, v_ = dense[0].copy(), dense[1].copy()
        tol = _ctx_tolerance(at['q'].float().numpy(), k_, v_, dense[2],
                             dense[3], lens, step,
                             kb.reshape(B, n, -1).numpy(),
                             vb.reshape(B, n, -1).numpy(), ksb.numpy(),
                             vsb.numpy())
        # the composition folds v_scale into p, row 13 into the values:
        # two more bf16 roundings of each term (2^-8 each)
        diff = np.abs(ctx.numpy() - at['ctx'].numpy())
        assert np.all(diff <= 2 * tol), float(np.max(diff / tol))


# ---------------------------------------------------------------- engine ---

_ENGINES = {}


def _engines(prefix_blocks=0):
    """The JAX paged engine and the port's, on the same weights."""
    if prefix_blocks not in _ENGINES:
        jcfg, jp, _, tp = _pair()
        jc, tc = _configs(prefix_cache_blocks=prefix_blocks)
        _ENGINES[prefix_blocks] = (jengine.ServingEngine(jc, jp),
                                   ServingEngine(tc, tp, device='cpu'))
    return _ENGINES[prefix_blocks]


def _requests(cls, seed=0, n=6):
    """More requests than slots: short prompts, one over the 16-token bucket
    (the chunked paged prefill) and one of 150 tokens (two blocks)."""
    rng = np.random.default_rng(seed)
    lengths = [5, 40, 12, 150, 3, 21][:n]
    return [cls(i, [int(t) for t in rng.integers(1, 256, size=length)],
                max_new_tokens=int(rng.integers(6, 12)))
            for i, length in enumerate(lengths)]


def _reference_logits(tcfg, params, seq):
    """The port's dense forward over the whole sequence: the logits of its
    next token."""
    cfg = LlamaConfig(**dict(PAGED, max_seq_len=512))
    cfg.use_kernel_matmul, cfg.norm_folded = False, tcfg.norm_folded
    T = len(seq)
    cache = tmodel.init_kv_cache(cfg, 1, 'cpu')
    logits, _ = tmodel.forward(
        params, cache, torch.tensor([seq], dtype=torch.int32),
        torch.arange(T, dtype=torch.int32)[None],
        torch.zeros(1, dtype=torch.int32),
        torch.full((1,), T, dtype=torch.int32), cfg)
    return logits[0, -1].numpy()


def _same_greedy_tokens(ref, got, tcfg, params):
    """test_engine_run_greedy_tokens' rule: where a token differs, the two
    candidates' logits lie within the logit tolerance of each other and of
    the top (a near-tie that bf16 noise decides), and the comparison of that
    request ends there. Returns the share of compared tokens that agree."""
    compared = equal = 0
    for a, b in zip(ref, got):
        for i, (x, y) in enumerate(zip(a.generated, b.generated)):
            compared += 1
            if x == y:
                equal += 1
                continue
            logits = _reference_logits(tcfg, params, b.prompt + b.generated[:i])
            scale = LOGIT_TOL * np.abs(logits).max()
            assert abs(logits[x] - logits[y]) <= scale
            assert logits.max() - min(logits[x], logits[y]) <= scale
            break
        else:
            assert len(a.generated) == len(b.generated)
    return equal / compared


def test_paged_engine_greedy_tokens_against_jax_and_the_dense_engine():
    """`run` with more requests than slots, bursts of 4: every request
    finishes within its budget, every block returns to the allocator, and
    the greedy tokens are the JAX paged engine's and the port's dense
    engine's by the near-tie rule."""
    jeng, teng = _engines()
    free0 = teng._alloc.free_blocks
    jreqs, treqs = _requests(jengine.Request), _requests(Request)
    jeng.run(jreqs, sync_every=4)
    teng.run(treqs, sync_every=4)
    for r in treqs:
        assert r.done and len(r.generated) == r.max_new_tokens
        assert all(0 <= t < 256 for t in r.generated)
    assert teng._alloc.free_blocks == free0 == teng._alloc.num_blocks - 1
    assert all(r is None for r in teng.slot_req) and not teng.slot_len.any()
    assert _same_greedy_tokens(jreqs, treqs, teng.cfg, teng.params) >= 0.8
    dense_cfg = LlamaConfig(**PAGED)
    dense_cfg.use_ragged_attention = False
    dense = ServingEngine(dense_cfg, _pair()[3], device='cpu')
    dreqs = _requests(Request)
    dense.run(dreqs, sync_every=4)
    assert _same_greedy_tokens(dreqs, treqs, teng.cfg, teng.params) >= 0.8


def test_paged_engine_single_steps_and_benchmark_decode():
    """sync_every=1 decodes one paged step at a time (the tokens of bursts
    of 4 by the near-tie rule: a step reads from the pool what a burst reads
    from its buffer, in another order; every block back); benchmark_decode
    runs the paged burst at a fill over one block."""
    _, teng = _engines()
    a, b = _requests(Request, seed=5, n=3), _requests(Request, seed=5, n=3)
    teng.run(a, sync_every=1)
    teng.run(b, sync_every=4)
    assert _same_greedy_tokens(b, a, teng.cfg, teng.params) >= 0.6
    assert teng._alloc.free_blocks == teng._alloc.num_blocks - 1
    out = teng.benchmark_decode(steps=4, burst=4, repeats=1, fill=130)
    assert out['tokens_per_sec'] > 0 and out['batch'] == 4
    teng.cache = teng._new_cache()


def _prefix_engines(prefix_blocks, bucket=128):
    _, _, _, tp = _pair()
    _, tc = _configs(prefix_cache_blocks=prefix_blocks, max_batch=2,
                     prefill_buckets=(bucket,))
    return ServingEngine(tc, tp, device='cpu')


def _gen(engine, prompts, n=4):
    outs = []
    for p in prompts:                 # sequential waves: reuse kicks in
        reqs = [Request(0, list(p), max_new_tokens=n)]
        engine.run(reqs, sync_every=2)
        outs.append(reqs[0].generated)
    return outs


def test_prefix_cache_exact_and_hits():
    """test_prefix_cache.py's first case: identical 200-token prompts, the
    second admit hits and gives the uncached engine's tokens."""
    prompt = np.random.RandomState(0).randint(1, 96, 200).tolist()
    ref = _gen(_prefix_engines(0), [prompt, prompt])
    eng = _prefix_engines(32)
    assert _gen(eng, [prompt, prompt]) == ref
    assert eng.prefix_cache.hits == 1 and eng.prefix_cache.misses == 1
    assert len(eng.prefix_cache.index) >= 1


def test_prefix_cache_divergent_tail_and_blocks_survive_retirement():
    """Prompts sharing their first block and diverging after: one hit and
    the uncached tokens; the cached block outlives its request, and the pool
    balances after clear()."""
    rng = np.random.RandomState(1)
    head = rng.randint(1, 96, 128).tolist()
    p1 = head + rng.randint(1, 96, 70).tolist()
    p2 = head + rng.randint(1, 96, 90).tolist()
    ref = _gen(_prefix_engines(0), [p1, p2])
    eng = _prefix_engines(32)
    assert _gen(eng, [p1, p2]) == ref
    assert eng.prefix_cache.hits == 1 and eng.prefix_cache.misses == 1
    held = len(eng.prefix_cache.index)
    assert held == 1
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1 - held
    eng.prefix_cache.clear()
    assert eng._alloc.free_blocks == eng._alloc.num_blocks - 1


def test_prefix_hit_whose_last_window_passes_the_table_end():
    """A 192-token chunk from the first uncached block (128) of a 256-token
    table: the window's padding passes the table's end, where the engine
    gives it trash columns; the tokens are the uncached engine's."""
    prompt = np.random.RandomState(3).randint(1, 96, 200).tolist()
    ref = _gen(_prefix_engines(0, bucket=192), [prompt, prompt])
    eng = _prefix_engines(32, bucket=192)
    assert _gen(eng, [prompt, prompt]) == ref
    assert eng.prefix_cache.hits == 1


def test_prefix_cache_lru_eviction_against_jax():
    """The LRU index and the allocator's references, step for step against
    the JAX package's on the same calls."""
    caches = []
    for alloc_cls, cache_cls, kw in (
            (jpaged.BlockAllocator, jpaged.PrefixCache, dict(native=False)),
            (tpaged.BlockAllocator, tpaged.PrefixCache, {})):
        a = alloc_cls(16, 2, 8, 4, **kw)
        pc = cache_cls(a, block_size=4, max_blocks=2)
        a.ensure(0, 12)
        pc.insert(list(range(12)), a.slot_block_ids(0))   # cap 2 of 3
        a.ensure(1, 4)
        pc.insert(list(range(100, 104)), a.slot_block_ids(1))
        a.release(0)
        hit = pc.match(list(range(12)) + [7])
        miss = pc.match([5, 6, 7])
        caches.append((sorted(pc.index.values()), a.free_blocks, hit, miss,
                       pc.hits, pc.misses, a.tables().tolist()))
    assert caches[0] == caches[1]


def test_pool_exhaustion_and_what_the_paged_engine_refuses():
    """A pool of two usable blocks raises when a request outgrows it; block
    sizes and head dims that the paged path does not take raise."""
    _, _, _, tp = _pair()
    _, tc = _configs(kv_pool_blocks=2)
    eng = ServingEngine(tc, tp, device='cpu')
    with pytest.raises((MemoryError, ValueError)):
        eng.run([Request(0, list(range(2, 100)), max_new_tokens=200)],
                sync_every=64)
    for extra in (dict(kv_block_size=192), dict(max_seq_len=384,
                                                kv_block_size=256)):
        _, tc = _configs(**extra)
        with pytest.raises(ValueError, match='kv_block_size'):
            ServingEngine(tc, tp, device='cpu')
    cfg = LlamaConfig(**dict(PAGED, n_heads=4, n_kv_heads=2), paged_kv=True)
    params = tmodel.init_llama_params(cfg, seed=0, device='cpu')
    with pytest.raises(ValueError, match='head_dim'):
        ServingEngine(cfg, params, device='cpu')
