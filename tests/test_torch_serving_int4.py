"""INT4 weights in ppq_tpu_torch against ppq_tpu on the CPU: split-half
packing, the INT4 dequant-matmul kernels (row 9, `qmm_int4`, and the INT4
body of row 10, `qmm_gateup`) against the JAX package's Pallas kernels in
interpret mode, then the slice: quantization, `qmatmul` in both numerics,
parameters, prefill + decode + burst, and `ServingEngine.run`, each against
the JAX package on the same numpy-seeded weights.

Tolerances: the kernels as in tests/test_torch_serving_kernels.py (both
sides multiply bf16 operands exactly in f32 and sum in another order); the
slice as in tests/test_torch_serving.py (bf16 activations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.kernels import qmm as jqmm
from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu_torch.interop import (kv_cache_to_numpy,
                                   llama_params_from_numpy,
                                   llama_params_to_numpy)
from ppq_tpu_torch.kernels import (LAUNCHES, pack_int4_splithalf, qmm_gateup,
                                   qmm_int4, unpack_int4_splithalf)
from ppq_tpu_torch.kernels import qmm as tqmm
from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                   init_llama_params)
from ppq_tpu_torch.serving import model as tmodel

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
EPILOGUES = [(False, False), (True, False), (False, True), (True, True)]
# d_model 512: the INT4 kernel route needs (d_model / 2) % 256 == 0
INT4 = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=1024, max_seq_len=64, max_batch=4,
            prefill_buckets=(16,), weight_bits=4)
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
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np_tree(tree):
    return jax.tree.map(
        lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a), tree)


def _assert_trees_equal(jtree, ttree):
    jn, tn = _np_tree(jtree), llama_params_to_numpy(ttree)
    assert jax.tree.structure(jn) == jax.tree.structure(tn)
    for a, b in zip(jax.tree.leaves(jn), jax.tree.leaves(tn)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- packing ------

def test_pack_unpack_bit_equal():
    """Every nibble pair, numpy and torch copies against the JAX package's
    numpy pack and jnp unpack."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    q = np.concatenate([lo.reshape(1, -1), hi.reshape(1, -1)]).astype(np.int8)
    q = np.concatenate([q, np.random.default_rng(0).integers(
        -8, 8, size=(62, 256)).astype(np.int8)])
    q = np.concatenate([q[::2], q[1::2]])        # (64, 256), both halves mixed
    want = jqmm.pack_int4_splithalf(q)
    np.testing.assert_array_equal(pack_int4_splithalf(q), want)
    got = pack_int4_splithalf(torch.from_numpy(q))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(jqmm.unpack_int4_splithalf(jnp.asarray(want)))
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(unpack_int4_splithalf(want), back)
    np.testing.assert_array_equal(
        unpack_int4_splithalf(torch.from_numpy(want)).numpy(), back)


@pytest.mark.parametrize('method', ['minmax', 'mse'])
def test_quantize_weight_int4_bit_equal(method):
    w = np.random.default_rng(3).standard_normal((96, 40)).astype(np.float32)
    w[:, 5] = 0.0
    want = jmodel.quantize_weight(w, 4, method=method)
    got = tmodel.quantize_weight(w, 4, method=method, device='cpu')
    assert set(got) == {'w_packed', 'scale'}
    _assert_trees_equal(want, got)


# ---------------------------------------------------------- kernels ------

def _case(B, D, F, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((B, D)).astype(np.float32))
    w = jqmm.pack_int4_splithalf(
        rng.integers(-8, 8, size=(D, F)).astype(np.int8))
    scale = (rng.random(F) * 0.01 + 0.001).astype(np.float32)
    row = (rng.random(B) + 0.5).astype(np.float32)
    res = _bf16(rng.standard_normal((B, F)).astype(np.float32))
    return x, w, scale, row, res


@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
@pytest.mark.parametrize('has_row,has_res', EPILOGUES)
@pytest.mark.parametrize('B,D,F', [(1, 512, 128), (5, 1024, 384)])
def test_qmm_int4_vs_pallas(B, D, F, has_row, has_res, out):
    x, w, scale, row, res = _case(B, D, F, seed=B + D + F)
    want = jqmm.qmm_int4(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        out_dtype=getattr(jnp, out), interpret=True,
        row_scale=jnp.asarray(row) if has_row else None,
        residual=jnp.asarray(res, jnp.bfloat16) if has_res else None)
    before = dict(LAUNCHES)
    got = qmm_int4(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(scale), out_dtype=getattr(torch, out),
        row_scale=torch.from_numpy(row) if has_row else None,
        residual=torch.from_numpy(res).bfloat16() if has_res else None)
    assert LAUNCHES == before
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (B, F)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(F32_TOL if out == 'float32' else BF16_TOL))


@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
@pytest.mark.parametrize('has_row', [False, True])
@pytest.mark.parametrize('B,D,F', [(1, 512, 128), (8, 1024, 256)])
def test_qmm_gateup_int4_vs_pallas(B, D, F, has_row, out):
    """The INT4 body, chosen as the JAX package chooses it (rows * 2 == D)."""
    x, w, scale, row, _ = _case(B, D, 2 * F, seed=B + D + F + 1)
    assert w.shape[0] * 2 == D
    want = jqmm.qmm_gateup(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        out_dtype=getattr(jnp, out), interpret=True,
        row_scale=jnp.asarray(row) if has_row else None)
    got = qmm_gateup(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(scale), out_dtype=getattr(torch, out),
        row_scale=torch.from_numpy(row) if has_row else None)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (B, F)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(F32_TOL if out == 'float32' else BF16_TOL))


def test_int4_routing_rules():
    """The port tiles what the JAX kernels tile, without the JAX package's
    16 MiB fast-memory budget. At every shape the slices use both agree; the
    budget only refuses much larger panels, where the JAX package takes its
    fallback numerics and the port its kernel (listed last here)."""
    same = [(256, 4096, 128), (1024, 4096, 128), (1024, 2048, 128),
            (2816, 2048, 128), (256, 1024, 4), (512, 512, 4), (128, 256, 4),
            (256, 192, 4)]
    for dp, f, b in same:
        assert tqmm.supports_int4(dp, f, b) == jqmm.supports_int4(dp, f, b), \
            (dp, f, b)
    for d, f2, b in [(2048, 11264, 128), (512, 2048, 4), (1024, 512, 8),
                     (256, 512, 4), (512, 384, 4)]:
        for bits in (4, 8):
            assert tqmm.supports_gateup(d, f2, b, bits) == \
                jqmm.supports_gateup(d, f2, b, bits), (d, f2, b, bits)
    # a 16384-deep packed weight: the JAX package's budget refuses it (its
    # fallback), the port's kernel takes it
    assert tqmm.supports_int4(16384, 4096, 128)
    assert not jqmm.supports_int4(16384, 4096, 128)


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('epilogue', ['none', 'row', 'residual', 'both'])
def test_qmatmul_int4_both_numerics(kernel, epilogue, monkeypatch):
    """qmatmul on a `w_packed` weight follows the JAX kernel (scale after
    the dot) where that runs and the JAX fallback (unpacked weight times
    scale rounded to bf16) elsewhere: each within one bf16 step."""
    if kernel:
        monkeypatch.setattr(jqmm, 'qmm_int4', functools.partial(
            jqmm.qmm_int4, interpret=True))
    rng = np.random.default_rng(1)
    w = jmodel.quantize_weight(
        rng.standard_normal((512, 384)).astype(np.float32) / 16, 4)
    wt = llama_params_from_numpy(_np_tree(w), device='cpu')
    x = _bf16(rng.standard_normal((2, 3, 512)).astype(np.float32))
    row = (rng.random((2, 3)) + 0.5).astype(np.float32)
    res = _bf16(rng.standard_normal((2, 3, 384)).astype(np.float32))
    use_row, use_res = epilogue in ('row', 'both'), epilogue in ('residual', 'both')
    want = jmodel.qmatmul(
        jnp.asarray(x, jnp.bfloat16), w, pallas=kernel,
        row_scale=jnp.asarray(row) if use_row else None,
        residual=jnp.asarray(res, jnp.bfloat16) if use_res else None)
    got = tmodel.qmatmul(
        torch.from_numpy(x).bfloat16(), wt, kernel=kernel,
        row_scale=torch.from_numpy(row) if use_row else None,
        residual=torch.from_numpy(res).bfloat16() if use_res else None)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (got != want).mean() <= 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-3)


@pytest.mark.parametrize('lm_head_bits', [None, 4])
def test_init_and_fuse_int4_leaf_for_leaf(lm_head_bits):
    """init_llama_params at weight_bits=4 draws the JAX package's weights;
    fuse_decode_params concatenates `w_packed` leaves and pads the lm_head
    (INT8 by default, INT4 when asked) to 1024 columns."""
    jcfg = jconfig.LlamaConfig(**INT4, lm_head_bits=lm_head_bits)
    tcfg = LlamaConfig(**INT4, lm_head_bits=lm_head_bits)
    jp = jmodel.init_llama_params(jcfg, seed=4)
    tp = init_llama_params(tcfg, seed=4, device='cpu')
    _assert_trees_equal(jp, tp)
    jf, tf = jmodel.fuse_decode_params(jp, jcfg), tmodel.fuse_decode_params(tp, tcfg)
    _assert_trees_equal(jf, tf)
    key = 'w_int' if lm_head_bits is None else 'w_packed'
    assert tf['lm_head'][key].shape[1] == 1024
    assert tf['layers'][0]['wqkv']['w_packed'].shape == (256, 1024)


# ------------------------------------------------------------ slice -------

def _configs(kernel):
    jcfg = jconfig.LlamaConfig(**INT4)
    jcfg.use_pallas_matmul, jcfg.use_ragged_attention = kernel, False
    tcfg = LlamaConfig(**INT4)
    tcfg.use_kernel_matmul, tcfg.use_ragged_attention = kernel, False
    return jcfg, tcfg


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
def test_int4_prefill_decode_and_burst(kernel, monkeypatch):
    """A masked prefill, one decode step and a teacher-forced burst of 5 at
    weight_bits=4, against the JAX package's XLA path and its kernel path
    (Pallas `qmm_int4`, `qmm_gateup` INT4 and `qmm_int8` for the lm_head, in
    interpret mode): logits and the cache after each."""
    if kernel:
        for name in ('qmm_int8', 'qmm_int4', 'qmm_gateup'):
            monkeypatch.setattr(jqmm, name, functools.partial(
                getattr(jqmm, name), interpret=True))
    jcfg, tcfg = _configs(kernel)
    jp = jmodel.init_llama_params(jcfg, seed=0)
    tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
    jp, tp = jmodel.fuse_decode_params(jp, jcfg), tmodel.fuse_decode_params(tp, tcfg)
    assert 'w_packed' in tp['layers'][0]['w_gateup']
    B, T = 4, 16
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    active = np.array([True, True, False, True])
    jfwd = jax.jit(lambda *a, active: jmodel.forward(*a, jcfg, active=active))

    def both(jc, tc, toks, positions, write_pos, lens, act):
        jl, jc = jfwd(jp, jc, *(jnp.asarray(a) for a in
                                (toks, positions, write_pos, lens)),
                      active=None if act is None else jnp.asarray(act))
        tl, tc = tmodel.forward(tp, tc, *(torch.from_numpy(a) for a in
                                          (toks, positions, write_pos, lens)),
                                tcfg, active=None if act is None
                                else torch.from_numpy(act))
        _assert_logits_close(tl.numpy(), np.asarray(jl))
        _assert_caches_close(jc, tc)
        return jc, tc

    jc, tc = both(jmodel.init_kv_cache(jcfg, B), tmodel.init_kv_cache(tcfg, B, 'cpu'),
                  tokens, pos, np.zeros(B, np.int32), np.full(B, T, np.int32),
                  active)
    seq = np.array([16, 16, 0, 16], np.int32)
    jc, tc = both(jc, tc, rng.integers(0, 256, size=(B, 1)).astype(np.int32),
                  seq[:, None], seq, seq + 1, None)
    seq = seq + 1
    n = 5
    cur = rng.integers(0, 256, size=B).astype(np.int32)
    forced = rng.integers(0, 256, size=(n, B)).astype(np.int32)
    seen = {}

    def keep(step, logits):
        seen[int(step)] = np.asarray(logits)

    def jselect(logits, key):
        jax.debug.callback(keep, key[0], logits, ordered=True)
        return jnp.asarray(forced)[key[0]]

    keys = jnp.stack([jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros(n, jnp.uint32)], axis=1)
    _, jc = jax.jit(lambda p, c, t, s, k: jmodel.burst_forward(
        p, c, t, s, k, jcfg, jselect, s_limit=32))(
            jp, jc, jnp.asarray(cur), jnp.asarray(seq), keys)
    jax.effects_barrier()
    tseen = []

    def tselect(logits, step):
        tseen.append(logits.numpy().copy())
        return torch.from_numpy(forced[step])

    before = dict(LAUNCHES)
    tmodel.burst_forward(tp, tc, torch.from_numpy(cur), torch.from_numpy(seq),
                         n, tcfg, tselect, s_limit=32)
    assert LAUNCHES == before
    for i in range(n):
        _assert_logits_close(tseen[i], seen[i])
    _assert_caches_close(jc, tc)


def test_engine_run_int4_greedy_tokens():
    """`run` at weight_bits=4 (an INT8 lm_head), more requests than slots,
    bursts of 4: every request finishes, and the greedy tokens are the JAX
    engine's (a near-tie that bf16 noise decides may end a request's
    comparison, within the logit tolerance)."""
    jcfg, tcfg = _configs(None)
    jp = jmodel.init_llama_params(jcfg, seed=0)
    jeng = jengine.ServingEngine(jcfg, jp)
    teng = ServingEngine(tcfg, llama_params_from_numpy(_np_tree(jp), device='cpu'),
                         device='cpu')
    assert tcfg.resolved_lm_head_bits == 8 and 'w_int' in teng.params['lm_head']
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(1, 256, size=int(size))]
               for size in rng.integers(3, 16, size=6)]
    budgets = [int(b) for b in rng.integers(4, 9, size=6)]
    jreqs = [jengine.Request(i, p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    treqs = [Request(i, p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    jeng.run(jreqs, sync_every=4)
    teng.run(treqs, sync_every=4)
    compared = equal = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == tr.max_new_tokens
        assert all(0 <= t < 256 for t in tr.generated)
        for a, b in zip(jr.generated, tr.generated):
            compared += 1
            if a != b:
                break
            equal += 1
    assert equal >= 0.8 * compared
