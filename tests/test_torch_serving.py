"""The serving slice of ppq_tpu_torch against ppq_tpu on the CPU: the same
numpy-seeded weights (carried across by `interop`) and inputs through both
packages, module by module with tight tolerances and as a whole with the
tolerances that bf16 activations allow, on a config with head dim 128 (the
bank-write and window-write branch) and one with head dim 32 (the indexed
writes).

Tolerances of the whole-slice comparisons. Activations are bf16 and every
module rounds to bf16 on its way out; the two frameworks sum in another
order and evaluate rsqrt, cos, sin and exp to another last bit, so now and
then a value rounds to the neighbouring bf16 number, and two layers later
most values differ by a bf16 step (2^-8 relative):
  * logits: |diff| <= 2e-2 of the largest |logit| (measured: 0.9e-2);
  * KV codes: at most 6 % of entries differ, by at most 3 codes (a code
    next to a rounding tie moves by one; a row whose absmax moved by a bf16
    step moves its largest codes by one more; measured 2.5 %, 2 codes);
  * KV scales: rtol 2.4e-2, three bf16 steps of the row's absmax (a step is
    up to 2^-7 of the value; measured: two steps on 2 of 2048 rows).
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.kernels import qmm as jqmm
from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu_torch.interop import (kv_cache_from_numpy, kv_cache_to_numpy,
                                   llama_params_from_numpy,
                                   llama_params_to_numpy)
from ppq_tpu_torch.serving import (LlamaConfig, Request, SamplingParams,
                                   ServingEngine, init_llama_params)
from ppq_tpu_torch.serving import model as tmodel

SIZES = {
    # head dim 128: bank-write kernel branch, window-write merge
    'dh128': dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
                  n_kv_heads=1, d_ff=512, max_seq_len=64, max_batch=4,
                  prefill_buckets=(16,)),
    # head dim 32: immediate column writes, indexed merge
    'dh32': dict(vocab_size=256, d_model=256, n_layers=2, n_heads=8,
                 n_kv_heads=4, d_ff=512, max_seq_len=64, max_batch=4,
                 prefill_buckets=(16,)),
}
LOGIT_TOL, CODE_SHARE, CODE_STEP, SCALE_RTOL = 2e-2, 0.06, 3, 2.4e-2


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors here are tiny. With one thread PyTorch opens no OpenMP
    region, whose idle workers would otherwise spin on the cores that the
    other test processes need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(size, kernel=False, **extra):
    """The same configuration for both packages (the JAX package's matmul
    switch is `use_pallas_matmul`)."""
    jcfg = jconfig.LlamaConfig(**SIZES[size], **extra)
    jcfg.use_pallas_matmul, jcfg.use_ragged_attention = kernel, False
    tcfg = LlamaConfig(**SIZES[size], **extra)
    tcfg.use_kernel_matmul, tcfg.use_ragged_attention = kernel, False
    return jcfg, tcfg


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


def _kernel_path(monkeypatch):
    """Send the JAX package's matmuls through its Pallas kernels in
    interpret mode: `qmatmul` looks them up at call time."""
    for name in ('qmm_int8', 'qmm_gateup'):
        monkeypatch.setattr(jqmm, name, functools.partial(
            getattr(jqmm, name), interpret=True))


def _pair(size, kernel=False, seed=0):
    """(jcfg, fused JAX params, tcfg, fused port params carried across)."""
    jcfg, tcfg = _configs(size, kernel)
    jp = jmodel.init_llama_params(jcfg, seed=seed)
    tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
    return (jcfg, jmodel.fuse_decode_params(jp, jcfg),
            tcfg, tmodel.fuse_decode_params(tp, tcfg))


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


def _assert_logits_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


# ----------------------------------------------------------- weights ------

@pytest.mark.parametrize('bits,method', [(8, 'minmax'), (8, 'mse'),
                                         (16, 'minmax')])
def test_quantize_weight_bit_equal(bits, method):
    w = np.random.default_rng(3).standard_normal((96, 40)).astype(np.float32)
    w[:, 5] = 0.0                                  # the 1e-8 floor
    want = jmodel.quantize_weight(w, bits, method=method)
    got = tmodel.quantize_weight(w, bits, method=method, device='cpu')
    _assert_trees_equal(want, got)


@pytest.mark.parametrize('size', list(SIZES))
def test_init_llama_params_same_seed_same_weights(size):
    jcfg, tcfg = _configs(size)
    _assert_trees_equal(jmodel.init_llama_params(jcfg, seed=4),
                        init_llama_params(tcfg, seed=4, device='cpu'))


def test_unquantized_init_and_quantize_llama_params():
    jcfg, tcfg = _configs('dh32')
    jp = jmodel.init_llama_params(jcfg, seed=1, quantized=False)
    tp = init_llama_params(tcfg, seed=1, quantized=False, device='cpu')
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(jmodel.quantize_llama_params(jp, jcfg),
                        tmodel.quantize_llama_params(tp, tcfg))


def _with_gammas(params_np, seed):
    rng = np.random.default_rng(seed)
    def gamma(a):
        return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
    params_np['final_norm'] = gamma(params_np['final_norm'])
    for layer in params_np['layers']:
        layer['attn_norm'] = gamma(layer['attn_norm'])
        layer['mlp_norm'] = gamma(layer['mlp_norm'])
    return params_np


@pytest.mark.parametrize('bits', [8, 16])
def test_fuse_decode_params_leaf_for_leaf(bits):
    """8 bits: unit gammas fold trivially, the lm_head is padded to 1024
    columns. 16 bits with real gammas: the fold scales the weights. 8 bits
    with real gammas: the fold declines."""
    for real_gammas in (False, True):
        jcfg, tcfg = _configs('dh128', weight_bits=bits)
        base = _np_tree(jmodel.init_llama_params(jcfg, seed=2))
        if real_gammas:
            base = _with_gammas(base, 5)
        as_jax = jax.tree.map(jnp.asarray, base)
        for owner in [as_jax, *as_jax['layers']]:
            for key, leaf in owner.items():
                if key in ('embed',):
                    owner[key] = leaf.astype(jnp.bfloat16)
                elif isinstance(leaf, dict) and 'w' in leaf:
                    leaf['w'] = leaf['w'].astype(jnp.bfloat16)
        jf = jmodel.fuse_decode_params(as_jax, jcfg)
        tf = tmodel.fuse_decode_params(llama_params_from_numpy(base, device='cpu'), tcfg)
        _assert_trees_equal(jf, tf)
        assert tcfg.norm_folded == jcfg.norm_folded
        assert tcfg.norm_folded == (not real_gammas or bits == 16)
        if bits == 8:
            assert tf['lm_head']['w_int'].shape[1] == 1024


# --------------------------------------------------------- components -----

def _bf16_np(a):
    """float32 values that bf16 holds exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def test_norm_rope_and_kv_quant_components():
    """One module at a time on the same inputs: f32 results to a few ulp;
    bf16 results equal except where the f32 value sat on a rounding
    boundary (at most 1 % of entries, by one bf16 step)."""
    rng = np.random.default_rng(0)
    x = _bf16_np(rng.standard_normal((3, 5, 256)).astype(np.float32))
    gamma = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()

    def bf16_close(got, want):
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert (got != want).mean() <= 0.01
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30)

    bf16_close(tmodel.rms_norm(xt, torch.from_numpy(gamma), 1e-5),
               jmodel.rms_norm(xj, jnp.asarray(gamma), 1e-5))
    np.testing.assert_allclose(tmodel.row_rsqrt(xt, 1e-5).numpy(),
                               np.asarray(jmodel.row_rsqrt(xj, 1e-5)),
                               rtol=1e-6)
    pos = rng.integers(0, 64, size=(3, 5)).astype(np.int32)
    heads = x.reshape(3, 5, 2, 128)
    tcos, tsin = tmodel.rope_tables(torch.from_numpy(pos), 10000.0, 128)
    jcos, jsin = jmodel.rope_tables(jnp.asarray(pos), 10000.0, 128)
    # angles up to 63 rad computed in f32: an ulp of the angle is 4e-6
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=2e-5)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=2e-5)
    bf16_close(tmodel.rope(torch.from_numpy(heads).bfloat16(),
                           torch.from_numpy(pos), 10000.0),
               jmodel.rope(jnp.asarray(heads, jnp.bfloat16),
                           jnp.asarray(pos), 10000.0))
    tq, ts = tmodel._kv_quant(torch.from_numpy(heads).bfloat16())
    jq, js = jmodel._kv_quant(jnp.asarray(heads, jnp.bfloat16))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-7)
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3    # ties only


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('epilogue', ['none', 'row', 'residual', 'both'])
def test_qmatmul_both_numerics(kernel, epilogue, monkeypatch):
    """qmatmul follows the JAX kernel (scale after the dot) where that would
    run, and the JAX fallback (weight times scale rounded to bf16 first)
    where that would: same routing, and each within one bf16 step of its
    counterpart. The two numerics themselves differ by more."""
    if kernel:
        _kernel_path(monkeypatch)
    rng = np.random.default_rng(1)
    w = jmodel.quantize_weight(
        rng.standard_normal((256, 384)).astype(np.float32) / 16, 8)
    wt = llama_params_from_numpy(_np_tree(w), device='cpu')
    x = _bf16_np(rng.standard_normal((2, 3, 256)).astype(np.float32))
    row = (rng.random((2, 3)) + 0.5).astype(np.float32)
    res = _bf16_np(rng.standard_normal((2, 3, 384)).astype(np.float32))
    use_row, use_res = epilogue in ('row', 'both'), epilogue in ('residual', 'both')
    want = jmodel.qmatmul(
        jnp.asarray(x, jnp.bfloat16), w, pallas=kernel,
        row_scale=jnp.asarray(row) if use_row else None,
        residual=jnp.asarray(res, jnp.bfloat16) if use_res else None)
    got = tmodel.qmatmul(
        torch.from_numpy(x).bfloat16(), wt, kernel=kernel,
        row_scale=torch.from_numpy(row) if use_row else None,
        residual=torch.from_numpy(res).bfloat16() if use_res else None)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 384)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (got != want).mean() <= 0.01
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-3)


def test_qmatmul_routing_over_the_row_cap():
    """More than 2 MiB of activation rows keeps the library product even
    with the kernel switched on, as in the JAX package."""
    assert tmodel._KERNEL_QMM_MAX_X_BYTES == jmodel._PALLAS_QMM_MAX_X_BYTES
    rng = np.random.default_rng(2)
    w = llama_params_from_numpy(_np_tree(jmodel.quantize_weight(
        rng.standard_normal((256, 128)).astype(np.float32), 8)), device='cpu')
    x = torch.from_numpy(rng.standard_normal((4097, 256)).astype(np.float32))
    x = x.bfloat16()
    over = tmodel.qmatmul(x, w, kernel=True)
    assert torch.equal(over, tmodel.qmatmul(x, w, kernel=False))
    under = tmodel.qmatmul(x[:64], w, kernel=True)
    assert not torch.equal(under, over[:64])


# ------------------------------------------------------------ forward -----

_JIT_FORWARD = {}


def _jit_forward(jcfg):
    """The JAX package's forward, jitted once per configuration (and by JAX
    per input shape), so that the tests' many calls at one shape compile
    once."""
    key = repr(jcfg)
    if key not in _JIT_FORWARD:
        cfg = copy.deepcopy(jcfg)
        _JIT_FORWARD[key] = jax.jit(lambda *args, active: jmodel.forward(
            *args, cfg, active=active))
    return _JIT_FORWARD[key]


def _forward_both(pair, tokens, positions, write_pos, seq_lens, active,
                  caches=None):
    jcfg, jp, tcfg, tp = pair
    B = tokens.shape[0]
    if caches is None:
        caches = (jmodel.init_kv_cache(jcfg, B),
                  tmodel.init_kv_cache(tcfg, B, 'cpu'))
    jc, tc = caches
    jl, jc = _jit_forward(jcfg)(
            jp, jc, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(write_pos), jnp.asarray(seq_lens),
            active=None if active is None else jnp.asarray(active))
    tl, tc = tmodel.forward(
        tp, tc, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(write_pos), torch.from_numpy(seq_lens), tcfg,
        active=None if active is None else torch.from_numpy(active))
    return np.asarray(jl), tl.numpy(), (jc, tc)


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('size', list(SIZES))
def test_forward_prefill_continuation_and_decode(size, kernel, monkeypatch):
    """Masked prefill, a chunked continuation at unequal offsets and one
    decode step, each on the cache the step before left: logits and the
    cache's codes and scales."""
    if kernel:
        _kernel_path(monkeypatch)
    pair = _pair(size, kernel)
    rng = np.random.default_rng(7)
    B, T = 4, 16
    ar = np.arange(T, dtype=np.int32)
    tokens = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    active = np.array([True, True, False, True])
    zeros = np.zeros(B, np.int32)
    jl, tl, caches = _forward_both(
        pair, tokens, np.broadcast_to(ar, (B, T)).copy(), zeros,
        np.full(B, T, np.int32), active)
    _assert_logits_close(tl, jl)
    _assert_caches_close(*caches)
    tc = kv_cache_to_numpy(caches[1])
    assert not tc['k'][:, 2].any() and not tc['k_scale'][:, 2].any()

    write_pos = np.array([16, 12, 0, 16], np.int32)
    tokens = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    jl, tl, caches = _forward_both(
        pair, tokens, write_pos[:, None] + ar, write_pos, write_pos + T,
        np.array([True, True, False, False]), caches)
    _assert_logits_close(tl[:2], jl[:2])
    _assert_caches_close(*caches)

    seq = np.array([32, 28, 0, 16], np.int32)
    tokens = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
    jl, tl, caches = _forward_both(pair, tokens, seq[:, None], seq, seq + 1,
                                   None, caches)
    _assert_logits_close(tl, jl)
    _assert_caches_close(*caches)


# -------------------------------------------------------------- burst -----

def _prefilled(pair, seed, T=16):
    """Both packages' caches after the same masked prefill; slot 2 stays
    empty."""
    rng = np.random.default_rng(seed)
    B = 4
    tokens = rng.integers(0, 256, size=(B, T)).astype(np.int32)
    _, _, caches = _forward_both(
        pair, tokens, np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy(),
        np.zeros(B, np.int32), np.full(B, T, np.int32),
        np.array([True, True, False, True]))
    return caches, np.array([T, T, 0, T], np.int32)


def _burst_both(pair, caches, seq, cur, forced, s_limit=32, chunk=None):
    """Teacher-forced burst in both packages: step i is fed forced[i]
    whatever the logits say, so one flipped argmax does not end the
    comparison. Returns the per-step logits of both and the caches."""
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
        p, c, t, s, k, jcfg, jselect, s_limit=s_limit, chunk=chunk))(
            jp, caches[0], jnp.asarray(cur), jnp.asarray(seq), keys)
    jax.effects_barrier()
    tseen = {}

    def tselect(logits, step):
        tseen[step] = logits.numpy().copy()
        return torch.from_numpy(forced[step])

    ttoks, tc = tmodel.burst_forward(
        tp, caches[1], torch.from_numpy(cur), torch.from_numpy(seq), n, tcfg,
        tselect, s_limit=s_limit, chunk=chunk)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    return ([seen[i] for i in range(n)], [tseen[i] for i in range(n)],
            (jc, tc))


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('size', list(SIZES))
def test_burst_forward_teacher_forced(size, kernel, monkeypatch):
    """burst_forward against the JAX XLA path and against the JAX kernel
    path (Pallas in interpret mode), on the bank-write branch (dh128) and
    the immediate-write branch (dh32)."""
    if kernel:
        _kernel_path(monkeypatch)
    pair = _pair(size, kernel)
    assert pair[2].norm_folded and pair[0].norm_folded
    caches, seq = _prefilled(pair, seed=11)
    rng = np.random.default_rng(12)
    n = 6
    cur = rng.integers(0, 256, size=4).astype(np.int32)
    forced = rng.integers(0, 256, size=(n, 4)).astype(np.int32)
    jlogits, tlogits, caches = _burst_both(pair, caches, seq, cur, forced)
    for want, got in zip(jlogits, tlogits):
        _assert_logits_close(got, want)
    _assert_caches_close(*caches)
    # the burst wrote rows [seq, seq + n) of every slot and nothing else
    tc = kv_cache_to_numpy(caches[1])
    assert not tc['k'][:, 2, n:].any() and tc['k'][:, 0, 16:16 + n].any()
    assert not tc['k'][:, 0, 16 + n:].any()


def test_burst_forward_chunked_and_unfolded(monkeypatch):
    """The chunked buffer read (chunk=3 of 6 steps) against the JAX
    package's, and real gammas on quantized weights: the fold declines and
    the burst takes rms_norm instead of the fused epilogues."""
    jcfg, tcfg = _configs('dh128')
    base = _with_gammas(_np_tree(jmodel.init_llama_params(jcfg, seed=0)), 9)
    as_jax = jax.tree.map(jnp.asarray, base)
    as_jax['embed'] = as_jax['embed'].astype(jnp.bfloat16)
    pair = (jcfg, jmodel.fuse_decode_params(as_jax, jcfg), tcfg,
            tmodel.fuse_decode_params(llama_params_from_numpy(base, device='cpu'), tcfg))
    assert not jcfg.norm_folded and not tcfg.norm_folded
    caches, seq = _prefilled(pair, seed=13)
    rng = np.random.default_rng(14)
    cur = rng.integers(0, 256, size=4).astype(np.int32)
    forced = rng.integers(0, 256, size=(6, 4)).astype(np.int32)
    jlogits, tlogits, caches = _burst_both(pair, caches, seq, cur, forced,
                                           chunk=3)
    for want, got in zip(jlogits, tlogits):
        _assert_logits_close(got, want)
    _assert_caches_close(*caches)


@pytest.mark.parametrize('kernel', [False, True], ids=['xla', 'kernel'])
@pytest.mark.parametrize('size', list(SIZES))
def test_burst_equals_step_by_step_exactly(size, kernel):
    """Inside the port a greedy burst of n steps gives the tokens of n
    bursts of one step from the same prefilled cache, token for token, and
    leaves the same cache bit for bit: the frozen cache is not written
    before the merge, and a step's codes are the codes the cache gets."""
    tcfg = _configs(size, kernel)[1]
    tp = tmodel.fuse_decode_params(init_llama_params(tcfg, seed=3, device='cpu'), tcfg)
    rng = np.random.default_rng(5)
    B, T, n = 4, 16, 7
    tokens = torch.from_numpy(rng.integers(0, 256, size=(B, T)).astype(np.int32))
    positions = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    lengths = torch.tensor([16, 9, 0, 13], dtype=torch.int32)

    def prefilled():
        cache = tmodel.init_kv_cache(tcfg, B, 'cpu')
        tmodel.forward(tp, cache, tokens, positions,
                       torch.zeros(B, dtype=torch.int32),
                       torch.full((B,), T, dtype=torch.int32), tcfg,
                       active=lengths > 0)
        return cache

    def greedy(logits, step):
        return torch.argmax(logits, dim=-1)

    cur = torch.from_numpy(rng.integers(0, 256, size=B).astype(np.int32))
    burst_cache = prefilled()
    burst_toks, _ = tmodel.burst_forward(tp, burst_cache, cur, lengths, n,
                                         tcfg, greedy, s_limit=32)
    step_cache, tok, fill, step_toks = prefilled(), cur, lengths.clone(), []
    for _ in range(n):
        out, _ = tmodel.burst_forward(tp, step_cache, tok, fill, 1, tcfg,
                                      greedy, s_limit=32)
        tok, fill = out[0], fill + 1
        step_toks.append(tok)
    assert torch.equal(burst_toks, torch.stack(step_toks))
    for key in burst_cache:
        assert torch.equal(burst_cache[key], step_cache[key]), key


# ------------------------------------------------------------- engine -----

def _requests(cls, sampling_cls=None):
    """Seven seeded requests for four slots: a second wave is admitted; one
    prompt is longer than the bucket (chunked prefill); some stop at an
    eos."""
    rng = np.random.default_rng(21)
    reqs = []
    for i in range(7):
        length = 27 if i == 2 else int(rng.integers(3, 16))
        reqs.append(cls(i, [int(t) for t in rng.integers(1, 256, size=length)],
                        max_new_tokens=int(rng.integers(4, 11)),
                        eos_id=None))
    return reqs


def _reference_logits(tcfg, tp, sequence):
    """The port's logits for the token after `sequence`, from one plain
    forward over the whole sequence."""
    T = len(sequence)
    cache = tmodel.init_kv_cache(tcfg, 1, 'cpu')
    logits, _ = tmodel.forward(
        tp, cache, torch.tensor([sequence], dtype=torch.int32),
        torch.arange(T, dtype=torch.int32)[None],
        torch.zeros(1, dtype=torch.int32),
        torch.full((1,), T, dtype=torch.int32), tcfg)
    return logits[0, -1].numpy()


_ENGINES = {}


def _engines(size):
    """One JAX engine and one port engine per size, on the same weights,
    built once for the module: the JAX engine's jit compiles dominate."""
    if size not in _ENGINES:
        jcfg, tcfg = _configs(size)
        jcfg.use_pallas_matmul = tcfg.use_kernel_matmul = None  # both resolve off
        jp = jmodel.init_llama_params(jcfg, seed=0)
        tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
        _ENGINES[size] = (jengine.ServingEngine(jcfg, jp),
                          ServingEngine(tcfg, tp, device='cpu'))
    return _ENGINES[size]


@pytest.mark.parametrize('with_eos', [False, True], ids=['budget', 'eos'])
@pytest.mark.parametrize('size', list(SIZES))
def test_engine_run_greedy_tokens(size, with_eos):
    """`run` with more requests than slots, burst decode (sync_every=4):
    every request finishes within its budget, and the greedy tokens are the
    JAX engine's. Where a token differs, the two candidates' logits are
    within the logit tolerance of each other (a near-tie that bf16 noise
    decides), and the comparison of that request ends there."""
    jeng, teng = _engines(size)
    jreqs, treqs = _requests(jengine.Request), _requests(Request)
    if with_eos:
        # an eos that the reference run meets: the third token of request 0
        jeng.run(_probe := _requests(jengine.Request), sync_every=4)
        eos = _probe[0].generated[2]
        for reqs in (jreqs, treqs):
            for r in reqs[::2]:
                r.eos_id = eos
    assert teng.cfg.use_kernel_matmul is False
    jeng.run(jreqs, sync_every=4)
    teng.run(treqs, sync_every=4)
    compared = equal = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and 1 <= len(tr.generated) <= tr.max_new_tokens
        assert all(0 <= t < 256 for t in tr.generated)
        if tr.eos_id is not None and tr.eos_id in tr.generated:
            assert tr.generated.index(tr.eos_id) == len(tr.generated) - 1
        for i, (a, b) in enumerate(zip(jr.generated, tr.generated)):
            compared += 1
            if a == b:
                equal += 1
                continue
            logits = _reference_logits(teng.cfg, teng.params,
                                       tr.prompt + tr.generated[:i])
            assert abs(logits[a] - logits[b]) <= LOGIT_TOL * np.abs(logits).max()
            assert logits.max() - min(logits[a], logits[b]) \
                <= LOGIT_TOL * np.abs(logits).max()
            break
        else:
            assert len(jr.generated) == len(tr.generated)
    assert equal >= 0.8 * compared
    assert all(r is None for r in teng.slot_req) and not teng.slot_len.any()


def test_engine_single_step_decode_and_arrivals():
    """sync_every=1 takes the single-token forward; arrivals admit requests
    as the clock passes their offsets."""
    _, teng = _engines('dh32')
    reqs = _requests(Request)[:5]
    teng.run(reqs, sync_every=1, arrivals=[0.0, 0.0, 0.01, 0.02, 0.03])
    again = _requests(Request)[:5]
    teng.run(again, sync_every=4)
    for a, b in zip(reqs, again):
        assert a.done and a.t_first >= a.t_submit and a.t_done >= a.t_first
        assert len(a.generated) == len(b.generated)
    with pytest.raises(ValueError):
        teng.run(_requests(Request)[:2], arrivals=[0.0])


def test_sampler_thresholds_and_sampled_tokens():
    """The two sort-free thresholds are deterministic: equal to the JAX
    package's on the same logits. torch.multinomial and
    jax.random.categorical draw different tokens from one seed, so sampled
    tokens are only held to lie in the kept set."""
    jeng, teng = _engines('dh32')
    rng = np.random.default_rng(31)
    logits = (rng.standard_normal((4, 256)) * 3).astype(np.float32)
    logits[1, 10] = logits[1, 20]                       # a tie at the top
    k = np.array([1, 5, 40, 256], np.int32)
    want = np.asarray(jeng._topk_threshold(jnp.asarray(logits), jnp.asarray(k)))
    got = teng._topk_threshold(torch.from_numpy(logits), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    p = np.array([0.1, 0.5, 0.9, 0.999], np.float32)
    want = np.asarray(jeng._topp_threshold(jnp.asarray(probs), jnp.asarray(p)))
    got = teng._topp_threshold(torch.from_numpy(probs), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)

    samp = {'t': torch.tensor([0.0, 0.7, 1.0, 1.3]),
            'k': torch.tensor([0, 5, 0, 40], dtype=torch.int32),
            'p': torch.tensor([1.0, 1.0, 0.5, 0.9])}
    jsamp = {key: jnp.asarray(val.numpy()) for key, val in samp.items()}
    jtok = np.asarray(jeng._select_vec(jnp.asarray(logits),
                                       jax.random.PRNGKey(0), jsamp))
    assert jtok[0] == logits[0].argmax()
    order = np.argsort(-logits, axis=-1)
    for _ in range(20):
        tok = teng._select(torch.from_numpy(logits), samp).numpy()
        assert tok[0] == logits[0].argmax()             # t = 0: greedy
        assert tok[1] in order[1, :5]                   # top-5
        assert tok[3] in order[3, :40]
        kept = np.cumsum(probs[2][order[2]]) - probs[2][order[2]] < 0.5
        assert tok[2] in order[2][kept]                 # the 0.5 nucleus
    engine_wide = ServingEngine(
        LlamaConfig(**SIZES['dh32']), teng.params, device='cpu',
        sampling=SamplingParams(temperature=0.8, top_k=3, top_p=0.95, seed=1))
    tok = engine_wide._select(torch.from_numpy(logits)).numpy()
    assert all(tok[i] in order[i, :3] for i in range(4))


def test_engine_refuses_what_is_not_ported():
    """Every setting is ported; what the JAX engine refuses, the port
    refuses too, before any process group is touched: MoE on a pipeline
    mesh, a paged pp x sp mesh with a dp or tp axis, a max_batch or
    n_layers that the pipeline does not divide. Ragged attention, INT4
    weights, the paged KV cache, W8A8 prefill and MoE layers build (the
    meshes: tests/test_torch_serving_tp.py, test_torch_serving_pp_sp.py)."""
    tcfg = LlamaConfig(**SIZES['dh32'])
    params = init_llama_params(tcfg, seed=0, device='cpu')
    for paged in (False, True):
        for axes, fields, error, match in (
                ({'pp': 3}, {}, ValueError, 'max_batch'),
                ({'pp': 4}, dict(max_batch=4), ValueError, 'n_layers'),
                ({'pp': 2, 'sp': 2, 'tp': 2}, {}, NotImplementedError,
                 'pure pp x sp'),
                ({'pp': 2, 'sp': 2, 'dp': 2}, {}, NotImplementedError,
                 'pure pp x sp')):
            if not paged and match == 'pure pp x sp':
                continue
            # the axes alone: the refusal comes before any process group
            mesh = types.SimpleNamespace(shape=axes)
            cfg = LlamaConfig(**dict(SIZES['dh32'], **fields), paged_kv=paged)
            with pytest.raises(error, match=match):
                ServingEngine(cfg, params, mesh=mesh, device='cpu')
    moe_cfg = LlamaConfig(**SIZES['dh32'], n_experts=4)
    with pytest.raises(NotImplementedError, match='pp \\+ MoE'):
        ServingEngine(moe_cfg, init_llama_params(moe_cfg, device='cpu'),
                      mesh=types.SimpleNamespace(shape={'pp': 2}),
                      device='cpu')
    ServingEngine(LlamaConfig(**SIZES['dh32'], act_bits=8), params,
                  device='cpu')
    moe_cfg = LlamaConfig(**SIZES['dh32'], n_experts=4)
    moe = init_llama_params(moe_cfg, device='cpu')
    assert all('moe' in layer for layer in moe['layers'])
    ServingEngine(moe_cfg, moe, device='cpu')
    int4 = LlamaConfig(**SIZES['dh32'], weight_bits=4)
    ServingEngine(int4, init_llama_params(int4, seed=0, device='cpu'),
                  device='cpu')
    # the paged path's kernels take head dim 128 and blocks of 128
    paged = LlamaConfig(**dict(SIZES['dh128'], max_seq_len=128),
                        paged_kv=True)
    engine = ServingEngine(paged, init_llama_params(paged, seed=0,
                                                    device='cpu'),
                           device='cpu')
    assert engine._alloc.num_blocks == paged.max_batch + 1


def test_interop_round_trip():
    tcfg = LlamaConfig(**SIZES['dh32'], kv_cache_bits=16)
    params = init_llama_params(tcfg, seed=6, quantized=False, device='cpu')
    back = llama_params_from_numpy(llama_params_to_numpy(params), device='cpu')
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cache = tmodel.init_kv_cache(tcfg, 2, 'cpu')
    cache['k'].normal_()
    again = kv_cache_from_numpy(kv_cache_to_numpy(cache), device='cpu')
    assert again['k'].dtype == torch.bfloat16
    assert torch.equal(again['k'], cache['k'])


def test_weight_and_interop_entry_points_need_a_card_or_device_cpu():
    """quantize_weight and the interop loaders run on the card unless given
    a device: without a card and without device='cpu' they raise."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is the card')
    w = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    cache = {'k': np.zeros((1, 1, 4, 1, 8), np.int8)}
    for call in (lambda: tmodel.quantize_weight(w, 8),
                 lambda: llama_params_from_numpy({'embed': w}),
                 lambda: kv_cache_from_numpy(cache)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
