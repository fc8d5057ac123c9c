"""W8A8 prefill and MoE layers of the port's serving slice
(ppq_tpu_torch.serving: `model.qmatmul(a8=True)`, `moe.py`, the engine with
act_bits=8 and n_experts>0) held against the JAX package on the CPU, on
tests/test_awq.py's tiny configuration (vocab 97, d_model 64, 2 layers).

Tolerances:
  * per-token int8 codes, their scales and the int8 x int8 -> int32 sums:
    bit for bit;
  * W8A8 product outputs: within one bf16 step of the output (2^-8
    relative, the rounding of the final cast; measured: bit-equal);
  * moe_ffn in float32: 1e-5 of the largest |output| (the two frameworks
    sum the einsums in other orders);
  * whole-model logits and engine tokens: as tests/test_torch_serving.py
    holds them (LOGIT_TOL, near-tie rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import engine as jengine
from ppq_tpu.serving import model as jmodel
from ppq_tpu.serving import moe as jmoe
from ppq_tpu_torch.interop import (llama_params_from_numpy,
                                   llama_params_to_numpy)
from ppq_tpu_torch.serving import (LlamaConfig, Request, ServingEngine,
                                   init_llama_params)
from ppq_tpu_torch.serving import model as tmodel
from ppq_tpu_torch.serving import moe as tmoe
from test_torch_serving import (LOGIT_TOL, _assert_logits_close,
                                _assert_trees_equal, _reference_logits)

TINY = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=64, max_batch=2, prefill_buckets=(16,))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    """numpy leaves (bf16 as float32); Python numbers stay numbers."""
    return jax.tree.map(
        lambda a: a if isinstance(a, (int, float)) else np.array(
            a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _x(shape, seed, outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if outliers:
        x[..., 3] *= 25.0
    return _bf16(x)


# ----------------------------------------------------------------- W8A8 ---

@pytest.mark.parametrize('bits', [8, 4])
def test_w8a8_codes_scales_and_int32_sums_bit_equal(bits):
    """_a8_quant's codes and scales, and the int8 x int8 -> int32 product,
    bit for bit the JAX package's (its `lax.dot_general` with an int32
    result); INT4 weights unpack first."""
    x = _x((3, 7, 64), 1)
    w = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    jw = jmodel.quantize_weight(w, bits)
    tw = tmodel.quantize_weight(w, bits, device='cpu')
    jq, js = jmodel._a8_quant(jnp.asarray(x, jnp.bfloat16))
    tq, ts = tmodel._a8_quant(torch.tensor(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    j_int = jw['w_int'] if bits == 8 else jmodel._unpack_int4(jw['w_packed'])
    t_int = tw['w_int'] if bits == 8 else tmodel._unpack_int4(tw['w_packed'])
    want = jax.lax.dot_general(jq.reshape(21, 64), j_int,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tmodel.int8_product(tq.reshape(21, 64), t_int)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 1000


@pytest.mark.parametrize('epilogue', ['none', 'row', 'residual'])
def test_w8a8_qmatmul_outputs_vs_jax(epilogue):
    """qmatmul(a8=True) over a (B, T, D) window: within one bf16 step of the
    JAX package's output, with the folded-norm row scale or the residual in
    the epilogue."""
    x = _x((2, 5, 64), 3)
    w = np.random.default_rng(4).standard_normal((64, 40)).astype(np.float32)
    jw = jmodel.quantize_weight(w, 8)
    tw = tmodel.quantize_weight(w, 8, device='cpu')
    rs = np.random.default_rng(5).uniform(0.5, 2, (2, 5)).astype(np.float32)
    res = _x((2, 5, 40), 6, outliers=False)
    kw_j, kw_t = {}, {}
    if epilogue == 'row':
        kw_j['row_scale'] = jnp.asarray(rs)
        kw_t['row_scale'] = torch.from_numpy(rs)
    if epilogue == 'residual':
        kw_j['residual'] = jnp.asarray(res, jnp.bfloat16)
        kw_t['residual'] = torch.from_numpy(res).to(torch.bfloat16)
    want = np.asarray(jmodel.qmatmul(jnp.asarray(x, jnp.bfloat16), jw,
                                     a8=True, **kw_j).astype(jnp.float32))
    got = tmodel.qmatmul(torch.tensor(x).to(torch.bfloat16), tw, a8=True,
                         **kw_t).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
    plain = tmodel.qmatmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                           **kw_t).float().numpy()
    assert not np.array_equal(got, plain)         # the branch was taken


def test_w8a8_branch_only_where_the_jax_package_takes_it():
    """One token in the second-to-last axis (decode) and 16-bit weights keep
    the weight-only product."""
    w = np.random.default_rng(7).standard_normal((64, 32)).astype(np.float32)
    x1 = torch.from_numpy(_x((4, 1, 64), 8)).to(torch.bfloat16)
    tw = tmodel.quantize_weight(w, 8, device='cpu')
    assert torch.equal(tmodel.qmatmul(x1, tw, a8=True), tmodel.qmatmul(x1, tw))
    x5 = torch.from_numpy(_x((1, 5, 64), 9)).to(torch.bfloat16)
    tf = tmodel.quantize_weight(w, 16, device='cpu')
    assert torch.equal(tmodel.qmatmul(x5, tf, a8=True), tmodel.qmatmul(x5, tf))


# ------------------------------------------------------------------ MoE ---

@pytest.mark.parametrize('bits', [8, 16])
def test_init_moe_params_same_seed_same_weights(bits):
    want = jmoe.init_moe_params(64, 128, 4, 2, weight_bits=bits, seed=3)
    got = tmoe.init_moe_params(64, 128, 4, 2, weight_bits=bits, seed=3,
                               device='cpu')
    assert got['top_k'] == 2 and got['n_experts'] == 4
    _assert_trees_equal({k: v for k, v in want.items()
                         if k not in ('top_k', 'n_experts')},
                        {k: v for k, v in got.items()
                         if k not in ('top_k', 'n_experts')})


@pytest.mark.parametrize('top_k', [1, 2, 3])
def test_moe_ffn_vs_jax(top_k):
    params = jmoe.init_moe_params(64, 128, 4, top_k, seed=5)
    tparams = llama_params_from_numpy(_np_tree(params), device='cpu')
    x = np.random.default_rng(6).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), params, top_k=top_k))
    got = tmoe.moe_ffn(torch.from_numpy(x), tparams, top_k=top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_moe_top_k_ties_take_the_lower_index():
    """Equal gates: lax.top_k's choice (the lower expert index), which a
    stable descending sort gives."""
    gates = np.array([[[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 2)
    tv, ti = tmoe.top_k_lower_index(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), [[[1, 2], [0, 1]]])


def _configs(**extra):
    jcfg = jconfig.LlamaConfig(**TINY, **extra)
    tcfg = LlamaConfig(**TINY, **extra)
    jcfg.use_pallas_matmul = tcfg.use_kernel_matmul = False
    jcfg.use_ragged_attention = tcfg.use_ragged_attention = False
    return jcfg, tcfg


def test_moe_llama_init_and_prefill_logits_vs_jax():
    """init_llama_params with n_experts=4: the same tree as the JAX
    package's (the MoE draws per layer from seed*1000 + layer); a prefill
    forward's logits within the serving slice's tolerance."""
    jcfg, tcfg = _configs(n_experts=4, top_k=2)
    jp = jmodel.init_llama_params(jcfg, seed=2)
    tp = init_llama_params(tcfg, seed=2, device='cpu')
    _assert_trees_equal(jp, tp)
    assert 'moe' in tp['layers'][0] and 'w_gate' not in tp['layers'][0]
    toks = np.random.default_rng(1).integers(1, 97, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    zeros, fill = np.zeros(2, np.int32), np.full(2, 9, np.int32)
    want, _ = jmodel.forward(jp, jmodel.init_kv_cache(jcfg, 2),
                             jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(zeros), jnp.asarray(fill), jcfg)
    got, _ = tmodel.forward(tp, tmodel.init_kv_cache(tcfg, 2, 'cpu'),
                            torch.from_numpy(toks), torch.from_numpy(pos),
                            torch.from_numpy(zeros), torch.from_numpy(fill),
                            tcfg)
    _assert_logits_close(got.numpy(), np.asarray(want))
    assert tmodel.fold_norm_gamma(dict(tp)) is False


def test_moe_and_w8a8_interop_round_trip():
    jcfg, _ = _configs(n_experts=4)
    jp = jmodel.init_llama_params(jcfg, seed=3)
    jp['layers'][0]['moe']['top_k'] = 2
    tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
    assert tp['layers'][0]['moe']['top_k'] == 2
    assert tp['layers'][0]['moe']['w_gate']['w_int'].dtype == torch.int8
    back = llama_params_to_numpy(tp)
    for key in ('router',):
        np.testing.assert_array_equal(back['layers'][1]['moe'][key],
                                      np.asarray(jp['layers'][1]['moe'][key]))
    np.testing.assert_array_equal(
        back['layers'][1]['moe']['w_down']['scale'],
        np.asarray(jp['layers'][1]['moe']['w_down']['scale']))


def _prompts(cls, n=3, seed=4):
    rng = np.random.default_rng(seed)
    lengths = [int(rng.integers(3, 14)) for _ in range(n)]
    return [cls(i, [int(t) for t in rng.integers(1, 97, length)],
                max_new_tokens=6) for i, length in enumerate(lengths)]


@pytest.mark.parametrize('extra', [dict(n_experts=4, top_k=2),
                                   dict(act_bits=8)],
                         ids=['moe', 'w8a8'])
def test_engine_greedy_tokens_vs_jax(extra):
    """A MoE engine and a W8A8 engine (same seeded weights in both
    packages; more requests than slots, bursts of 4): every request
    finishes, and the greedy tokens are the JAX engine's; where one
    differs, the two candidates are a near-tie of the port's own plain
    forward (the serving slice's rule)."""
    jcfg, tcfg = _configs(**extra)
    jcfg.use_pallas_matmul = tcfg.use_kernel_matmul = None   # both off
    jp = jmodel.init_llama_params(jcfg, seed=0)
    tp = llama_params_from_numpy(_np_tree(jp), device='cpu')
    jeng = jengine.ServingEngine(jcfg, jp)
    teng = ServingEngine(tcfg, tp, device='cpu')
    assert teng.cfg.norm_folded is ('n_experts' not in extra)
    jreqs, treqs = _prompts(jengine.Request), _prompts(Request)
    jeng.run(jreqs, sync_every=4)
    teng.run(treqs, sync_every=4)
    compared = equal = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == 6
        for i, (a, b) in enumerate(zip(jr.generated, tr.generated)):
            compared += 1
            if a == b:
                equal += 1
                continue
            logits = _reference_logits(teng.cfg, teng.params,
                                       tr.prompt + tr.generated[:i])
            assert logits.max() - min(logits[a], logits[b]) \
                <= LOGIT_TOL * np.abs(logits).max()
            break
    assert equal >= 0.8 * compared
