"""The port's calibrated weight quantizers and checkpoint conversion
(ppq_tpu_torch.serving: `awq.py` AWQ and SmoothQuant, `gptq.py`,
`convert.py`) held against the JAX package on the CPU, on
tests/test_awq.py's tiny configuration (vocab 97, d_model 64, 2 layers)
with its outlier embedding channels.

Tolerances:
  * captured norm inputs (bf16 activations through two layers): 2e-2 of
    each capture's largest |value| (the serving slice's logit tolerance);
  * AWQ's chosen alpha: equal; its scales s and the folded gammas: rtol
    1e-5 (m's channel means sum in another order);
  * SmoothQuant's scales: rtol 1e-5;
  * codes: at most 0.5 % of an AWQ / SmoothQuant layer's codes and 2 % of
    a GPTQ layer's differ, each by one step (a value next to a rounding tie
    falls the other way when its scale moved by an ulp; GPTQ carries each
    row's error into the rows after it, so one flipped code moves later
    rows a little); the weight scales: rtol 1e-5;
  * converted parameters: bit for bit.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.serving import awq as jawq
from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import convert as jconvert
from ppq_tpu.serving import gptq as jgptq
from ppq_tpu.serving import model as jmodel
from ppq_tpu_torch.interop import llama_params_from_numpy
from ppq_tpu_torch.serving import LlamaConfig
from ppq_tpu_torch.serving import awq as tawq
from ppq_tpu_torch.serving import convert as tconvert
from ppq_tpu_torch.serving import gptq as tgptq
from ppq_tpu_torch.serving import model as tmodel
from test_torch_serving import _assert_trees_equal, _np_tree

TINY = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=64, max_batch=2, prefill_buckets=(16,))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(bits, **kw):
    return (jconfig.LlamaConfig(**TINY, weight_bits=bits, **kw),
            LlamaConfig(**TINY, weight_bits=bits, **kw))


@pytest.fixture(scope='module')
def floats():
    """test_awq.py's outlier float tree in both packages, and a calibration
    sample."""
    jcfg, _ = _cfgs(4)
    fp = jmodel.init_llama_params(jcfg, seed=0, quantized=False)
    emb = np.asarray(fp['embed'], np.float32)
    emb[:, [3, 17, 40]] *= 20.0
    fp = dict(fp, embed=jnp.asarray(emb, jnp.bfloat16))
    calib = np.random.RandomState(0).randint(1, 96, (4, 16)).astype(np.int32)
    return fp, llama_params_from_numpy(_np_tree(fp), device='cpu'), calib


def _codes(wq):
    if 'w_packed' in wq:
        return np.asarray(jmodel._unpack_int4(jnp.asarray(
            np.asarray(wq['w_packed']))), np.int32)
    return np.asarray(wq['w_int'], np.int32)


def _tcodes(wq):
    if 'w_packed' in wq:
        return tmodel._unpack_int4(wq['w_packed']).numpy().astype(np.int32)
    return wq['w_int'].numpy().astype(np.int32)


def _assert_codes_close(jtree, ttree, share):
    """Every quantized linear: scales rtol 1e-5, at most `share` of the
    codes differ, each by one step."""
    checked = 0
    for jl, tl in zip(jtree['layers'] + [jtree],
                      ttree['layers'] + [ttree]):
        for key in ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down',
                    'lm_head'):
            if key not in jl or not isinstance(jl[key], dict):
                continue
            a, b = _codes(jl[key]), _tcodes(tl[key])
            assert a.shape == b.shape, key
            assert np.abs(a - b).max() <= 1, key
            assert (a != b).mean() <= share, (key, (a != b).mean())
            np.testing.assert_allclose(tl[key]['scale'].numpy(),
                                       np.asarray(jl[key]['scale']),
                                       rtol=1e-5, err_msg=key)
            checked += 1
    assert checked == 2 * 7 + 1


def test_capture_norm_inputs_full_vs_jax(floats):
    jfp, tfp, calib = floats
    jcfg, tcfg = _cfgs(4)
    want = jawq.capture_norm_inputs(jfp, jcfg, calib, full=True)
    got = tawq.capture_norm_inputs(tfp, tcfg, calib, full=True)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w) == ['act', 'attn', 'ctx', 'mlp']
        for key in w:
            assert g[key].dtype == torch.float32
            assert tuple(g[key].shape) == w[key].shape
            np.testing.assert_allclose(g[key].numpy(), w[key], rtol=0,
                                       atol=2e-2 * np.abs(w[key]).max())


def test_awq_group_scale_and_codes_vs_jax(floats):
    jfp, tfp, calib = floats
    jcfg, tcfg = _cfgs(4)
    cap = jawq.capture_norm_inputs(jfp, jcfg, calib)[0]['attn']
    ws = [np.asarray(jfp['layers'][0][k]['w'], np.float32)
          for k in ('wq', 'wk', 'wv')]
    js, ja = jawq._group_scale(cap, ws, 4)
    ts, ta = tawq._group_scale(torch.from_numpy(cap),
                               [torch.from_numpy(w) for w in ws], 4)
    assert ta == ja and ja > 0
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)

    want = jawq.awq_quantize_llama_params(jfp, jcfg, calib)
    got = tawq.awq_quantize_llama_params(tfp, tcfg, calib)
    moved = 0
    for jl, tl in zip(want['layers'], got['layers']):
        for g in ('attn_norm', 'mlp_norm'):
            np.testing.assert_allclose(tl[g].numpy(), np.asarray(jl[g]),
                                       rtol=1e-5)
            moved += int(not np.allclose(np.asarray(jl[g]), 1.0))
    assert moved > 0
    _assert_codes_close(want, got, 0.005)


def test_smoothquant_scales_and_codes_vs_jax(floats):
    jfp, tfp, calib = floats
    jcfg, tcfg = _cfgs(8, act_bits=8)
    want = jawq.smoothquant_llama_params(jfp, jcfg, calib)
    got = tawq.smoothquant_llama_params(tfp, tcfg, calib)
    for jl, tl in zip(want['layers'], got['layers']):
        for g in ('attn_norm', 'mlp_norm'):
            np.testing.assert_allclose(tl[g].numpy(), np.asarray(jl[g]),
                                       rtol=1e-5)
    _assert_codes_close(want, got, 0.005)


def test_gptq_codes_vs_jax(floats):
    """GPTQ INT4 (packed split-half) over the whole tree and one INT8
    linear: the fixed mse scales equal, the codes within the share."""
    jfp, tfp, calib = floats
    jcfg, tcfg = _cfgs(4)
    want = jgptq.gptq_quantize_llama_params(jfp, jcfg, calib)
    got = tgptq.gptq_quantize_llama_params(tfp, tcfg, calib)
    assert 'w_packed' in got['layers'][0]['wq']
    _assert_codes_close(want, got, 0.02)
    rng = np.random.RandomState(0)
    xs = (rng.randn(256, 8) @ rng.randn(8, 64)).astype(np.float32)
    xs[:, 5] = 0.0                              # a dead input is pinned
    w = rng.randn(64, 48).astype(np.float32)
    a = jgptq.gptq_quantize_linear(w, xs, 8)
    b = tgptq.gptq_quantize_linear(torch.from_numpy(w),
                                   torch.from_numpy(xs), 8)
    np.testing.assert_array_equal(b['scale'].numpy(), np.asarray(a['scale']))
    ca, cb = _codes(a), _tcodes(b)
    assert np.abs(ca - cb).max() <= 1 and (ca != cb).mean() <= 0.02
    assert not cb[5].any()


def _hf_state_dict(tied=False):
    """A state dict with HF Llama's key names and (out, in) linears."""
    rng = np.random.default_rng(8)
    D, F, V, L = 64, 128, 97, 2
    sd = {'model.embed_tokens.weight': rng.standard_normal((V, D)),
          'model.norm.weight': 1 + 0.1 * rng.standard_normal(D)}
    for i in range(L):
        p = f'model.layers.{i}.'
        sd[p + 'input_layernorm.weight'] = 1 + 0.1 * rng.standard_normal(D)
        sd[p + 'post_attention_layernorm.weight'] = \
            1 + 0.1 * rng.standard_normal(D)
        for name, shape in (('self_attn.q_proj', (D, D)),
                            ('self_attn.k_proj', (32, D)),
                            ('self_attn.v_proj', (32, D)),
                            ('self_attn.o_proj', (D, D)),
                            ('mlp.gate_proj', (F, D)),
                            ('mlp.up_proj', (F, D)),
                            ('mlp.down_proj', (D, F))):
            sd[p + name + '.weight'] = rng.standard_normal(shape) * 0.1
    if not tied:
        sd['lm_head.weight'] = rng.standard_normal((V, D)) * 0.1
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


class _HFConfig:
    vocab_size, hidden_size, num_hidden_layers = 97, 64, 2
    num_attention_heads, num_key_value_heads = 4, 2
    intermediate_size, max_position_embeddings = 128, 64
    rope_theta, rms_norm_eps = 5e5, 1e-6


@pytest.mark.parametrize('quantize', [False, True])
@pytest.mark.parametrize('tied', [False, True])
def test_params_from_hf_state_dict_vs_jax(quantize, tied):
    sd = _hf_state_dict(tied)
    jcfg = jconvert.config_from_hf(_HFConfig)
    tcfg = tconvert.config_from_hf(_HFConfig)
    fields = ('vocab_size', 'd_model', 'n_layers', 'n_heads', 'n_kv_heads',
              'd_ff', 'max_seq_len', 'rope_theta', 'rms_eps')
    assert [getattr(jcfg, f) for f in fields] \
        == [getattr(tcfg, f) for f in fields]
    assert (tcfg.n_kv_heads, tcfg.rope_theta) == (2, 5e5)
    want = jconvert.params_from_hf_state_dict(sd, jcfg, quantize=quantize)
    got = tconvert.params_from_hf_state_dict(sd, tcfg, quantize=quantize,
                                             device='cpu')
    _assert_trees_equal(want, got)


def test_load_hf_llama_on_a_model_object_and_without_transformers(
        monkeypatch):
    class Model:
        config = _HFConfig

        @staticmethod
        def state_dict():
            return _hf_state_dict()

    cfg, params = tconvert.load_hf_llama(Model, device='cpu')
    assert cfg.d_model == 64 and 'w_int' in params['layers'][0]['wq']
    monkeypatch.setitem(sys.modules, 'transformers', None)
    with pytest.raises(ImportError, match='transformers'):
        tconvert.load_hf_llama('/nonexistent/checkpoint', device='cpu')
