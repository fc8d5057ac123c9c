"""The port's greedy speculative decoding (ppq_tpu_torch.serving
.speculative) against the JAX package's and against the target's own plain
greedy decoding, on the CPU, on tests/test_speculative.py's configurations
(vocab 97, d_model 64, 2 layers, INT8 weights; the draft a smaller model of
another seed, or the target itself). The emitted tokens and the acceptance
statistics must be equal exactly: greedy acceptance keeps the target's
continuation."""

import numpy as np
import pytest
import torch

from ppq_tpu.serving import config as jconfig
from ppq_tpu.serving import model as jmodel
from ppq_tpu.serving import speculative as jspec
from ppq_tpu_torch.interop import llama_params_from_numpy
from ppq_tpu_torch.serving import LlamaConfig
from ppq_tpu_torch.serving import speculative as tspec
from test_torch_serving import _np_tree

BASE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, max_batch=1, weight_bits=8)
DRAFT = dict(d_model=32, n_layers=1, d_ff=64, n_heads=2, n_kv_heads=2)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(seed, **kw):
    jcfg = jconfig.LlamaConfig(**dict(BASE, **kw))
    tcfg = LlamaConfig(**dict(BASE, **kw))
    jp = jmodel.init_llama_params(jcfg, seed=seed)
    return jcfg, jp, tcfg, llama_params_from_numpy(_np_tree(jp),
                                                   device='cpu')


def _plain_greedy(params, cfg, prompt, n):
    dec = tspec._Decoder(params, cfg)
    cur = int(dec.run(prompt)[-1])
    out = [cur]
    while len(out) < n:
        cur = int(dec.run([cur])[-1])
        out.append(cur)
    return out


@pytest.mark.parametrize('case', ['other_draft', 'same_draft', 'eos'])
def test_speculative_tokens_and_stats_vs_jax_and_plain_greedy(case):
    jt, jtp, tt, ttp = _model(0)
    if case == 'same_draft':
        jd, jdp, td, tdp = jt, jtp, tt, ttp
    else:
        jd, jdp, td, tdp = _model(99, **DRAFT)
    prompt, n, k = [5, 9, 3, 11, 2], 20, 4
    ref = _plain_greedy(ttp, tt, prompt, n)
    eos = ref[7] if case == 'eos' else None
    want = jspec.speculative_generate(jtp, jt, jdp, jd, prompt, n, k=k,
                                      eos_id=eos)
    got = tspec.speculative_generate(ttp, tt, tdp, td, prompt, n, k=k,
                                     eos_id=eos)
    assert got == want
    tokens, stats = got
    assert tokens == (ref[:ref.index(eos) + 1] if eos is not None else ref)
    assert sorted(stats) == ['accepted', 'proposed', 'target_calls']
    if case == 'same_draft':
        assert stats['accepted'] == stats['proposed'] > 0
    else:
        assert stats['accepted'] < stats['proposed']


def test_batch_invariant_window_equals_single_steps():
    """What greedy acceptance's exactness rests on: with batch_invariant
    (the decoders' setting) a window's logits are those of the same tokens
    run one by one, bit for bit; it moves the window's logits from the
    default float32 sums by float32 rounding only."""
    import dataclasses

    from ppq_tpu_torch.serving.model import forward, init_kv_cache
    _, _, tcfg, tp = _model(0)
    exact = dataclasses.replace(tcfg, batch_invariant=True)

    def run(cfg, cache, toks, start):
        T = len(toks)
        logits, _ = forward(tp, cache, torch.tensor([toks], dtype=torch.int32),
                            (start + torch.arange(T, dtype=torch.int32))[None],
                            torch.tensor([start], dtype=torch.int32),
                            torch.tensor([start + T], dtype=torch.int32), cfg)
        return logits[0]

    prompt, window = [5, 9, 3, 11, 2], [7, 1, 40, 6, 13]
    results = {}
    for name, cfg in (('exact', exact), ('default', tcfg)):
        cache = init_kv_cache(cfg, 1, 'cpu')
        run(cfg, cache, prompt, 0)
        steps = {k: v.clone() for k, v in cache.items()}
        whole = run(cfg, cache, window, len(prompt))
        single = torch.stack([run(cfg, steps, [t], len(prompt) + i)[0]
                              for i, t in enumerate(window)])
        results[name] = (whole, single)
    assert torch.equal(*results['exact'])
    np.testing.assert_allclose(results['exact'][0].numpy(),
                               results['default'][0].numpy(), rtol=0,
                               atol=1e-4 * results['default'][0].abs().max())
