"""Speculative decoding (greedy): the JAX package's
`ppq_tpu/serving/speculative.py`. A small draft model proposes k tokens,
the target verifies them in ONE teacher-forced window, and the longest
target-agreeing prefix is accepted plus one token from the target's own
choice.

Greedy acceptance is exact: the emitted sequence is what the target
decoding alone would produce, so speculation trades target calls for
draft calls. Each model decodes batch 1 over one dense KV cache through
`model.forward` windows; the cache writes are position-addressed, so a
rejection only moves the fill pointer back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import LlamaConfig
from .model import Params, forward, init_kv_cache


class _Decoder:
    """One model's windows over a dense batch-1 cache on the device of its
    parameters, with `batch_invariant` on: a window's rows are the logits
    of the same tokens run one by one, bit for bit, which the exactness of
    greedy acceptance rests on (the JAX package's products are per-row
    on its matrix unit; cuBLAS tiles a product by its row count, and a
    near-tie then decides another token). A configuration whose
    `use_kernel_matmul` is None takes the matmul kernels on a card, as the
    engine resolves it."""

    def __init__(self, params: Params, cfg: LlamaConfig):
        self.device = params['embed'].device
        kern = cfg.use_kernel_matmul
        if kern is None:
            kern = self.device.type == 'cuda'
        cfg = dataclasses.replace(cfg, use_kernel_matmul=kern,
                                  batch_invariant=True)
        self.params, self.cfg = params, cfg
        self.cache = init_kv_cache(cfg, 1, device=self.device)
        self.seq_len = 0

    def run(self, tokens) -> np.ndarray:
        """Teacher-force `tokens` (ids) at the current position; returns the
        greedy argmax per position ((T,) int32) and advances."""
        t = torch.as_tensor(np.asarray(tokens, np.int32)[None],
                            device=self.device)
        T = t.shape[1]
        start = self.seq_len
        pos = (start + torch.arange(T, dtype=torch.int32,
                                    device=self.device))[None]
        fill = torch.tensor([start], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            logits, self.cache = forward(self.params, self.cache, t, pos,
                                         fill, fill + T, self.cfg)
        self.seq_len += T
        return torch.argmax(logits[0], dim=-1).to(torch.int32).cpu().numpy()

    def rewind(self, n_keep: int):
        """Drop everything past position n_keep (the writes are position
        addressed: only the fill pointer moves)."""
        assert 0 <= n_keep <= self.seq_len
        self.seq_len = n_keep


def speculative_generate(target_params: Params, target_cfg: LlamaConfig,
                         draft_params: Params, draft_cfg: LlamaConfig,
                         prompt: List[int], max_new_tokens: int,
                         k: int = 4, eos_id: Optional[int] = None
                         ) -> Tuple[List[int], dict]:
    """Greedy speculative decoding of one sequence.

    Returns (generated tokens, stats) where stats carries the acceptance
    telemetry ({'proposed', 'accepted', 'target_calls'}). The output is
    the target's greedy continuation of `prompt`.
    """
    assert target_cfg.vocab_size == draft_cfg.vocab_size
    tgt = _Decoder(target_params, target_cfg)
    drf = _Decoder(draft_params, draft_cfg)

    # prefill both; the last position's argmax is the first new token
    first = int(tgt.run(prompt)[-1])
    drf.run(prompt)
    out = [first]
    stats = {'proposed': 0, 'accepted': 0, 'target_calls': 1}

    # Loop invariant at the top: both caches hold exactly prompt +
    # out[:-1] (the last emitted token is fed by whoever runs next). C
    # denotes that common fill.
    while len(out) < max_new_tokens and \
            (eos_id is None or out[-1] != eos_id):
        kk = min(k, max_new_tokens - len(out))
        C = tgt.seq_len
        assert drf.seq_len == C
        # the draft proposes kk tokens; its cache gains out[-1] +
        # proposal[:kk-1] (positions C .. C+kk-1)
        proposal = []
        cur = out[-1]
        for _ in range(kk):
            cur = int(drf.run([cur])[-1])
            proposal.append(cur)
        stats['proposed'] += kk

        # ONE target window over [out[-1]] + proposal: verify[i] is the
        # target's greedy token after prompt + out + proposal[:i]
        verify = tgt.run([out[-1]] + proposal)
        stats['target_calls'] += 1

        n_acc = 0
        while n_acc < kk and proposal[n_acc] == int(verify[n_acc]):
            n_acc += 1
        stats['accepted'] += n_acc
        # accepted tokens are the target's own choices; the next one (a
        # bonus on full acceptance, a correction on divergence) comes from
        # the target too
        emit = proposal[:n_acc] + [int(verify[n_acc])]
        if eos_id is not None and eos_id in emit:
            emit = emit[:emit.index(eos_id) + 1]
        out.extend(emit)

        # restore the invariant: the caches hold prompt + out[:-1], fill
        # C + len(emit)
        frontier = C + len(emit)
        tgt.rewind(frontier)
        if n_acc == kk and len(emit) == kk + 1:
            # the draft never saw its own last proposal in its cache
            drf.rewind(C + kk)
            drf.run([proposal[kk - 1]])
        else:
            drf.rewind(frontier)
    return out[:max_new_tokens], stats
