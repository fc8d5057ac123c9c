"""Serving engine: quantized single-card inference with continuous batching.
The single-device part of the JAX package's `ppq_tpu/serving/engine.py`.

  * decode is a batched single-token forward over the int8 KV cache, which
    is updated in place; `sync_every > 1` decodes that many steps per host
    round-trip with the cache frozen (model.burst_forward). On a card the
    burst reads the frozen cache through the ragged paged-attention kernels,
    the grouped one at shallow or mixed fills and the per-slot one where
    every slot is deep (`_grouped_gate`).
  * prefill pads the prompt to bucket lengths; all max_batch slots run
    through one masked forward, so a wave of admits costs one prefill.
    Prompts longer than every bucket stream through in chunk-size pieces.
  * continuous batching: a slot-based scheduler admits requests into free
    batch slots between decode bursts and retires finished sequences
    eagerly.
  * paged_kv=True backs every sequence with kv_block_size-token blocks of
    one shared pool (serving/paged.py): a host-side allocator hands out
    pool rows, the card sees block tables; with prefix_cache_blocks > 0,
    requests that share a prompt prefix adopt its cached blocks and
    prefill only the tail.

Not ported yet (each raises NotImplementedError, see LlamaConfig.unported
and ROADMAP.md): meshes and every tp/pp/sp/dp branch, W8A8 prefill, MoE
layers, the planned (fully asynchronous) run loop, prewarming and the
serving benchmarks.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..executor.executor import resolve_device
from .config import LlamaConfig
from .model import (Params, burst_forward, forward, fuse_decode_params,
                    init_kv_cache)
from .paged import (BlockAllocator, PrefixCache, burst_forward_paged,
                    init_paged_pools, prefill_chunk_paged, prefill_paged)


# --------------------------------------------------------------- request ---
class Request:
    """One generation request. `sampling` overrides the engine-wide
    SamplingParams for THIS request's decode steps (per-slot vectorized
    sampling for mixed batches); the first token produced by the prefill
    stays greedy regardless (prefill computes one argmax for every admitted
    slot)."""

    def __init__(self, rid: int, prompt: List[int], max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 sampling: Optional['SamplingParams'] = None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.sampling = sampling
        self.generated: List[int] = []
        self.done = False
        # latency bookkeeping: host timestamps of submission, first
        # generated token (end of prefill), and completion
        self.t_submit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None


class SamplingParams:
    """Engine-wide sampling configuration (greedy when temperature == 0)."""

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


# ---------------------------------------------------------------- engine ---
class ServingEngine:
    def __init__(self, cfg: LlamaConfig, params: Params, mesh=None,
                 sampling: Optional[SamplingParams] = None, device=None):
        """Runs on the card; without one it raises unless `device='cpu'`.
        `params` are moved to the engine's device if they lie elsewhere."""
        if mesh is not None:
            raise NotImplementedError(
                'a device mesh (tp / pp / sp / dp serving: ROADMAP item 15)')
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = None
        self.sampling = sampling or SamplingParams()
        # resolve the kernel fast-path knobs (None = auto): on with a card
        on_card = self.device.type == 'cuda'
        if cfg.use_kernel_matmul is None:
            cfg.use_kernel_matmul = on_card
        if cfg.use_ragged_attention is None:
            cfg.use_ragged_attention = (
                on_card and cfg.head_dim % 128 == 0
                and cfg.max_seq_len % 128 == 0)
        missing = cfg.unported()
        if missing is not None:
            raise NotImplementedError(missing)
        if any('moe' in layer for layer in params['layers']):
            raise NotImplementedError(
                'MoE layers (serving/moe.py: ROADMAP items 11 and 14)')
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.sampling.seed)
        params = _to_device(params, self.device)
        # decode steps are launch-overhead-bound: fuse q|k|v and gate|up
        # projections into single matmuls (numerically identical:
        # column-wise dequant is independent per column)
        self.params = fuse_decode_params(params, cfg)
        self._paged = bool(cfg.paged_kv)
        self.prefix_cache = None
        if self._paged:
            # a block never needs to span more than max_seq_len
            blk = min(cfg.kv_block_size, cfg.max_seq_len)
            cfg.kv_block_size = blk
            if blk % 128 or cfg.max_seq_len % blk:
                raise ValueError('paged_kv needs kv_block_size % 128 == 0 '
                                 'and max_seq_len % kv_block_size == 0')
            # one card always takes the kernel path, as the JAX package does
            # on one device
            if cfg.head_dim % 128:
                raise ValueError('paged_kv kernel path needs head_dim % '
                                 '128 == 0')
            mb_per_seq = cfg.max_seq_len // blk
            n_blocks = cfg.kv_pool_blocks or (cfg.max_batch * mb_per_seq + 1)
            self._alloc = BlockAllocator(n_blocks, cfg.max_batch, mb_per_seq,
                                         block_size=blk)
        self.cache = self._new_cache()
        B = cfg.max_batch
        self.slot_len = np.zeros(B, np.int64)        # tokens in cache per slot
        self.slot_req: List[Optional[Request]] = [None] * B
        self._decode_burst: Dict[Any, Any] = {}
        self._decode = self._build_decode()
        self._prefill: Dict[Any, Any] = {}           # bucket -> function

    # --------------------------------------------------------------- state
    def _new_cache(self):
        """A fresh KV cache. Paged: fresh pools, a fresh allocator and an
        empty prefix cache (an index of the old allocator's blocks would
        hand out rows that are free in the new one)."""
        if not self._paged:
            return init_kv_cache(self.cfg, self.cfg.max_batch, self.device)
        old = self._alloc
        self._alloc = BlockAllocator(old.num_blocks, old.max_batch,
                                     old.max_blocks_per_seq,
                                     block_size=old.block_size)
        if self.cfg.prefix_cache_blocks:
            self.prefix_cache = PrefixCache(self._alloc, old.block_size,
                                            self.cfg.prefix_cache_blocks)
        return init_paged_pools(self.cfg, old.num_blocks, self.device)

    def _tensor(self, array, dtype=None):
        return torch.as_tensor(np.asarray(array), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------ programs
    def _forward(self, params, cache, tokens, positions, write_pos,
                 seq_lens, active=None):
        with torch.no_grad():
            return forward(params, cache, tokens, positions, write_pos,
                           seq_lens, self.cfg, active=active)

    @staticmethod
    def _topk_threshold(scaled, k_eff, iters=24):
        """Per-row threshold tau with {x : x > tau} = the top-k set (ties at
        the k-th value included, matching a sort-based threshold), found by
        COUNT-BISECTION: no (B, V) sort."""
        lo = torch.amin(scaled, dim=-1, keepdim=True)
        hi = torch.amax(scaled, dim=-1, keepdim=True)
        lo = lo - 1.0     # keep-everything is reachable (count(>lo) = V)
        k = k_eff[:, None]
        # invariant: count(> lo) >= k, count(> hi) < k  ->  v_k in (lo, hi]
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            cnt = torch.sum(scaled > mid, dim=-1, keepdim=True)
            at_least_k = cnt >= k
            lo = torch.where(at_least_k, mid, lo)
            hi = torch.where(at_least_k, hi, mid)
        # exact final pass: the k-th largest is the max value <= hi
        # (count(> hi) < k); threshold just below it keeps the top-k
        # including exact ties of v_k
        neg_inf = torch.full_like(scaled[:, :1], -torch.inf)
        kth = torch.amax(torch.where(scaled <= hi, scaled, neg_inf), dim=-1,
                         keepdim=True)
        tau = torch.nextafter(kth, neg_inf)
        # guard: when adjacent order statistics are closer than the
        # bisection resolution, the bracket can hold two distinct values and
        # `kth` resolves one too high, keeping k-1 tokens; verify the count
        # and fall back to the (ties-over-inclusive) lo side
        cnt = torch.sum(scaled > tau, dim=-1, keepdim=True)
        return torch.where(cnt >= k, tau, lo)

    @staticmethod
    def _topp_threshold(probs, p, iters=24):
        """Per-row tau with {i : probs_i > tau} = the nucleus (smallest
        prefix of descending probs with cumulative mass >= p), by MASS-
        BISECTION: M(tau) = sum probs*[probs > tau] is decreasing; the lo
        side of the bracket converges into [p_next, p_boundary), where the
        kept set is exactly the nucleus."""
        lo = torch.zeros((probs.shape[0], 1), dtype=probs.dtype,
                         device=probs.device)
        hi = torch.amax(probs, dim=-1, keepdim=True)
        pt = p[:, None]
        zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            mass = torch.sum(torch.where(probs > mid, probs, zero), dim=-1,
                             keepdim=True)
            enough = mass >= pt
            lo = torch.where(enough, mid, lo)
            hi = torch.where(enough, hi, mid)
        return lo

    def _draw(self, scaled):
        """One token per row from softmax(scaled), with the engine's
        generator (seeded from SamplingParams.seed)."""
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=self._generator)[:, 0] \
            .to(torch.int32)

    def _select(self, logits, samp=None):
        """Greedy or (top-k/top-p) temperature sampling over (B, vocab)
        logits. samp: optional per-slot tensors {'t': (B,) temperature,
        'k': (B,) top-k (0 = off), 'p': (B,) top-p}: vectorized per-request
        sampling for mixed batches; slots with t <= 0 stay exactly greedy.
        With samp=None the engine-wide SamplingParams apply. Both top-k and
        top-p use sort-free bisection thresholds."""
        if samp is not None:
            return self._select_vec(logits, samp)
        sp = self.sampling
        if sp.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        scaled = logits / sp.temperature
        if sp.top_k > 0:
            k_eff = torch.full((logits.shape[0],), sp.top_k,
                               dtype=torch.int32, device=logits.device)
            tau = self._topk_threshold(scaled, k_eff)
            scaled = scaled.masked_fill(scaled <= tau, -torch.inf)
        if sp.top_p < 1.0:
            probs = torch.softmax(scaled, dim=-1)
            tau = self._topp_threshold(probs, torch.full(
                (logits.shape[0],), sp.top_p, dtype=torch.float32,
                device=logits.device))
            scaled = scaled.masked_fill(probs <= tau, -torch.inf)
        return self._draw(scaled)

    def _select_vec(self, logits, samp):
        """Per-slot vectorized sampler (see _select)."""
        V = logits.shape[1]
        greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        t = samp['t'][:, None]
        scaled = logits / torch.clamp_min(t, 1e-6)
        # per-slot top-k: threshold just below the k-th largest
        # (k == 0 -> off, threshold below the minimum keeps everything)
        k_eff = torch.clamp(torch.where(samp['k'] > 0, samp['k'], V), 1, V)
        tau_k = self._topk_threshold(scaled, k_eff)
        scaled = scaled.masked_fill(scaled <= tau_k, -torch.inf)
        # per-slot nucleus over the top-k-masked logits
        probs = torch.softmax(scaled, dim=-1)
        tau_p = self._topp_threshold(probs, samp['p'])
        scaled = scaled.masked_fill(probs <= tau_p, -torch.inf)
        return torch.where(samp['t'] <= 0.0, greedy_tok, self._draw(scaled))

    def _samp_arrays(self):
        """Per-slot sampling tensors, or None when every active slot uses
        the engine-wide GREEDY default (keeps the no-threshold fast path)."""
        if self.sampling.greedy and \
                all(r is None or r.sampling is None for r in self.slot_req):
            return None
        B = self.cfg.max_batch
        sp = self.sampling
        t = np.full(B, sp.temperature, np.float32)
        k = np.full(B, sp.top_k, np.int32)
        p = np.full(B, sp.top_p, np.float32)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.sampling is not None:
                t[i] = r.sampling.temperature
                k[i] = r.sampling.top_k
                p[i] = r.sampling.top_p
        return {'t': self._tensor(t), 'k': self._tensor(k),
                'p': self._tensor(p)}

    def _build_decode(self):
        def decode_step(params, cache, tokens, seq_lens, samp=None):
            # tokens: (B,) current token per slot; seq_lens: (B,) cache fill
            positions = seq_lens[:, None]                    # (B, 1)
            logits, cache = self._forward(params, cache, tokens[:, None],
                                          positions, seq_lens, seq_lens + 1)
            return self._select(logits[:, -1, :], samp), cache
        return decode_step

    def _decode_bucket(self, s_need: int) -> Optional[int]:
        """Smallest frozen-read bucket covering s_need cache slots (decode
        reads the cache; reading all max_seq_len slots at short fills is
        pure waste). s_need is the deepest FILL only: the burst's own tokens
        live in the in-burst buffers, never in the frozen read window.
        Floor 32."""
        b = 32
        while b < min(s_need, self.cfg.max_seq_len):
            b *= 2
        return min(b, self.cfg.max_seq_len)

    def _grouped_gate(self, active_fills, n: int,
                      s_limit: Optional[int]) -> bool:
        """Host-side choice between the grouped and the per-slot attention
        kernel for a burst, the JAX package's rule: the per-slot (fused)
        kernel, one block per deep slot, once even the SHALLOWEST active
        slot is past 3/4 of the read bucket; the grouped kernel otherwise
        (shallow or mixed fills). The fill is compared with the bucket, not
        fill + n: the burst's own tokens never enter the frozen window."""
        if s_limit is None or not len(active_fills):
            return True
        return min(active_fills) < 0.75 * s_limit

    def _build_decode_burst(self, n_steps: int, s_limit: Optional[int] = None,
                            grouped: bool = True):
        """n decode steps with the cache frozen and one host round-trip per
        burst. grouped: the ragged read's kernel (see _grouped_gate)."""
        key = (n_steps, s_limit, grouped)
        if key in self._decode_burst:
            return self._decode_burst[key]
        cfg = self.cfg

        def decode_burst(params, cache, tokens, seq_lens, samp=None):
            with torch.no_grad():
                return burst_forward(
                    params, cache, tokens, seq_lens, n_steps, cfg,
                    lambda logits, step: self._select(logits, samp),
                    s_limit=s_limit, ragged=bool(cfg.use_ragged_attention),
                    prefer_grouped=grouped, chunk=cfg.burst_chunk)
        self._decode_burst[key] = decode_burst
        return decode_burst

    def _prefill_fn(self, bucket: int):
        """Batched masked prefill: all max_batch slots run through one
        forward; inactive slots are masked out of the cache write, so a
        wave of admits costs one prefill instead of one per request."""
        if bucket in self._prefill:
            return self._prefill[bucket]
        B = self.cfg.max_batch

        def prefill(params, cache, tokens, lengths, active):
            # tokens: (B, bucket); lengths: (B,); active: (B,) bool. The
            # cache updates in place at slot offset 0 for active slots
            positions = torch.arange(bucket, dtype=torch.int32,
                                     device=self.device)[None, :].expand(B, bucket)
            write_pos = torch.zeros((B,), dtype=torch.int32,
                                    device=self.device)
            logits, cache = self._forward(
                params, cache, tokens, positions, write_pos,
                torch.full((B,), bucket, dtype=torch.int32,
                           device=self.device), active=active)
            last = torch.gather(
                torch.argmax(logits, dim=-1),
                1, torch.clamp_min(lengths.long() - 1, 0)[:, None])[:, 0]
            return last.to(torch.int32), cache
        self._prefill[bucket] = prefill
        return prefill

    def _prefill_chunk_fn(self, chunk: int):
        """Continuation prefill: write `chunk` prompt tokens at an arbitrary
        cache offset, attending over everything already in the cache:
        prompts longer than any bucket stream through in chunk-size
        pieces."""
        key = ('chunk', chunk)
        if key in self._prefill:
            return self._prefill[key]

        def prefill_chunk(params, cache, tokens, write_pos, active):
            positions = write_pos[:, None] + torch.arange(
                chunk, dtype=torch.int32, device=self.device)
            logits, cache = self._forward(params, cache, tokens, positions,
                                          write_pos, write_pos + chunk,
                                          active=active)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        self._prefill[key] = prefill_chunk
        return prefill_chunk

    def _prefill_paged_fn(self, bucket: int):
        """Paged batched prefill: writes the prompt windows into pool
        blocks through the slots' block tables (serving/paged.py)."""
        key = ('paged', bucket)
        if key in self._prefill:
            return self._prefill[key]

        def prefill(params, pools, tokens, lengths, tables, active):
            with torch.no_grad():
                logits, pools = prefill_paged(params, pools, tokens, lengths,
                                              tables, active, self.cfg)
            last = torch.gather(
                torch.argmax(logits, dim=-1),
                1, torch.clamp_min(lengths.long() - 1, 0)[:, None])[:, 0]
            return last.to(torch.int32), pools
        self._prefill[key] = prefill
        return prefill

    def _prefill_chunk_paged_fn(self, chunk: int, prefix_blocks: int):
        key = ('pagedchunk', chunk, prefix_blocks)
        if key in self._prefill:
            return self._prefill[key]

        def prefill_chunk(params, pools, tokens, write_pos, tables, active):
            with torch.no_grad():
                logits, pools = prefill_chunk_paged(
                    params, pools, tokens, write_pos, tables, active,
                    prefix_blocks, self.cfg)
            return torch.argmax(logits, dim=-1).to(torch.int32), pools
        self._prefill[key] = prefill_chunk
        return prefill_chunk

    def _chunk_prefill_paged(self, req: Request, slot: int, offsets):
        """Stream req.prompt's windows at `offsets` through the pool: one
        chunked paged prefill each, the gathered prefix bucketed to powers
        of two of blocks. Only the slot's own row runs: a row's result
        depends on its own tokens and blocks alone, and the JAX package's
        other max_batch - 1 rows (one compiled program for every slot) are
        masked out of the write. A last window whose padding passes the
        table's end sees trash columns there (its padding is never read).
        Returns the last window's tokens, (1, chunk) on the card."""
        blk = self._alloc.block_size
        chunk = self.cfg.prefill_buckets[-1]
        table = self._alloc.tables()[slot:slot + 1]
        past = -(-(offsets[-1] + chunk) // blk) - table.shape[1]
        tables = self._tensor(np.pad(table, ((0, 0), (0, max(past, 0)))))
        active = self._tensor(np.ones(1, bool))
        last = None
        for off in offsets:
            pb = 1
            while pb < max(1, -(-off // blk)):
                pb *= 2
            fn = self._prefill_chunk_paged_fn(chunk,
                                              min(pb, table.shape[1]))
            toks = np.zeros((1, chunk), np.int32)
            window = req.prompt[off: off + chunk]
            toks[0, :len(window)] = window
            last, self.cache = fn(self.params, self.cache, self._tensor(toks),
                                  self._tensor(np.array([off], np.int32)),
                                  tables, active)
        self.slot_req[slot] = req
        self.slot_len[slot] = len(req.prompt)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt,
                                     self._alloc.slot_block_ids(slot),
                                     slot=slot)
        return last

    def _admit_long_paged(self, req: Request, slot: int):
        """Chunked paged prefill of an over-bucket prompt (the final window
        overlaps backward, so no padding lands in the pool). Returns the
        first generated token as a DEVICE scalar."""
        chunk = self.cfg.prefill_buckets[-1]
        n = len(req.prompt)
        if n >= self.cfg.max_seq_len:
            raise ValueError(f'prompt length {n} exceeds max_seq_len '
                             f'{self.cfg.max_seq_len}')
        self._alloc.ensure(slot, n)
        offsets = list(range(0, n - chunk, chunk)) + [n - chunk]
        last = self._chunk_prefill_paged(req, slot, offsets)
        return last[0, n - 1 - offsets[-1]]

    def _admit_prefix_shared(self, req: Request, slot: int,
                             shared: List[int]):
        """Admit a request whose prompt prefix is in the pool (a prefix-
        cache hit): adopt the cached blocks and prefill only the tail, in
        fixed-width windows from the first uncached block (the last
        window's padding past the prompt lands where decode overwrites it
        before reading). Returns the first generated token as a DEVICE
        scalar."""
        chunk = self.cfg.prefill_buckets[-1]
        n = len(req.prompt)
        base = len(shared) * self._alloc.block_size
        self._alloc.adopt(slot, shared)
        self._alloc.ensure(slot, n)
        offsets = list(range(base, n, chunk))
        last = self._chunk_prefill_paged(req, slot, offsets)
        return last[0, n - 1 - offsets[-1]]

    def _build_decode_burst_paged(self, n_steps: int,
                                  read_limit: Optional[int] = None):
        key = ('paged', n_steps, read_limit)
        if key in self._decode_burst:
            return self._decode_burst[key]
        cfg = self.cfg

        def decode_burst(params, pools, tokens, seq_lens, tables, samp=None):
            with torch.no_grad():
                return burst_forward_paged(
                    params, pools, tokens, seq_lens, tables, n_steps, cfg,
                    lambda logits, step: self._select(logits, samp),
                    chunk=cfg.burst_chunk, read_limit=read_limit)
        self._decode_burst[key] = decode_burst
        return decode_burst

    def _table_width(self, tokens: int) -> int:
        """The block tables' width for `tokens` positions: a power of two of
        blocks, at most the full table (fewer table columns, fewer blocks
        to walk)."""
        need = max(1, -(-tokens // self._alloc.block_size))
        mb = 1
        while mb < need:
            mb *= 2
        return min(mb, self._alloc.max_blocks_per_seq)

    def _paged_decode(self, n: int, cur_tok, seq_lens, active, samp=None):
        """One paged decode burst (n >= 1): grow each active slot's block
        list to cover the burst, ship the tables, run. The frozen read's
        bucket covers the fills only: the burst's own tokens live in its
        buffers."""
        for slot in active:
            self._alloc.ensure(slot, int(self.slot_len[slot]) + n)
        max_fill = int(max(self.slot_len[s] for s in active))
        mb = self._table_width(max_fill + n)
        fn = self._build_decode_burst_paged(
            n, read_limit=self._decode_bucket(max(max_fill, 1)))
        return fn(self.params, self.cache, cur_tok, seq_lens,
                  self._tensor(self._alloc.tables()[:, :mb]), samp)

    # ------------------------------------------------------------- serving
    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        # longer prompts stream through chunked prefill
        return -1

    def _admit_long(self, req: Request, slot: int):
        tok = self._admit_long_device(req, slot)
        req.generated.append(int(tok))

    def _admit_long_device(self, req: Request, slot: int):
        """Chunked prefill for prompts longer than every bucket: stream the
        prompt through the cache in chunk-size pieces (the final chunk
        overlaps backward so no padded garbage lands in the cache). Returns
        the first generated token as a DEVICE scalar (no host sync)."""
        B = self.cfg.max_batch
        chunk = self.cfg.prefill_buckets[-1]
        n = len(req.prompt)
        if n >= self.cfg.max_seq_len:
            raise ValueError(f'prompt length {n} exceeds max_seq_len '
                             f'{self.cfg.max_seq_len}')
        fn = self._prefill_chunk_fn(chunk)
        offsets = list(range(0, n - chunk, chunk)) + [n - chunk]
        active = np.zeros(B, bool)
        active[slot] = True
        last = None
        for off in offsets:
            toks = np.zeros((B, chunk), np.int32)
            toks[slot] = req.prompt[off: off + chunk]
            write_pos = np.zeros(B, np.int32)
            write_pos[slot] = off
            last, self.cache = fn(self.params, self.cache,
                                  self._tensor(toks), self._tensor(write_pos),
                                  self._tensor(active))
        self.slot_req[slot] = req
        self.slot_len[slot] = n
        return last[slot, n - 1 - offsets[-1]]

    def _admit_batch(self, admits):
        """admits: list of (slot, Request): one masked batched prefill.
        Paged with a prefix cache: hits take the shared-adopt path (the
        match runs before any of this wave is inserted), misses the batched
        admit."""
        B = self.cfg.max_batch
        if self.prefix_cache is not None:
            rest = []
            for slot, req in admits:
                shared = self.prefix_cache.match(req.prompt, slot=slot)
                if shared:
                    tok = self._admit_prefix_shared(req, slot, shared)
                    req.generated.append(int(tok))
                else:
                    rest.append((slot, req))
            if not rest:
                return
            admits = rest
        longest = max(len(r.prompt) for _, r in admits)
        if self._bucket_for(longest) == -1:
            # split: chunked path for over-bucket prompts, batched for rest
            long_admits = [(s, r) for s, r in admits
                           if self._bucket_for(len(r.prompt)) == -1]
            short_admits = [a for a in admits if a not in long_admits]
            for slot, req in long_admits:
                if self._paged:
                    req.generated.append(int(self._admit_long_paged(req, slot)))
                else:
                    self._admit_long(req, slot)
            if short_admits:
                self._admit_batch(short_admits)
            return
        bucket = self._bucket_for(longest)
        toks = np.zeros((B, bucket), np.int32)
        lengths = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        for slot, req in admits:
            toks[slot, :len(req.prompt)] = req.prompt
            lengths[slot] = len(req.prompt)
            active[slot] = True
            if self._paged:
                self._alloc.ensure(slot, len(req.prompt))
        if self._paged:
            last, self.cache = self._prefill_paged_fn(bucket)(
                self.params, self.cache, self._tensor(toks),
                self._tensor(lengths), self._tensor(self._alloc.tables()),
                self._tensor(active))
        else:
            last, self.cache = self._prefill_fn(bucket)(
                self.params, self.cache, self._tensor(toks),
                self._tensor(lengths), self._tensor(active))
        last = last.cpu().numpy()
        for slot, req in admits:
            self.slot_req[slot] = req
            self.slot_len[slot] = len(req.prompt)
            req.generated.append(int(last[slot]))
            if self.prefix_cache is not None:
                self.prefix_cache.insert(req.prompt,
                                         self._alloc.slot_block_ids(slot),
                                         slot=slot)

    def run(self, requests: List[Request], sync_every: int = 1,
            progress: bool = False,
            arrivals: Optional[List[float]] = None) -> List[Request]:
        """Continuous-batching generation loop until all requests finish.

        sync_every > 1 decodes that many steps per host round-trip (one
        burst with the cache frozen); eos-terminated requests are truncated
        after the burst. Exact for greedy decoding.

        arrivals (open-loop mode): per-request arrival offsets in seconds
        from loop start, sorted ascending with `requests`. A request is only
        admissible once the wall clock passes its offset; the loop keeps
        decoding active slots while future requests are pending and sleeps
        only when it would otherwise spin empty.

        This is the synchronous loop. The JAX package also has a planned
        loop for budget-only workloads, which dispatches everything without
        waiting; it makes the same scheduling decisions and is not ported
        yet.
        """
        waiting = list(requests)
        t_start = now = time.perf_counter()
        arr = None
        if arrivals is not None:
            if len(arrivals) != len(requests):
                raise ValueError(f'{len(arrivals)} arrivals for '
                                 f'{len(requests)} requests')
            arr = list(arrivals)
            if any(b < a for a, b in zip(arr, arr[1:])):
                raise ValueError('arrivals must be sorted ascending '
                                 '(requests admit in list order)')
            for r, a in zip(waiting, arr):
                r.t_submit = t_start + a
        else:
            for r in waiting:
                if r.t_submit is None:
                    r.t_submit = now      # closed-loop: all queued at t0
        cur_tok = np.zeros(self.cfg.max_batch, np.int32)
        while waiting or any(r is not None for r in self.slot_req):
            if arr is not None and waiting:
                due = time.perf_counter() - t_start
                if not any(r is not None for r in self.slot_req) and \
                        arr[0] > due:
                    time.sleep(arr[0] - due)      # idle: wait for arrival
            # admit a wave into all free slots with ONE batched prefill
            admits = []
            for slot in range(self.cfg.max_batch):
                if self.slot_req[slot] is None and waiting:
                    if arr is not None and arr[0] > \
                            time.perf_counter() - t_start:
                        break             # next request hasn't arrived
                    if arr is not None:
                        arr.pop(0)
                    admits.append((slot, waiting.pop(0)))
            if admits:
                self._admit_batch(admits)
                now = time.perf_counter()
                for slot, req in admits:
                    cur_tok[slot] = req.generated[-1]
                    req.t_first = now     # prefill emitted token 0
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                break

            # fixed burst length; per-slot overshoot past max_new_tokens is
            # dropped at retire below
            cache_room = int(self.cfg.max_seq_len - 1 -
                             max(self.slot_len[s] for s in active))
            # (max over active: the fullest slot bounds the burst)
            n = max(1, min(sync_every, cache_room,
                           self.cfg.max_decode_burst))

            seq_lens = self._tensor(self.slot_len, torch.int32)
            samp = self._samp_arrays()
            if self._paged:
                toks, self.cache = self._paged_decode(
                    n, self._tensor(cur_tok), seq_lens, active, samp)
                toks_np = toks.cpu().numpy()                  # (n, B)
            elif n == 1:
                next_tok, self.cache = self._decode(
                    self.params, self.cache, self._tensor(cur_tok), seq_lens,
                    samp)
                toks_np = next_tok.cpu().numpy()[None, :]     # (1, B)
            else:
                s_need = int(max(self.slot_len[s] for s in active))
                bucket = self._decode_bucket(s_need)
                fills = [int(self.slot_len[s]) for s in active]
                fn = self._build_decode_burst(
                    n, bucket, grouped=self._grouped_gate(fills, n, bucket))
                toks, self.cache = fn(self.params, self.cache,
                                      self._tensor(cur_tok), seq_lens, samp)
                toks_np = toks.cpu().numpy()                  # (n, B)

            for slot in active:
                req = self.slot_req[slot]
                new = [int(t) for t in toks_np[:, slot]]
                budget = req.max_new_tokens - len(req.generated)
                new = new[:max(budget, 0)] or new[:1]
                if req.eos_id is not None and req.eos_id in new:
                    new = new[:new.index(req.eos_id) + 1]
                req.generated.extend(new)
                self.slot_len[slot] += len(new)
                cur_tok[slot] = new[-1]
                limit_hit = len(req.generated) >= req.max_new_tokens
                eos_hit = req.eos_id is not None and \
                    req.generated[-1] == req.eos_id
                cache_full = self.slot_len[slot] >= self.cfg.max_seq_len - 1
                if limit_hit or eos_hit or cache_full:
                    req.done = True
                    req.t_done = time.perf_counter()
                    self.slot_req[slot] = None
                    self.slot_len[slot] = 0
                    if self._paged:
                        self._alloc.release(slot)
        return requests

    def benchmark_decode(self, batch: Optional[int] = None, steps: int = 50,
                         warmup: int = 5, burst: Optional[int] = 32,
                         repeats: int = 3, fill: int = 16) -> Dict[str, float]:
        """Steady-state decode throughput (tokens/sec) at full batch.

        Measures the BURST path (the production decode mode), takes the best
        of `repeats` timed regions, and ends every timed region with a host
        fetch of the generated tokens.

        `fill` sets every slot's pre-existing cache occupancy: 16 is the
        near-empty flattering case; pass e.g. max_seq_len//2 for a
        mid-generation steady state that pays real KV read traffic.
        """
        B = self.cfg.max_batch
        cache = self._new_cache()
        tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        seq_lens = torch.full((B,), fill, dtype=torch.int32,
                              device=self.device)
        if self._paged or (burst and burst > 1):
            n = burst if burst and burst > 1 else 1
            bucket = self._decode_bucket(max(fill, 1))
            if self._paged:
                # every slot's blocks through fill + n, the tables bucketed
                # as the run loop buckets them (_paged_decode)
                for slot in range(B):
                    self._alloc.ensure(slot, fill + n)
                tables = self._tensor(
                    self._alloc.tables()[:, :self._table_width(fill + n)])
                paged = self._build_decode_burst_paged(n, read_limit=bucket)

                def burst_fn(cache):
                    return paged(self.params, cache, tokens, seq_lens, tables)
            else:
                dense = self._build_decode_burst(
                    n, bucket, grouped=self._grouped_gate([fill] * B, n,
                                                          bucket))

                def burst_fn(cache):
                    return dense(self.params, cache, tokens, seq_lens)
            n_bursts = max(1, steps // n)
            toks, cache = burst_fn(cache)
            toks.cpu()                            # warm + full sync
            best = float('inf')
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(n_bursts):
                    toks, cache = burst_fn(cache)
                toks.cpu()
                best = min(best, time.perf_counter() - t0)
            dt = best
            n_steps = n_bursts * n
        else:
            for _ in range(warmup):
                tok, cache = self._decode(self.params, cache, tokens,
                                          seq_lens)
            tok.cpu()
            t0 = time.perf_counter()
            for _ in range(steps):
                tok, cache = self._decode(self.params, cache, tokens,
                                          seq_lens)
            tok.cpu()
            dt = time.perf_counter() - t0
            n_steps = steps
        return {'tokens_per_sec': B * n_steps / dt,
                'ms_per_step': dt / n_steps * 1e3,
                'batch': B}


def _to_device(tree, device):
    """A copy of a parameter tree with every tensor on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
