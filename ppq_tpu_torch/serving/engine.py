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
  * on a card every decode burst is a CUDA graph, the counterpart of the
    JAX package's jitted burst: the first call of a burst shape runs it
    uncaptured and captures it, later calls copy their tokens, fills,
    tables and sampling arrays into the graph's buffers and replay it
    (`_CapturedBurst`). A graph writes the cache at the addresses it was
    captured with, so where the JAX package builds a new cache on the same
    engine the port zeroes the cache in place (`_reset_cache`).
  * budget-only workloads (no eos) take the planned loop: every prefill
    and burst is dispatched without a host wait and the tokens come back
    in one download at the end (`_run_planned`). `prewarm_decode` captures
    the burst shapes a run will meet before it is timed;
    `benchmark_serving*` are the JAX package's serving benchmarks.

  * cfg.act_bits == 8 runs every prefill product W8A8 (serving/model.py
    `qmatmul`); MoE layers (serving/moe.py) run in prefill and in the
    captured bursts like every other layer.

  * on a mesh (`mesh=`, parallel.make_mesh / make_hybrid_mesh) every rank
    of it builds the engine on the same global parameters and runs the same
    requests: the rank keeps its tensor-parallel slices
    (serving/tensor_parallel.py: Megatron layout over 'tp', experts over
    'ep' or 'tp', the cache's kv heads over 'tp'; 'dp' replicates), the
    hand kernels run on its shard, and the all-reduced activations and
    gathered logits are the same bits on every rank, so every rank takes
    the same tokens (sampled ones too: one generator a rank, seeded
    alike). The bursts run uncaptured on a mesh: a gloo collective cannot
    be captured.
  * a 'pp' mesh: each rank holds its stage's layers and their cache slabs
    or pool rows; prefills, chunks and bursts run the staged functions of
    serving/pipeline.py (microbatches through the stages, the last stage's
    activations broadcast, the logits replicated). An 'sp' mesh shards the
    dense cache's sequence axis (reads merge their partial softmaxes over
    'sp') or the paged pools' block axis (dp x sp: a dp-grouped allocator
    and prefix cache, `GroupedBlockAllocator`); pp x sp shards a paged
    pool's layers and blocks. Reads are never bucketed on an 'sp' mesh: a
    bucket would slice a sharded axis. The JAX engine's refusals stand:
    pp + MoE, a paged pp x sp mesh with dp or tp axes, and a max_batch or
    n_layers that the axes do not divide.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..executor.executor import resolve_device
from ..kernels import qmm as _qmm
from ..kernels.loader import LAUNCHES, graph_capture
from .config import LlamaConfig
from .model import (Params, burst_forward, forward, fuse_decode_params,
                    init_kv_cache)
from .paged import (BlockAllocator, GroupedBlockAllocator, GroupedPrefixCache,
                    PrefixCache, burst_forward_paged, init_paged_pools,
                    prefill_chunk_paged, prefill_paged)
from .pipeline import (burst_forward_staged, burst_forward_staged_paged,
                       forward_staged, prefill_chunk_staged_paged,
                       prefill_staged_paged)
from .tensor_parallel import (mark_parallel, rank_cache, rank_pools,
                              shard_llama_params)


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


# --------------------------------------------------------- captured burst ---
def _addresses(cache: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in cache.values())


class _CapturedBurst:
    """One decode burst captured into a CUDA graph.

    `walk(inputs)` is the burst on a dict of input tensors (tokens, fills,
    tables, sampling arrays) over the engine's cache and parameters; it has
    already run once uncaptured on the caller's stream (which loads the
    kernels and sizes the workspaces, none of which a capture may do). The
    inputs are copied into static buffers allocated outside the graph's
    memory pool, then the walk is captured into the engine's pool, with the
    engine's generator registered so that every replay draws fresh
    uniforms from it. A call copies its inputs into the static buffers,
    replays, and returns a copy of the tokens (the static output lies in
    the shared pool, which the engine's other graphs reuse).

    The launches the capture recorded are not counted at capture (nothing
    ran); each replay adds `launches_per_replay` to `LAUNCHES`. The graph
    writes the cache at the addresses it was captured with
    (`cache_addresses`)."""

    def __init__(self, walk: Callable, inputs: Dict[str, torch.Tensor],
                 cache: Dict[str, torch.Tensor], generator: torch.Generator,
                 pool):
        self.cache_addresses = _addresses(cache)
        self.static_in = {k: v.detach().clone().contiguous()
                          for k, v in inputs.items()}
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        before = dict(LAUNCHES)
        with graph_capture(self.graph, pool=pool):
            self.static_out = walk(self.static_in)
        self.launches_per_replay = {k: LAUNCHES[k] - before[k]
                                    for k in LAUNCHES
                                    if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        for k, v in inputs.items():
            self.static_in[k].copy_(v)
        self.graph.replay()
        for k, v in self.launches_per_replay.items():
            LAUNCHES[k] += v
        return self.static_out.clone()


def _samp_inputs(samp) -> Dict[str, torch.Tensor]:
    return {} if samp is None else {'samp_' + k: v for k, v in samp.items()}


def _samp_of(inputs) -> Optional[Dict[str, torch.Tensor]]:
    samp = {k[5:]: v for k, v in inputs.items() if k.startswith('samp_')}
    return samp or None


# ---------------------------------------------------------------- engine ---
class ServingEngine:
    def __init__(self, cfg: LlamaConfig, params: Params, mesh=None,
                 sampling: Optional[SamplingParams] = None, device=None):
        """Runs on the card; without one it raises unless `device='cpu'`.
        `params` are moved to the engine's device if they lie elsewhere.
        mesh: every rank of it builds the engine with the same global
        `params` (its slices are taken here)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.sampling = sampling or SamplingParams()
        # resolve the kernel fast-path knobs (None = auto): on with a card
        on_card = self.device.type == 'cuda'
        if cfg.use_kernel_matmul is None:
            cfg.use_kernel_matmul = on_card
        if cfg.use_ragged_attention is None:
            cfg.use_ragged_attention = (
                on_card and cfg.head_dim % 128 == 0
                and cfg.max_seq_len % 128 == 0)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.sampling.seed)
        shape = {} if mesh is None else dict(mesh.shape)
        self._pp = shape.get('pp', 1) > 1
        # the mesh the sequence- or block-sharded paths take (None: no sp)
        self._sp_mesh = mesh if shape.get('sp', 1) > 1 else None
        # paged dp x sp: the batch's slots partition over dp rows, each
        # row's blocks on its own shards (one allocator group a row)
        self._paged_dp = 1
        self._model_cfg = cfg
        if mesh is not None:
            self._check_mesh(cfg, params, shape)
            if cfg.paged_kv and self._sp_mesh is not None and not self._pp:
                self._paged_dp = shape.get('dp', 1)
            # this rank's slices and heads, before the per-rank fusion
            params, cfg = shard_llama_params(params, cfg, mesh)
        self.cfg = cfg
        params = _to_device(params, self.device)
        lm_columns = next(iter(params['lm_head'].values())).shape[-1]
        # decode steps are launch-overhead-bound: fuse q|k|v and gate|up
        # projections into single matmuls (numerically identical:
        # column-wise dequant is independent per column); on a mesh each
        # rank fuses its own columns
        params = fuse_decode_params(params, cfg)
        self.params = params if mesh is None else \
            mark_parallel(params, mesh, lm_columns)
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
            self._model_cfg.kv_block_size = blk
            mb_per_seq = cfg.max_seq_len // blk
            n_blocks = cfg.kv_pool_blocks or (cfg.max_batch * mb_per_seq + 1)
            if self._sp_mesh is not None:
                # whole blocks a shard
                shards = shape['sp'] * self._paged_dp
                n_blocks = -(-n_blocks // shards) * shards
            self._alloc = self._make_alloc(n_blocks, cfg.max_batch,
                                           mb_per_seq, blk)
        self.cache = self._new_cache()
        B = cfg.max_batch
        self.slot_len = np.zeros(B, np.int64)        # tokens in cache per slot
        self.slot_req: List[Optional[Request]] = [None] * B
        self._decode_burst: Dict[Any, Any] = {}
        self._decode = self._build_decode()
        self._prefill: Dict[Any, Any] = {}           # bucket -> function
        # captured bursts (on a card): one CUDA graph a burst shape, all in
        # one memory pool (they never run at once); `_capture` False runs
        # every burst uncaptured (to measure or compare the two)
        self._capture = on_card and mesh is None
        self._graphs: Dict[Any, _CapturedBurst] = {}
        self._graph_pool = None
        self.graph_captures = 0

    @staticmethod
    def _check_mesh(cfg, params, shape):
        """The JAX engine's refusals of a mesh (`ppq_tpu/serving/engine.py`
        :178-190, :232-254)."""
        pp, sp = shape.get('pp', 1), shape.get('sp', 1)
        if pp > 1 and any('moe' in l for l in params['layers']):
            raise NotImplementedError(
                'pp + MoE is out of scope: expert all-reduces would '
                'serialize against the stage ring')
        if pp > 1 and cfg.max_batch % pp:
            raise ValueError(f'max_batch ({cfg.max_batch}) must divide by '
                             f'pp={pp} stages')
        if pp > 1 and cfg.n_layers % pp:
            raise ValueError(f'n_layers ({cfg.n_layers}) must divide by '
                             f'pp={pp} stages')
        if cfg.paged_kv and sp > 1:
            if pp > 1 and (shape.get('dp', 1) > 1 or shape.get('tp', 1) > 1):
                raise NotImplementedError(
                    'paged_kv + sp x pp composes only as a pure pp x sp mesh '
                    '(no dp / tp axes)')
            if pp == 1 and cfg.max_batch % shape.get('dp', 1):
                raise ValueError('paged_kv + dp needs max_batch % dp == 0')

    def _make_alloc(self, n_blocks, max_batch, mb_per_seq, blk):
        if self._paged_dp > 1:
            return GroupedBlockAllocator(n_blocks, max_batch, mb_per_seq,
                                         block_size=blk, groups=self._paged_dp)
        return BlockAllocator(n_blocks, max_batch, mb_per_seq,
                              block_size=blk)

    # --------------------------------------------------------------- state
    def _new_cache(self):
        """A fresh KV cache. Paged: fresh pools, a fresh allocator and an
        empty prefix cache (an index of the old allocator's blocks would
        hand out rows that are free in the new one). On a mesh the rank's
        slices of the global cache or pools (`tensor_parallel.rank_cache`,
        `rank_pools`)."""
        if not self._paged:
            if self.mesh is not None:
                return rank_cache(self._model_cfg, self.mesh,
                                  self.cfg.max_batch, self.device)
            return init_kv_cache(self.cfg, self.cfg.max_batch, self.device)
        self._new_allocator()
        if self.mesh is not None:
            return rank_pools(self._model_cfg, self.mesh,
                              self._alloc.num_blocks, self.device)
        return init_paged_pools(self.cfg, self._alloc.num_blocks, self.device)

    def _new_allocator(self):
        old = self._alloc
        self._alloc = self._make_alloc(old.num_blocks, old.max_batch,
                                       old.max_blocks_per_seq, old.block_size)
        if self.cfg.prefix_cache_blocks:
            # dp-grouped pools: one index a dp row, a cached chain adopted
            # only on its own row
            cache = GroupedPrefixCache if self._paged_dp > 1 else PrefixCache
            self.prefix_cache = cache(self._alloc, old.block_size,
                                      self.cfg.prefix_cache_blocks)

    def _reset_cache(self):
        """What `self.cache = self._new_cache()` does in the JAX package, in
        place: the cache's tensors zeroed (the values of a new cache), a
        paged engine's allocator and prefix cache new. The captured bursts
        keep writing where they were captured, and no second cache is held
        (recorded difference 42)."""
        if self.cache is None:
            self.cache = self._new_cache()
            return
        for t in self.cache.values():
            t.zero_()
        if self._paged:
            self._new_allocator()

    def _tensor(self, array, dtype=None):
        """A host array on the engine's device. On a card through pinned
        memory, without a host wait: the planned loop dispatches a whole run
        before it reads anything back."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type != 'cuda':
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _matmul_launches(self):
        """(M, D, F, gateup, int4) of every dequant-matmul a decode step
        launches (M = max_batch rows), for the graph workspace."""
        B = self.cfg.max_batch
        weights = [(name, wq) for layer in self.params['layers']
                   for name, wq in layer.items()]
        weights.append(('lm_head', self.params['lm_head']))
        out = []
        for name, wq in weights:
            if not isinstance(wq, dict):
                continue
            if 'w_int' in wq:
                D, F = wq['w_int'].shape
                int4 = False
            elif 'w_packed' in wq:
                D, F = 2 * wq['w_packed'].shape[0], wq['w_packed'].shape[1]
                int4 = True
            else:
                continue
            gateup = name == 'w_gateup'
            out.append((B, D, F // 2 if gateup else F, gateup, int4))
        return out

    def _burst(self, key, walk: Callable, inputs: Dict[str, torch.Tensor],
               cache) -> torch.Tensor:
        """Run one decode burst. On the card a replay of its captured graph:
        the first call with a key (or with another cache than the one the
        key was captured on) runs the walk uncaptured and captures it. On
        the CPU, or with `_capture` off, the walk. A capture that fails
        raises."""
        if self.device.type != 'cuda' or not self._capture:
            return walk(inputs)
        graph = self._graphs.get(key)
        if graph is not None and graph.cache_addresses == _addresses(cache):
            return graph(inputs)
        self._graphs.pop(key, None)
        toks = walk(inputs)
        _qmm.reserve_graph_workspace(self.device, self._matmul_launches())
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._graphs[key] = _CapturedBurst(walk, inputs, cache,
                                           self._generator, self._graph_pool)
        self.graph_captures += 1
        return toks

    # ------------------------------------------------------------ programs
    def _forward(self, params, cache, tokens, positions, write_pos,
                 seq_lens, active=None):
        """model.forward, or the pipeline-staged variant on a 'pp' mesh."""
        with torch.no_grad():
            if self._pp:
                return forward_staged(params, cache, tokens, positions,
                                      write_pos, seq_lens, self.cfg,
                                      self.mesh, active=active)
            return forward(params, cache, tokens, positions, write_pos,
                           seq_lens, self.cfg, active=active,
                           sp_mesh=self._sp_mesh)

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
        Floor 32. None (no bucketing, a full read) on an 'sp' mesh, where
        the cache's sequence axis or the pool's block axis is sharded and
        must not be sliced."""
        if self._sp_mesh is not None:
            return None
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
            def walk(inputs):
                args = (params, cache, inputs['tokens'], inputs['seq_lens'],
                        n_steps, cfg)
                sel = lambda logits, step: self._select(logits,
                                                        _samp_of(inputs))
                kw = dict(s_limit=s_limit,
                          ragged=bool(cfg.use_ragged_attention),
                          prefer_grouped=grouped, chunk=cfg.burst_chunk)
                with torch.no_grad():
                    if self._pp:
                        # each stage's slabs frozen, its own buffers
                        return burst_forward_staged(*args, self.mesh,
                                                    select_fn=sel, **kw)[0]
                    return burst_forward(*args, sel, sp_mesh=self._sp_mesh,
                                         **kw)[0]
            inputs = dict(tokens=tokens, seq_lens=seq_lens,
                          **_samp_inputs(samp))
            return self._burst(key + (samp is None,), walk, inputs,
                               cache), cache
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
                if self._pp:
                    logits, pools = prefill_staged_paged(
                        params, pools, tokens, lengths, tables, active,
                        self.cfg, self.mesh)
                else:
                    logits, pools = prefill_paged(
                        params, pools, tokens, lengths, tables, active,
                        self.cfg, sp_mesh=self._sp_mesh)
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
                if self._pp:
                    # one row (`_chunk_prefill_paged`): one microbatch
                    logits, pools = prefill_chunk_staged_paged(
                        params, pools, tokens, write_pos, tables, active,
                        prefix_blocks, self.cfg, self.mesh,
                        microbatches=1)
                else:
                    logits, pools = prefill_chunk_paged(
                        params, pools, tokens, write_pos, tables, active,
                        prefix_blocks, self.cfg, sp_mesh=self._sp_mesh)
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
            def walk(inputs):
                args = (params, pools, inputs['tokens'], inputs['seq_lens'],
                        inputs['tables'], n_steps, cfg)
                sel = lambda logits, step: self._select(logits,
                                                        _samp_of(inputs))
                kw = dict(chunk=cfg.burst_chunk, read_limit=read_limit)
                with torch.no_grad():
                    if self._pp:
                        return burst_forward_staged_paged(
                            *args, self.mesh, select_fn=sel, **kw)[0]
                    return burst_forward_paged(*args, sel,
                                               sp_mesh=self._sp_mesh, **kw)[0]
            inputs = dict(tokens=tokens, seq_lens=seq_lens, tables=tables,
                          **_samp_inputs(samp))
            return self._burst(key + (tables.shape[1], samp is None), walk,
                               inputs, pools), pools
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
        burst with the cache frozen, a replay of its CUDA graph on a card);
        eos-terminated requests are truncated after the burst. Exact for
        greedy decoding.

        When no request has an eos_id, retirement depends only on token
        BUDGETS, never on token VALUES: the whole schedule is known in
        advance, so every prefill and burst is dispatched without a host
        wait and the tokens download once, at the end (`_run_planned`).

        arrivals (open-loop mode): per-request arrival offsets in seconds
        from loop start, sorted ascending with `requests`. A request is only
        admissible once the wall clock passes its offset; the loop keeps
        decoding active slots while future requests are pending and sleeps
        only when it would otherwise spin empty.
        """
        if arrivals is None and requests and \
                all(r.eos_id is None for r in requests) and sync_every > 1:
            return self._run_planned(requests, sync_every)
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

    def _run_planned(self, requests: List[Request],
                     sync_every: int) -> List[Request]:
        """Fully-pipelined generation for budget-only workloads (no eos):
        identical scheduling decisions to the synchronous loop (retirement
        depends only on host-known budgets), but every prefill and burst is
        dispatched without waiting, and the generated tokens download once
        at the end: one copy into pinned memory, one wait."""
        downloads, host, done = self._dispatch_planned(requests, sync_every)
        if done is not None:
            done.synchronize()
        flat = host.numpy() if host is not None else None
        at = 0
        for kind, toks, what in downloads:
            arr = flat[at:at + toks.numel()].reshape(tuple(toks.shape))
            at += toks.numel()
            if kind == 'prefill':
                for slot, req in what:
                    req.generated.append(int(arr[slot]))
            elif kind == 'prefill_scalar':
                what.generated.append(int(arr))
            else:                                         # (n, B)
                for slot, req, take in what:
                    req.generated.extend(int(t) for t in arr[:take, slot])
        return requests

    def _dispatch_planned(self, requests: List[Request], sync_every: int):
        """The planned loop up to its download: every prefill and burst,
        then the copy of all their tokens into pinned host memory, with no
        host wait (nothing here reads the card). Returns the download
        entries (kind, tokens on the device, what they go to), the host
        buffer and the event that marks the copy done (None off the card,
        where the buffer is the tokens)."""
        cfg = self.cfg
        B = cfg.max_batch
        waiting = list(requests)
        cur_tok = torch.zeros((B,), dtype=torch.int32, device=self.device)
        downloads: List[Tuple] = []
        vcount: Dict[int, int] = {}           # id(req) -> tokens planned

        def put(cur, slot, tok):
            # a copy: cur may be the last burst's tokens, still to download
            cur = cur.clone()
            cur[slot] = tok
            return cur

        while waiting or any(r is not None for r in self.slot_req):
            admits = []
            for slot in range(B):
                if self.slot_req[slot] is None and waiting:
                    admits.append((slot, waiting.pop(0)))
            if admits and self._paged and self.prefix_cache is not None:
                # prefix-cache hits adopt cached blocks; tail-only prefill
                rest = []
                for slot, req in admits:
                    shared = self.prefix_cache.match(req.prompt, slot=slot)
                    if shared:
                        tok = self._admit_prefix_shared(req, slot, shared)
                        cur_tok = put(cur_tok, slot, tok)
                        vcount[id(req)] = 1
                        downloads.append(('prefill_scalar', tok, req))
                    else:
                        rest.append((slot, req))
                admits = rest
            if admits:
                long_admits = [(s, r) for s, r in admits
                               if self._bucket_for(len(r.prompt)) == -1]
                short_admits = [a for a in admits if a not in long_admits]
                for slot, req in long_admits:
                    tok = (self._admit_long_paged(req, slot) if self._paged
                           else self._admit_long_device(req, slot))
                    cur_tok = put(cur_tok, slot, tok)
                    vcount[id(req)] = 1
                    downloads.append(('prefill_scalar', tok, req))
                if short_admits:
                    bucket = self._bucket_for(
                        max(len(r.prompt) for _, r in short_admits))
                    toks = np.zeros((B, bucket), np.int32)
                    lengths = np.zeros(B, np.int32)
                    mask = np.zeros(B, bool)
                    for slot, req in short_admits:
                        toks[slot, :len(req.prompt)] = req.prompt
                        lengths[slot] = len(req.prompt)
                        mask[slot] = True
                        self.slot_req[slot] = req
                        self.slot_len[slot] = len(req.prompt)
                        vcount[id(req)] = 1
                    if self._paged:
                        for slot, req in short_admits:
                            self._alloc.ensure(slot, len(req.prompt))
                        last, self.cache = self._prefill_paged_fn(bucket)(
                            self.params, self.cache, self._tensor(toks),
                            self._tensor(lengths),
                            self._tensor(self._alloc.tables()),
                            self._tensor(mask))
                        if self.prefix_cache is not None:
                            for slot, req in short_admits:
                                self.prefix_cache.insert(
                                    req.prompt,
                                    self._alloc.slot_block_ids(slot),
                                    slot=slot)
                    else:
                        last, self.cache = self._prefill_fn(bucket)(
                            self.params, self.cache, self._tensor(toks),
                            self._tensor(lengths), self._tensor(mask))
                    cur_tok = torch.where(self._tensor(mask), last, cur_tok)
                    downloads.append(('prefill', last, list(short_admits)))
            active = [i for i, r in enumerate(self.slot_req)
                      if r is not None]
            if not active:
                break
            cache_room = int(self.cfg.max_seq_len - 1 -
                             max(self.slot_len[s] for s in active))
            n = max(1, min(sync_every, cache_room,
                           self.cfg.max_decode_burst))
            seq_lens = self._tensor(self.slot_len, torch.int32)
            samp = self._samp_arrays()
            if self._paged:
                toks, self.cache = self._paged_decode(n, cur_tok, seq_lens,
                                                      active, samp)
            elif n == 1:
                nxt, self.cache = self._decode(self.params, self.cache,
                                               cur_tok, seq_lens, samp)
                toks = nxt[None, :]
            else:
                s_need = int(max(self.slot_len[s] for s in active))
                bucket = self._decode_bucket(s_need)
                fills = [int(self.slot_len[s]) for s in active]
                fn = self._build_decode_burst(
                    n, bucket, grouped=self._grouped_gate(fills, n, bucket))
                toks, self.cache = fn(self.params, self.cache, cur_tok,
                                      seq_lens, samp)
            cur_tok = toks[-1]
            takes = []
            for slot in active:
                req = self.slot_req[slot]
                # virtual generated count: budget-only math, mirrors the
                # sync loop's new[:max(budget,0)] or new[:1]
                budget = req.max_new_tokens - vcount[id(req)]
                take = min(n, budget) if budget > 0 else 1
                takes.append((slot, req, take))
                self.slot_len[slot] += take
                vcount[id(req)] += take
                if (vcount[id(req)] >= req.max_new_tokens or
                        self.slot_len[slot] >= self.cfg.max_seq_len - 1):
                    req.done = True
                    self.slot_req[slot] = None
                    self.slot_len[slot] = 0
                    if self._paged:
                        self._alloc.release(slot)
            downloads.append(('burst', toks, takes))
        if not downloads:
            return downloads, None, None
        flat = torch.cat([toks.reshape(-1).to(torch.int32)
                          for _, toks, _ in downloads])
        if self.device.type != 'cuda':
            return downloads, flat, None
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return downloads, host, done

    # ---------------------------------------------------------------- bench
    def benchmark_serving(self, n_requests: int = 32, prompt_len: int = 64,
                          max_new_tokens: int = 32, sync_every: int = 8,
                          seed: int = 0) -> Dict[str, float]:
        """End-to-end continuous-batching throughput: a burst of requests
        streamed through run(), which includes prefill, scheduling, and
        decode."""
        rng = np.random.RandomState(seed)
        reqs = [Request(i, rng.randint(1, self.cfg.vocab_size,
                                       prompt_len).tolist(),
                        max_new_tokens=max_new_tokens)
                for i in range(n_requests)]
        # warm the captured paths (one admit + one decode)
        warm = [Request(-1, reqs[0].prompt,
                        max_new_tokens=max(2, sync_every))]
        self.run(warm, sync_every=sync_every)
        self._reset_cache()
        self.slot_len[:] = 0
        self.slot_req = [None] * self.cfg.max_batch

        t0 = time.perf_counter()
        self.run(reqs, sync_every=sync_every)
        dt = time.perf_counter() - t0
        gen_tokens = sum(len(r.generated) for r in reqs)
        prompt_tokens = n_requests * prompt_len
        return {
            'requests_per_sec': n_requests / dt,
            'generated_tokens_per_sec': gen_tokens / dt,
            'total_tokens_per_sec': (gen_tokens + prompt_tokens) / dt,
            'wall_s': dt,
        }

    def _mixed_requests(self, n_requests, mean_prompt, max_new_tokens,
                        eos_id, seed):
        # log-normal prompt lengths, eos termination, sampling on every
        # other request: the shared mixed / open-loop workload shape
        rng = np.random.RandomState(seed)
        bucket_cap = max(self.cfg.prefill_buckets) if \
            self.cfg.prefill_buckets else self.cfg.max_seq_len // 2
        lens = np.clip(
            rng.lognormal(np.log(mean_prompt), 0.6, n_requests).astype(int),
            4, min(bucket_cap, self.cfg.max_seq_len // 2))
        reqs = []
        for i, L in enumerate(lens):
            samp = SamplingParams(temperature=0.8, top_p=0.95, seed=i) \
                if i % 2 else None
            reqs.append(Request(
                i, rng.randint(3, self.cfg.vocab_size, int(L)).tolist(),
                max_new_tokens=max_new_tokens, eos_id=eos_id,
                sampling=samp))
        return reqs, lens

    def prewarm_decode(self, max_fill: int, sync_every: int,
                       with_sampling: bool = True):
        """Capture ahead of time the decode-burst variants a serving run
        will traverse. Fills grow through generation, so each new read
        bucket (and, on the dense engine, the grouped / per-slot kernel
        choice; on the paged engine, the table width) selects a new burst
        shape, whose first call runs uncaptured and captures it: inside a
        timed window that capture would dominate it. The fill ladder and
        the two sampling variants are the JAX package's (its compiles)."""
        cfg = self.cfg
        B = cfg.max_batch
        n = max(1, min(sync_every, cfg.max_decode_burst))
        if n <= 1:
            return
        cap = max(1, min(max_fill, cfg.max_seq_len - n - 2))
        fills = sorted({min(f, cap)
                        for f in (16, 48, 96, 192, 384, 768, cap)})
        tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        samps = [None]
        if with_sampling:
            # per-slot sampling arrays select another burst variant: a
            # mixed workload runs BOTH (all-greedy straggler waves select
            # samp=None)
            save = [self.slot_req[0]]
            self.slot_req[0] = Request(-3, [1], max_new_tokens=1,
                                       sampling=SamplingParams(
                                           temperature=0.8, top_p=0.95,
                                           seed=0))
            samps.append(self._samp_arrays())
            self.slot_req[0] = save[0]
        for fill in fills:
            seq = torch.full((B,), fill, dtype=torch.int32,
                             device=self.device)
            self.slot_len[:] = fill
            for samp in samps:
                if self._paged:
                    toks, self.cache = self._paged_decode(
                        n, tokens, seq, list(range(B)), samp=samp)
                else:
                    bucket = self._decode_bucket(fill)
                    fn = self._build_decode_burst(
                        n, bucket,
                        grouped=self._grouped_gate([fill] * B, n, bucket))
                    toks, self.cache = fn(self.params, self.cache, tokens,
                                          seq, samp)
        # drop the garbage the warm bursts wrote
        self.slot_len[:] = 0
        if self._paged:
            for slot in range(B):
                self._alloc.release(slot)
        self._reset_cache()

    def _warm_serving(self, reqs, sync_every, eos_id):
        """Capture every burst variant a measured serving run can hit, then
        reset the cache and slots. TWO separate warm waves: the per-slot
        sampling arrays select another burst variant, and a wave whose
        active slots are ALL greedy selects the samp=None one; both happen
        mid-run (greedy stragglers after sampled requests retire, and vice
        versa)."""
        p0 = reqs[0].prompt
        p1 = reqs[1].prompt if len(reqs) > 1 else p0
        self.run([Request(-1, p0, max_new_tokens=2,
                          eos_id=eos_id)], sync_every=sync_every)
        self.run([Request(-2, p1, max_new_tokens=2,
                          eos_id=eos_id,
                          sampling=SamplingParams(temperature=0.8,
                                                  top_p=0.95, seed=0))],
                 sync_every=sync_every)
        # decode-burst bucket ladder: every read bucket the measured run
        # can reach is captured HERE, not inside the timed window
        max_fill = max((len(r.prompt) + r.max_new_tokens for r in reqs),
                       default=64)
        self.prewarm_decode(max_fill, sync_every,
                            with_sampling=any(r.sampling is not None
                                              for r in reqs))
        self._reset_cache()
        self.slot_len[:] = 0
        self.slot_req = [None] * self.cfg.max_batch

    @staticmethod
    def _latency_percentiles(out, reqs):
        # TTFT = queue + prefill to first token; TPOT = completion span /
        # tokens after the first (burst-granular: tokens surface at host
        # syncs every sync_every steps)
        ttft = np.array([r.t_first - r.t_submit for r in reqs
                         if r.t_first is not None])
        tpot = np.array([(r.t_done - r.t_first) /
                         max(len(r.generated) - 1, 1) for r in reqs
                         if r.t_done is not None and r.t_first is not None])
        if len(ttft):
            out['ttft_p50_ms'] = float(np.percentile(ttft, 50) * 1e3)
            out['ttft_p99_ms'] = float(np.percentile(ttft, 99) * 1e3)
        if len(tpot):
            out['tpot_p50_ms'] = float(np.percentile(tpot, 50) * 1e3)
            out['tpot_p99_ms'] = float(np.percentile(tpot, 99) * 1e3)
        return out

    def benchmark_serving_mixed(self, n_requests: int = 128,
                                mean_prompt: int = 64,
                                max_new_tokens: int = 64,
                                sync_every: int = 16,
                                eos_id: int = 2,
                                seed: int = 0) -> Dict[str, float]:
        """Realistic mixed-workload throughput: log-normal prompt lengths,
        eos-terminating requests, and per-request sampling on half the
        batch. Retirement depends on token VALUES, so run() takes the
        synchronous per-wave loop. Publish this alongside the planned-path
        number from benchmark_serving(): the two bracket real deployments
        (the planned number is the no-eos best case)."""
        reqs, lens = self._mixed_requests(n_requests, mean_prompt,
                                          max_new_tokens, eos_id, seed)
        self._warm_serving(reqs, sync_every, eos_id)

        t0 = time.perf_counter()
        self.run(reqs, sync_every=sync_every)
        dt = time.perf_counter() - t0
        gen_tokens = sum(len(r.generated) for r in reqs)
        prompt_tokens = int(np.sum(lens))
        out = {
            'requests_per_sec': n_requests / dt,
            'generated_tokens_per_sec': gen_tokens / dt,
            'total_tokens_per_sec': (gen_tokens + prompt_tokens) / dt,
            'wall_s': dt,
        }
        return self._latency_percentiles(out, reqs)

    def benchmark_serving_open(self, rate_rps: float,
                               n_requests: int = 128,
                               mean_prompt: int = 64,
                               max_new_tokens: int = 64,
                               sync_every: int = 8,
                               eos_id: int = 2,
                               seed: int = 0) -> Dict[str, float]:
        """Open-loop latency-under-load: requests arrive by a Poisson
        process at `rate_rps` and the engine serves whatever is due. TTFT
        includes queueing from the scheduled ARRIVAL, so percentiles
        degrade as offered load approaches capacity; throughput alone
        saturates at min(rate, capacity)."""
        reqs, lens = self._mixed_requests(n_requests, mean_prompt,
                                          max_new_tokens, eos_id, seed)
        arrivals = np.cumsum(np.random.RandomState(seed + 1).exponential(
            1.0 / rate_rps, n_requests)).tolist()
        self._warm_serving(reqs, sync_every, eos_id)

        t0 = time.perf_counter()
        self.run(reqs, sync_every=sync_every, arrivals=arrivals)
        dt = time.perf_counter() - t0
        gen_tokens = sum(len(r.generated) for r in reqs)
        out = {
            'offered_rate_rps': rate_rps,
            'completed_rps': n_requests / dt,
            'generated_tokens_per_sec': gen_tokens / dt,
            'wall_s': dt,
        }
        return self._latency_percentiles(out, reqs)

    def benchmark_serving_open_sweep(self, rates, duration_s: float = 20.0,
                                     mean_prompt: int = 64,
                                     max_new_tokens: int = 96,
                                     sync_every: int = 32,
                                     eos_id: int = 2,
                                     seed: int = 0,
                                     warmup_frac: float = 0.15):
        """Steady-state open-loop latency-under-load across offered rates.

        Each rate point runs a Poisson arrival stream spanning >=
        duration_s, and the reported window EXCLUDES warm-up (the first
        warmup_frac of the stream) and drain (everything after the last
        scheduled arrival). A rate is *sustained* when completions inside
        the window keep pace with arrivals (>= 95%); `sustainable_rps` is
        the highest sustained offered rate. TTFT percentiles are taken over
        requests that ARRIVE inside the window (queueing included), TPOT
        over those that also complete in-run.
        """
        out = {'rate_points': [], 'sustainable_rps': 0.0,
               'duration_s': duration_s}
        for ri, rate in enumerate(rates):
            n = max(8, int(round(rate * duration_s)))
            reqs, _lens = self._mixed_requests(n, mean_prompt,
                                               max_new_tokens, eos_id,
                                               seed + ri)
            arrivals = np.cumsum(np.random.RandomState(
                seed + 17 + ri).exponential(1.0 / rate, n))
            self._warm_serving(reqs, sync_every, eos_id)
            t0 = time.perf_counter()
            self.run(reqs, sync_every=sync_every,
                     arrivals=arrivals.tolist())
            wall = time.perf_counter() - t0
            w0 = t0 + warmup_frac * float(arrivals[-1])
            w1 = t0 + float(arrivals[-1])      # last scheduled arrival
            win = max(w1 - w0, 1e-9)
            arrived = [r for r in reqs if w0 <= r.t_submit <= w1]
            done_in = [r for r in reqs
                       if r.t_done is not None and w0 <= r.t_done <= w1]
            gen_tok = sum(len(r.generated) for r in done_in)
            offered_w = len(arrived) / win
            completed_w = len(done_in) / win
            sustained = completed_w >= 0.95 * offered_w
            point = {
                'offered_rps': float(rate),
                'offered_in_window_rps': offered_w,
                'completed_in_window_rps': completed_w,
                'generated_tokens_per_sec': gen_tok / win,
                'wall_s': wall,
                'window_s': win,
                'n_requests': n,
                'sustained': bool(sustained),
            }
            out['rate_points'].append(
                self._latency_percentiles(point, arrived))
            if sustained:
                out['sustainable_rps'] = max(out['sustainable_rps'],
                                             float(rate))
        return out

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
        # the JAX package decodes into a new cache here; the port zeroes the
        # engine's own (its captured bursts write there): one cache, not two
        self._reset_cache()
        cache = self.cache
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
