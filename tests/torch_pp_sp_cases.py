"""Rank bodies of tests/test_torch_serving_pp_sp.py: the serving engine's
pipeline (pp) and sequence (sp) meshes, run on every rank of a world that
`ppq_tpu_torch.parallel.spawn` starts.

This module imports no JAX and nothing of the JAX package. Each body builds
its meshes (every rank of the world, in the same order: group creation is
collective), runs the port on its shard on the CPU over gloo, and returns
numpy arrays that the test holds against the JAX package in its own
process. A case runs on the ranks from its first rank on; ranks outside
its mesh return None for it, so cases on disjoint ranks run at once.
"""

import numpy as np
import torch

from ppq_tpu_torch.parallel import multihost
from ppq_tpu_torch.parallel.mesh import Mesh


def _mesh(axes, first=0):
    sizes = [s for _, s in axes]
    return Mesh(first + np.arange(int(np.prod(sizes))).reshape(sizes),
                [a for a, _ in axes])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ module cases --
def decode_sp(mesh, q, kv_pool, kv_scale, tables, seq_lens):
    """paged_decode_sp of every layer over this rank's block rows of the
    global pool: [(acc, m, l)] a layer."""
    from ppq_tpu_torch.serving.paged import (_shard_block_offset,
                                             paged_decode_sp)
    L, NB = kv_pool.shape[:2]
    nb = NB // (mesh.shape.get('sp', 1) * mesh.shape.get('dp', 1))
    off = _shard_block_offset(mesh, nb)

    def local(a):
        out = np.zeros((L, nb + 1) + a.shape[2:], a.dtype)
        out[:, 1:] = a[:, off:off + nb]
        return _t(out)
    kv, sc = local(kv_pool), local(kv_scale)
    return [tuple(t.numpy() for t in paged_decode_sp(
        _t(q), kv, sc, _t(tables), _t(seq_lens), li, mesh))
        for li in range(L)]


def _rank_model(fields, mesh, seed):
    from ppq_tpu_torch.serving import LlamaConfig, init_llama_params
    from ppq_tpu_torch.serving.tensor_parallel import shard_llama_params
    cfg = LlamaConfig(**fields)
    params = init_llama_params(cfg, seed=seed, device='cpu')
    local, rank_cfg = shard_llama_params(params, cfg, mesh)
    rank_cfg.use_kernel_matmul = cfg.use_kernel_matmul = False
    return cfg, local, rank_cfg


def staged_paged(mesh, fields, seed, toks0, toks1, tables, n_blocks):
    """The staged paged prefill of toks0 at position 0, then the staged
    chunk toks1 after it: (logits0, logits1, this rank's pools)."""
    from ppq_tpu_torch.serving.pipeline import (prefill_chunk_staged_paged,
                                                prefill_staged_paged)
    from ppq_tpu_torch.serving.tensor_parallel import rank_pools
    cfg, params, rank_cfg = _rank_model(fields, mesh, seed)
    B, T0 = toks0.shape
    pools = rank_pools(cfg, mesh, n_blocks, 'cpu')
    active = torch.ones(B, dtype=torch.bool)
    tables = _t(tables)
    with torch.no_grad():
        l0, pools = prefill_staged_paged(
            params, pools, _t(toks0), torch.full((B,), T0, dtype=torch.int32),
            tables, active, rank_cfg, mesh)
        l1, pools = prefill_chunk_staged_paged(
            params, pools, _t(toks1), torch.full((B,), T0, dtype=torch.int32),
            tables, active, 1, rank_cfg, mesh)
    return l0.numpy(), l1.numpy(), {k: v.numpy() for k, v in pools.items()}


def dense_steps(mesh, fields, seed, toks, steps):
    """A prefill of `toks` (B, T), then single steps feeding steps[i] (B,),
    through the dense cache: forward_staged on a 'pp' mesh, forward on a
    sequence-sharded cache on an 'sp' one. Returns every call's logits and
    this rank's cache."""
    from ppq_tpu_torch.serving.model import forward
    from ppq_tpu_torch.serving.pipeline import forward_staged
    from ppq_tpu_torch.serving.tensor_parallel import rank_cache
    cfg, params, rank_cfg = _rank_model(fields, mesh, seed)
    B, T = toks.shape
    cache = rank_cache(cfg, mesh, B, 'cpu')

    def call(tok, pos, wp, sl):
        if mesh.shape.get('pp', 1) > 1:
            return forward_staged(params, cache, tok, pos, wp, sl, rank_cfg,
                                  mesh)[0]
        return forward(params, cache, tok, pos, wp, sl, rank_cfg,
                       sp_mesh=mesh)[0]
    out = []
    with torch.no_grad():
        out.append(call(_t(toks), torch.arange(T, dtype=torch.int32)[None]
                        .expand(B, T), torch.zeros(B, dtype=torch.int32),
                        torch.full((B,), T, dtype=torch.int32)).numpy())
        seq = torch.full((B,), T, dtype=torch.int32)
        for cur in steps:
            out.append(call(_t(cur)[:, None], seq[:, None], seq,
                            seq + 1).numpy())
            seq = seq + 1
    return out, {k: v.numpy() for k, v in cache.items()}


# --------------------------------------------------------------- serving ----
def requests(vocab, seed=31):
    """The legs' requests: two long prompts that cross the 128-position
    boundary of a two-way sequence shard (the fifth repeats the first, a
    prefix-cache hit where its dp row holds it), three short ones; the
    second request retires first, so the fifth lands on slot 1."""
    from ppq_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    lengths, budgets = (150, 12, 9, 20, 150), (6, 3, 8, 10, 6)
    prompts = [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]
    prompts[4] = list(prompts[0])
    return [Request(i, p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def probe_logits(engine, sequence):
    """The engine's logits for the token after `sequence`: one forward over
    a fresh one-slot dense cache of the rank's shape (its stage's layers,
    its positions of a sequence-sharded cache), staged on a 'pp' mesh."""
    from ppq_tpu_torch.serving.model import forward
    from ppq_tpu_torch.serving.pipeline import forward_staged
    from ppq_tpu_torch.serving.tensor_parallel import rank_cache
    T = len(sequence)
    cache = rank_cache(engine._model_cfg, engine.mesh, 1, engine.device)
    args = (engine.params, cache, torch.tensor([sequence], dtype=torch.int32),
            torch.arange(T, dtype=torch.int32)[None],
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), T, dtype=torch.int32), engine.cfg)
    with torch.no_grad():
        if engine._pp:
            logits = forward_staged(*args, engine.mesh, microbatches=1)[0]
        else:
            logits = forward(*args, sp_mesh=engine._sp_mesh)[0]
    return logits[0, -1].numpy()


def _shards_of(tables, engine):
    """The number of pool shards each slot's blocks lie on."""
    from ppq_tpu_torch.serving.paged import block_shard
    shard = block_shard(engine.cache, engine.mesh)
    if shard is None:
        return [1] * tables.shape[0]
    return [len({int(b) // shard.size for b in row if b}) for row in tables]


def serve(mesh, name, fields, sync_every=4):
    """One leg: an engine on `mesh` runs `requests`. Returns its tokens, the
    probe logits of the first prompt, the rank's cache shapes and heads, the
    most pool shards one slot's blocks spanned, the prefix cache's hits and
    misses, the blocks left free and the kernel launches of the run."""
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.serving import (LlamaConfig, SamplingParams,
                                       ServingEngine, init_llama_params)
    cfg = LlamaConfig(**fields)
    eng = ServingEngine(cfg, init_llama_params(cfg, seed=0, device='cpu'),
                        mesh=mesh, device='cpu', sampling=SamplingParams(seed=3))
    reqs = requests(cfg.vocab_size)
    spans = [1]
    if eng._paged:
        real = eng._paged_decode

        def watch(n, *a, **k):
            spans.extend(_shards_of(eng._alloc.tables(), eng))
            return real(n, *a, **k)
        eng._paged_decode = watch
    reset_launches()
    eng.run(reqs, sync_every=sync_every)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    pc = eng.prefix_cache
    return dict(
        tokens=[list(r.generated) for r in reqs],
        logits=probe_logits(eng, reqs[0].prompt),
        cache={k: tuple(v.shape) for k, v in eng.cache.items()},
        heads=(eng.cfg.n_heads, eng.cfg.n_kv_heads, eng.cfg.n_layers),
        spans=max(spans), prefix=None if pc is None else (pc.hits, pc.misses),
        prefix_kind=None if pc is None else type(pc).__name__,
        free=eng._alloc.free_blocks if eng._paged else None,
        blocks=eng._alloc.num_blocks if eng._paged else None,
        launches=launches, coords=mesh.coords)


def world(module_cases, legs):
    """Every module case, then every serving leg, on one world. A case or a
    leg is (name, axes, first rank, arguments); its mesh is built first,
    with every other, in one order on every rank. Returns {name: result}
    of the cases and legs this rank took part in."""
    meshes = [_mesh(axes, first) for _, axes, first, _ in module_cases + legs]
    bodies = {'decode_sp': decode_sp, 'staged_paged': staged_paged,
              'dense_steps': dense_steps}
    out = {}
    for (name, _, _, args), mesh in zip(module_cases + legs, meshes):
        if mesh.coords is None:
            continue
        if name in dict((c[0], 1) for c in module_cases):
            out[name] = bodies[args[0]](mesh, *args[1:])
        else:
            out[name] = serve(mesh, name, *args)
    out['rank'] = multihost.global_rank()
    return out
