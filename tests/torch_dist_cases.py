"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel.py,
test_torch_ring_pipeline.py, test_torch_serving_tp.py), run on every rank
of a world that `ppq_tpu_torch.parallel.spawn` starts.

This module imports no JAX and nothing of the JAX package, so a spawned
rank never loads them (nor tests/conftest.py). Each body builds its mesh
(every rank of the world calls the mesh constructors), runs the port on its
shard on the CPU over gloo, and returns numpy arrays that the test holds
against the JAX package in its own process.
"""

import types

import numpy as np
import torch

from ppq_tpu_torch.parallel import (broadcast_from_host0, host_local_array,
                                    initialize_multihost, local_batch_size,
                                    make_hybrid_mesh, make_mesh,
                                    slice_topology, sync_global_devices)
from ppq_tpu_torch.parallel import multihost


def _cpu_executor():
    return types.SimpleNamespace(device=torch.device('cpu'))


# ------------------------------------------------------------ the runtime --
def dp_over_dcn():
    """tests/_mp_worker.py's flow on a world of two nodes: a dp x tp
    hybrid mesh whose dp axis spans the nodes, each rank's rows of its dp
    coordinate, a global sum, a dp-summed gradient, rank 0's value
    everywhere, a barrier."""
    assert initialize_multihost() is True        # joined already: True
    mesh = make_hybrid_mesh([('dp', 2), ('tp', 2)])
    assert mesh.shape == {'dp': 2, 'tp': 2}
    assert local_batch_size(8, mesh) == 4
    dp = mesh.index('dp')
    x = host_local_array(np.full((4, 16), float(dp + 1), np.float32),
                         mesh, ('dp', None))
    total = multihost.all_reduce(x.sum().reshape(1), mesh.group('dp'))
    w = torch.ones(16, requires_grad=True)
    torch.mean((x @ w) ** 2).backward()
    grad = multihost.all_reduce(w.grad.clone(), mesh.group('dp')) / 2
    rank = multihost.global_rank()
    seed = broadcast_from_host0(1234 if rank == 0 else 999)
    sync_global_devices('test_ckpt')
    return dict(total=float(total[0]), grad=grad.numpy(), seed=seed,
                rank=rank, backend=multihost.world_backend(),
                transport=multihost.world_transport())


def parallel_world(grids, calib, train_args):
    """One world for tests/test_torch_parallel.py: the dp-over-DCN flow,
    hybrid meshes' rank grids (`grids`: lists of axes), the dp-2
    calibration of each method (`calib`: methods, batches) and the 2 x 2
    sharded step (`train`'s arguments after dp and tp)."""
    return dict(topology=slice_topology(), flow=dp_over_dcn(),
                grids=[make_hybrid_mesh(a).devices.tolist() for a in grids],
                calib=calibrate(*calib, 2),
                train=train(*train_args[:3], 2, 2, *train_args[3:]))


# --------------------------------------------------- ring and pipeline -----
def ring(n, q, k, v, causal):
    """Ring attention over an 'sp' mesh of the first n ranks: this rank's
    chunk of the output (None outside the mesh)."""
    from ppq_tpu_torch.serving.ring_attention import \
        sequence_parallel_attention
    from ppq_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(np.arange(n), ('sp',))
    if mesh.coords is None:
        return None
    i, T = mesh.index('sp'), q.shape[1] // n
    chunk = slice(i * T, (i + 1) * T)
    out = sequence_parallel_attention(
        torch.from_numpy(q[:, chunk]), torch.from_numpy(k[:, chunk]),
        torch.from_numpy(v[:, chunk]), mesh, causal=causal)
    return out.numpy()


def _gelu_block(lp, x):
    return torch.nn.functional.gelu(x @ lp['w'] + lp['b'], approximate='tanh')


def pipeline(stages, micro, layers, x):
    """pipeline_forward over a 'pp' mesh of the first `stages` ranks with
    the JAX test's gelu layers (None outside the mesh)."""
    from ppq_tpu_torch.parallel.mesh import Mesh
    from ppq_tpu_torch.serving.pipeline import (pipeline_forward,
                                                stack_layer_params)
    mesh = Mesh(np.arange(stages), ('pp',))
    if mesh.coords is None:
        return None
    stacked = stack_layer_params([{k: torch.from_numpy(v) for k, v in l.items()}
                                  for l in layers])
    return pipeline_forward(stacked, torch.from_numpy(x), _gelu_block, mesh,
                            microbatches=micro).numpy()


def ring_and_pipeline(ring_cases, pipe_cases):
    """Every ring case (n, q, k, v, causal), then every pipeline case
    (stages, microbatches, layers, x), on one world: this rank's results
    in order (None where it is outside the case's mesh)."""
    return ([ring(*c) for c in ring_cases],
            [pipeline(*c) for c in pipe_cases])


# ------------------------------------------------------------ calibration --
def prepare_tiny_cnn(method):
    """tests/test_parallel_calibration.py's graph in the port."""
    from ppq_tpu_torch import TargetPlatform, dispatch_graph
    from ppq_tpu_torch.ir import QuantableOperation, format_graph
    from ppq_tpu_torch.quantization.optim import ParameterQuantizePass
    from ppq_tpu_torch.quantization.quantizer import TPUInt8Quantizer
    from ppq_tpu_torch.zoo import tiny_cnn
    g = format_graph(tiny_cnn(input_shape=(8, 3, 16, 16)))
    dispatch_graph(g, TargetPlatform.TPU_INT8)
    q = TPUInt8Quantizer(g)
    for name, op in list(g.operations.items()):
        if op.platform == q.target_platform and \
                op.type in q.quant_operation_types:
            q.quantize_operation(name)
    ParameterQuantizePass().optimize(g)
    for op in g.operations.values():
        if isinstance(op, QuantableOperation):
            for var, cfg in op.config_pairs():
                if not var.is_parameter:
                    cfg.observer_algorithm = method
    return g


def activation_scales(g):
    from ppq_tpu_torch.core import QuantizationStates
    from ppq_tpu_torch.ir import QuantableOperation
    out = {}
    for op in g.operations.values():
        if not isinstance(op, QuantableOperation):
            continue
        for var, cfg in op.config_pairs():
            if var.is_parameter or not cfg.is_root:
                continue
            if cfg.state == QuantizationStates.ACTIVATED:
                out[var.name] = np.asarray(cfg.scale)
    return out


def calibrate(methods, loader, dp):
    """The compiled calibration of tiny_cnn over a dp mesh of the world's
    ranks, each method in turn: {method: scales}."""
    from ppq_tpu_torch.quantization.optim import CompiledCalibrationPass
    mesh = make_mesh(dp=dp, tp=1)
    if mesh.coords is None:
        return None
    out = {}
    for method in methods:
        g = prepare_tiny_cnn(method)
        CompiledCalibrationPass(calib_steps=len(loader), mesh=mesh).optimize(
            g, dataloader=loader, executor=_cpu_executor())
        out[method] = activation_scales(g)
    return out


# ------------------------------------------------------- sharded training --
def train(graph, x, target, dp, tp, steps, lr):
    """make_sharded_train_step on a dp x tp mesh: the losses, this rank's
    coordinates, its (sharded) parameters after the steps and its
    all-reduced gradients of the first step."""
    from ppq_tpu_torch.executor.compile import CompiledGraph
    from ppq_tpu_torch.parallel import make_sharded_train_step, shard_batch
    from ppq_tpu_torch.quantization.optim.training import \
        _unbaked_parameters
    mesh = make_mesh(dp=dp, tp=tp)
    with _unbaked_parameters(graph):
        cg = CompiledGraph(graph, device='cpu')
        step, state = make_sharded_train_step(cg, mesh, lr=lr)
        xs = shard_batch(mesh, x, 'cpu')
        ts = shard_batch(mesh, target, 'cpu')
        losses, grads = [], None
        for _ in range(steps):
            state, loss = step(state, xs, ts)
            losses.append(float(loss))
            if grads is None:
                grads = {k: v.grad.numpy().copy() for k, v in
                         state['trainable']['params'].items()}
        full = {k: v.detach().numpy() for k, v in step.full_params().items()}
    return dict(losses=losses, coords=mesh.coords, params=full, grads=grads,
                local={k: v.detach().numpy() for k, v in
                       state['trainable']['params'].items()},
                qparams={k: {kk: vv.detach().numpy() for kk, vv in v.items()}
                         for k, v in state['trainable']['qparams'].items()})


# ---------------------------------------------------------------- serving --
def _requests(n, vocab, seed, sampled=False):
    from ppq_tpu_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = 27 if i == 2 else int(rng.integers(3, 16))
        samp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=5) \
            if sampled and i % 2 else None
        out.append(Request(i, [int(t) for t in rng.integers(1, vocab, length)],
                           max_new_tokens=int(rng.integers(4, 11)),
                           sampling=samp))
    return out


def _probe_logits(engine, sequence):
    """The engine's logits for the token after `sequence` from one forward
    over a fresh single-slot cache of the engine's (rank's) shape."""
    from ppq_tpu_torch.serving import model as tmodel
    T = len(sequence)
    dev = engine.device
    cache = tmodel.init_kv_cache(engine.cfg, 1, dev)
    with torch.no_grad():
        logits, _ = tmodel.forward(
            engine.params, cache,
            torch.tensor([sequence], dtype=torch.int32, device=dev),
            torch.arange(T, dtype=torch.int32, device=dev)[None],
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), T, dtype=torch.int32, device=dev), engine.cfg)
    return logits[0, -1].cpu().numpy()


def serve(variants, n_requests=7, seed=21, device='cpu'):
    """Engines on meshes of this world, every variant in turn. A variant is
    (name, config fields, mesh axes, sampled, sync_every[, first rank]):
    its mesh is the ranks from its first rank (default 0) on, and ranks
    outside it skip it. Every mesh is built first (that is collective), so
    variants on disjoint ranks run at once. Returns {name: {'tokens',
    'logits', ...}} with the probe logits of the first request's prompt and
    the kernel launches of the run."""
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.parallel.mesh import Mesh
    from ppq_tpu_torch.serving import (LlamaConfig, SamplingParams,
                                       ServingEngine, init_llama_params)
    meshes = []
    for variant in variants:
        sizes = [s for _, s in variant[2]]
        first = variant[5] if len(variant) > 5 else 0
        meshes.append(Mesh(first + np.arange(int(np.prod(sizes)))
                           .reshape(sizes), [a for a, _ in variant[2]]))
    out = {}
    for variant, mesh in zip(variants, meshes):
        name, fields, axes, sampled, sync_every = variant[:5]
        if mesh.coords is None:
            continue
        cfg = LlamaConfig(**fields)
        params = init_llama_params(cfg, seed=0, device=device)
        eng = ServingEngine(cfg, params, mesh=mesh, device=device,
                            sampling=SamplingParams(seed=3))
        reqs = _requests(n_requests, cfg.vocab_size, seed, sampled)
        reset_launches()
        eng.run(reqs, sync_every=sync_every)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        out[name] = dict(
            tokens=[list(r.generated) for r in reqs],
            logits=_probe_logits(eng, reqs[0].prompt),
            heads=(eng.cfg.n_heads, eng.cfg.n_kv_heads),
            cache={k: tuple(v.shape) for k, v in eng.cache.items()},
            free=None if not eng._paged else eng._alloc.free_blocks,
            launches=launches, transport=multihost.world_transport(),
            backend=multihost.world_backend())
    return out


def moe_ffn_ep(n, params_np, x):
    """moe_ffn with the expert stacks over an 'ep' mesh of n ranks."""
    from ppq_tpu_torch.parallel.mesh import Mesh
    from ppq_tpu_torch.serving.moe import moe_ffn, shard_moe_params
    mesh = Mesh(np.arange(n), ('ep',))
    if mesh.coords is None:
        return None
    params = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else
                  torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in params_np.items()}
    local = shard_moe_params(params, mesh)
    return moe_ffn(torch.from_numpy(x), local, top_k=2).numpy()


def serving_world(variants, moe_args):
    """One world for tests/test_torch_serving_tp.py: every engine variant
    (`serve`), then moe_ffn over an 'ep' mesh (`moe_ffn_ep`)."""
    return dict(serve=serve(variants), moe=moe_ffn_ep(*moe_args))


def fails_on_rank_one():
    """A rank that raises: the world must come down."""
    if multihost.global_rank() == 1:
        raise RuntimeError('rank 1 fails on purpose')
    mesh = make_mesh(dp=2, tp=1)
    # rank 0 waits in a collective that rank 1 never joins
    multihost.all_reduce(torch.ones(1), mesh.group('dp'))
    return 'unreachable'
