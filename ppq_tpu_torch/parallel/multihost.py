"""Multi-rank runtime on torch.distributed: one process a rank.

The JAX package runs one process a host, each driving every device of its
host under one global mesh (`ppq_tpu/parallel/multihost.py`). Here every
rank is a process of its own with one device, and every collective is an
explicit call. Two link classes shape where a mesh axis may go, as in the
JAX package:

  ICI: the cards of one node (NVLink on an H100 node). Axes whose
       collectives move weight- or activation-sized tensors every step
       ('tp', 'sp', 'ep') stay inside a node.
  DCN: the network between nodes. 'dp' and 'pp' (one gradient reduction a
       step, microbatch transfers) may span nodes.

Backend and transport. NCCL is the backend where every rank of a node has a
card of its own. Where the ranks share fewer cards (one H100 for a world of
four) NCCL refuses two ranks on one device, so the collectives go over gloo
while the compute stays on the card; gloo takes CUDA tensors for only some
collectives, and `_transport` stages every collective of such a world
through host memory (recorded difference 54). A `device='cuda'` world with
no card raises; there is no CPU fallback.

`spawn` starts a one-machine world: `world` child processes that meet on a
FileStore (no TCP port is chosen), each running `fn(*args)`; it kills every
rank and raises when one fails or when `timeout` passes.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..executor.executor import resolve_device

# Axes that must stay inside a node (per-step, tensor-sized collectives).
ICI_AXES = ('tp', 'sp', 'ep')
# Axes that tolerate the network between nodes.
DCN_AXES = ('dp', 'pp')

# the world this process joined: its device and backend
_WORLD = {'device': None, 'backend': None}
# collectives run, by transport: 'direct' (the backend takes the tensor as
# it lies) or 'host' (a CUDA tensor staged through host memory for gloo),
# their host seconds (a staged call waits for the card) and bytes
TRANSPORT_COUNTS = {'direct': 0, 'host': 0}
TRANSPORT_SECONDS = {'direct': 0.0, 'host': 0.0}
TRANSPORT_BYTES = {'direct': 0, 'host': 0}


def reset_transport() -> None:
    for table in (TRANSPORT_COUNTS, TRANSPORT_SECONDS, TRANSPORT_BYTES):
        for k in table:
            table[k] = type(table[k])(0)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_device() -> torch.device:
    """The device of this rank's compute (the card unless the world was
    started with device='cpu')."""
    if _WORLD['device'] is None:
        return resolve_device(None)
    return _WORLD['device']


def world_backend() -> Optional[str]:
    return _WORLD['backend']


def world_transport() -> str:
    """'host' where a gloo world computes on a card (every collective is
    staged through host memory), else 'direct'."""
    dev = _WORLD['device']
    if _WORLD['backend'] == 'gloo' and dev is not None and \
            dev.type == 'cuda':
        return 'host'
    return 'direct'


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None, timeout: float = 600.0) -> bool:
    """Join the world of a multi-rank job. Call once per process, before
    any collective.

    Arguments default to the launcher's environment: RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT (a TCP rendezvous), or PPQ_TPU_STORE (the
    path of a FileStore, which `spawn` uses). LOCAL_WORLD_SIZE and
    LOCAL_RANK name the ranks of this node (default: the whole world on
    one node). Returns True when a multi-rank world was started and False
    for the single-process no-op, as the JAX package's does.

    device: the rank's compute device (the card unless 'cpu' is named; a
    'cuda' world with no card raises). NCCL where the node has a card for
    every local rank, each rank on its own; otherwise every rank on card 0
    (or the CPU) and gloo."""
    env = os.environ
    if num_processes is None and env.get('WORLD_SIZE'):
        num_processes = int(env['WORLD_SIZE'])
    if process_id is None and env.get('RANK'):
        process_id = int(env['RANK'])
    store_path = env.get('PPQ_TPU_STORE')
    if coordinator_address is None and env.get('MASTER_ADDR'):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes in (None, 1) and coordinator_address is None and \
            store_path is None:
        return False               # single process: nothing to initialize
    if dist.is_initialized():
        return True
    if num_processes is None or process_id is None:
        raise ValueError('a multi-rank world needs WORLD_SIZE and RANK')
    device = resolve_device(device)
    local_world = int(env.get('LOCAL_WORLD_SIZE', num_processes))
    local_rank = int(env.get('LOCAL_RANK', process_id % local_world))
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a device="cuda" world needs a CUDA card')
        if torch.cuda.device_count() >= local_world:
            backend = 'nccl'
            device = torch.device('cuda', local_rank)
        else:
            # the ranks share card 0: NCCL refuses two ranks on one device
            backend = 'gloo'
            device = torch.device('cuda', 0)
        torch.cuda.set_device(device)
    else:
        backend = 'gloo'
    wait = datetime.timedelta(seconds=timeout)
    if store_path is not None:
        store = dist.FileStore(store_path, num_processes)
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, timeout=wait)
    else:
        dist.init_process_group(backend,
                                init_method=f'tcp://{coordinator_address}',
                                rank=process_id, world_size=num_processes,
                                timeout=wait)
    _WORLD['device'] = device
    _WORLD['backend'] = backend
    return True


def slice_topology() -> Tuple[int, int]:
    """(nodes, ranks a node): a node's cards stand for a TPU slice, NVLink
    for ICI and the network for DCN. One node unless LOCAL_WORLD_SIZE says
    the world spans more."""
    n = world_size()
    per = int(os.environ.get('LOCAL_WORLD_SIZE', n)) or n
    per = min(per, n)
    return max(n // per, 1), per


def make_hybrid_mesh(axes: Sequence[Tuple[str, int]],
                     dcn_axes: Sequence[str] = DCN_AXES):
    """A mesh whose named axes land on the right link class.

    axes: ordered (name, size) pairs, e.g. [('dp', 4), ('tp', 8)].
    dcn_axes: names allowed to span nodes. Axes not listed stay inside a
    node, and their sizes must fit its ranks. On one node this is the
    row-major mesh over the world's ranks. Every rank of the world calls
    it (it creates the axes' process groups)."""
    from .mesh import Mesh
    names = tuple(n for n, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    total = int(np.prod(sizes))
    have = world_size()
    if total > have:
        raise ValueError(f'mesh {dict(axes)} needs {total} ranks, have '
                         f'{have}')
    for n in names:
        if n in dcn_axes and n in ICI_AXES:
            raise ValueError(f"axis '{n}' carries per-step tensor-sized "
                             f'collectives and must not span DCN')
    n_nodes, per_node = slice_topology()
    if n_nodes <= 1:
        return Mesh(np.arange(total).reshape(sizes), names)
    dcn_shape = tuple(s if n in dcn_axes else 1 for n, s in axes)
    ici_shape = tuple(1 if n in dcn_axes else s for n, s in axes)
    n_dcn = int(np.prod(dcn_shape))
    n_ici = int(np.prod(ici_shape))
    if n_dcn > n_nodes:
        raise ValueError(f'DCN axes {dcn_shape} need {n_dcn} nodes, '
                         f'the world has {n_nodes}')
    if n_ici > per_node:
        raise ValueError(f'ICI axes {ici_shape} exceed ranks per node '
                         f'({per_node})')
    # a rank's node is its DCN coordinate, its place in the node its ICI one
    grid = np.empty(sizes, np.int64)
    for idx in np.ndindex(*sizes):
        d = np.ravel_multi_index(
            tuple(i if n in dcn_axes else 0 for i, n in zip(idx, names)),
            dcn_shape)
        c = np.ravel_multi_index(
            tuple(0 if n in dcn_axes else i for i, n in zip(idx, names)),
            ici_shape)
        grid[idx] = d * per_node + c
    return Mesh(grid, names)


def local_batch_size(global_batch: int, mesh, batch_axis: str = 'dp') -> int:
    """Per-RANK batch of a dp-sharded input: each rank loads only the rows
    of its dp coordinate."""
    dp = dict(mesh.shape).get(batch_axis, 1)
    if global_batch % dp:
        raise ValueError(f'global batch {global_batch} not divisible by '
                         f'{batch_axis}={dp}')
    return global_batch // dp


def host_local_array(local_data: np.ndarray, mesh, spec) -> torch.Tensor:
    """This rank's shard as a tensor on the world's device: `local_data`
    already holds only its rows (the JAX package assembles a global array
    from such shards; here the shard is what a rank computes on). `spec`
    is checked against the mesh."""
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None and ax not in mesh.shape:
                raise ValueError(f'axis {ax!r} is not in the mesh')
    return torch.as_tensor(np.asarray(local_data)).to(world_device())


def sync_global_devices(tag: str = 'ppq_tpu') -> None:
    """Barrier across all ranks (no-op single-process). Use around
    checkpoint writes so no rank reads a half-written directory."""
    if world_size() == 1:
        return
    dist.barrier()


def broadcast_from_host0(tree):
    """Rank 0's value (any picklable tree) on every rank."""
    if world_size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ------------------------------------------------------------- transport ---
def _transport(tensors: Sequence[torch.Tensor],
               call: Callable[[Sequence[torch.Tensor]], None]) -> None:
    """Run the collective `call` on `tensors`, which it reads and writes in
    place. On a gloo world that computes on a card, the tensors are
    staged through host memory and written back (difference 54); NCCL, and
    gloo on CPU tensors, take them as they lie."""
    t0 = time.perf_counter()
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if world_transport() == 'host' and any(t.is_cuda for t in tensors):
        # pinned buffers (PyTorch's host allocator caches them): the copies
        # run at the link's rate, not a pageable bounce's
        host = [torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=t.is_cuda).copy_(t) for t in tensors]
        call(host)
        for t, h in zip(tensors, host):
            t.copy_(h)
        kind = 'host'
    else:
        call(tensors)
        kind = 'direct'
    TRANSPORT_COUNTS[kind] += 1
    TRANSPORT_BYTES[kind] += nbytes
    TRANSPORT_SECONDS[kind] += time.perf_counter() - t0


_OPS = {'sum': dist.ReduceOp.SUM, 'min': dist.ReduceOp.MIN,
        'max': dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = 'sum') -> torch.Tensor:
    """In place over `group` (a mesh axis's `(process group, ranks)`; None:
    a one-rank axis, nothing to do). Every rank gets the same bits."""
    if group is None:
        return t
    pg, _ = group
    _transport([t], lambda ts: dist.all_reduce(ts[0], op=_OPS[op], group=pg))
    return t


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors joined along `dim` in rank order."""
    if group is None:
        return t
    pg, ranks = group
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in ranks]

    def call(ts):
        dist.all_gather(list(ts[1:]), ts[0], group=pg)
    _transport([t] + parts, call)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In place: the group's `src`-th rank's tensor on every rank."""
    if group is None:
        return t
    pg, ranks = group
    _transport([t], lambda ts: dist.broadcast(ts[0], src=ranks[src],
                                              group=pg))
    return t


def ring_shift(tensors: Sequence[torch.Tensor], group
               ) -> List[torch.Tensor]:
    """Each rank sends `tensors` to the next rank of the group and returns
    what the previous one sent (`jax.lax.ppermute` with i -> i + 1)."""
    if group is None:
        return list(tensors)
    pg, ranks = group
    me = ranks.index(global_rank())
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    k = len(tensors)

    def call(ts):
        ops = [dist.P2POp(dist.isend, s, nxt, group=pg) for s in ts[:k]]
        ops += [dist.P2POp(dist.irecv, r, prv, group=pg) for r in ts[k:]]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _transport(tensors + out, call)
    return out


def send(t: torch.Tensor, dst: int) -> None:
    """Point to point to global rank `dst`."""
    _transport([t], lambda ts: dist.send(ts[0], dst))


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """In place from global rank `src`."""
    _transport([t], lambda ts: dist.recv(ts[0], src))
    return t


# ----------------------------------------------------------------- spawn ---
def _fn_address(fn: Callable) -> Tuple[str, str, str]:
    """(module, qualified name, directory to import it from) of a
    module-level function; a script's functions by the script's name."""
    module = sys.modules[fn.__module__]
    path = getattr(module, '__file__', None)
    if path is None:
        raise ValueError(f'{fn!r} is not importable from a file')
    name = fn.__module__
    if name == '__main__':
        name = os.path.splitext(os.path.basename(path))[0]
    root = os.path.dirname(os.path.abspath(path))
    for _ in range(name.count('.')):
        root = os.path.dirname(root)
    return name, fn.__qualname__, root


def spawn(world: int, fn: Callable, args: tuple = (), device=None,
          timeout: float = 120.0, env: Optional[dict] = None) -> list:
    """Run `fn(*args)` on every rank of a one-machine world of `world`
    processes and return the ranks' results in rank order.

    `fn` is a module-level function; the children import its module (a
    script's by its file name) and nothing else of the caller, so a rank
    never imports what the caller's process has loaded (a test's JAX).
    Each child joins the world through a FileStore in a temporary
    directory (`initialize_multihost(device=device)`: the card unless
    'cpu' is named, and a world without a card raises), runs with one torch
    thread (the ranks share the machine's cores), and writes its result
    there; `env` adds to
    the children's environment (LOCAL_WORLD_SIZE=1 makes every rank a node
    of its own). When a rank
    fails, every rank is killed and this raises with its output; when
    `timeout` seconds pass first, likewise."""
    module, qualname, root = _fn_address(fn)
    import ppq_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ppq_tpu_torch.__file__)))
    work = tempfile.mkdtemp(prefix='ppq_tpu_world_')
    with open(os.path.join(work, 'job.pkl'), 'wb') as f:
        pickle.dump(dict(module=module, qualname=qualname, root=root,
                         args=args, timeout=timeout,
                         device=None if device is None else str(device)),
                    f)
    base = dict(os.environ)
    path = [pkg_root, root] + [p for p in
                               base.get('PYTHONPATH', '').split(os.pathsep)
                               if p]
    base['PYTHONPATH'] = os.pathsep.join(dict.fromkeys(path))
    base.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                PPQ_TPU_STORE=os.path.join(work, 'store'))
    base.update(env or {})
    for key in ('MASTER_ADDR', 'MASTER_PORT'):
        base.pop(key, None)
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(work, f'rank{r}.log'), 'wb')
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'ppq_tpu_torch.parallel._rank', work],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f'rank {bad[0]} of {world} failed (exit {codes[bad[0]]}):'
                    f'\n{_tail(work, bad[0])}')
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f'world of {world} ranks running {module}.{qualname} '
                    f'passed its {timeout:.0f} s timeout; ranks still '
                    f'running: {[r for r, c in enumerate(codes) if c is None]}'
                    f'\n{_tail(work, codes.index(None))}')
            time.sleep(0.02)
        out = []
        for r in range(world):
            with open(os.path.join(work, f'result{r}.pkl'), 'rb') as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def _tail(work: str, rank: int, n: int = 6000) -> str:
    try:
        with open(os.path.join(work, f'rank{rank}.log'), 'rb') as f:
            return f.read().decode('utf-8', 'replace')[-n:]
    except OSError:
        return ''
