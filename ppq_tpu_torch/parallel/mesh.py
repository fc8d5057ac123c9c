"""Meshes and shardings over the ranks of a torch.distributed world.

Counterpart of `ppq_tpu/parallel/mesh.py`. A JAX mesh is a grid of devices
with named axes, and a NamedSharding says which slice of a global array
each device holds; XLA inserts the collectives. Here a mesh is a grid of
global ranks with named axes and one process group for every line of each
axis (`Mesh`, a thin class of the port's own: DeviceMesh fixes one device
type a mesh and would give the ranks of a one-card world distinct cards),
a sharding is the same spec (`Sharding`), and a rank takes its slice of
a global tensor with `Sharding.local`. The collectives are explicit calls
(multihost.py).

Axes:
  dp: data parallel (batch dim). Calibration sweeps and finetune batches
      shard here; gradient and statistic reductions run over it.
  tp: tensor parallel (channel dim). Large weights shard the axis that
      `_tp_axis_for` picks; quant scales stay replicated.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import global_rank, world_size


class Mesh:
    """A row-major grid of global ranks with named axes.

    Every rank of the world constructs it with the same arguments (the
    axes' process groups are created collectively); a rank outside the
    grid gets `coords` None. `group(axis)` is this rank's line along the
    axis as `(process group, global ranks)`, None for an axis of size 1."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        ranks = np.asarray(ranks, np.int64)
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        if ranks.ndim != len(self.axis_names):
            raise ValueError(f'{ranks.shape} grid for axes '
                             f'{self.axis_names}')
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        have = world_size()
        if self.size > 1 and (not dist.is_initialized() or
                              int(ranks.max()) >= have):
            raise ValueError(f'mesh {self.shape} needs {self.size} ranks, '
                             f'have {have}')
        me = global_rank()
        where = np.argwhere(ranks == me)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self._groups: Dict[str, Tuple[object, list]] = {}
        for ax, name in enumerate(self.axis_names):
            if ranks.shape[ax] == 1:
                continue
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                line = [int(r) for r in line]
                pg = dist.new_group(line)
                if me in line:
                    self._groups[name] = (pg, line)

    def group(self, axis: str):
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (0 for an absent axis)."""
        if self.coords is None:
            raise ValueError('this rank is not in the mesh')
        return self.coords.get(axis, 0)

    def __repr__(self):
        return f'Mesh({self.shape})'


class Sharding(NamedTuple):
    """Which slice of a global array a rank holds: `spec` has one entry a
    dimension, None (whole), an axis name, or a tuple of axis names (the
    dimension split over their product, the first major), as a JAX
    PartitionSpec."""
    mesh: Mesh
    spec: tuple

    def local(self, value):
        """This rank's slice of `value` (a numpy array or a tensor), a view
        where the slice is contiguous."""
        return local_slice(value, self.spec, dict(self.mesh.shape),
                           self.mesh.coords)


def local_slice(value, spec: Sequence, mesh_shape: Dict[str, int],
                coords: Dict[str, int]):
    """The block of `value` that the device at `coords` of a mesh of
    `mesh_shape` holds under `spec` (a pure function of the shapes)."""
    index = []
    for dim, entry in enumerate(tuple(spec) + (None,) *
                                (len(value.shape) - len(spec))):
        if entry is None:
            index.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for ax in axes:
            n, i = n * mesh_shape.get(ax, 1), i * mesh_shape.get(ax, 1) \
                + coords.get(ax, 0)
        size = value.shape[dim]
        if size % n:
            raise ValueError(f'dimension {dim} ({size}) does not split '
                             f'over {axes} ({n})')
        step = size // n
        index.append(slice(i * step, (i + 1) * step))
    return value[tuple(index)]


def make_mesh(n_devices: Optional[int] = None,
              dp: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """A (dp, tp) mesh over the first n ranks of the world."""
    if n_devices is None and dp is not None and tp is not None:
        n_devices = dp * tp
    n = n_devices or world_size()
    if dp is None and tp is None:
        # favor tp (bandwidth-bound weights) but keep dp > 1 when possible
        dp = 2 if n % 2 == 0 and n > 2 else 1
        tp = n // dp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f'dp({dp}) * tp({tp}) != devices({n})'
    return Mesh(np.arange(n).reshape(dp, tp), ('dp', 'tp'))


def _tp_axis_for(name: str, shape: Tuple[int, ...], tp_size: int
                 ) -> Optional[int]:
    """The axis to shard over tp for one parameter, or None.

    Convention: computing-op weights shard their *largest* axis that is
    divisible by tp_size and big enough to matter; biases and norm params
    stay replicated."""
    if len(shape) == 0 or np.prod(shape) < 1024:
        return None
    best, best_size = None, 0
    for ax, s in enumerate(shape):
        if s % tp_size == 0 and s > best_size and s >= 2 * tp_size:
            best, best_size = ax, s
    return best


def tp_param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh
                       ) -> Dict[str, Sharding]:
    """Sharding a parameter: big weights sharded over 'tp', the rest
    replicated."""
    tp_size = mesh.shape.get('tp', 1)
    out = {}
    for name, val in params.items():
        ax = _tp_axis_for(name, tuple(val.shape), tp_size)
        if ax is None:
            out[name] = Sharding(mesh, ())
        else:
            spec = [None] * len(val.shape)
            spec[ax] = 'tp'
            out[name] = Sharding(mesh, tuple(spec))
    return out


def shard_qparams(qparams: Dict[str, Dict[str, torch.Tensor]], mesh: Mesh,
                  param_shardings: Optional[Dict[str, Sharding]] = None
                  ) -> Dict[str, Dict[str, Sharding]]:
    """Quant scales and offsets: replicated (they are tiny)."""
    return {k: {'scale': Sharding(mesh, ()), 'offset': Sharding(mesh, ())}
            for k in qparams}


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard the leading (batch) dim over 'dp'."""
    return Sharding(mesh, ('dp',) + (None,) * (ndim - 1))


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
