"""Tensor-, data- and expert-parallel serving: the shardings of the JAX
package's engine (`ppq_tpu/serving/engine.py:36-105`) as each rank's
slices of the global parameters, and the collectives that GSPMD would
insert, as explicit calls.

Megatron layout over the mesh's 'tp' axis: wq / wk / wv / w_gate / w_up /
lm_head column-parallel (output axis split, scales with it), wo / w_down
row-parallel (input axis split, scales replicated), norms and the
embedding replicated. A rank's model is the one-card model on its shard:
its heads are n_heads / tp and n_kv_heads / tp (`RankConfig`), its KV
cache holds its kv heads, and the hand kernels run on its local tensors
(recorded difference 52: the JAX package's mesh path takes its XLA
products instead). Two weights carry a collective (`qmatmul` in model.py):
  * RowParallel (wo, w_down): the partial product in float32, an
    all-reduce over 'tp', then the residual once (added on every rank
    before the reduce it would count tp times), then the cast;
  * ColumnParallel (lm_head): the local logits without the kernel's padding
    columns, all-gathered over 'tp' in rank order.
The fused q|k|v and gate|up weights are fused per rank after sharding, so
a rank's fused columns are its own q, k, v (gate, up) columns
(`fuse_decode_params` on the local tree). INT4 row-parallel weights are
unpacked, sliced by logical input row and packed again: a contiguous slice
of the split-half packed rows pairs row r with r + in/2 of the global
weight, not of the rank's rows.

MoE layers split their expert stacks over 'ep', or 'tp' where the mesh has
no 'ep' axis (`shard_moe_params`, ExpertParallel); each rank computes its
experts' share and an all-reduce sums it. 'dp' replicates, as the JAX
engine does when tp is 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..kernels import qmm as _qmm
from ..parallel.mesh import Sharding
from ..parallel.multihost import all_gather, all_reduce
from .config import LlamaConfig

F32 = torch.float32
PP_SP = ('pipeline (pp) and sequence (sp) meshes: ROADMAP item 15b')


class RowParallel(dict):
    """A row-parallel weight dict (this rank's input rows, 1 / `shards` of
    the depth): its product is a partial sum, all-reduced over `group`.
    It takes the kernel where one card's whole weight would
    (`model._qmatmul`'s `shards`), so a rank launches what one card
    launches; a shard the kernel cannot tile then raises here, never
    falls to the plain product (at tp 2 the 1B decoder's INT4 w_down is
    1408 packed rows deep, which the JAX package's rule refuses and the
    kernel's 32-row steps tile)."""

    def __init__(self, wq: dict, group, shards: int):
        super().__init__(wq)
        self.group = group
        self.shards = shards
        if 'w' in wq:
            return
        depth, f = (wq['w_packed'] if 'w_packed' in wq else wq['w_int']).shape
        whole, tiled = ((_qmm.supports_int4, _qmm.tiles_int4)
                        if 'w_packed' in wq else
                        (_qmm.supports, _qmm.tiles_int8))
        if whole(depth * shards, f) and not tiled(depth, f):
            raise ValueError(
                f'a {shards}-way row shard of a {depth * shards} x {f} weight '
                f'({depth} {"packed " if "w_packed" in wq else ""}rows) does '
                'not tile the kernel one card takes for it')

    def reduce(self, part: torch.Tensor) -> torch.Tensor:
        return all_reduce(part.contiguous(), self.group)


class ColumnParallel(dict):
    """A column-parallel weight dict whose outputs are gathered (lm_head):
    `n_out` columns are this rank's, the rest the kernel's padding."""

    def __init__(self, wq: dict, group, n_out: int):
        super().__init__(wq)
        self.group = group
        self.n_out = n_out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return all_gather(local[..., :self.n_out].contiguous(), self.group,
                          dim=-1)


class ExpertParallel(dict):
    """A MoE layer's parameters with this rank's experts `offset ..
    offset + E_local` of `n_experts`; the expert sum is all-reduced over
    `group`."""

    def __init__(self, moe: dict, group, offset: int):
        super().__init__(moe)
        self.group = group
        self.offset = offset


@dataclasses.dataclass
class RankConfig(LlamaConfig):
    """A rank's view of the model: n_heads and n_kv_heads are the rank's,
    the head dim stays the model's."""
    tp: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // (self.n_heads * self.tp)


def rank_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    if tp == 1:
        return cfg
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                  d_ff=cfg.d_ff // tp, tp=tp)
    return RankConfig(**fields)


# ------------------------------------------------------------ shardings ----
def param_shardings(cfg: LlamaConfig, mesh):
    """Megatron-style TP layout over the 'tp' axis (the JAX package's
    `param_shardings`): spec_of(params) -> the tree's Shardings."""
    col = {'w': (None, 'tp'), 'w_int': (None, 'tp'),
           'w_packed': (None, 'tp'), 'scale': ('tp',)}
    row = {'w': ('tp', None), 'w_int': ('tp', None),
           'w_packed': ('tp', None), 'scale': ()}
    exp_axis = 'ep' if 'ep' in mesh.shape else 'tp'
    moe_layout = {'w': (exp_axis, None, None),
                  'w_int': (exp_axis, None, None),
                  'w_packed': (exp_axis, None, None),
                  'scale': (exp_axis, None)}
    rep = Sharding(mesh, ())

    def pick(d, layout):
        return {k: Sharding(mesh, layout[k]) for k in d}

    def layer_spec(layer):
        spec = {'attn_norm': rep, 'mlp_norm': rep,
                'wq': pick(layer['wq'], col), 'wk': pick(layer['wk'], col),
                'wv': pick(layer['wv'], col), 'wo': pick(layer['wo'], row)}
        if 'moe' in layer:
            spec['moe'] = {'router': rep}
            for wname in ('w_gate', 'w_up', 'w_down'):
                spec['moe'][wname] = pick(layer['moe'][wname], moe_layout)
        else:
            spec['w_gate'] = pick(layer['w_gate'], col)
            spec['w_up'] = pick(layer['w_up'], col)
            spec['w_down'] = pick(layer['w_down'], row)
        return spec

    def spec_of(params):
        return {'embed': rep, 'final_norm': rep,
                'lm_head': pick(params['lm_head'], col),
                'layers': [layer_spec(l) for l in params['layers']]}
    return spec_of


def cache_shardings(cfg: LlamaConfig, mesh) -> Dict[str, Sharding]:
    """KV cache placement, arrays (L, B, S, KV, Dh): 'tp' splits the
    kv-head axis (each head's K/V stay on the rank that computes it). The
    'pp' layer axis and the 'sp' sequence axis are item 15b."""
    axes = [None] * 5
    if mesh.shape.get('tp', 1) > 1 and \
            cfg.n_kv_heads % mesh.shape['tp'] == 0:
        axes[3] = 'tp'
    kv = Sharding(mesh, tuple(axes))
    sc = Sharding(mesh, tuple(axes[:4]))
    out = {'k': kv, 'v': kv}
    if cfg.kv_cache_bits == 8:
        out['k_scale'] = sc
        out['v_scale'] = sc
    return out


def _local(value, sharding: Sharding, key: str):
    if key == 'w_packed' and sharding.spec[:1] in (('tp',), ('ep',)) and \
            len(sharding.spec) == 2:
        # row-parallel INT4: slice the logical input rows, then pack again
        full = _qmm.unpack_int4_splithalf(value)
        return _qmm.pack_int4_splithalf(sharding.local(full).contiguous())
    return sharding.local(value).contiguous()


def shard_llama_params(params: Dict[str, Any], cfg: LlamaConfig, mesh
                       ) -> Tuple[Dict[str, Any], LlamaConfig]:
    """This rank's slices of the global (unfused) parameter tree and its
    RankConfig. Raises for pp / sp meshes (item 15b)."""
    shape = dict(mesh.shape)
    if shape.get('pp', 1) > 1 or shape.get('sp', 1) > 1:
        raise NotImplementedError(PP_SP)
    tp = shape.get('tp', 1)
    moe = any('moe' in l for l in params['layers'])
    if tp > 1:
        # a rank's cache holds the kv heads cache_shardings gives it; where
        # that spec keeps every head on every rank (n_kv_heads not divisible
        # by tp), a rank's wk / wv columns would split a head
        if cfg.n_heads % tp or \
                cache_shardings(cfg, mesh)['k'].spec[3] != 'tp':
            raise ValueError(f'tp={tp} needs n_heads ({cfg.n_heads}) and '
                             f'n_kv_heads ({cfg.n_kv_heads}) divisible by it')
        spec = param_shardings(cfg, mesh)(params)

        def take(tree, sp, key=None):
            if isinstance(tree, dict):
                return {k: (take(v, sp[k], k) if k in sp else v)
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [take(v, s) for v, s in zip(tree, sp)]
            if isinstance(tree, torch.Tensor):
                return _local(tree, sp, key)
            return tree
        params = take(params, spec)
    elif moe and shape.get('ep', 1) > 1:
        params = dict(params)
        params['layers'] = [
            dict(l, moe=_local_experts(l['moe'], mesh)) if 'moe' in l else l
            for l in params['layers']]
    return params, rank_config(cfg, tp)


def _local_experts(moe: dict, mesh) -> dict:
    axis = 'ep' if 'ep' in mesh.shape else 'tp'
    out = dict(moe)
    for wname in ('w_gate', 'w_up', 'w_down'):
        out[wname] = {k: Sharding(mesh, (axis,) + (None,) * (v.dim() - 1))
                      .local(v).contiguous()
                      for k, v in moe[wname].items()}
    return out


def mark_parallel(params: Dict[str, Any], mesh,
                  lm_columns: int) -> Dict[str, Any]:
    """The collectives of a rank's (fused) tree: wo / w_down RowParallel,
    lm_head ColumnParallel over 'tp' (its first `lm_columns` outputs the
    rank's), MoE layers ExpertParallel."""
    shape = dict(mesh.shape)
    tp = mesh.group('tp') if shape.get('tp', 1) > 1 else None
    exp_axis = 'ep' if 'ep' in shape else 'tp'
    experts = mesh.group(exp_axis) if shape.get(exp_axis, 1) > 1 else None
    out = dict(params)
    layers = []
    for layer in params['layers']:
        lay = dict(layer)
        if tp is not None:
            for name in ('wo', 'w_down'):
                if name in lay:
                    lay[name] = RowParallel(lay[name], tp, shape['tp'])
        if 'moe' in lay and experts is not None:
            e_local = lay['moe']['w_gate'][next(iter(
                lay['moe']['w_gate']))].shape[0]
            lay['moe'] = ExpertParallel(lay['moe'], experts,
                                        mesh.index(exp_axis) * e_local)
        layers.append(lay)
    out['layers'] = layers
    if tp is not None:
        out['lm_head'] = ColumnParallel(params['lm_head'], tp, lm_columns)
    return out


def shard_moe_params(params: Dict, mesh) -> Dict:
    """Expert parallelism: this rank's slice of the expert stacks over
    'ep' (or 'tp' where the mesh has no 'ep' axis), router replicated, as
    an ExpertParallel dict that `moe_ffn` sums over the axis."""
    axis = 'ep' if 'ep' in mesh.shape else 'tp'
    local = _local_experts(params, mesh)
    e_local = next(iter(local['w_gate'].values())).shape[0]
    group = mesh.group(axis) if mesh.shape.get(axis, 1) > 1 else None
    return ExpertParallel(local, group, mesh.index(axis) * e_local)
