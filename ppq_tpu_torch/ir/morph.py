"""Graph surgery: formatter / merger (fusions) / replacer / decomposer.

Capability-equivalent redesign of ppq/IR/morph.py (GraphFormatter:155,
GraphMerger:501, GraphReplacer:16, GraphDecomposer:1078). Implemented as
plain functions over BaseGraph; `GraphFormatter` etc. below are thin
namespaces so callers can keep the reference's class-style spelling.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import DataType, TargetPlatform, ppq_warning
from .graph import BaseGraph, Operation, Variable
from .search import SearchableGraph

# ============================================================= formatter ===


def format_constant_input(graph: BaseGraph):
    """Constant op → parameter variable (ppq/IR/morph.py:345)."""
    for op in list(graph.operations.values()):
        if op.type != 'Constant':
            continue
        value = op.attributes.get('value')
        out_var = op.outputs[0]
        out_var.value = np.asarray(value)
        out_var.is_parameter = True
        out_var.source_op = None
        op.outputs.clear()
        graph.remove_operation(op)


def format_parameter(graph: BaseGraph):
    """Split parameter variables shared by several ops so each consumer owns
    a private copy (ppq/IR/morph.py:445) — required because per-op TQCs may
    quantize the same weight differently."""
    for var in list(graph.variables.values()):
        if not var.is_parameter or len(var.dest_ops) <= 1:
            continue
        for i, op in enumerate(list(var.dest_ops[1:]), start=1):
            clone = graph.create_variable(
                name=f'{var.name}_split_{i}', value=np.array(var.value, copy=True),
                is_parameter=True)
            idx = op.input_idx(var)
            op.inputs[idx] = clone
            clone.dest_ops.append(op)
        kept = var.dest_ops[0]
        var.dest_ops[:] = [kept]


def remove_identity(graph: BaseGraph, including_dropout: bool = True):
    """Splice out Identity (and inference-mode Dropout) ops
    (ppq/IR/morph.py:486)."""
    removable = {'Identity'} | ({'Dropout'} if including_dropout else set())
    for op in list(graph.operations.values()):
        if op.type not in removable:
            continue
        if op.type == 'Dropout' and len(op.outputs) > 1:
            # mask output in use? drop it if unconsumed
            if any(o.dest_ops or o.name in graph.outputs for o in op.outputs[1:]):
                continue
            for extra in list(op.outputs[1:]):
                graph.remove_variable(extra)
            op.outputs[:] = op.outputs[:1]
        # identity over a parameter: constant-fold
        src = op.inputs[0]
        if src.is_parameter and len(op.inputs) == 1:
            out = op.outputs[0]
            out.value = np.array(src.value, copy=True)
            out.is_parameter = True
            src.dest_ops.remove(op)
            graph._drop_variable_if_isolated(src)
            out.source_op = None
            op.outputs.clear()
            op.inputs.clear()
            graph.remove_operation(op)
            continue
        if src.name in graph.inputs and op.outputs[0].name in graph.outputs:
            continue  # degenerate passthrough graph; keep
        graph.remove_operation(op, keep_coherence=True)


def delete_isolated(graph: BaseGraph):
    """Remove ops whose outputs reach no graph output
    (ppq/IR/morph.py:401)."""
    changed = True
    while changed:
        changed = False
        for op in list(graph.operations.values()):
            alive = any(v.dest_ops or v.name in graph.outputs for v in op.outputs)
            if not alive:
                graph.remove_operation(op)
                changed = True
    for var in list(graph.variables.values()):
        if (var.source_op is None and not var.dest_ops
                and var.name not in graph.inputs and var.name not in graph.outputs):
            graph.remove_variable(var)


def format_cast(graph: BaseGraph):
    """Remove Cast ops that cast float→float (simulator is dtype-polymorphic)
    (ppq/IR/morph.py: format_cast)."""
    for op in list(graph.operations.values()):
        if op.type != 'Cast':
            continue
        to = DataType(op.attributes.get('to', DataType.FP32))
        src_dt = op.inputs[0].dtype
        if to.is_float and src_dt.is_float:
            graph.remove_operation(op, keep_coherence=True)


def _attr_to_input(graph: BaseGraph, op: Operation, attr: str,
                   dtype=np.int64) -> bool:
    if attr not in op.attributes:
        return False
    value = np.asarray(op.attributes.pop(attr), dtype=dtype)
    graph.create_variable(value=value, is_parameter=True, dest_ops=[op])
    return True


def format_slice(graph: BaseGraph):
    """Normalize opset<10 attribute-style Slice to input-style."""
    for op in graph.operations.values():
        if op.type != 'Slice' or len(op.inputs) > 1:
            continue
        for attr in ('starts', 'ends', 'axes'):
            _attr_to_input(graph, op, attr)


def format_clip(graph: BaseGraph):
    """Normalize attribute-style Clip(min=,max=) to input-style."""
    for op in graph.operations.values():
        if op.type != 'Clip':
            continue
        if 'min' in op.attributes or 'max' in op.attributes:
            lo = op.attributes.pop('min', None)
            hi = op.attributes.pop('max', None)
            if len(op.inputs) == 1:
                graph.create_variable(
                    value=np.asarray(-3.4e38 if lo is None else lo, np.float32),
                    is_parameter=True, dest_ops=[op])
                graph.create_variable(
                    value=np.asarray(3.4e38 if hi is None else hi, np.float32),
                    is_parameter=True, dest_ops=[op])


def format_pad(graph: BaseGraph):
    for op in graph.operations.values():
        if op.type != 'Pad':
            continue
        _attr_to_input(graph, op, 'pads')
        if 'value' in op.attributes and len(op.inputs) == 2:
            graph.create_variable(
                value=np.asarray(op.attributes.pop('value'), np.float32),
                is_parameter=True, dest_ops=[op])


def format_resize(graph: BaseGraph):
    """Normalize Upsample / attribute-scales Resize to opset-13 Resize."""
    for op in graph.operations.values():
        if op.type == 'Upsample' and 'scales' in op.attributes:
            op.type = 'Resize'
            scales = np.asarray(op.attributes.pop('scales'), np.float32)
            # Resize inputs: X, roi, scales
            graph.create_variable(value=np.zeros(0, np.float32),
                                  is_parameter=True, dest_ops=[op])
            graph.create_variable(value=scales, is_parameter=True, dest_ops=[op])


def format_axes_to_input(graph: BaseGraph):
    """opset-13 moved Squeeze/Unsqueeze axes and Split split to inputs; accept
    attribute form and normalize."""
    for op in graph.operations.values():
        if op.type in {'Squeeze', 'Unsqueeze'}:
            _attr_to_input(graph, op, 'axes')
        elif op.type == 'Split':
            _attr_to_input(graph, op, 'split')


def format_int64_constants(graph: BaseGraph):
    """Keep SOI params as int64 numpy (nothing to do — IR is numpy-native),
    but downcast float64 params that sneak in via ONNX."""
    for var in graph.variables.values():
        if var.is_parameter and var.has_value and var.value.dtype == np.float64:
            var.value = var.value.astype(np.float32)


def truncate_on_var(graph: BaseGraph, var: Variable, mark_as_output: bool):
    """Cut the graph at var: drop everything strictly downstream
    (ppq/IR/morph.py:367)."""
    downstream = set()
    frontier = list(var.dest_ops)
    while frontier:
        op = frontier.pop()
        if op.name in downstream:
            continue
        downstream.add(op.name)
        frontier.extend(graph.get_downstream_operations(op))
    for name in downstream:
        if name in graph.operations:
            graph.remove_operation(graph.operations[name])
    var.dest_ops.clear()
    if mark_as_output:
        graph.mark_as_output(var)
    for out_name in list(graph.outputs):
        if out_name not in graph.variables:
            del graph.outputs[out_name]
    delete_isolated(graph)


def format_graph(graph: BaseGraph) -> BaseGraph:
    """Standard normalization chain (ppq/api/interface.py:593-641)."""
    format_constant_input(graph)
    format_axes_to_input(graph)
    format_slice(graph)
    format_clip(graph)
    format_pad(graph)
    format_resize(graph)
    format_cast(graph)
    format_int64_constants(graph)
    fuse_bn(graph)
    remove_identity(graph)
    format_parameter(graph)
    delete_isolated(graph)
    return graph


# =============================================================== merger ===


def fuse_bn(graph: BaseGraph):
    """Fold BatchNormalization into preceding Conv/ConvTranspose/Gemm
    (ppq/IR/morph.py:517-616).

    W'_oc = W_oc * gamma_oc / sqrt(var_oc + eps)
    b'_oc = (b_oc - mean_oc) * gamma_oc / sqrt(var_oc + eps) + beta_oc
    """
    search = SearchableGraph(graph)
    pairs = search.pattern_matching(
        [lambda op: op.type in {'Conv', 'ConvTranspose', 'Gemm'},
         'BatchNormalization'], exclusive=True)
    for comp, bn in pairs:
        if len(graph.get_downstream_operations(comp)) != 1:
            continue
        gamma, beta, mean, var = (bn.inputs[i].value for i in (1, 2, 3, 4))
        eps = float(bn.attributes.get('epsilon', 1e-5))
        alpha = gamma / np.sqrt(var + eps)

        w = comp.inputs[1].value
        b = comp.inputs[2].value if len(comp.inputs) > 2 else None
        if comp.type == 'Conv':
            w = w * alpha.reshape([-1] + [1] * (w.ndim - 1))
        elif comp.type == 'ConvTranspose':
            groups = int(comp.attributes.get('group', 1))
            # weight layout [C_in, C_out/groups, *k]
            oc = alpha.shape[0]
            w = w.reshape(groups, w.shape[0] // groups, w.shape[1], *w.shape[2:])
            a = alpha.reshape(groups, 1, oc // groups, *([1] * (w.ndim - 3)))
            w = (w * a).reshape(-1, w.shape[2], *w.shape[3:])
        elif comp.type == 'Gemm':
            if int(comp.attributes.get('transB', 0)) == 1:
                w = w * alpha.reshape(-1, 1)
            else:
                w = w * alpha.reshape(1, -1)
        if b is None:
            b = np.zeros_like(mean)
        b = (b - mean) * alpha + beta

        comp.inputs[1].value = w.astype(np.float32)
        if len(comp.inputs) > 2:
            comp.inputs[2].value = b.astype(np.float32)
        else:
            graph.create_variable(value=b.astype(np.float32),
                                  is_parameter=True, dest_ops=[comp])
        # drop BN params then splice BN out
        graph.remove_operation(bn, keep_coherence=True)


def fuse_matmul_add(graph: BaseGraph):
    """MatMul + Add(bias) → Gemm when 2-D, else BiasFusedMatMul
    (ppq/IR/morph.py:617-692,1045)."""
    search = SearchableGraph(graph)
    for mm, add in search.pattern_matching(['MatMul', 'Add'], exclusive=True):
        if len(graph.get_downstream_operations(mm)) != 1:
            continue
        bias_vars = [v for v in add.inputs if v.is_parameter]
        if len(bias_vars) != 1:
            continue
        bias = bias_vars[0]
        w = mm.inputs[1]
        if not w.is_parameter or w.value is None or w.value.ndim != 2:
            continue
        n = w.value.shape[1]
        if bias.value is None or bias.value.size != n:
            continue
        act_rank = mm.inputs[0].ndim
        if act_rank == 2:
            mm.type = 'Gemm'
            mm.attributes.update({'alpha': 1.0, 'beta': 1.0,
                                  'transA': 0, 'transB': 0})
        else:
            mm.type = 'PPQBiasFusedMatMul'
        bias.value = bias.value.reshape(-1).astype(np.float32)
        bias.dest_ops.remove(add)
        graph.connect(bias, mm)
        graph.remove_operation(add, keep_coherence=True)


def fuse_gelu(graph: BaseGraph):
    """x * 0.5 * (1 + erf(x/sqrt(2))) chain → Gelu (ppq/IR/morph.py:845)."""
    search = SearchableGraph(graph)
    chains = search.pattern_matching(['Div', 'Erf', 'Add', 'Mul', 'Mul'],
                                     exclusive=False)
    for div, erf, add, mul1, mul2 in chains:
        root_candidates = [v for v in div.inputs if not v.is_parameter]
        if not root_candidates:
            continue
        root = root_candidates[0]
        if not any(v.source_op is root.source_op or v is root for v in mul1.inputs):
            continue
        gelu = graph.create_operation('Gelu', platform=div.platform)
        out = mul2.outputs[0]
        for op in (mul2, mul1, add, erf, div):
            if op.name in graph.operations:
                for var in list(op.inputs):
                    if op in var.dest_ops:
                        var.dest_ops.remove(op)
                    if var.is_parameter:
                        graph._drop_variable_if_isolated(var)
                for var in list(op.outputs):
                    var.source_op = None
                    if var is not out and not var.dest_ops:
                        graph.variables.pop(var.name, None)
                graph.operations.pop(op.name)
        graph.connect(root, gelu)
        gelu.outputs.append(out)
        out.source_op = gelu
        delete_isolated(graph)


def fuse_layernorm(graph: BaseGraph):
    """ReduceMean/Sub/Pow/ReduceMean/Add/Sqrt/Div/Mul/Add decomposed DAG →
    LayerNormalization (ppq/IR/morph.py:693-820). Matched with the DAG
    pattern engine: the Sub→Div variance/centering branch is a structural
    edge of the pattern, not a linearity assumption."""
    from .search import GraphPattern
    search = SearchableGraph(graph)
    ln_pattern = GraphPattern(
        ['ReduceMean', 'Sub', 'Pow', 'ReduceMean', 'Add', 'Sqrt', 'Div',
         'Mul', 'Add'],
        edges=[[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [1, 6],
               [6, 7], [7, 8]])
    chains = search.dag_matching(ln_pattern, exclusive=False)
    for ops in chains:
        rm1, sub, pow_, rm2, add_eps, sqrt, div, mul, add_b = ops
        if any(o.name not in graph.operations for o in ops):
            continue                      # consumed by an earlier match
        x_cands = [v for v in rm1.inputs if not v.is_parameter]
        if not x_cands:
            continue
        x = x_cands[0]
        if x not in sub.inputs:
            continue
        gamma_v = next((v for v in mul.inputs if v.is_parameter), None)
        beta_v = next((v for v in add_b.inputs if v.is_parameter), None)
        if gamma_v is None or beta_v is None:
            continue
        eps_v = next((v for v in add_eps.inputs if v.is_parameter), None)
        eps = float(eps_v.value) if eps_v is not None and eps_v.value is not None else 1e-5
        axes = rm1.attributes.get('axes', [-1])
        axis = int(axes[0]) if isinstance(axes, (list, tuple)) else int(axes)
        ln = graph.create_operation('LayerNormalization',
                                    attributes={'axis': axis, 'epsilon': eps},
                                    platform=rm1.platform)
        out = add_b.outputs[0]
        for op in (add_b, mul, div, sqrt, add_eps, rm2, pow_, sub, rm1):
            if op.name not in graph.operations:
                continue
            for var in list(op.inputs):
                if op in var.dest_ops:
                    var.dest_ops.remove(op)
                if var.is_parameter and var not in (gamma_v, beta_v):
                    graph._drop_variable_if_isolated(var)
            for var in list(op.outputs):
                var.source_op = None
                if var is not out and not var.dest_ops:
                    graph.variables.pop(var.name, None)
            graph.operations.pop(op.name)
        graph.connect(x, ln)
        graph.connect(gamma_v, ln)
        graph.connect(beta_v, ln)
        ln.outputs.append(out)
        out.source_op = ln
        delete_isolated(graph)


def fuse_bias_add(graph: BaseGraph):
    """Conv/ConvTranspose/Gemm without bias + Add(parameter) → folded bias
    (ppq/IR/morph.py:885)."""
    search = SearchableGraph(graph)
    for comp, add in search.pattern_matching(
            [lambda op: op.type in {'Conv', 'ConvTranspose'}, 'Add'],
            exclusive=True):
        if len(comp.inputs) >= 3:
            continue
        bias_vars = [v for v in add.inputs if v.is_parameter]
        if len(bias_vars) != 1 or bias_vars[0].value is None:
            continue
        bias = bias_vars[0]
        oc = comp.inputs[1].value.shape[0] if comp.type == 'Conv' else None
        flat = bias.value.reshape(-1)
        if oc is not None and flat.size != oc:
            continue
        bias.value = flat.astype(np.float32)
        bias.dest_ops.remove(add)
        graph.connect(bias, comp)
        graph.remove_operation(add, keep_coherence=True)


def fuse_skiplayernorm(graph: BaseGraph):
    """Add + LayerNormalization → skipLayerNormPlugin
    (ppq/IR/morph.py:821)."""
    search = SearchableGraph(graph)
    for add, ln in search.pattern_matching(
            ['Add', 'LayerNormalization'], exclusive=True):
        if any(v.is_parameter for v in add.inputs):
            continue
        x, skip = add.inputs[0], add.inputs[1]
        params = [v for v in ln.inputs if v.is_parameter]
        out = ln.outputs[0]
        fused = graph.create_operation(
            'skipLayerNormPlugin', name=f'{ln.name}_skipln',
            attributes={'epsilon': ln.attributes.get('epsilon', 1e-5)},
            platform=ln.platform)
        # detach add & ln
        for var in (x, skip):
            var.dest_ops.remove(add)
        mid = add.outputs[0]
        mid.dest_ops.clear()
        graph.operations.pop(add.name)
        graph.variables.pop(mid.name, None)
        for v in list(ln.inputs):
            if ln in v.dest_ops:
                v.dest_ops.remove(ln)
        graph.operations.pop(ln.name)
        # wire fused op
        graph.connect(x, fused)
        graph.connect(skip, fused)
        for p in params:
            graph.connect(p, fused)
        fused.outputs.append(out)
        out.source_op = fused
    delete_isolated(graph)


def fuse_selfattention(graph: BaseGraph):
    """MatMul(q,k^T) → [Mul/Div scale] → Softmax → MatMul(.,v) →
    one Attention op (ppq/IR/morph.py:928). Recognizes the transposed-head
    pattern produced by transformer exports."""
    from .search import GraphPattern
    search = SearchableGraph(graph)
    fused = 0
    # two DAG shapes: with and without an explicit scale op between the
    # score MatMul and the Softmax
    scaled = search.dag_matching(GraphPattern(
        ['MatMul', lambda op: op.type in ('Mul', 'Div'), 'Softmax',
         'MatMul'], edges=[[0, 1], [1, 2], [2, 3]]), exclusive=False)
    plain = search.dag_matching(GraphPattern(
        ['MatMul', 'Softmax', 'MatMul'], edges=[[0, 1], [1, 2]]),
        exclusive=False)
    candidates = [(m[0], m[1], m[2], m[3]) for m in scaled] + \
                 [(m[0], None, m[1], m[2]) for m in plain]
    for score_mm, scale_op, softmax, ctx_mm in candidates:
        if any(op is not None and op.name not in graph.operations
               for op in (score_mm, scale_op, softmax, ctx_mm)):
            continue                      # consumed by an earlier match
        if any(v.is_parameter for v in score_mm.inputs):
            continue
        # single-consumer interior (safe-to-fuse)
        if len(score_mm.outputs[0].dest_ops) != 1:
            continue
        if scale_op is not None:
            if not any(v.is_parameter for v in scale_op.inputs):
                continue
            if len(scale_op.outputs[0].dest_ops) != 1:
                continue
        if len(softmax.outputs[0].dest_ops) != 1:
            continue
        if ctx_mm.inputs[0].source_op is not softmax:
            continue
        # fold: Attention(q, k_t, v) with scale attribute
        q, k_t = score_mm.inputs[0], score_mm.inputs[1]
        v = ctx_mm.inputs[1]
        scale_val = 1.0
        if scale_op is not None:
            pv = next(x for x in scale_op.inputs if x.is_parameter)
            s = float(np.asarray(pv.value).reshape(-1)[0])
            scale_val = s if scale_op.type == 'Mul' else 1.0 / s
        out = ctx_mm.outputs[0]
        att = graph.create_operation(
            'Attention', name=f'{score_mm.name}_attention',
            attributes={'scale': scale_val}, platform=score_mm.platform)
        for var, op in ((q, score_mm), (k_t, score_mm)):
            if op in var.dest_ops:
                var.dest_ops.remove(op)
        if ctx_mm in v.dest_ops:
            v.dest_ops.remove(ctx_mm)
        for dead in (score_mm, scale_op, softmax, ctx_mm):
            if dead is None:
                continue
            for var in list(dead.inputs):
                if dead in var.dest_ops:
                    var.dest_ops.remove(dead)
            for var in list(dead.outputs):
                if var is not out:
                    var.source_op = None
                    graph.variables.pop(var.name, None)
            graph.operations.pop(dead.name, None)
        graph.connect(q, att)
        graph.connect(k_t, att)
        graph.connect(v, att)
        att.outputs.append(out)
        out.source_op = att
        fused += 1
    delete_isolated(graph)
    return fused


def fuse_scale(graph: BaseGraph):
    """Mul(x, per-channel param) [+ Add(param)] → Scale op
    (ppq/IR/morph.py:921)."""
    for mul in [op for op in list(graph.operations.values())
                if op.type == 'Mul']:
        params = [v for v in mul.inputs if v.is_parameter]
        if len(params) != 1:
            continue
        mul.type = 'Scale'
        nxt = mul.outputs[0].dest_ops
        if len(nxt) == 1 and nxt[0].type == 'Add':
            add = nxt[0]
            bias = [v for v in add.inputs if v.is_parameter]
            if len(bias) == 1 and \
                    np.asarray(bias[0].value).size == \
                    np.asarray(params[0].value).size:
                bias_var = bias[0]
                bias_var.dest_ops.remove(add)
                graph.connect(bias_var, mul)
                graph.remove_operation(add, keep_coherence=True)


# ============================================================= decomposer ===


def decompose_gru(graph: BaseGraph, max_unroll: int = 128):
    """GRU → per-gate Gemm/elementwise subgraph (ppq/IR/morph.py:1157).

    Expands each single-direction GRU into its gate arithmetic, statically
    unrolled over time (sequence length must be known from the input shape).
    Gate order is ONNX zrh; `linear_before_reset` is honored. Per step t:

        z_t = Sigmoid(Gemm(x_t, Wz, wbz+rbz) + Gemm(h, Rz))
        r_t = Sigmoid(Gemm(x_t, Wr, wbr+rbr) + Gemm(h, Rr))
        hh  = Tanh(Gemm(x_t, Wh, wbh) + r*(Gemm(h, Rh)+rbh))   (lbr=1)
        hh  = Tanh(Gemm(x_t, Wh, wbh) + Gemm(r*h, Rh, rbh))    (lbr=0)
        h   = hh + z * (h - hh)

    The result matches GRU_forward (ops/default.py) to float tolerance —
    parity-tested in tests/test_gru_decompose.py. Bidirectional GRUs and
    GRUs with an active sequence_lens input are left intact with a warning
    (the executor runs them natively)."""
    for op in [o for o in list(graph.operations.values()) if o.type == 'GRU']:
        x_var = op.inputs[0]
        w_var, r_var = op.inputs[1], op.inputs[2]
        if not (w_var.is_parameter and r_var.is_parameter and
                w_var.has_value and r_var.has_value):
            ppq_warning(f'decompose_gru: {op.name} has non-constant weights, '
                        f'skipped')
            continue
        W, R = np.asarray(w_var.value), np.asarray(r_var.value)
        num_dir, H = W.shape[0], R.shape[-1]
        if num_dir != 1:
            ppq_warning(f'decompose_gru: {op.name} is bidirectional, skipped '
                        f'(executor runs it natively)')
            continue
        shape = x_var.shape
        if shape is None or len(shape) != 3 or any(
                s is None or int(s) <= 0 for s in shape[:2]):
            ppq_warning(f'decompose_gru: {op.name} needs a static (T, N, I) '
                        f'input shape, skipped')
            continue
        T, N = int(shape[0]), int(shape[1])
        if T > max_unroll:
            ppq_warning(f'decompose_gru: {op.name} seq_len={T} exceeds '
                        f'max_unroll={max_unroll}, skipped')
            continue

        def _real_input(idx):
            if idx >= len(op.inputs):
                return None
            v = op.inputs[idx]
            if v.source_op is None and not v.has_value:
                return None          # empty-name optional slot (placeholder)
            return v

        seq_lens = _real_input(4)
        if seq_lens is not None and (seq_lens.has_value and
                                     np.asarray(seq_lens.value).size > 0):
            ppq_warning(f'decompose_gru: {op.name} uses sequence_lens, '
                        f'skipped')
            continue
        b_var = _real_input(3)
        B = (np.asarray(b_var.value) if b_var is not None and b_var.has_value
             else np.zeros((1, 6 * H), np.float32))
        h0_var = _real_input(5)
        lbr = int(op.attributes.get('linear_before_reset', 0))
        plat = op.platform

        wb, rb = B[0][:3 * H], B[0][3 * H:]
        Wz, Wr, Wh = W[0][:H], W[0][H:2 * H], W[0][2 * H:]
        Rz, Rr, Rh = R[0][:H], R[0][H:2 * H], R[0][2 * H:]

        def param(val, name_hint):
            return graph.create_variable(
                name=f'{op.name}_{name_hint}',
                value=np.ascontiguousarray(val, dtype=np.float32),
                is_parameter=True)

        def gemm(x, w, b, tag):
            """y = x @ w.T (+ b); w: (H, K) parameter, transB=1."""
            g = graph.create_operation(
                'Gemm', name=f'{op.name}_{tag}',
                attributes={'alpha': 1.0, 'beta': 1.0,
                            'transA': 0, 'transB': 1}, platform=plat)
            graph.connect(x, g)
            graph.connect(param(w, f'{tag}_w'), g)
            if b is not None:
                graph.connect(param(b, f'{tag}_b'), g)
            return graph.create_variable(source_op=g)

        def unary(kind, x, tag):
            o = graph.create_operation(kind, name=f'{op.name}_{tag}',
                                       platform=plat)
            graph.connect(x, o)
            return graph.create_variable(source_op=o)

        def binary(kind, a, b, tag):
            o = graph.create_operation(kind, name=f'{op.name}_{tag}',
                                       platform=plat)
            graph.connect(a, o)
            graph.connect(b, o)
            return graph.create_variable(source_op=o)

        # initial hidden state: Squeeze(initial_h) or a zeros parameter
        if h0_var is not None:
            sq = graph.create_operation(
                'Squeeze', name=f'{op.name}_h0_squeeze', platform=plat)
            graph.connect(h0_var, sq)
            graph.connect(graph.create_variable(
                name=f'{op.name}_h0_axes', value=np.asarray([0], np.int64),
                is_parameter=True), sq)
            h = graph.create_variable(source_op=sq)
        else:
            h = param(np.zeros((N, H), np.float32), 'h_init')

        step_outs = []
        for t in range(T):
            # x_t = Gather(X, t, axis=0): (N, I)
            gat = graph.create_operation(
                'Gather', name=f'{op.name}_x{t}',
                attributes={'axis': 0}, platform=plat)
            graph.connect(x_var, gat)
            graph.connect(graph.create_variable(
                name=f'{op.name}_idx{t}', value=np.asarray(t, np.int64),
                is_parameter=True), gat)
            x_t = graph.create_variable(source_op=gat)

            z = unary('Sigmoid',
                      binary('Add', gemm(x_t, Wz, wb[:H] + rb[:H], f't{t}_zx'),
                             gemm(h, Rz, None, f't{t}_zh'), f't{t}_zsum'),
                      f't{t}_z')
            r = unary('Sigmoid',
                      binary('Add',
                             gemm(x_t, Wr, wb[H:2 * H] + rb[H:2 * H],
                                  f't{t}_rx'),
                             gemm(h, Rr, None, f't{t}_rh'), f't{t}_rsum'),
                      f't{t}_r')
            hx = gemm(x_t, Wh, wb[2 * H:], f't{t}_hx')
            if lbr:
                hr = gemm(h, Rh, rb[2 * H:], f't{t}_hr')
                gated = binary('Mul', r, hr, f't{t}_rgate')
            else:
                rh_in = binary('Mul', r, h, f't{t}_rh_in')
                gated = gemm(rh_in, Rh, rb[2 * H:], f't{t}_hr')
            hh = unary('Tanh', binary('Add', hx, gated, f't{t}_hsum'),
                       f't{t}_hh')
            # h = hh + z * (h - hh)
            diff = binary('Sub', h, hh, f't{t}_diff')
            scaled = binary('Mul', z, diff, f't{t}_zdiff')
            h = binary('Add', hh, scaled, f't{t}_hnew')

            # (N, H) → (1, 1, N, H) for the Y output stack
            un = graph.create_operation(
                'Unsqueeze', name=f'{op.name}_y{t}_unsq', platform=plat)
            graph.connect(h, un)
            graph.connect(graph.create_variable(
                name=f'{op.name}_y{t}_axes',
                value=np.asarray([0, 1], np.int64), is_parameter=True), un)
            step_outs.append(graph.create_variable(source_op=un))

        # assemble outputs: Y = Concat(step_outs, axis=0); Y_h = Unsqueeze(h)
        y_out = op.outputs[0] if len(op.outputs) > 0 else None
        yh_out = op.outputs[1] if len(op.outputs) > 1 else None

        # detach the GRU from the graph (keep its output Variables)
        for v in list(op.inputs):
            if op in v.dest_ops:
                v.dest_ops.remove(op)
        op.inputs.clear()
        op.outputs.clear()
        graph.operations.pop(op.name)

        if y_out is not None:
            cat = graph.create_operation(
                'Concat', name=f'{op.name}_y_concat',
                attributes={'axis': 0}, platform=plat)
            for v in step_outs:
                graph.connect(v, cat)
            cat.outputs.append(y_out)
            y_out.source_op = cat
        if yh_out is not None:
            un = graph.create_operation(
                'Unsqueeze', name=f'{op.name}_yh_unsq', platform=plat)
            graph.connect(h, un)
            graph.connect(graph.create_variable(
                name=f'{op.name}_yh_axes', value=np.asarray([0], np.int64),
                is_parameter=True), un)
            un.outputs.append(yh_out)
            yh_out.source_op = un
        delete_isolated(graph)
    return graph


def stem_space_to_depth(graph: BaseGraph, max_in_channels: int = 4):
    """Rewrite tiny-C_in stride-2 stem convolutions into a space-to-depth
    input packing + stride-1 conv — the classic TPU stem optimization
    (MLPerf ResNet practice). No reference counterpart (a CUDA backend
    doesn't need it): with C_in=3 a 7x7/2 conv leaves >95% of the MXU's
    128 input lanes idle; packing the stride-2 grid into channels
    quadruples the contraction depth and halves the spatial extent.

    The rewrite is EXACT (output-identical in fp32): for stride 2, output
    o[i] = sum_t w[t] x[2i + t - p] becomes, with x2[r, j] = x[2j + r],
    o[i] = sum_{a,r} w2[a, r] x2[r, i + a - c] where w2[a, r] = w[2a+r-2c+p]
    (taps outside [0, k) are zero). Quantization configs are untouched:
    the conv's activation TQC still quantizes the (permuted) same values,
    and the weight TQC is per-output-channel (axis 0), which the
    input-side rearrangement never mixes.

    Applies only when: 2-D Conv, group 1, dilation 1, strides (2, 2),
    symmetric pads (k//2) with odd k, C_in <= max_in_channels, even
    input H/W, and output spatial exactly (H/2, W/2). Returns the number
    of convs rewritten."""
    from ..core import TargetPlatform
    rewritten = 0
    for op in list(graph.operations.values()):
        if op.type != 'Conv':
            continue
        x_var, w_var = op.inputs[0], op.inputs[1]
        if x_var.is_parameter or not w_var.is_parameter:
            continue
        w = np.asarray(w_var.value)
        if w.ndim != 4:
            continue
        OC, C, kh, kw = w.shape
        if C > max_in_channels:
            continue
        if int(op.attributes.get('group', 1)) != 1:
            continue
        strides = [int(s) for s in op.attributes.get('strides', [1, 1])]
        dil = [int(d) for d in op.attributes.get('dilations', [1, 1])]
        pads = [int(p) for p in op.attributes.get('pads', [0, 0, 0, 0])]
        if strides != [2, 2] or dil != [1, 1]:
            continue
        if kh % 2 == 0 or kw % 2 == 0:
            continue
        py, px = kh // 2, kw // 2
        if pads != [py, px, py, px]:
            continue
        if x_var.shape is None or len(x_var.shape) != 4:
            continue
        H, W = int(x_var.shape[2]), int(x_var.shape[3])
        if H % 2 or W % 2:
            continue
        # onnx output size must equal exactly H/2 (guards pad arithmetic)
        if (H + 2 * py - kh) // 2 + 1 != H // 2 or \
                (W + 2 * px - kw) // 2 + 1 != W // 2:
            continue

        cy, cx = -(-py // 2), -(-px // 2)
        Ay = (kh - 1 - py + 2 * cy) // 2 + 1
        Ax = (kw - 1 - px + 2 * cx) // 2 + 1
        # packed weights: channel order (ry*2 + rx)*C + ci matches the
        # reshape/transpose chain below
        w2 = np.zeros((OC, 4 * C, Ay, Ax), dtype=w.dtype)
        for ry in range(2):
            for rx in range(2):
                for ay in range(Ay):
                    ty = 2 * ay + ry - 2 * cy + py
                    if not 0 <= ty < kh:
                        continue
                    for ax in range(Ax):
                        tx = 2 * ax + rx - 2 * cx + px
                        if not 0 <= tx < kw:
                            continue
                        w2[:, (ry * 2 + rx) * C:(ry * 2 + rx + 1) * C,
                           ay, ax] = w[:, :, ty, tx]
        w_var.value = np.ascontiguousarray(w2)
        w_var.shape = list(w2.shape)
        op.attributes['strides'] = [1, 1]
        op.attributes['pads'] = [cy, cx, Ay - 1 - cy, Ax - 1 - cx]
        if 'kernel_shape' in op.attributes:
            op.attributes['kernel_shape'] = [Ay, Ax]

        H2, W2 = H // 2, W // 2

        B0 = x_var.shape[0]

        def _ins(op_type, attrs, shape_param, tag, up_var, out_shape):
            o = graph.create_operation(
                op_type, name=f'{op.name}_s2d_{tag}',
                attributes=attrs, platform=TargetPlatform.FP32)
            graph.insert_op_between_var_and_op(o, up_var, op)
            if shape_param is not None:
                graph.connect(graph.create_variable(
                    name=f'{op.name}_s2d_{tag}_shape',
                    value=np.asarray(shape_param, np.int64),
                    is_parameter=True), o)
            link = op.inputs[0]
            link.shape = list(out_shape)
            return link

        # x (B,C,H,W) -> (B,C,H/2,2,W/2,2) -> (B,2,2,C,H/2,W/2)
        # -> (B,4C,H/2,W/2); batch rides as an onnx 0-copy dim so the
        # compiled graph stays batch-agnostic
        v = _ins('Reshape', {}, [0, C, H2, 2, W2, 2], 'r1', x_var,
                 [B0, C, H2, 2, W2, 2])
        v = _ins('Transpose', {'perm': [0, 3, 5, 1, 2, 4]}, None, 'tr', v,
                 [B0, 2, 2, C, H2, W2])
        v = _ins('Reshape', {}, [0, 4 * C, H2, W2], 'r2', v,
                 [B0, 4 * C, H2, W2])
        rewritten += 1
    return rewritten


def decompose_gemm(graph: BaseGraph):
    """Gemm → MatMul (+ Add) for backends without Gemm
    (ppq/IR/morph.py:1121)."""
    for op in list(graph.operations.values()):
        if op.type != 'Gemm':
            continue
        alpha = float(op.attributes.pop('alpha', 1.0))
        beta = float(op.attributes.pop('beta', 1.0))
        trans_a = int(op.attributes.pop('transA', 0))
        trans_b = int(op.attributes.pop('transB', 0))
        if trans_a:
            ppq_warning(f'decompose_gemm: {op.name} has transA=1, skipped')
            continue
        w = op.inputs[1]
        if trans_b and w.is_parameter and w.value is not None:
            w.value = np.ascontiguousarray(w.value.T)
        elif trans_b:
            ppq_warning(f'decompose_gemm: {op.name} transB on activation, skipped')
            continue
        if alpha != 1.0 and w.is_parameter:
            w.value = w.value * alpha
        op.type = 'MatMul'
        if len(op.inputs) > 2:
            bias = op.inputs[2]
            op.inputs.remove(bias)
            bias.dest_ops.remove(op)
            if beta != 1.0 and bias.value is not None:
                bias.value = bias.value * beta
            add = graph.create_operation('Add', platform=op.platform)
            graph.insert_op_on_var(add, op.outputs[0])
            graph.connect(bias, add)


# ============================================================== replacer ===


def replace_op_type(graph: BaseGraph, op: Operation, new_type: str,
                    attributes: Optional[dict] = None):
    op.type = new_type
    if attributes is not None:
        op.attributes = dict(attributes)


# thin namespaces for reference-style spelling ------------------------------

class GraphFormatter:
    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def format(self):
        format_graph(self.graph)


class GraphMerger:
    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def fuse_bn(self): fuse_bn(self.graph)
    def fuse_matmul_add(self): fuse_matmul_add(self.graph)
    def fuse_gelu(self): fuse_gelu(self.graph)
    def fuse_layernorm(self): fuse_layernorm(self.graph)
    def fuse_bias_add(self): fuse_bias_add(self.graph)
    def fuse_skiplayernorm(self): fuse_skiplayernorm(self.graph)
    def fuse_selfattention(self): fuse_selfattention(self.graph)
    def fuse_scale(self): fuse_scale(self.graph)


class GraphDecomposer:
    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def decompose_gemm(self): decompose_gemm(self.graph)
    def decompose_gru(self): decompose_gru(self.graph)
    def stem_space_to_depth(self): stem_space_to_depth(self.graph)
