"""Quantization error analysis tools
(redesign of ppq/quantization/analyse/{graphwise,layerwise}.py).

graphwise_error_analyse — cumulative error: run the quantized graph and the
fp32 graph side by side, report per-op output SNR/cosine/MSE (errors
accumulate through the network, reference graphwise.py:64).

layerwise_error_analyse — isolated error: quantize exactly one op at a time
and measure its output error (reference layerwise.py:15).

statistical_analyse — per-op input/weight/output statistics records
(reference graphwise.py:186).

Port of ppq_tpu/quantization/analyse.py. Every analysis runs the port's
compiled executor where `compilable(graph)` holds and the eager
TorchExecutor otherwise, on the card unless the caller names another
device. The compared tensors stay on the device until the scalar metrics,
which are computed there in float32 (SNR, cosine, MSE) or float64 (the
QuantZoo errors and the statistics), as the JAX package computes them on
the host. A whole-graph analysis captures one CUDA graph for the quantized
graph and one for the fp32 graph. `layerwise_error_analyse` runs the eager
executor always: it runs two forwards for every op it isolates, and a
compiled graph built for each would be walked once and dropped (where the
JAX package builds two compiled programs an op).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from ..core import QuantizationStates, ppq_info
from ..executor.compile import CompiledGraph, compilable
from ..executor.executor import TorchExecutor, resolve_device
from ..ir import (BaseGraph, QuantableOperation, dequantize_graph,
                  restore_graph_quantization)
from .measure import (torch_cosine_similarity, torch_mean_square_error,
                      torch_snr_error)

METRICS = {
    'snr': torch_snr_error,
    'cosine': torch_cosine_similarity,
    'mse': torch_mean_square_error,
}


def _batches(dataloader, collate_fn, limit):
    n = 0
    for batch in dataloader:
        if collate_fn is not None:
            batch = collate_fn(batch)
        yield batch
        n += 1
        if n >= limit:
            break


def _feed(graph, batch):
    names = list(graph.inputs.keys())
    if isinstance(batch, dict):
        return batch
    if isinstance(batch, (list, tuple)):
        return dict(zip(names, batch))
    return {names[0]: batch}


def _forward(graph: BaseGraph, names: List[str], device) -> Callable:
    """fn(batch) -> [the values of `names`] as float32 tensors on `device`:
    the compiled runner where the graph compiles (captured per input shape
    on the card), else the eager executor."""
    ok, _ = compilable(graph)
    if ok:
        runner = CompiledGraph(graph, output_names=names,
                               device=device).make_runner()
        return lambda batch: runner(_feed(graph, batch))
    return _eager(TorchExecutor(graph, device=device), graph, names)


def _eager(executor: TorchExecutor, graph: BaseGraph,
           names: List[str]) -> Callable:
    return lambda batch: [
        v.to(torch.float32) for v in executor.forward(
            _feed(graph, batch), output_names=names)]


def _interested_outputs(graph: BaseGraph) -> List[str]:
    names = []
    for op in graph.topological_sort():
        if isinstance(op, QuantableOperation) and op.outputs:
            cfg = op.config.output_quantization_config[0]
            if cfg.state != QuantizationStates.FP32:
                names.append(op.outputs[0].name)
    return names


def graphwise_error_analyse(graph: BaseGraph, dataloader: Iterable,
                            collate_fn=None, steps: int = 8,
                            method: str = 'snr',
                            verbose: bool = True,
                            device=None) -> Dict[str, float]:
    """Cumulative per-op quantization error (reference graphwise.py:64).
    Returns {op output variable: metric} ordered by execution."""
    device = resolve_device(device)
    metric_fn = METRICS[method]
    names = _interested_outputs(graph)
    if not names:
        return {}

    fwd_q = _forward(graph, names, device)
    results: Dict[str, List[float]] = {n: [] for n in names}
    q_outs_all = [fwd_q(batch)
                  for batch in _batches(dataloader, collate_fn, steps)]
    del fwd_q

    dequantize_graph(graph)
    try:
        fwd_f = _forward(graph, names, device)
        for i, batch in enumerate(_batches(dataloader, collate_fn, steps)):
            for name, fv, qv in zip(names, fwd_f(batch), q_outs_all[i]):
                m = float(metric_fn(qv.reshape(1, -1), fv.reshape(1, -1)))
                results[name].append(m)
    finally:
        restore_graph_quantization(graph)

    report = {n: float(np.mean(v)) for n, v in results.items()}
    if verbose:
        _print_report(graph, report, method)
    return report


def _relative_error(qv: torch.Tensor, fv: torch.Tensor) -> float:
    """||q - f||_F / ||f||_F in float64."""
    qv, fv = qv.to(torch.float64), fv.to(torch.float64)
    denom = float(torch.linalg.vector_norm(fv.reshape(-1)))
    return float(torch.linalg.vector_norm((qv - fv).reshape(-1))) \
        / max(denom, 1e-12)


def quantzoo_error_analyse(graph: BaseGraph, dataloader: Iterable,
                           collate_fn=None, steps: int = 8,
                           verbose: bool = True,
                           device=None) -> Dict[str, float]:
    """OnnxQuant/QuantZoo protocol metrics (reference
    samples/QuantZoo/Readme.md:214-227):

    Per computing layer (Conv/Gemm/MatMul/ConvTranspose/LayerNorm), the
    RELATIVE error ||A - B||_F / ||B||_F between the quantized network's
    layer output A and the float network's corresponding output B
    (cumulative — the quantized net runs as a whole).

      AQE — mean of the per-layer relative errors
      MQE — max  of the per-layer relative errors
      OQE — max relative error over the graph's OUTPUT variables

    Returns {'AQE', 'MQE', 'OQE', 'per_layer': {var: rel_err}}.
    """
    device = resolve_device(device)
    computing = {'Conv', 'Gemm', 'MatMul', 'ConvTranspose',
                 'LayerNormalization', 'PPQBiasFusedMatMul'}
    names = []
    for op in graph.topological_sort():
        if isinstance(op, QuantableOperation) and op.type in computing \
                and op.outputs:
            names.append(op.outputs[0].name)
    out_names = [n for n in graph.outputs]
    probe = list(dict.fromkeys(names + out_names))
    if not probe:
        return {'AQE': 0.0, 'MQE': 0.0, 'OQE': 0.0, 'per_layer': {}}

    fwd_q = _forward(graph, probe, device)
    q_outs_all = [fwd_q(batch)
                  for batch in _batches(dataloader, collate_fn, steps)]
    del fwd_q

    dequantize_graph(graph)
    rel: Dict[str, List[float]] = {n: [] for n in probe}
    try:
        fwd_f = _forward(graph, probe, device)
        for i, batch in enumerate(_batches(dataloader, collate_fn, steps)):
            for name, fv, qv in zip(probe, fwd_f(batch), q_outs_all[i]):
                rel[name].append(_relative_error(qv, fv))
    finally:
        restore_graph_quantization(graph)

    per_layer = {n: float(np.mean(rel[n])) for n in names}
    out_errs = [float(np.mean(rel[n])) for n in out_names if rel.get(n)]
    result = {
        'AQE': float(np.mean(list(per_layer.values()))) if per_layer else 0.0,
        'MQE': float(np.max(list(per_layer.values()))) if per_layer else 0.0,
        'OQE': float(np.max(out_errs)) if out_errs else 0.0,
        'per_layer': per_layer,
    }
    if verbose:
        ppq_info(f"QuantZoo protocol: AQE {result['AQE']:.4f}  "
                 f"MQE {result['MQE']:.4f}  OQE {result['OQE']:.4f} "
                 f"({len(per_layer)} computing layers)")
    return result


def layerwise_error_analyse(graph: BaseGraph, dataloader: Iterable,
                            collate_fn=None, steps: int = 8,
                            method: str = 'snr',
                            interested_ops=None,
                            verbose: bool = True,
                            device=None) -> Dict[str, float]:
    """Isolated per-op error: only one op quantized at a time
    (reference layerwise.py:15, incl. its interested_outputs scoping).
    Returns {op name: metric}. interested_ops: optional iterable of op
    names to analyse — each isolated op costs two eager forwards of every
    batch, so scoping matters on big graphs."""
    device = resolve_device(device)
    metric_fn = METRICS[method]
    qops = [op for op in graph.topological_sort()
            if isinstance(op, QuantableOperation)]
    if interested_ops is not None:
        keep = set(interested_ops)
        qops = [op for op in qops if op.name in keep]
    if not qops:
        return {}

    batches = list(_batches(dataloader, collate_fn, steps))

    # fp32 reference outputs of every analysed op
    dequantize_graph(graph)
    executor = TorchExecutor(graph, device=device)
    report: Dict[str, float] = {}
    try:
        for op in qops:
            if not op.outputs:
                continue
            out_name = op.outputs[0].name
            fwd_f = _eager(executor, graph, [out_name])
            fp_vals = [fwd_f(b)[0] for b in batches]

            # re-quantize just this op
            op.restore_quantize_state()
            fwd_q = _eager(executor, graph, [out_name])
            ms = []
            for b, fv in zip(batches, fp_vals):
                qv = fwd_q(b)[0]
                ms.append(float(metric_fn(qv.reshape(1, -1),
                                          fv.reshape(1, -1))))
            report[op.name] = float(np.mean(ms))
            op.dequantize()
            del fwd_f, fwd_q, fp_vals
    finally:
        restore_graph_quantization(graph)
    if verbose:
        items = sorted(report.items(), key=lambda kv: -kv[1])
        ppq_info(f'Layerwise error analysis ({method}), worst first:')
        for name, v in items[:20]:
            ppq_info(f'  {name:<40s} {v:.6f}')
    return report


def statistical_analyse(graph: BaseGraph, dataloader: Iterable,
                        collate_fn=None, steps: int = 8,
                        device=None) -> List[dict]:
    """Per-op statistics records (reference graphwise.py:186): input/weight/
    output value ranges, mean/std, and quantization error decomposition."""
    device = resolve_device(device)
    names = _interested_outputs(graph)
    fwd_q = _forward(graph, names, device)
    acc: Dict[str, dict] = {}
    for batch in _batches(dataloader, collate_fn, steps):
        for n, v in zip(names, fwd_q(batch)):
            v = v.to(torch.float64)
            rec = acc.setdefault(n, {'min': np.inf, 'max': -np.inf,
                                     'sum': 0.0, 'sq': 0.0, 'count': 0})
            rec['min'] = min(rec['min'], float(v.min()))
            rec['max'] = max(rec['max'], float(v.max()))
            rec['sum'] += float(v.sum())
            rec['sq'] += float(torch.square(v).sum())
            rec['count'] += v.numel()
    records = []
    var_to_op = {op.outputs[0].name: op for op in graph.operations.values()
                 if op.outputs}
    for n, rec in acc.items():
        mean = rec['sum'] / rec['count']
        var = rec['sq'] / rec['count'] - mean * mean
        op = var_to_op.get(n)
        records.append({
            'variable': n, 'op': op.name if op else None,
            'type': op.type if op else None,
            'min': rec['min'], 'max': rec['max'],
            'mean': mean, 'std': float(np.sqrt(max(var, 0.0))),
        })
    return records


def variable_analyse(graph: BaseGraph, var_name: str, dataloader,
                     collate_fn=None, steps: int = 8, bins: int = 64,
                     device=None) -> np.ndarray:
    """Histogram dump of one variable's values (reference layerwise.py:137),
    binned on the host as the JAX package bins them."""
    device = resolve_device(device)
    fwd = _forward(graph, [var_name], device)
    samples = [fwd(batch)[0].detach().cpu().numpy().ravel()
               for batch in _batches(dataloader, collate_fn, steps)]
    hist, _ = np.histogram(np.concatenate(samples), bins=bins)
    return hist


def parameter_analyse(graph: BaseGraph) -> List[dict]:
    """Weight statistics per parameter (reference layerwise.py:179)."""
    records = []
    for name, var in graph.variables.items():
        if not var.is_parameter or not var.has_value:
            continue
        v = np.asarray(var.value, np.float64)
        if not np.issubdtype(v.dtype, np.floating) or v.size == 0:
            continue
        records.append({
            'parameter': name, 'shape': list(v.shape),
            'min': float(v.min()), 'max': float(v.max()),
            'mean': float(v.mean()), 'std': float(v.std()),
        })
    return records


def _print_report(graph: BaseGraph, report: Dict[str, float], method: str):
    var_to_op = {}
    for op in graph.operations.values():
        for v in op.outputs:
            var_to_op[v.name] = op
    ppq_info(f'Graphwise error analysis ({method}):')
    for name, value in report.items():
        op = var_to_op.get(name)
        bar = '█' * int(min(value, 1.0) * 40) if method != 'cosine' else ''
        ppq_info(f'  {op.name if op else name:<36s} {value:>10.6f} {bar}')
