"""Parameters and TQCs as plain dictionaries, in and out of a graph.

    parameters:  {variable name: np.ndarray}
    TQCs:        {(op name, 'in' | 'out', index):
                      {'scale': np.ndarray | None, 'offset': np.ndarray | None,
                       'state': QuantizationStates name,
                       'policy': int (the QuantizationPolicy bits, which say
                                 linear or floating), 'exponent_bits': int,
                       'num_of_bits': int, 'quant_min', 'quant_max'}}
    block caches: [{variable name: np.ndarray}], one dict per cached batch
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import QuantizationPolicy, QuantizationStates
from ..ir import BaseGraph, QuantableOperation

ConfigKey = Tuple[str, str, int]


def parameters_of(graph) -> Dict[str, np.ndarray]:
    """Every parameter value of a graph, copied."""
    return {name: np.array(var.value, copy=True)
            for name, var in graph.variables.items()
            if var.is_parameter and var.has_value}


def load_parameters(graph: BaseGraph, params: Dict[str, np.ndarray]) -> None:
    """Overwrite the graph's parameters by name; shapes must agree."""
    for name, value in params.items():
        var = graph.variables.get(name)
        if var is None or not var.is_parameter:
            raise KeyError(f'{name!r} is not a parameter of graph {graph.name!r}')
        value = np.array(value, copy=True)
        if var.has_value and np.shape(var.value) != value.shape:
            raise ValueError(f'{name}: shape {value.shape} does not match '
                             f'{np.shape(var.value)}')
        var.value = value


def _configs(op, side: str):
    if side == 'in':
        return op.config.input_quantization_config
    if side == 'out':
        return op.config.output_quantization_config
    raise ValueError(f"side must be 'in' or 'out', got {side!r}")


def quantization_configs_of(graph) -> Dict[ConfigKey, dict]:
    """Scale, offset and state of every TQC of every quantized op. A TQC
    dominated by another reports its dominator's scale and offset."""
    out: Dict[ConfigKey, dict] = {}
    for op in graph.operations.values():
        if not hasattr(op, 'config'):
            continue
        for side in ('in', 'out'):
            for idx, cfg in enumerate(_configs(op, side)):
                has = cfg.has_scale
                out[(op.name, side, idx)] = {
                    'scale': np.array(cfg.scale, copy=True) if has else None,
                    'offset': np.array(cfg.offset, copy=True) if has else None,
                    'state': cfg.state.name,
                    'policy': int(cfg.policy),
                    'exponent_bits': int(cfg.exponent_bits),
                    'num_of_bits': int(cfg.num_of_bits),
                    'quant_min': cfg.quant_min, 'quant_max': cfg.quant_max,
                }
    return out


def load_quantization_configs(graph: BaseGraph,
                              configs: Dict[ConfigKey, dict]) -> None:
    """Set the state of every named TQC, its policy, bit layout and range
    where the entry carries them, and the scale and offset of those that
    are their own root. Dominated TQCs read their root's, so the graph must
    have the sharing links of the graph the configs came from (the same
    quantizer and passes build the same links)."""
    for (op_name, side, idx), entry in configs.items():
        op = graph.operations.get(op_name)
        if not isinstance(op, QuantableOperation):
            raise KeyError(f'{op_name!r} is not a quantized op of graph '
                           f'{graph.name!r}')
        cfg = _configs(op, side)[idx]
        cfg.state = QuantizationStates[entry['state']]
        if 'policy' in entry:
            cfg.policy = QuantizationPolicy(entry['policy'])
            cfg.exponent_bits = entry['exponent_bits']
            cfg.num_of_bits = entry['num_of_bits']
            cfg.quant_min = entry['quant_min']
            cfg.quant_max = entry['quant_max']
        if cfg.is_root and entry['scale'] is not None:
            cfg.scale = np.asarray(entry['scale'], np.float32)
            cfg.offset = np.asarray(entry['offset'], np.float32)


def block_caches_to_numpy(cache) -> List[Dict[str, np.ndarray]]:
    """A training pass's block cache (quantized block inputs or fp32 block
    targets; tensors or arrays) as host numpy, one dict per batch."""
    return [{name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for name, v in batch.items()}
            for batch in cache]


def block_caches_from_numpy(cache, device) -> List[Dict[str, torch.Tensor]]:
    """Host numpy block caches as tensors on `device`, as the port's
    training passes keep them."""
    return [{name: torch.as_tensor(np.array(v, copy=True), device=device)
             for name, v in batch.items()} for batch in cache]
