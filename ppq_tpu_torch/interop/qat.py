"""Carry the JAX package's flax QAT variables (ppq_tpu/qat.py) into the
port's QAT layers (ppq_tpu_torch/qat.py) and back, as numpy arrays.

A flax QConv keeps {'act_scale', 'conv': {'kernel' (HWIO), 'bias'}} under
'params' and {'absmax'} under 'qat_stats'; a QDense {'act_scale', 'kernel'
(in, out), 'bias'}. The port's QConv2d holds an OIHW weight and QLinear an
(out, in) one. `modules` maps each flax submodule name to the port's layer;
a lone flax layer, whose variables sit at the top of the tree, takes the
name ''.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _layer_arrays(layer) -> Dict[str, np.ndarray]:
    from ..qat import QConv2d
    weight = layer.weight.detach().cpu().numpy()
    if isinstance(layer, QConv2d):
        kernel = {'conv': {'kernel': weight.transpose(2, 3, 1, 0),
                           'bias': layer.bias.detach().cpu().numpy()}}
    else:
        kernel = {'kernel': weight.T, 'bias': layer.bias.detach().cpu().numpy()}
    return dict(act_scale=layer.act_scale.detach().cpu().numpy(), **kernel)


def qat_params_from_flax(variables, modules: Dict[str, torch.nn.Module]):
    """Load flax variables ({'params': ..., 'qat_stats': ...}) into the
    port's layers, in place, on each layer's device."""
    from ..qat import QConv2d
    params = variables.get('params', {})
    stats = variables.get('qat_stats', {})
    for name, layer in modules.items():
        p = params[name] if name else params
        s = (stats.get(name, {}) if name else stats) or {}
        if isinstance(layer, QConv2d):
            weight = np.asarray(p['conv']['kernel']).transpose(3, 2, 0, 1)
            bias = np.asarray(p['conv']['bias'])
        else:
            weight = np.asarray(p['kernel']).T
            bias = np.asarray(p['bias'])
        with torch.no_grad():
            for target, value in ((layer.weight, weight), (layer.bias, bias),
                                  (layer.act_scale, p['act_scale'])):
                if tuple(target.shape) != tuple(np.shape(value)):
                    raise ValueError(f'{name or "layer"}: shape '
                                     f'{np.shape(value)} for '
                                     f'{tuple(target.shape)}')
                target.copy_(torch.as_tensor(np.asarray(value, np.float32)))
            if 'absmax' in s:
                layer.absmax.copy_(torch.as_tensor(
                    np.asarray(s['absmax'], np.float32)))
    return modules


def qat_params_to_flax(modules: Dict[str, torch.nn.Module]):
    """The port's layers as flax variables of numpy arrays."""
    params, stats = {}, {}
    for name, layer in modules.items():
        arrays = _layer_arrays(layer)
        absmax = {'absmax': layer.absmax.detach().cpu().numpy()}
        if name:
            params[name], stats[name] = arrays, absmax
        else:
            params, stats = arrays, absmax
    return {'params': params, 'qat_stats': stats}
