"""PFL: the registry-based expert API (ppq_tpu/lib.py; redesign of
ppq/lib/quant.py:19-217 and ppq/lib/extension.py), over the port's
registries.

Usage mirrors the reference's `from ppq.lib import *` power-user surface:

    from ppq_tpu_torch import lib as PFL
    quantizer = PFL.Quantizer(platform, graph)
    dispatcher = PFL.Dispatcher(graph, 'conservative')
    exporter   = PFL.Exporter(platform)
    pipeline   = PFL.Pipeline([...])

`QuantFunction` fake-quantizes a torch tensor where it lies: on the card it
launches the fake-quant kernels (rows 1 and 2 of the kernel table, and the
floating kernel's tensorwise and channelwise bodies, row 6), on the CPU
their plain versions. `ParameterQuant` calibrates on the host, as the
observers do for parameters.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .core import (QP, QuantizationPolicy, RoundingPolicy, TargetPlatform,
                   TensorQuantizationConfig)
from .ir import BaseGraph
from .quantization.observers import OBSERVER_TABLE, build_observer
from .quantization.optim import (QuantizationOptimizationPass,
                                 QuantizationOptimizationPipeline)
from .quantization.qfunction import ppq_fake_quant
from .quantization.quantizer import (QUANTIZER_COLLECTION, BaseQuantizer,
                                     register_network_quantizer)
from .scheduler import DISPATCHER_TABLE


# --------------------------------------------------------------- factories --
def Quantizer(platform: TargetPlatform, graph: BaseGraph) -> BaseQuantizer:
    """(reference lib/quant.py:19)"""
    if platform not in QUANTIZER_COLLECTION:
        raise KeyError(f'No quantizer registered for {platform.name}')
    return QUANTIZER_COLLECTION[platform](graph)


def Dispatcher(graph: BaseGraph, method: str = 'conservative'):
    """(reference lib/quant.py:112)"""
    method = method.lower()
    if method not in DISPATCHER_TABLE:
        raise KeyError(f'Unknown dispatcher {method!r}')
    return DISPATCHER_TABLE[method](graph)


def Exporter(platform: TargetPlatform):
    """(reference lib/quant.py:194)"""
    from .frontends import EXPORTER_COLLECTION
    if platform not in EXPORTER_COLLECTION:
        raise KeyError(f'No exporter registered for {platform.name}')
    return EXPORTER_COLLECTION[platform]()


def Parser(framework: str = 'onnx'):
    """(reference lib/quant.py:180)"""
    from .frontends import PARSER_COLLECTION
    if framework not in PARSER_COLLECTION:
        raise KeyError(f'No parser registered for {framework!r}')
    return PARSER_COLLECTION[framework]()


def Observer(config: TensorQuantizationConfig):
    """(reference lib/quant.py:151)"""
    return build_observer(config)


def Pipeline(passes: List[QuantizationOptimizationPass]
             ) -> QuantizationOptimizationPipeline:
    """(reference lib/quant.py:166)"""
    return QuantizationOptimizationPipeline(passes)


def QuantFunction(tensor, config: TensorQuantizationConfig):
    """(reference lib/quant.py:210) `tensor` is a torch tensor, on the card
    or on the CPU; the result lies beside it."""
    return ppq_fake_quant(tensor, config)


# ------------------------------------------------------------ config makers --
def LinearQuantizationConfig(
        symmetrical: bool = True, dynamic: bool = False,
        power_of_2: bool = False, channel_axis: Optional[int] = None,
        quant_min: int = -128, quant_max: int = 127, num_of_bits: int = 8,
        calibration: str = 'minmax',
        rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
        ) -> TensorQuantizationConfig:
    """(reference lib/quant.py:40)"""
    bits = QP.LINEAR
    bits |= QP.SYMMETRICAL if symmetrical else QP.ASYMMETRICAL
    bits |= QP.PER_TENSOR if channel_axis is None else QP.PER_CHANNEL
    if power_of_2:
        bits |= QP.POWER_OF_2
    if dynamic:
        bits |= QP.DYNAMIC
    return TensorQuantizationConfig(
        policy=QuantizationPolicy(bits), rounding=rounding,
        num_of_bits=num_of_bits, quant_min=quant_min, quant_max=quant_max,
        observer_algorithm=calibration, channel_axis=channel_axis)


def FloatingQuantizationConfig(
        exponent_bits: int = 4, mantissa_bits: int = 3,
        quant_min: float = -448.0, quant_max: float = 448.0,
        channel_axis: Optional[int] = None,
        calibration: str = 'constant') -> TensorQuantizationConfig:
    """(reference lib/quant.py:76)"""
    bits = QP.FLOATING | QP.SYMMETRICAL
    bits |= QP.PER_TENSOR if channel_axis is None else QP.PER_CHANNEL
    return TensorQuantizationConfig(
        policy=QuantizationPolicy(bits),
        num_of_bits=1 + exponent_bits + mantissa_bits,
        exponent_bits=exponent_bits,
        quant_min=quant_min, quant_max=quant_max,
        observer_algorithm=calibration, channel_axis=channel_axis)


# --------------------------------------------------------- manual quant ops --
def TensorQuant(graph: BaseGraph, var_name: str,
                config: TensorQuantizationConfig):
    """Manually attach a quant config to one variable's consumers
    (reference lib/quant.py:217 TensorQuant). Requires the consumers to be
    QuantableOperations; returns how many took it."""
    from .ir import QuantableOperation
    var = graph.variables[var_name]
    touched = 0
    for dest in var.dest_ops:
        if isinstance(dest, QuantableOperation):
            idx = dest.inputs.index(var)
            dest.config.input_quantization_config[idx] = config
            touched += 1
    return touched


def ParameterQuant(graph: BaseGraph, var_name: str,
                   config: TensorQuantizationConfig):
    """Calibrate + attach a config to a parameter (reference lib/quant.py)."""
    var = graph.variables[var_name]
    if not var.is_parameter:
        raise ValueError(f'{var_name} is not a parameter')
    obs = build_observer(config)
    obs.observe(np.asarray(var.value, np.float32))
    obs.render_quantization_config()
    return TensorQuant(graph, var_name, config)


# ------------------------------------------------------------- registration --
from .executor.base import register_operation_handler  # noqa: E402
from .frontends import (register_network_exporter,  # noqa: E402
                        register_network_parser)

register_calibration_observer = OBSERVER_TABLE.__setitem__

__all__ = [
    'Quantizer', 'Dispatcher', 'Exporter', 'Parser', 'Observer', 'Pipeline',
    'QuantFunction', 'LinearQuantizationConfig', 'FloatingQuantizationConfig',
    'TensorQuant', 'ParameterQuant', 'register_network_quantizer',
    'register_network_parser', 'register_network_exporter',
    'register_operation_handler', 'register_calibration_observer',
]
