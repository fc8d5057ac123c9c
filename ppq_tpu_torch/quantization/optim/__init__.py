"""The passes this slice of the port carries (the JAX package's other
passes are listed in ROADMAP.md)."""

from .base import (QuantizationOptimizationPass,
                   QuantizationOptimizationPipeline)
from .baking import ParameterBakingPass
from .calibration import (CalibrationHook, IsotoneCalibrationPass,
                          OperationObserver, RuntimeCalibrationPass)
from .parameters import ParameterQuantizePass, PassiveParameterQuantizePass
from .refine import (MishFusionPass, QuantAlignmentPass, QuantizeFusionPass,
                     QuantizeSimplifyPass, SwishFusionPass)

__all__ = [
    'QuantizationOptimizationPass', 'QuantizationOptimizationPipeline',
    'ParameterBakingPass', 'CalibrationHook', 'IsotoneCalibrationPass',
    'OperationObserver', 'RuntimeCalibrationPass', 'ParameterQuantizePass',
    'PassiveParameterQuantizePass', 'MishFusionPass', 'QuantAlignmentPass',
    'QuantizeFusionPass', 'QuantizeSimplifyPass', 'SwishFusionPass',
]
