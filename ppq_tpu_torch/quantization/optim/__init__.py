"""The passes this slice of the port carries (the JAX package's other
passes are listed in ROADMAP.md)."""

from .base import (QuantizationOptimizationPass,
                   QuantizationOptimizationPipeline)
from .baking import ParameterBakingPass
from .calibration import (CalibrationHook, IsotoneCalibrationPass,
                          OperationObserver, RuntimeCalibrationPass)
from .fcalibration import (CompiledCalibrationPass,
                           compiled_calibration_supported)
from .parameters import ParameterQuantizePass, PassiveParameterQuantizePass
from .refine import (MishFusionPass, QuantAlignmentPass, QuantizeFusionPass,
                     QuantizeSimplifyPass, SwishFusionPass)
from .training import (AdaroundPass, BiasCorrectionPass, BlockRuntime,
                       LearnedStepSizePass, RoundTuningPass,
                       TrainableQuantDelegator, TrainingBasedPass)

__all__ = [
    'QuantizationOptimizationPass', 'QuantizationOptimizationPipeline',
    'ParameterBakingPass', 'CalibrationHook', 'IsotoneCalibrationPass',
    'OperationObserver', 'RuntimeCalibrationPass', 'CompiledCalibrationPass',
    'compiled_calibration_supported', 'ParameterQuantizePass',
    'PassiveParameterQuantizePass', 'MishFusionPass', 'QuantAlignmentPass',
    'QuantizeFusionPass', 'QuantizeSimplifyPass', 'SwishFusionPass',
    'AdaroundPass', 'BiasCorrectionPass', 'LearnedStepSizePass',
    'RoundTuningPass', 'TrainingBasedPass', 'BlockRuntime',
    'TrainableQuantDelegator',
]
