"""The optimization passes (the JAX package's, by the same names)."""

from .base import (QuantizationOptimizationPass,
                   QuantizationOptimizationPipeline)
from .baking import ParameterBakingPass
from .calibration import (CalibrationHook, IsotoneCalibrationPass,
                          OperationObserver, RuntimeCalibrationPass)
from .fcalibration import (CompiledCalibrationPass,
                           compiled_calibration_supported)
from .parameters import ParameterQuantizePass, PassiveParameterQuantizePass
from .equalization import (ActivationEqualizationPass, ChannelwiseSplitPass,
                           LayerwiseEqualizationPass)
from .experimental import LearningToCalibPass, MatrixFactorizationPass
from .extension import ExtensionPass
from .morph import (GRUSplitPass, HorizontalLayerSplitPass,
                    StemSpaceToDepthPass,
                    NCNNFormatGemmPass, NXPResizeModeChangePass)
from .refine import (MishFusionPass, QuantAlignmentPass, QuantizeFusionPass,
                     QuantizeSimplifyPass, SwishFusionPass)
from .ssd import SSDEqualizationPass
from .vendor import (MetaxGemmSplitPass, NxpInputRoundingRefinePass,
                     NxpQuantizeFusionPass, PPLCudaAddConvReluMerge,
                     PPLDSPTIReCalibrationPass)
from .training import (AdaroundPass, BiasCorrectionPass, BlockRuntime,
                       LearnedStepSizePass, RoundTuningPass,
                       TrainableQuantDelegator, TrainingBasedPass)

__all__ = [
    'QuantizationOptimizationPass', 'QuantizationOptimizationPipeline',
    'ParameterBakingPass', 'CalibrationHook', 'IsotoneCalibrationPass',
    'OperationObserver', 'RuntimeCalibrationPass', 'ParameterQuantizePass',
    'PassiveParameterQuantizePass', 'MishFusionPass', 'QuantAlignmentPass',
    'QuantizeFusionPass', 'QuantizeSimplifyPass', 'SwishFusionPass',
    'CompiledCalibrationPass', 'compiled_calibration_supported',
    'ActivationEqualizationPass', 'ChannelwiseSplitPass',
    'LayerwiseEqualizationPass', 'ExtensionPass', 'GRUSplitPass',
    'StemSpaceToDepthPass',
    'HorizontalLayerSplitPass', 'NCNNFormatGemmPass',
    'NXPResizeModeChangePass', 'SSDEqualizationPass', 'AdaroundPass',
    'BiasCorrectionPass', 'LearnedStepSizePass', 'RoundTuningPass',
    'TrainingBasedPass', 'LearningToCalibPass', 'MatrixFactorizationPass',
    'MetaxGemmSplitPass', 'NxpInputRoundingRefinePass',
    'NxpQuantizeFusionPass', 'PPLCudaAddConvReluMerge',
    'PPLDSPTIReCalibrationPass', 'BlockRuntime', 'TrainableQuantDelegator',
]
