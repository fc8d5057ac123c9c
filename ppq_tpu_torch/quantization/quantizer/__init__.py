from .base import BaseQuantizer
from .platforms import (QUANTIZER_COLLECTION, AcademicQuantizer,
                        AscendQuantizer, ExtQuantizer, FPGAQuantizer,
                        GraphCoreFP8Quantizer, MetaxChannelwiseQuantizer,
                        MetaxTensorwiseQuantizer, MNNQuantizer, NCNNQuantizer,
                        NXPQuantizer, OpenvinoQuantizer, ORTQuantizer,
                        RKNNPerChannelQuantizer, RKNNPerTensorQuantizer,
                        SNPEQuantizer, TengineQuantizer, TensorRTFP8Quantizer,
                        TensorRTQuantizer, TPUDSPInt8Quantizer,
                        TPUFP8Quantizer, TPUInt4WeightOnlyQuantizer,
                        TPUInt8Quantizer, TPUPowerOf2Quantizer,
                        register_network_quantizer)

__all__ = [
    'BaseQuantizer', 'QUANTIZER_COLLECTION', 'register_network_quantizer',
    'TPUInt8Quantizer', 'TPUFP8Quantizer', 'TPUInt4WeightOnlyQuantizer',
    'TPUDSPInt8Quantizer', 'TPUPowerOf2Quantizer', 'TensorRTQuantizer',
    'TensorRTFP8Quantizer', 'GraphCoreFP8Quantizer', 'ORTQuantizer',
    'OpenvinoQuantizer', 'NCNNQuantizer', 'MNNQuantizer', 'SNPEQuantizer',
    'RKNNPerTensorQuantizer', 'RKNNPerChannelQuantizer', 'TengineQuantizer',
    'AscendQuantizer', 'MetaxChannelwiseQuantizer', 'MetaxTensorwiseQuantizer',
    'NXPQuantizer', 'FPGAQuantizer', 'AcademicQuantizer', 'ExtQuantizer',
]
