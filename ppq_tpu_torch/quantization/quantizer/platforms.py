"""Concrete platform quantizers
(capability parity with ppq/quantization/quantizer/ — 17 platform classes;
see SURVEY.md §2.6).

TPU-native targets come first (INT8 / FP8 / INT4-weight-only / DSP-style
asym / power-of-2); the vendor-compat classes reproduce each reference
backend's quantization *semantics* (bits, symmetry, per-channel axes,
observers, fusion sets) so exported artifacts match what those runtimes
expect, while simulation always runs on the TPU executor.
"""

from __future__ import annotations

from ...core import (QP, LINEAR_ACTIVATIONS, QuantizationPolicy,
                     QuantizationStates, QuantizationVisibility,
                     RoundingPolicy, TargetPlatform,
                     TensorQuantizationConfig)
from ...ir import Operation
from .base import BaseQuantizer

_CONV_FAMILY = {'Conv', 'ConvTranspose', 'Gemm', 'MatMul', 'PPQBiasFusedMatMul'}


# ============================================================ TPU-native ====
class TPUInt8Quantizer(BaseQuantizer):
    """Flagship: symmetric INT8, per-channel weights, per-tensor activations.
    Matches the MXU int8 path: bf16 accumulate-free int8 matmuls with scale
    fusion in the epilogue. (semantics modeled on PPLCUDAQuantizer,
    ppq/quantization/quantizer/PPLQuantizer.py)"""

    target_platform = TargetPlatform.TPU_INT8
    act_observer = 'percentile'
    activation_fusion_types = set(LINEAR_ACTIVATIONS) | {'Gelu', 'Sigmoid', 'HardSwish'}


class TPUFP8Quantizer(BaseQuantizer):
    """E4M3 floating quant (reference: FP8Quantizer.py GraphCoreQuantizer:12)."""

    target_platform = TargetPlatform.TPU_FP8
    act_num_of_bits = 8
    act_exponent_bits = 4
    act_policy_bits = QP.PER_TENSOR | QP.FLOATING | QP.SYMMETRICAL
    act_observer = 'constant'
    w_num_of_bits = 8
    w_exponent_bits = 4
    w_policy_bits = QP.PER_TENSOR | QP.FLOATING | QP.SYMMETRICAL
    w_observer = 'floating'
    quant_operation_types = _CONV_FAMILY | {'LayerNormalization', 'Attention',
                                            'MultiHeadAttention'}


class TPUInt4WeightOnlyQuantizer(BaseQuantizer):
    """INT4 weight-only (activations stay bf16) — LLM-serving style."""

    target_platform = TargetPlatform.TPU_INT4_WEIGHT_ONLY
    w_num_of_bits = 4
    quant_operation_types = set(_CONV_FAMILY)

    def create_default_quant_config(self, op):
        cfg = super().create_default_quant_config(op)
        # weight-only: every activation config is disabled
        for var, c in zip(op.inputs, cfg.input_quantization_config):
            if not var.is_parameter:
                c.state = QuantizationStates.FP32
                c.visibility = QuantizationVisibility.INTERNAL
        for c in cfg.output_quantization_config:
            c.state = QuantizationStates.FP32
            c.visibility = QuantizationVisibility.INTERNAL
        return cfg


class TPUDSPInt8Quantizer(BaseQuantizer):
    """Asymmetric per-tensor INT8 — DSP-style semantics
    (reference: DSPQuantizer.py PPL_DSP_Quantizer)."""

    target_platform = TargetPlatform.TPU_DSP_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    w_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    act_observer = 'percentile'
    w_observer = 'minmax'


class PPLDSPTIQuantizer(TPUDSPInt8Quantizer):
    """DSP-TI semantics: per-channel symmetric computing-op weights on top
    of the asymmetric per-tensor DSP activations (reference:
    DSPQuantizer.py PPL_DSP_TI_Quantizer)."""

    target_platform = TargetPlatform.PPL_DSP_TI_INT8
    w_policy_bits = QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL


class TPUPowerOf2Quantizer(BaseQuantizer):
    """Power-of-2 scale symmetric INT8 (reference: NXP_Quantizer,
    FPGAQuantizer) — shift-only dequant."""

    target_platform = TargetPlatform.TPU_POWER_OF_2
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL | QP.POWER_OF_2
    w_policy_bits = QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL | QP.POWER_OF_2
    act_observer = 'minmax'


# ========================================================= vendor-compat ====
class TensorRTQuantizer(TPUInt8Quantizer):
    """(reference: TensorRTQuantizer.py:12)"""
    target_platform = TargetPlatform.TRT_INT8
    act_observer = 'kl'
    activation_fusion_types = set(LINEAR_ACTIVATIONS)


class TensorRTFP8Quantizer(TPUFP8Quantizer):
    """(reference: FP8Quantizer.py TensorRTQuantizer_FP8:107)"""
    target_platform = TargetPlatform.TRT_FP8


class GraphCoreFP8Quantizer(TPUFP8Quantizer):
    """(reference: FP8Quantizer.py GraphCoreQuantizer:12)"""
    target_platform = TargetPlatform.GRAPHCORE_FP8


class ORTQuantizer(BaseQuantizer):
    """ONNXRuntime QDQ semantics: asymmetric per-tensor activations,
    symmetric per-channel weights (reference: ORTQuantizer.py)."""
    target_platform = TargetPlatform.ORT_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    act_observer = 'percentile'


class OpenvinoQuantizer(TPUInt8Quantizer):
    """(reference: OpenvinoQuantizer)"""
    target_platform = TargetPlatform.OPENVINO_INT8
    act_observer = 'minmax'


class NCNNQuantizer(BaseQuantizer):
    """(reference: NCNNQuantizer) — sym per-channel weights, kl activations."""
    target_platform = TargetPlatform.NCNN_INT8
    act_observer = 'kl'
    quant_operation_types = set(_CONV_FAMILY)


class MNNQuantizer(NCNNQuantizer):
    target_platform = TargetPlatform.MNN_INT8


class SNPEQuantizer(TPUDSPInt8Quantizer):
    """(reference: PPL_DSP_TI_Quantizer / SNPE semantics)"""
    target_platform = TargetPlatform.SNPE_INT8


class RKNNPerTensorQuantizer(BaseQuantizer):
    """(reference: RKNN_PerTensorQuantizer)"""
    target_platform = TargetPlatform.RKNN_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    w_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    act_observer = 'minmax'


class RKNNPerChannelQuantizer(BaseQuantizer):
    target_platform = TargetPlatform.RKNN_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL


class TengineQuantizer(BaseQuantizer):
    """Tengine: strictly PER-TENSOR symmetric (reference
    TengineQuantizer.py:48,90 — the backend rejects per-channel)."""
    target_platform = TargetPlatform.TENGINE_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL
    w_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL
    act_observer = 'minmax'


class AscendQuantizer(BaseQuantizer):
    """(reference: AscendQuantizer) — per-tensor symmetric."""
    target_platform = TargetPlatform.ASCEND_INT8
    w_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL
    act_observer = 'minmax'
    quant_operation_types = set(_CONV_FAMILY) | {'AveragePool'}


class MetaxChannelwiseQuantizer(TPUInt8Quantizer):
    """(reference: MetaxQuantizer.py)"""
    target_platform = TargetPlatform.METAX_INT8_C
    act_observer = 'percentile'


class MetaxTensorwiseQuantizer(BaseQuantizer):
    target_platform = TargetPlatform.METAX_INT8_T
    w_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL


class NXPQuantizer(TPUPowerOf2Quantizer):
    """(reference: NXP_Quantizer) — power-of-2, half-up rounding quirk."""
    target_platform = TargetPlatform.NXP_INT8
    rounding_policy = RoundingPolicy.ROUND_HALF_UP


class FPGAQuantizer(TPUPowerOf2Quantizer):
    target_platform = TargetPlatform.FPGA_INT8


class AcademicQuantizer(BaseQuantizer):
    """Clean textbook INT8 for research (reference: AcademicQuantizer) —
    no fusion tricks, per-channel weights, asym activations."""
    target_platform = TargetPlatform.ACADEMIC_INT8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL
    act_observer = 'minmax'
    activation_fusion_types: set = set()


class ExtQuantizer(TPUInt8Quantizer):
    """User extension template (reference: MyQuantizer.py)."""
    target_platform = TargetPlatform.EXTENSION


# --------------------------------------------------------------- registry --
# reference: ppq/lib/common.py:22-44 __QUANTIZER_COLLECTION__
QUANTIZER_COLLECTION = {
    TargetPlatform.PPL_DSP_TI_INT8: PPLDSPTIQuantizer,
    TargetPlatform.TPU_INT8: TPUInt8Quantizer,
    TargetPlatform.TPU_FP8: TPUFP8Quantizer,
    TargetPlatform.TPU_INT4_WEIGHT_ONLY: TPUInt4WeightOnlyQuantizer,
    TargetPlatform.TPU_DSP_INT8: TPUDSPInt8Quantizer,
    TargetPlatform.TPU_POWER_OF_2: TPUPowerOf2Quantizer,
    TargetPlatform.TRT_INT8: TensorRTQuantizer,
    TargetPlatform.TRT_FP8: TensorRTFP8Quantizer,
    TargetPlatform.GRAPHCORE_FP8: GraphCoreFP8Quantizer,
    TargetPlatform.ORT_INT8: ORTQuantizer,
    TargetPlatform.OPENVINO_INT8: OpenvinoQuantizer,
    TargetPlatform.NCNN_INT8: NCNNQuantizer,
    TargetPlatform.MNN_INT8: MNNQuantizer,
    TargetPlatform.SNPE_INT8: SNPEQuantizer,
    TargetPlatform.RKNN_INT8: RKNNPerTensorQuantizer,
    TargetPlatform.TENGINE_INT8: TengineQuantizer,
    TargetPlatform.ASCEND_INT8: AscendQuantizer,
    TargetPlatform.METAX_INT8_C: MetaxChannelwiseQuantizer,
    TargetPlatform.METAX_INT8_T: MetaxTensorwiseQuantizer,
    TargetPlatform.NXP_INT8: NXPQuantizer,
    TargetPlatform.FPGA_INT8: FPGAQuantizer,
    TargetPlatform.ACADEMIC_INT8: AcademicQuantizer,
    TargetPlatform.EXTENSION: ExtQuantizer,
}


def register_network_quantizer(quantizer_cls, platform: TargetPlatform):
    """(reference: ppq/lib/extension.py register_network_quantizer)"""
    QUANTIZER_COLLECTION[platform] = quantizer_cls
