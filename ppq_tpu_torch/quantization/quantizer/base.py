"""BaseQuantizer — platform policy + the end-to-end quantize() driver
(redesign of ppq/quantization/quantizer/base.py:16-392).

A quantizer owns three things:
  1. the *policy* of its target platform (bits, sym/asym, per-channel axes,
     observers, quantable op set, activation fusion set) expressed as class
     attributes;
  2. `init_quantize_config(op)` — materializes per-op TQCs from the
     OpSocket model (SOI/FP32 inputs pre-marked, weights per-channel, bias
     passive 32-bit);
  3. the pipeline builders translating QuantizationSetting flags into the
     ordered pass list.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Set

from ...core import (COMPUTING_OP, LINEAR_ACTIVATIONS, PASSIVE_OPERATIONS,
                     PPQ_TPU_CONFIG, QP, DataType, OperationQuantizationConfig,
                     QuantizationPolicy, QuantizationStates,
                     QuantizationVisibility, RoundingPolicy, TargetPlatform,
                     TensorQuantizationConfig, ppq_info, ppq_warning)
from ...ir import (BaseGraph, Operation, QuantableOperation,
                   quantize_operation, socket_of)
from ..optim import (IsotoneCalibrationPass, ParameterBakingPass,
                     ParameterQuantizePass, PassiveParameterQuantizePass,
                     QuantAlignmentPass, QuantizationOptimizationPipeline,
                     QuantizeFusionPass, QuantizeSimplifyPass,
                     RuntimeCalibrationPass, MishFusionPass, SwishFusionPass)


class BaseQuantizer:
    """(reference quantizer/base.py:16)"""

    # ---------------- platform policy: override in subclasses ----------------
    target_platform: TargetPlatform = TargetPlatform.TPU_INT8
    default_platform: TargetPlatform = TargetPlatform.FP32
    rounding_policy: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN

    # activations
    act_num_of_bits: int = 8
    act_policy_bits = QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL
    act_observer: str = 'percentile'
    act_exponent_bits: int = 0

    # weights
    w_num_of_bits: int = 8
    w_policy_bits = QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL
    w_observer: str = 'minmax'
    w_exponent_bits: int = 0

    # bias
    bias_bits: int = 32

    quant_operation_types: Set[str] = {
        'Conv', 'ConvTranspose', 'Gemm', 'MatMul', 'PPQBiasFusedMatMul',
        'Relu', 'PRelu', 'Clip', 'Sigmoid', 'LeakyRelu', 'HardSwish',
        'HardSigmoid', 'Gelu',
        'Add', 'Sub', 'Mul', 'Div', 'Sum', 'Max', 'Min',
        'MaxPool', 'GlobalMaxPool', 'AveragePool', 'GlobalAveragePool',
        'Resize', 'Interp', 'Upsample',
        'Concat', 'Split', 'Slice', 'Pad', 'Reshape', 'Flatten', 'Squeeze',
        'Unsqueeze', 'Transpose', 'Gather', 'ReduceMean', 'ReduceSum',
        'Softmax', 'LayerNormalization',
    }
    activation_fusion_types: Set[str] = set(LINEAR_ACTIVATIONS)

    def __init__(self, graph: BaseGraph):
        self.graph = graph
        self._verbose = True

    # ------------------------------------------------------------- ranges
    @staticmethod
    def int_range(bits: int, symmetric: bool):
        if symmetric:
            return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        return 0, (1 << bits) - 1

    # ------------------------------------------------- default TQC creation
    def build_act_config(self) -> TensorQuantizationConfig:
        policy = QuantizationPolicy(self.act_policy_bits)
        qmin, qmax = self.int_range(self.act_num_of_bits, policy.symmetric)
        if policy.floating:
            qmin, qmax = -448.0, 448.0  # E4M3 default; refined by subclass
        return TensorQuantizationConfig(
            policy=policy, rounding=self.rounding_policy,
            num_of_bits=self.act_num_of_bits, quant_min=qmin, quant_max=qmax,
            exponent_bits=self.act_exponent_bits,
            observer_algorithm=self.act_observer)

    def build_weight_config(self, channel_axis: Optional[int]) -> TensorQuantizationConfig:
        policy = QuantizationPolicy(self.w_policy_bits)
        qmin, qmax = self.int_range(self.w_num_of_bits, policy.symmetric)
        if policy.floating:
            qmin, qmax = -448.0, 448.0
        return TensorQuantizationConfig(
            policy=policy, rounding=self.rounding_policy,
            num_of_bits=self.w_num_of_bits, quant_min=qmin, quant_max=qmax,
            exponent_bits=self.w_exponent_bits,
            observer_algorithm=self.w_observer,
            channel_axis=channel_axis if policy.per_channel else None)

    def build_bias_config(self, channel_axis: int = 0) -> TensorQuantizationConfig:
        qmin, qmax = self.int_range(self.bias_bits, True)
        # bias granularity follows the weight policy (scale = in_s * w_s):
        # per-tensor-weight backends (Tengine et al.) reject any
        # per-channel config, including bias
        w_per_channel = QuantizationPolicy(self.w_policy_bits).per_channel
        gran = QP.PER_CHANNEL if w_per_channel else QP.PER_TENSOR
        return TensorQuantizationConfig(
            policy=QuantizationPolicy(gran | QP.LINEAR | QP.SYMMETRICAL),
            rounding=self.rounding_policy, num_of_bits=self.bias_bits,
            quant_min=qmin, quant_max=qmax, observer_algorithm='minmax',
            state=QuantizationStates.PASSIVE_INIT,
            channel_axis=channel_axis if w_per_channel else None,
            visibility=QuantizationVisibility.INTERNAL)

    def build_fp32_config(self) -> TensorQuantizationConfig:
        cfg = self.build_act_config()
        cfg.state = QuantizationStates.FP32
        cfg.visibility = QuantizationVisibility.INTERNAL
        return cfg

    @staticmethod
    def weight_channel_axis(op: Operation, input_idx: int) -> int:
        """Output-channel axis of a computing op's weight tensor."""
        if op.type == 'Conv':
            return 0                                   # OIHW
        if op.type == 'ConvTranspose':
            return 1                                   # IOHW
        if op.type == 'Gemm':
            return 0 if int(op.attributes.get('transB', 0)) else 1
        if op.type in {'MatMul', 'PPQBiasFusedMatMul'}:
            var = op.inputs[input_idx]
            nd = var.ndim if var.ndim is not None else 2
            return nd - 1
        return 0

    def create_default_quant_config(self, op: Operation) -> OperationQuantizationConfig:
        """(reference quantizer/base.py:107-204) — socket-aware TQC set."""
        sck = socket_of(op)
        in_cfgs = []
        for idx, var in enumerate(op.inputs):
            plat = sck.in_plat[min(idx, len(sck.in_plat) - 1)] \
                if sck.in_plat else TargetPlatform.UNSPECIFIED
            if plat in (TargetPlatform.SOI, TargetPlatform.FP32):
                in_cfgs.append(self.build_fp32_config())
            elif var.is_parameter and op.type in COMPUTING_OP and idx == 1:
                axis = self.weight_channel_axis(op, idx)
                in_cfgs.append(self.build_weight_config(axis))
            elif var.is_parameter and op.type in COMPUTING_OP and idx == 2:
                in_cfgs.append(self.build_bias_config())
            elif var.is_parameter and op.type in PASSIVE_OPERATIONS:
                cfg = self.build_act_config()
                cfg.state = QuantizationStates.PASSIVE_INIT
                cfg.visibility = QuantizationVisibility.INTERNAL
                in_cfgs.append(cfg)
            else:
                in_cfgs.append(self.build_act_config())
        out_cfgs = []
        for idx, var in enumerate(op.outputs):
            plat = sck.out_plat[min(idx, len(sck.out_plat) - 1)] \
                if sck.out_plat else TargetPlatform.UNSPECIFIED
            if plat == TargetPlatform.SOI:
                out_cfgs.append(self.build_fp32_config())
            else:
                out_cfgs.append(self.build_act_config())
        return OperationQuantizationConfig(in_cfgs, out_cfgs)

    def init_quantize_config(self, op: Operation) -> OperationQuantizationConfig:
        """Per-op refinement point; default = socket-based config."""
        return self.create_default_quant_config(op)

    # ------------------------------------------------------------- driver
    def quantize_operation(self, op_name: str) -> QuantableOperation:
        op = self.graph.operations[op_name]
        if isinstance(op, QuantableOperation):
            return op
        cfg = self.init_quantize_config(op)
        return quantize_operation(self.graph, op_name, cfg)

    def quantize(self, executor, dataloader: Iterable, setting,
                 collate_fn=None, inputs=None, verbose: bool = True):
        """End-to-end PTQ driver (reference quantizer/base.py:31-78):
        prequant pipeline → meta tracing → op wrapping → main pipeline."""
        self._verbose = verbose
        graph = self.graph

        prequant = self.build_prequant_pipeline(setting)
        prequant.optimize(graph, dataloader=dataloader, executor=executor,
                          collate_fn=collate_fn, verbose=verbose)

        if inputs is not None:
            executor.tracing_operation_meta(inputs)

        for name, op in list(graph.operations.items()):
            if op.platform == self.target_platform and \
                    op.type in self.quant_operation_types:
                self.quantize_operation(name)
        executor.load_graph(graph)   # re-bind: ops were swapped in place

        pipeline = self.build_quant_pipeline(setting)
        pipeline.optimize(graph, dataloader=dataloader, executor=executor,
                          collate_fn=collate_fn, verbose=verbose)
        if verbose:
            self.report()
        return graph

    # ---------------------------------------------------- pipeline builders
    def build_prequant_pipeline(self, setting) -> QuantizationOptimizationPipeline:
        """(reference quantizer/base.py:352-392)"""
        pipeline = QuantizationOptimizationPipeline()
        if getattr(setting, 'weight_split', False):
            from ..optim.morph import HorizontalLayerSplitPass
            ws = setting.weight_split_setting
            pipeline.append(HorizontalLayerSplitPass(
                value_threshold=ws.value_threshold,
                including_conv=ws.including_conv,
                including_gemm=ws.including_gemm))
        if getattr(setting, 'ssd_equalization', False):
            from ..optim.ssd import SSDEqualizationPass
            pipeline.append(SSDEqualizationPass())
        if getattr(setting, 'equalization', False):
            from ..optim.equalization import LayerwiseEqualizationPass
            eq = setting.equalization_setting
            pipeline.append(LayerwiseEqualizationPass(
                iterations=eq.iterations,
                value_threshold=eq.value_threshold,
                including_bias=eq.including_bias,
                bias_multiplier=eq.bias_multiplier,
                including_act=eq.including_act,
                act_multiplier=eq.act_multiplier))
        if getattr(setting, 'channel_split', False):
            from ..optim.equalization import ChannelwiseSplitPass
            cs = setting.channel_split_setting
            pipeline.append(ChannelwiseSplitPass(
                iterations=cs.iterations,
                value_threshold=cs.value_threshold))
        return pipeline

    def build_quant_pipeline(self, setting) -> QuantizationOptimizationPipeline:
        """(reference quantizer/base.py:249-350) — canonical pass order."""
        pipeline = QuantizationOptimizationPipeline()
        fusion = setting.fusion_setting

        if setting.fusion:
            if fusion.fuse_swish:
                pipeline.append(SwishFusionPass())
            if fusion.fuse_mish:
                pipeline.append(MishFusionPass())
            pipeline.append(QuantizeFusionPass(
                activation_type=self.activation_fusion_types,
                fuse_activation=fusion.fuse_activation,
                fuse_passive_op=fusion.fuse_passive_op))
            if fusion.remove_useless_quantization:
                pipeline.append(QuantizeSimplifyPass())

        if setting.quantize_parameter:
            pipeline.append(ParameterQuantizePass(
                method=setting.quantize_parameter_setting.calib_algorithm))

        if setting.quantize_activation:
            calib = setting.calibration
            if calib.isotone:
                pipeline.append(IsotoneCalibrationPass(
                    calib_steps=calib.calib_steps, axis=calib.isotone_axis))
            else:
                pipeline.append(RuntimeCalibrationPass(
                    method=(setting.quantize_activation_setting.calib_algorithm
                            or calib.calib_algorithm),
                    calib_steps=calib.calib_steps,
                    prefer_compiled=PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR))

        if setting.fusion and fusion.align_quantization:
            pipeline.append(QuantAlignmentPass(
                elementwise_alignment=fusion.align_elementwise_to,
                concat_alignment=fusion.align_concat_to,
                pooling_alignment=fusion.align_pooling_to,
                force_overlap=fusion.force_alignment_overlap))

        if setting.quantize_parameter and \
                setting.quantize_parameter_setting.quantize_passive_parameter:
            pipeline.append(PassiveParameterQuantizePass())

        if getattr(setting, 'bias_correct', False):
            from ..optim.training import BiasCorrectionPass
            bc = setting.bias_correct_setting
            pipeline.append(BiasCorrectionPass(
                block_size=bc.block_size, steps=bc.steps))

        if getattr(setting, 'lsq_optimization', False):
            from ..optim.training import LearnedStepSizePass
            lsq = setting.lsq_optimization_setting
            pipeline.append(LearnedStepSizePass(
                block_size=lsq.block_size, lr=lsq.lr, steps=lsq.steps,
                gamma=lsq.gamma, is_scale_trainable=lsq.is_scale_trainable))

        if getattr(setting, 'blockwise_reconstruction', False):
            from ..optim.training import AdaroundPass
            br = setting.blockwise_reconstruction_setting
            pipeline.append(AdaroundPass(
                block_size=br.block_size, steps=br.steps, lr=br.lr,
                gamma=br.gamma))

        if setting.quantize_parameter and \
                setting.quantize_parameter_setting.baking_parameter:
            pipeline.append(ParameterBakingPass())

        if getattr(setting, 'extension', False):
            from ..optim.extension import ExtensionPass
            pipeline.append(ExtensionPass())
        return pipeline

    # ------------------------------------------------------------- report
    def report(self):
        """Quant-state census (reference quantizer/base.py:223-247)."""
        census = {}
        for op in self.graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for cfg in op.config:
                census[cfg.state.name] = census.get(cfg.state.name, 0) + 1
        total = sum(census.values())
        ppq_info(f'Quantization state census ({total} configs): ' +
                 ', '.join(f'{k}={v}' for k, v in sorted(census.items())))
        return census
