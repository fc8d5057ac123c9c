"""QuantizationSetting — the user-facing configuration tree
(redesign of ppq/api/setting.py:8-509).

A tree of small dataclass-like sub-settings, JSON round-trippable, with a
factory of per-target presets. The quantizer translates these flags into the
optimization pipeline (quantizer/base.py build_quant_pipeline).
"""

from __future__ import annotations

import json
from typing import Dict, Optional


class _SubSetting:
    """JSON-serializable plain attribute bag."""

    def to_dict(self) -> dict:
        out = {}
        for k, v in vars(self).items():
            if isinstance(v, _SubSetting):
                out[k] = v.to_dict()
            else:
                out[k] = v
        return out

    def load_dict(self, d: dict):
        for k, v in d.items():
            if not hasattr(self, k):
                continue
            cur = getattr(self, k)
            if isinstance(cur, _SubSetting) and isinstance(v, dict):
                cur.load_dict(v)
            else:
                setattr(self, k, v)
        return self


class EqualizationSetting(_SubSetting):
    """(reference setting.py:28-66)"""

    def __init__(self):
        self.iterations = 10
        self.value_threshold = 0.5
        self.opt_level = 1
        self.including_bias = False
        self.bias_multiplier = 0.5
        self.including_act = False
        self.act_multiplier = 0.5


class ChannelSplitSetting(_SubSetting):
    def __init__(self):
        self.iterations = 1
        self.value_threshold = 0.5


class MatrixFactorizationSetting(_SubSetting):
    def __init__(self):
        self.value_threshold = 1.0


class FusionSetting(_SubSetting):
    """(reference setting.py:102-148)"""

    def __init__(self):
        self.fuse_activation = True
        self.fuse_passive_op = True
        self.remove_useless_quantization = True   # QuantizeSimplifyPass
        self.align_quantization = True            # QuantAlignmentPass
        self.align_elementwise_to = 'Align to Large'
        self.align_concat_to = 'Align to Output'
        self.align_pooling_to = 'None'
        self.force_alignment_overlap = False
        self.fuse_swish = False
        self.fuse_mish = False


class CalibrationSetting(_SubSetting):
    def __init__(self):
        self.calib_algorithm: Optional[str] = None   # None → per-TQC default
        self.calib_steps = 32
        self.isotone = False
        self.isotone_axis = -1


class ParameterSetting(_SubSetting):
    def __init__(self):
        self.calib_algorithm = 'minmax'
        self.baking_parameter = True
        self.quantize_passive_parameter = True


class ActivationSetting(_SubSetting):
    def __init__(self):
        self.calib_algorithm: Optional[str] = None


class BiasCorrectionSetting(_SubSetting):
    """(reference setting.py:151-176)"""

    def __init__(self):
        self.block_size = 4
        self.steps = 32
        self.collecting_device = 'cpu'


class LSQSetting(_SubSetting):
    """(reference setting.py:179-230)"""

    def __init__(self):
        self.block_size = 4
        self.lr = 1e-5
        self.steps = 500
        self.gamma = 0.0
        self.is_scale_trainable = True
        self.collecting_device = 'cpu'


class BlockwiseReconstructionSetting(_SubSetting):
    def __init__(self):
        self.block_size = 4
        self.steps = 5000
        self.lr = 1e-3
        self.gamma = 1.0
        self.is_scale_trainable = False
        self.collecting_device = 'cpu'


class WeightSplitSetting(_SubSetting):
    def __init__(self):
        self.value_threshold = 2.0
        self.including_conv = True
        self.including_gemm = True


class DispatchingTable(_SubSetting):
    """Manual op→platform overrides (reference setting.py:306-330)."""

    def __init__(self):
        self.intro = ('Dispatching Table, mapping operation name → platform '
                      'integer; overrides the dispatcher decision.')
        self.dispatchings: Dict[str, int] = {}

    def append(self, operation: str, platform: int):
        self.dispatchings[operation] = int(platform)


class QuantizationSetting(_SubSetting):
    """Master setting (reference setting.py:333-400)."""

    def __init__(self):
        # prequant structural optims
        self.ssd_equalization = False
        self.equalization = False
        self.equalization_setting = EqualizationSetting()
        self.channel_split = False
        self.channel_split_setting = ChannelSplitSetting()
        self.matrix_factorization = False
        self.matrix_factorization_setting = MatrixFactorizationSetting()
        self.weight_split = False
        self.weight_split_setting = WeightSplitSetting()

        # main pipeline switches
        self.fusion = True
        self.fusion_setting = FusionSetting()
        self.quantize_parameter = True
        self.quantize_parameter_setting = ParameterSetting()
        self.quantize_activation = True
        self.quantize_activation_setting = ActivationSetting()
        self.calibration = CalibrationSetting()

        self.bias_correct = False
        self.bias_correct_setting = BiasCorrectionSetting()
        self.lsq_optimization = False
        self.lsq_optimization_setting = LSQSetting()
        self.blockwise_reconstruction = False
        self.blockwise_reconstruction_setting = BlockwiseReconstructionSetting()

        self.extension = False
        self.legacy_8bit_restriction = False

        # scheduling
        self.dispatcher = 'conservative'
        self.dispatching_table = DispatchingTable()

    # ----------------------------------------------------------- JSON round-trip
    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=4)

    @classmethod
    def from_json(cls, obj) -> 'QuantizationSetting':
        if isinstance(obj, str):
            obj = json.loads(obj)
        setting = cls()
        setting.load_dict(obj)
        return setting


class UnbelievableUserFriendlyQuantizationSetting:
    """Beginner config (reference api/interface.py:702): a handful of plain
    switches that expand into a full QuantizationSetting."""

    def __init__(self, platform=None, finetune_steps: int = 0,
                 finetune_lr: float = 1e-5, calibration: str = 'percentile',
                 equalization: bool = False, non_quantable_op: Optional[list] = None):
        self.platform = platform
        self.finetune_steps = finetune_steps
        self.finetune_lr = finetune_lr
        self.calibration = calibration
        self.equalization = equalization
        self.non_quantable_op = list(non_quantable_op or [])

    def convert_to_daddy_setting(self) -> 'QuantizationSetting':
        """(reference spelling kept)"""
        s = QuantizationSetting()
        s.calibration.calib_algorithm = self.calibration
        s.equalization = self.equalization
        if self.finetune_steps > 0:
            s.lsq_optimization = True
            s.lsq_optimization_setting.steps = self.finetune_steps
            s.lsq_optimization_setting.lr = self.finetune_lr
        for op_name in self.non_quantable_op:
            s.dispatching_table.append(op_name, 1)  # TargetPlatform.FP32
        return s


class QuantizationSettingFactory:
    """Preset settings per target (reference setting.py:403-509)."""

    @staticmethod
    def default_setting() -> QuantizationSetting:
        return QuantizationSetting()

    @staticmethod
    def tpu_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.fusion_setting.align_concat_to = 'Align to Output'
        return s

    @staticmethod
    def trt_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.fusion_setting.force_alignment_overlap = True
        return s

    @staticmethod
    def fp8_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.quantize_parameter_setting.calib_algorithm = 'floating'
        s.calibration.calib_algorithm = 'floating'
        return s

    @staticmethod
    def dsp_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.fusion_setting.align_elementwise_to = 'Align to Output'
        return s

    @staticmethod
    def academic_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.fusion = False
        return s

    @staticmethod
    def weight_only_setting() -> QuantizationSetting:
        s = QuantizationSetting()
        s.quantize_activation = False
        s.fusion = False
        s.dispatcher = 'pointwise'
        return s
