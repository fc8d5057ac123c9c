"""Core quantization type system.

TPU-native re-design of the reference data model (ppq/core/quant.py:36-364 and
ppq/core/data.py:16-120): target platforms, rounding policies, quantization
property bitmasks / policies, quantization state machine, and data types.

Unlike the reference (which keys DataType to torch dtypes), DataType here maps
onto JAX/XLA dtypes; ONNX TensorProto integer codes are preserved so the ONNX
frontend round-trips losslessly.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np


class TargetPlatform(enum.IntEnum):
    """Execution/quantization region tag attached to every Operation.

    Mirrors the *concept* of ppq/core/quant.py:36-120: the scheduler assigns
    each op to a platform; quantizers only touch ops on quantable platforms.

    TPU-first platform set: the real quantable targets are TPU INT8 / FP8 /
    INT4 weight-only; the reference's 30+ vendor platforms are kept as export
    flavors (see ppq_tpu/quantization/quantizer) rather than as distinct
    runtime platforms.
    """

    # --- virtual platforms (never executed quantized) ---
    UNSPECIFIED = 0        # not yet dispatched
    FP32 = 1               # run in float, never quantize
    SOI = 2                # shape-or-index subgraph (host / scalar domain)
    BOUNDARY = 3           # device-switch boundary ops

    # --- quantable platforms ---
    TPU_INT8 = 10          # per-tensor / per-channel linear INT8
    TPU_FP8 = 11           # E4M3 / E5M2 floating quant
    TPU_INT4_WEIGHT_ONLY = 12
    TPU_DSP_INT8 = 13      # asymmetric per-tensor (DSP-style semantics)
    TPU_POWER_OF_2 = 14    # power-of-2 scales (NXP/FPGA-style semantics)

    # --- export-compat platforms (quantable, vendor semantics) ---
    TRT_INT8 = 20
    TRT_FP8 = 21
    ORT_INT8 = 22
    OPENVINO_INT8 = 23
    NCNN_INT8 = 24
    MNN_INT8 = 25
    SNPE_INT8 = 26
    RKNN_INT8 = 27
    TENGINE_INT8 = 28
    ASCEND_INT8 = 29
    GRAPHCORE_FP8 = 30
    METAX_INT8_C = 31
    METAX_INT8_T = 32
    NXP_INT8 = 33
    FPGA_INT8 = 34
    ACADEMIC_INT8 = 35
    EXTENSION = 36
    ONNX = 37              # plain onnx (fp32 export)
    PPL_DSP_TI_INT8 = 38   # DSP-TI: per-channel filter ranges in prototxt
    CAFFE = 39             # plain caffe (fp32 export)

    @classmethod
    def is_quantable(cls, platform: 'TargetPlatform') -> bool:
        return int(platform) >= 10

    @classmethod
    def is_virtual(cls, platform: 'TargetPlatform') -> bool:
        return int(platform) < 10


class RoundingPolicy(enum.Enum):
    """Rounding semantics for value→grid mapping (ppq/core/quant.py:123-144).

    7 policies; ROUND_HALF_EVEN is the IEEE default and the TPU-native fast
    path (maps to XLA's round-to-nearest-even).
    """

    ROUND_HALF_EVEN = 0
    ROUND_HALF_UP = 1
    ROUND_HALF_DOWN = 2
    ROUND_HALF_TOWARDS_ZERO = 3
    ROUND_HALF_FAR_FROM_ZERO = 4
    ROUND_TO_NEAR_INT = 5       # alias of half-up semantics in the reference
    ROUND_UP = 6                # ceil
    ROUND_DOWN = 7              # floor


class QuantizationVisibility(enum.IntEnum):
    """Controls whether a TQC is written out at export (ppq/core/quant.py:22-33)."""

    FORCE_EXPORT = 1
    EXPORT_WHEN_ACTIVE = 2
    INTERNAL = 3


class QuantizationProperty(enum.IntFlag):
    """Bitmask describing one aspect of a quantization scheme
    (ppq/core/quant.py:145-210)."""

    PER_TENSOR = 0x01
    PER_CHANNEL = 0x02
    LINEAR = 0x04
    FLOATING = 0x08
    SYMMETRICAL = 0x10
    ASYMMETRICAL = 0x20
    POWER_OF_2 = 0x40
    DYNAMIC = 0x80


# shorthand used throughout
QP = QuantizationProperty


_VALID_POLICIES = frozenset({
    # linear int schemes
    QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL,
    QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL,
    QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL,
    QP.PER_CHANNEL | QP.LINEAR | QP.ASYMMETRICAL,
    QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL | QP.POWER_OF_2,
    QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL | QP.POWER_OF_2,
    QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL | QP.POWER_OF_2,
    QP.PER_CHANNEL | QP.LINEAR | QP.ASYMMETRICAL | QP.POWER_OF_2,
    # dynamic variants
    QP.PER_TENSOR | QP.LINEAR | QP.SYMMETRICAL | QP.DYNAMIC,
    QP.PER_TENSOR | QP.LINEAR | QP.ASYMMETRICAL | QP.DYNAMIC,
    QP.PER_CHANNEL | QP.LINEAR | QP.SYMMETRICAL | QP.DYNAMIC,
    QP.PER_CHANNEL | QP.LINEAR | QP.ASYMMETRICAL | QP.DYNAMIC,
    # floating (fp8-style) schemes
    QP.PER_TENSOR | QP.FLOATING | QP.SYMMETRICAL,
    QP.PER_CHANNEL | QP.FLOATING | QP.SYMMETRICAL,
    QP.PER_TENSOR | QP.FLOATING | QP.SYMMETRICAL | QP.POWER_OF_2,
    QP.PER_CHANNEL | QP.FLOATING | QP.SYMMETRICAL | QP.POWER_OF_2,
})


class QuantizationPolicy:
    """A validated combination of QuantizationProperty bits
    (ppq/core/quant.py:213-296)."""

    __slots__ = ('_policy',)

    def __init__(self, policy: QuantizationProperty | int):
        policy = QuantizationProperty(int(policy))
        base = policy & ~(QP.DYNAMIC)
        if (policy & ~QP.DYNAMIC) not in _VALID_POLICIES and policy not in _VALID_POLICIES:
            # re-check including dynamic combos listed explicitly
            if policy not in _VALID_POLICIES:
                raise ValueError(
                    f'Invalid quantization policy combination: {policy!r}. '
                    f'A policy must pick exactly one of PER_TENSOR/PER_CHANNEL, '
                    f'one of LINEAR/FLOATING, and one of SYMMETRICAL/ASYMMETRICAL.')
        del base
        self._policy = policy

    def has_property(self, prop: QuantizationProperty) -> bool:
        return bool(self._policy & prop)

    # -- conveniences ------------------------------------------------------
    @property
    def per_channel(self) -> bool: return self.has_property(QP.PER_CHANNEL)

    @property
    def per_tensor(self) -> bool: return self.has_property(QP.PER_TENSOR)

    @property
    def linear(self) -> bool: return self.has_property(QP.LINEAR)

    @property
    def floating(self) -> bool: return self.has_property(QP.FLOATING)

    @property
    def symmetric(self) -> bool: return self.has_property(QP.SYMMETRICAL)

    @property
    def asymmetric(self) -> bool: return self.has_property(QP.ASYMMETRICAL)

    @property
    def power_of_2(self) -> bool: return self.has_property(QP.POWER_OF_2)

    @property
    def dynamic(self) -> bool: return self.has_property(QP.DYNAMIC)

    def to_dict(self) -> dict:
        return {p.name: self.has_property(p) for p in QuantizationProperty}

    def __int__(self) -> int:
        return int(self._policy)

    def __eq__(self, other) -> bool:
        return isinstance(other, QuantizationPolicy) and int(self) == int(other)

    def __hash__(self) -> int:
        return hash(int(self._policy))

    def __repr__(self) -> str:
        names = [p.name for p in QuantizationProperty if self.has_property(p)]
        return f'QuantizationPolicy({"|".join(names)})'


class QuantizationStates(enum.IntEnum):
    """Per-TQC lifecycle state machine (ppq/core/quant.py:309-364).

    INITIAL        — created, no scale/offset yet.
    FP32           — permanently disabled (op input kept in float).
    ACTIVATED      — calibrated; fake-quant applies at runtime.
    BAKED          — parameter statically quantized; runtime applies nothing.
    OVERLAPPED     — this TQC defers to its dominator (quant happens elsewhere).
    PASSIVE_INIT   — passive param (bias/pad value) awaiting scale derivation.
    PASSIVE        — passive param with derived scale (in_scale * w_scale).
    PASSIVE_BAKED  — passive param statically quantized.
    """

    INITIAL = 1
    FP32 = 2
    ACTIVATED = 3
    BAKED = 4
    OVERLAPPED = 5
    PASSIVE_INIT = 6
    PASSIVE = 7
    PASSIVE_BAKED = 8

    @classmethod
    def is_activated(cls, state: 'QuantizationStates') -> bool:
        """Quant math is applied at runtime in these states."""
        return state in {cls.ACTIVATED, cls.PASSIVE}

    @classmethod
    def can_export(cls, state: 'QuantizationStates') -> bool:
        return state in {
            cls.ACTIVATED, cls.BAKED, cls.OVERLAPPED,
            cls.PASSIVE, cls.PASSIVE_BAKED, cls.FP32,
        }


class DataType(enum.IntEnum):
    """Tensor element types, numbered to match ONNX TensorProto.DataType so the
    frontend round-trips (ppq/core/data.py:16-114 keeps the same alignment)."""

    UNDEFINED = 0
    FP32 = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FP16 = 10
    FP64 = 11
    UINT32 = 12
    UINT64 = 13
    COMPLEX64 = 14
    COMPLEX128 = 15
    BF16 = 16
    FP8_E4M3 = 17
    FP8_E5M2 = 19  # onnx FLOAT8E5M2

    @classmethod
    def from_numpy(cls, dtype: np.dtype) -> 'DataType':
        m = {
            np.dtype(np.float32): cls.FP32, np.dtype(np.float64): cls.FP64,
            np.dtype(np.float16): cls.FP16,
            np.dtype(np.int8): cls.INT8, np.dtype(np.uint8): cls.UINT8,
            np.dtype(np.int16): cls.INT16, np.dtype(np.uint16): cls.UINT16,
            np.dtype(np.int32): cls.INT32, np.dtype(np.int64): cls.INT64,
            np.dtype(np.uint32): cls.UINT32, np.dtype(np.uint64): cls.UINT64,
            np.dtype(np.bool_): cls.BOOL,
        }
        try:
            import ml_dtypes
            m[np.dtype(ml_dtypes.bfloat16)] = cls.BF16
            m[np.dtype(ml_dtypes.float8_e4m3fn)] = cls.FP8_E4M3
            m[np.dtype(ml_dtypes.float8_e5m2)] = cls.FP8_E5M2
        except ImportError:
            pass
        d = np.dtype(dtype)
        if d not in m:
            raise TypeError(f'No DataType mapping for numpy dtype {d}')
        return m[d]

    def to_numpy(self) -> np.dtype:
        m = {
            DataType.FP32: np.float32, DataType.FP64: np.float64,
            DataType.FP16: np.float16,
            DataType.INT8: np.int8, DataType.UINT8: np.uint8,
            DataType.INT16: np.int16, DataType.UINT16: np.uint16,
            DataType.INT32: np.int32, DataType.INT64: np.int64,
            DataType.UINT32: np.uint32, DataType.UINT64: np.uint64,
            DataType.BOOL: np.bool_,
        }
        if self in m:
            return np.dtype(m[self])
        import ml_dtypes
        m2 = {
            DataType.BF16: ml_dtypes.bfloat16,
            DataType.FP8_E4M3: ml_dtypes.float8_e4m3fn,
            DataType.FP8_E5M2: ml_dtypes.float8_e5m2,
        }
        if self in m2:
            return np.dtype(m2[self])
        raise TypeError(f'No numpy mapping for {self!r}')

    @property
    def is_float(self) -> bool:
        return self in {DataType.FP32, DataType.FP64, DataType.FP16,
                        DataType.BF16, DataType.FP8_E4M3, DataType.FP8_E5M2}

    @property
    def is_integer(self) -> bool:
        return self in {DataType.INT8, DataType.UINT8, DataType.INT16,
                        DataType.UINT16, DataType.INT32, DataType.INT64,
                        DataType.UINT32, DataType.UINT64, DataType.BOOL}
