"""TensorQuantizationConfig — the central quantization control structure.

Capability-equivalent redesign of ppq/core/quant.py:367-1013. A TQC describes
how one tensor (one op input or output) is quantized: policy, bit-width,
quant range, scale/offset, lifecycle state, and the *sharing links*
(`dominated_by` / `master_by`) that let multiple tensors share one scale.

TPU-native notes:
  * scale/offset are stored as numpy arrays on host; the executor/compiler
    converts them to jnp on demand. They are compile-time metadata, not
    traced values — keeping them host-side lets the whole-graph compiler
    burn them into the XLA program as constants.
  * the dominator links form a union-find forest; resolution is path-lookup
    (no compression, trees are tiny) so that re-parenting stays coherent
    after graph copies — the same subtlety the reference handles at
    ppq/IR/base/graph.py:836-921.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator, List, Optional

import numpy as np

from .qtypes import (DataType, QuantizationPolicy, QuantizationProperty,
                     QuantizationStates, QuantizationVisibility, RoundingPolicy)

_tqc_counter = itertools.count()


class TensorQuantizationConfig:
    """Quantization spec of a single tensor (ppq/core/quant.py:367)."""

    def __init__(
        self,
        policy: QuantizationPolicy,
        rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
        num_of_bits: int = 8,
        quant_min: int | float = -128,
        quant_max: int | float = 127,
        scale: Optional[np.ndarray] = None,
        offset: Optional[np.ndarray] = None,
        exponent_bits: int = 0,
        observer_algorithm: str = 'minmax',
        state: QuantizationStates = QuantizationStates.INITIAL,
        channel_axis: Optional[int] = None,
        visibility: QuantizationVisibility = QuantizationVisibility.EXPORT_WHEN_ACTIVE,
        detail: Optional[dict] = None,
    ):
        if num_of_bits < 2 or num_of_bits > 32:
            raise ValueError(f'num_of_bits must be in [2, 32], got {num_of_bits}')
        self.policy = policy
        self.rounding = rounding
        self.num_of_bits = num_of_bits
        self.quant_min = quant_min
        self.quant_max = quant_max
        self.exponent_bits = exponent_bits
        self.observer_algorithm = observer_algorithm
        self.channel_axis = channel_axis
        self.visibility = visibility
        self.detail: dict = detail if detail is not None else {}
        self._scale: Optional[np.ndarray] = _as_f32(scale)
        self._offset: Optional[np.ndarray] = _as_f32(offset)
        self._state = state
        self._dominator: 'TensorQuantizationConfig' = self   # union-find parent
        self._uid = next(_tqc_counter)

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> QuantizationStates:
        return self._state

    @state.setter
    def state(self, value: QuantizationStates):
        self._state = value

    @property
    def is_active(self) -> bool:
        """True when fake-quant must be applied at runtime for this tensor."""
        return QuantizationStates.is_activated(self.effective_state)

    @property
    def effective_state(self) -> QuantizationStates:
        """State after resolving domination: an OVERLAPPED config reports its
        dominator's state for runtime decisions made elsewhere."""
        return self._state

    # ----------------------------------------------------------- scale/offset
    @property
    def scale(self) -> np.ndarray:
        root = self.dominated_by
        if root is not self:
            return root.scale
        if self._scale is None:
            raise ValueError(
                f'scale of TQC#{self._uid} accessed before calibration '
                f'(state={self._state.name})')
        return self._scale

    @scale.setter
    def scale(self, value):
        root = self.dominated_by
        if root is not self:
            raise PermissionError(
                'This TQC is dominated by another config; set the scale on '
                'its dominator instead (see ppq/core/quant.py:807-826).')
        self._scale = _as_f32(value)

    @property
    def offset(self) -> np.ndarray:
        root = self.dominated_by
        if root is not self:
            return root.offset
        if self._offset is None:
            raise ValueError(
                f'offset of TQC#{self._uid} accessed before calibration '
                f'(state={self._state.name})')
        return self._offset

    @offset.setter
    def offset(self, value):
        root = self.dominated_by
        if root is not self:
            raise PermissionError(
                'This TQC is dominated by another config; set the offset on '
                'its dominator instead.')
        self._offset = _as_f32(value)

    @property
    def has_scale(self) -> bool:
        root = self.dominated_by
        return (root._scale is not None) if root is not self else (self._scale is not None)

    # ------------------------------------------------------------- domination
    @property
    def dominated_by(self) -> 'TensorQuantizationConfig':
        """Root of this config's domination tree (ppq/core/quant.py:646-692).

        A dominated config is OVERLAPPED: the tensor is quantized by the
        dominator's TQC somewhere else in the graph, so this site performs no
        quant math and exports no qparams of its own.
        """
        node = self
        while node._dominator is not node:
            node = node._dominator
        return node

    @dominated_by.setter
    def dominated_by(self, master: 'TensorQuantizationConfig'):
        if master.dominated_by is self.dominated_by and master is not self:
            # already in the same tree; just re-point
            self._dominator = master
            return
        if master is self:
            raise ValueError('A config cannot dominate itself explicitly.')
        root = self.dominated_by
        root._dominator = master
        if root is not self:
            self._dominator = master
        self._state = QuantizationStates.OVERLAPPED

    @property
    def master_by(self) -> 'TensorQuantizationConfig':
        """Alias view of the sharing link used for *joint* quantization
        (ppq/core/quant.py:693-712): the slave keeps applying quant math at
        runtime (state PASSIVE) but reads scale/offset from the master."""
        return self.dominated_by

    @master_by.setter
    def master_by(self, master: 'TensorQuantizationConfig'):
        if master is self:
            # detach: become own master again
            self._dominator = self
            if self._state == QuantizationStates.PASSIVE:
                self._state = QuantizationStates.ACTIVATED
            return
        self._dominator = master
        # consult the master's ROOT: the master handed in may itself be an
        # OVERLAPPED slave (e.g. QuantAlignment aligning Add inputs that
        # QuantizeSimplify already overlapped onto their producers) — what
        # matters is whether a calibrated scale is reachable. PASSIVE means
        # this site keeps applying quant math at runtime with the shared
        # scale (reference quant.py:693-712).
        root_state = master.dominated_by.state
        if root_state in {QuantizationStates.ACTIVATED, QuantizationStates.PASSIVE,
                          QuantizationStates.BAKED, QuantizationStates.PASSIVE_BAKED}:
            self._state = QuantizationStates.PASSIVE
        else:
            self._state = QuantizationStates.PASSIVE_INIT

    @property
    def is_root(self) -> bool:
        return self._dominator is self

    def detach(self):
        """Break the sharing link, restoring independent quantization."""
        self._dominator = self
        if self._state in {QuantizationStates.OVERLAPPED, QuantizationStates.PASSIVE}:
            self._state = QuantizationStates.ACTIVATED

    # ------------------------------------------------------------------ misc
    @property
    def can_export(self) -> bool:
        """Whether exporters should emit qparams for this config
        (ppq/core/quant.py:601-645)."""
        if self.visibility == QuantizationVisibility.INTERNAL:
            return False
        valid_state = QuantizationStates.can_export(self._state)
        if self.visibility == QuantizationVisibility.FORCE_EXPORT:
            return True
        return valid_state and self._state not in {QuantizationStates.FP32}

    def copy(self) -> 'TensorQuantizationConfig':
        """Deep copy, *preserving* the dominator link target (callers that
        copy whole graphs must re-link afterwards, see BaseGraph.copy)."""
        cfg = TensorQuantizationConfig(
            policy=self.policy, rounding=self.rounding,
            num_of_bits=self.num_of_bits,
            quant_min=self.quant_min, quant_max=self.quant_max,
            scale=None if self._scale is None else self._scale.copy(),
            offset=None if self._offset is None else self._offset.copy(),
            exponent_bits=self.exponent_bits,
            observer_algorithm=self.observer_algorithm,
            state=self._state, channel_axis=self.channel_axis,
            visibility=self.visibility, detail=dict(self.detail),
        )
        if self._dominator is not self:
            cfg._dominator = self._dominator
        return cfg

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return self._uid

    def __repr__(self):
        return (f'TQC#{self._uid}(state={self._state.name}, bits={self.num_of_bits}, '
                f'policy={self.policy!r}, '
                f'scale={"set" if self._scale is not None else "unset"})')

    # -------------------------------------------------------- (de)serialize
    def to_dict(self) -> dict:
        return {
            'policy': int(self.policy),
            'rounding': self.rounding.value,
            'num_of_bits': self.num_of_bits,
            'quant_min': self.quant_min,
            'quant_max': self.quant_max,
            'exponent_bits': self.exponent_bits,
            'observer_algorithm': self.observer_algorithm,
            'state': self._state.value,
            'channel_axis': self.channel_axis,
            'visibility': self.visibility.value,
            'scale': None if self._scale is None else self._scale.tolist(),
            'offset': None if self._offset is None else self._offset.tolist(),
            'detail': {k: v for k, v in self.detail.items()
                       if isinstance(v, (int, float, str, bool, list, type(None)))},
        }

    @classmethod
    def from_dict(cls, d: dict) -> 'TensorQuantizationConfig':
        return cls(
            policy=QuantizationPolicy(d['policy']),
            rounding=RoundingPolicy(d['rounding']),
            num_of_bits=d['num_of_bits'],
            quant_min=d['quant_min'], quant_max=d['quant_max'],
            exponent_bits=d.get('exponent_bits', 0),
            observer_algorithm=d.get('observer_algorithm', 'minmax'),
            state=QuantizationStates(d['state']),
            channel_axis=d.get('channel_axis'),
            visibility=QuantizationVisibility(d.get('visibility', 2)),
            scale=None if d.get('scale') is None else np.asarray(d['scale'], np.float32),
            offset=None if d.get('offset') is None else np.asarray(d['offset'], np.float32),
            detail=d.get('detail', {}),
        )


class OperationQuantizationConfig:
    """Per-op bundle: one TQC per input + one per output
    (ppq/core/quant.py:952-1013)."""

    def __init__(self, input_quantization_config: List[TensorQuantizationConfig],
                 output_quantization_config: List[TensorQuantizationConfig]):
        self.input_quantization_config = list(input_quantization_config)
        self.output_quantization_config = list(output_quantization_config)

    def __iter__(self) -> Iterator[TensorQuantizationConfig]:
        yield from self.input_quantization_config
        yield from self.output_quantization_config

    def __len__(self) -> int:
        return len(self.input_quantization_config) + len(self.output_quantization_config)

    def copy(self) -> 'OperationQuantizationConfig':
        return OperationQuantizationConfig(
            [c.copy() for c in self.input_quantization_config],
            [c.copy() for c in self.output_quantization_config])


def _as_f32(value) -> Optional[np.ndarray]:
    if value is None:
        return None
    arr = np.asarray(value, dtype=np.float32)
    if arr.ndim == 0:
        arr = arr.reshape(())
    return arr
