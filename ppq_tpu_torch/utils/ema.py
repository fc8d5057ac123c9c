"""Exponential moving average recorder (redesign of ppq/utils/ema.py:15).
A copy of ppq_tpu/utils/ema.py."""

from __future__ import annotations

from typing import Optional


class EMARecorder:
    def __init__(self, beta: float = 0.98):
        self.beta = beta
        self._value: Optional[float] = None

    def push(self, value: float) -> float:
        if self._value is None:
            self._value = float(value)
        else:
            self._value = self.beta * self._value + (1 - self.beta) * float(value)
        return self._value

    @property
    def value(self) -> float:
        if self._value is None:
            raise ValueError('EMARecorder has no observations yet')
        return self._value
