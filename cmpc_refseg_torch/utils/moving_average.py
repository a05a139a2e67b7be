"""Windowed moving average (reference: util/functions.py:4-40), used for
step-time tracking in the train loop (trainval_model.py:78-79,118-120).
A copy of the JAX package's utils/moving_average.py."""

from __future__ import annotations

from collections import deque


class MovingAverage:
    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self._values = deque(maxlen=window_size)
        self._sum = 0.0

    def add(self, value: float) -> None:
        if len(self._values) == self._values.maxlen:
            self._sum -= self._values[0]
        self._values.append(float(value))
        self._sum += float(value)

    def get(self) -> float:
        if not self._values:
            return 0.0
        return self._sum / len(self._values)

    def __len__(self) -> int:
        return len(self._values)
