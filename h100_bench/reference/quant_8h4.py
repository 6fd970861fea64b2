"""The ``8h4`` preset worked out again from the benchmark's fp32 numbers:
every linear of both towers int8, the head from ``embed_tokens``
transposed at int4 (``reference/qwen_vl.quantized_weights``). Its
control puts int4 where the preset has int8."""

from __future__ import annotations

from reference.qwen_vl import quantized_weights


def weights(raw):
    return quantized_weights(raw, 8, 4)


def control(raw):
    return quantized_weights(raw, 4, 4)
