"""Colour-science constants (the port's own copy of the constants of
``hdrtv_tpu/ops/color.py``): SMPTE ST 2084 (PQ) and the BT.709 → BT.2020
primaries conversion (linear light, D65). ``ops/pack.py
colorimetric_pq_pack`` hands them to its kernel as arguments."""

from __future__ import annotations

import numpy as np

PQ_M1 = 2610.0 / 16384.0
PQ_M2 = 2523.0 / 32.0
PQ_C1 = 3424.0 / 4096.0
PQ_C2 = 2413.0 / 128.0
PQ_C3 = 2392.0 / 128.0

BT709_TO_BT2020 = np.array(
    [
        [0.6274039, 0.3292830, 0.0433131],
        [0.0690973, 0.9195404, 0.0113623],
        [0.0163914, 0.0880133, 0.8955953],
    ],
    dtype=np.float32,
)
