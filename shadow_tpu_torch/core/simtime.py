"""Simulation-time constants and helpers.

Simulated time is signed int64 nanoseconds (``torch.int64``), with
INVALID = int64 max as the "no event" sentinel — the same model as
``shadow_tpu/core/simtime.py`` (ref: definitions.h:14-78).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.int64

# Sentinel meaning "no time / empty slot" (ref: definitions.h:28).
INVALID = int(np.iinfo(np.int64).max)
MAX = INVALID - 1
MIN = 0

ONE_NANOSECOND = 1
ONE_MICROSECOND = 1_000
ONE_MILLISECOND = 1_000_000
ONE_SECOND = 1_000_000_000
ONE_MINUTE = 60 * ONE_SECOND
ONE_HOUR = 3600 * ONE_SECOND

# Offset added to simulated time so applications observe a wall clock
# starting at 2000-01-01 00:00:00 UTC (ref: definitions.h:74-78).
EMULATED_TIME_OFFSET = 946_684_800 * ONE_SECOND
