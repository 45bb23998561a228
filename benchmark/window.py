"""What a window measured, as the end-to-end readers take it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    attempted: int  # units (steps or requests) run
    failed: int  # units whose output was not finite
    seconds: float  # from the first unit's call to the device's end after the last
    frames: int  # frames the units produced (trained on, or predicted)
    latencies: list  # seconds of each request, call to frames on the host
    setup_s: float = 0.0
