"""Model FLOPs of the window's units (counted on the reference) over the
window's time at the float32 peak, in %."""

from benchmark.yardstick import mfu


def read(reading):
    return mfu(reading.window, reading.flops_per_unit)
