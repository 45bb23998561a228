"""The device's idle share of a unit, in %: 1 - (device busy time per
traced unit, the union of the profiled device operations' intervals) /
(wall time per unit of the untraced window). The profiler slows the host,
so the traced window's own wall time would overstate the idle share."""


def read(reading):
    if not reading.device_ops or not reading.window.attempted:
        return None
    per_unit = reading.window.seconds / reading.window.attempted
    return 100.0 * (1.0 - reading.busy_s() / reading.units / per_unit)
