"""Peak memory allocated by the traced train steps, in GiB."""


def read(reading):
    return reading.peak_bytes / 2 ** 30 if reading.peak_bytes else None
