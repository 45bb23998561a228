"""Host-side kernel launches per traced unit (step or request)."""


def read(reading):
    return reading.launches / reading.units if reading.launches else None
