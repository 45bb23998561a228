"""Process start to the first timed call: imports, the card, the kernels
built or loaded, weights, inputs, and the warm-up (the check steps or
requests)."""


def read(window):
    return window.setup_s
