"""Predicted frames (B·n_predictions a request) over the window."""


def read(window):
    return window.frames / window.seconds
