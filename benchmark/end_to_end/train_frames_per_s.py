"""Frames of the completed train steps (B·T each) over the window, which
ends on a device synchronize after the last step."""


def read(window):
    return window.frames / window.seconds
