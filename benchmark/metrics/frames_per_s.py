"""Frames whose features reached the host, over the window's seconds."""


def read(run):
    return run.rate()
