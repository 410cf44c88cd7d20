"""Device ms a frame outside the detect kernels (``kernels/*.py`` of
group ``detect``), in the traced window."""

from yardstick import readers


def read(run):
    return readers.glue_ms(run, "detect")
