"""Device busy ms a frame in the traced window."""

from yardstick import readers


def read(run):
    return readers.device_ms(run)
