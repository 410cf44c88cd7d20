"""Device busy ms a pair in the traced window."""

from yardstick import readers


def read(run):
    return readers.device_ms(run)
