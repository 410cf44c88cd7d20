"""Sum of the detect kernels' roofline bounds over the sum of their device
time, in the traced window (%)."""

from yardstick import readers


def read(run):
    return readers.roofline_share(run, "detect")
