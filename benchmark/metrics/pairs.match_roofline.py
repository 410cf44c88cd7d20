"""``match_2nn``'s roofline bound at the pairs' live counts over its
device time, in the traced window (%)."""

from yardstick import readers


def read(run):
    return readers.roofline_share(run, "match")
