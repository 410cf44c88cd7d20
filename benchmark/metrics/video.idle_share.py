"""1 - device busy ms an item (traced window) over wall ms an item
(untraced window), in %."""

from yardstick import readers


def read(run):
    return readers.idle_share(run)
