"""The program's ``host_reads`` counter a pair: blocking reads of device
data by the host (counts, fields of a download), over the spans window
(``yardstick/spans.py``)."""

from yardstick import spans


def read(run):
    return spans.counter_per_item(run, "host_reads")
