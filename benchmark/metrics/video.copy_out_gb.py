"""The program's ``compiled.copy_out_bytes`` counter a frame, in GB (1e9
bytes): the bytes a replayed program's call copies out of its static
outputs, the retained pyramid's included (spans window,
``yardstick/spans.py``). None where the program has no such counter."""

from yardstick import spans

COUNTER = "compiled.copy_out_bytes"


def read(run):
    w = spans.windows(run)
    if w is None or COUNTER not in w["counters"]:
        return None
    return spans.counter_per_item(run, COUNTER) / 1e9
