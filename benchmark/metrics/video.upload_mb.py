"""The program's ``compiled.upload_bytes`` counter a frame, in MB (1e6
bytes): the bytes a replayed program's call copies from host memory into
its static inputs, the frame (spans window, ``yardstick/spans.py``). None
where the program has no such counter."""

from yardstick import spans

COUNTER = "compiled.upload_bytes"


def read(run):
    w = spans.windows(run)
    if w is None or COUNTER not in w["counters"]:
        return None
    return spans.counter_per_item(run, COUNTER) / 1e6
