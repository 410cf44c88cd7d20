"""Host ms a frame inside the program's ``compiled.copy_out`` spans: the
clones of each replay's outputs (the retained pyramid's included) and the
pool's done event (spans window, ``yardstick/spans.py``)."""

from yardstick import spans


def read(run):
    return spans.ms_per_item(run, "compiled.copy_out")
