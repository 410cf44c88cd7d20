"""Host ms a pair inside the program's ``compiled.upload`` spans (two
detects and the match): the frames' pinned staging, the static-input
copies and fills of each replayed program (spans window, ``yardstick/spans.py``)."""

from yardstick import spans


def read(run):
    return spans.ms_per_item(run, "compiled.upload")
