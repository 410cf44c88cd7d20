"""The program's ``programs.record_s`` counter at the end of set-up: seconds
spent recording programs (warm-up and capture), less the kernel
libraries' seconds inside (``yardstick/spans.py``)."""

from yardstick import spans


def read(run):
    return spans.setup_counter(run, "programs.record_s")
