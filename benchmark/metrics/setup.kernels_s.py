"""The program's ``kernels.load_s`` counter at the end of set-up: seconds
spent building (``nvcc``) and loading the kernel libraries
(``yardstick/spans.py``)."""

from yardstick import spans


def read(run):
    return spans.setup_counter(run, "kernels.load_s")
