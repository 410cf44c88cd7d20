"""Device ms a frame in device-to-device copies, under the trace's
``Memcpy DtoD`` name, in the traced window: the clones of each replay's
static outputs (the retained pyramid's included), and any such copy
inside the replayed graph."""

from yardstick import readers

DTOD = "Memcpy DtoD"


def read(run):
    n = readers.items_traced(run)
    if not n:
        return None
    return sum(t for name, t in run.trace["device_s"].items()
               if name.startswith(DTOD)) * 1e3 / n
