"""``frontend``: the 26-neighbour extremum test and the Newton walk code
of every interior DoG cell of an octave. Reads the DoG stack once, writes
one byte a cell and one count a row; 147 f32 operations a cell (the
count of ``chip_smoke.py::frontend_bound``, frozen)."""

from yardstick import roofline

SYMBOL = "frontend_kernel"
GROUP = "detect"


def work(item, device="cpu"):
    out = []
    for fr in item.frames:
        ns = fr.scales + 2
        for w, h in fr.sizes:
            cells = (ns - 2) * (h - 2) * (w - 2)
            out.append((4 * ns * h * w + cells + 4 * (ns - 2) * (h - 2),
                        147 * cells, roofline.PEAKS["f32_ops_per_s"]))
    return out
