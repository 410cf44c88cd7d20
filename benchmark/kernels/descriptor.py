"""``descriptor``: the raw 128-float descriptor of every live orientation
pair over its window of radius floor(sqrt(2) 3 sigma 5/2 + 1/2). Bytes:
the distinct pyramid pixels the windows read, a 40-byte record and a
128-float row a pair; 75 f32 operations a window cell (eight weighted bin
updates, transcendentals counted as one: ``chip_smoke.py``'s count,
frozen)."""

from yardstick import roofline

SYMBOL = "descriptor_kernel"
GROUP = "detect"


def work(item, device="cpu"):
    out = []
    for fr in item.frames:
        px, cells, n = roofline.window_work(fr, True, roofline.desc_radius,
                                            device)
        out.append((4 * px + n * 40 + 4 * 128 * n, 75 * cells,
                    roofline.PEAKS["f32_ops_per_s"]))
    return out
