"""``orientation_hist``: the 36-bin gradient histogram of every live
keypoint over its window of radius floor(4.5 sigma). Bytes: the distinct
pyramid pixels the windows read, a 40-byte record and a 36-float row a
keypoint; 30 f32 operations a window cell (transcendentals counted as
one: ``chip_smoke.py``'s count, frozen)."""

from yardstick import roofline

SYMBOL = "orientation_hist_kernel"
GROUP = "detect"


def work(item, device="cpu"):
    out = []
    for fr in item.frames:
        px, cells, n = roofline.window_work(fr, False, roofline.ori_radius,
                                            device)
        out.append((4 * px + n * 40 + 4 * 36 * n, 30 * cells,
                    roofline.PEAKS["f32_ops_per_s"]))
    return out
