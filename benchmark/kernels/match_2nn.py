"""``match_2nn``: the 2-NN of NA live rows among NB: each live descriptor
read once, four 4-byte outputs a live A row and the two counts;
2 x 128 u8 operations a row pair at the int8 tensor rate."""

from yardstick import roofline

SYMBOL = "match_2nn_kernel"
GROUP = "match"


def work(item, device="cpu"):
    if item.na is None or item.nb is None:
        return []
    na, nb = item.na, item.nb
    return [(128 * (na + nb) + 16 * na + 8, 2 * 128 * na * nb,
             roofline.PEAKS["int8_ops_per_s"])]
