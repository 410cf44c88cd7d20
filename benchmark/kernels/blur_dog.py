"""``blur_dog``: the separable blur of every gaussian layer and its DoG
layer. Each launch reads its input layer once and writes its output (and
DoG) layer once; operations: 1 + 3 k a pass and pixel for a half kernel of
k + 1 taps, two passes, one subtraction for the DoG."""

from yardstick import roofline
from reference import sift as ref_sift

SYMBOL = "blur_dog_kernel"
GROUP = "detect"


def work(item, device="cpu"):
    out = []
    for fr in item.frames:
        taps = [len(t) for t in ref_sift.blur_taps(fr.cfg)]
        for o, (w, h) in enumerate(fr.sizes):
            npx = w * h
            # Octave 0 blurs its seed first (no DoG); every octave then
            # blurs S + 2 layers, each with its DoG.
            launches = [(taps[0], False)] if o == 0 else []
            launches += [(taps[i], True) for i in range(1, len(taps))]
            for n, dog in launches:
                k = n - 1
                out.append((4 * npx * (3 if dog else 2),
                            npx * (2 * (1 + 3 * k) + (1 if dog else 0)),
                            roofline.PEAKS["f32_ops_per_s"]))
    return out
