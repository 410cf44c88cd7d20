"""The traffic generator: deterministic by seed, with the stated shapes
and item counts."""

import numpy as np
import pytest

from yardstick import images, spec, traffic

CONFIG = {"pan-video": "hannover-1536x1024", "oxford-pairs": "oxford-640x480",
          "exhaustive-50": "hannover-1536x1024"}


def _pool(name, seed):
    t = spec.traffic(name)
    frame = spec.config(spec.benchmark(), CONFIG[name])["frame"]
    return t, frame, traffic.make_images(t, frame, np.random.default_rng(seed))


@pytest.mark.parametrize("name,count,shape,items", [
    ("pan-video", 64, (1024, 1536), 64),
    ("oxford-pairs", 48, (480, 640), 40),
    ("exhaustive-50", 50, (1024, 1536), 1225),
])
def test_shapes_and_item_counts(name, count, shape, items):
    t, frame, imgs = _pool(name, 2 ** 31 + 5)
    assert len(imgs) == count
    assert all(im.shape == shape and im.dtype == np.uint8 for im in imgs)
    assert len(traffic.make_items(t, len(imgs))) == items


@pytest.mark.parametrize("name", ["pan-video", "oxford-pairs"])
def test_deterministic_by_seed(name):
    _, _, a = _pool(name, 123)
    _, _, b = _pool(name, 123)
    _, _, c = _pool(name, 124)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_pan_crops_move_by_the_step():
    crops = images.pan(160, 128, 3, (7, 5), np.random.default_rng(0))
    assert np.array_equal(crops[1][:-5, :-7], crops[0][5:, 7:])
    assert np.array_equal(crops[2][:-5, :-7], crops[1][5:, 7:])


def test_items_bind_the_right_images_and_buffers():
    t = spec.traffic("oxford-pairs")
    items = traffic.make_items(t, 12)
    assert items[:5] == [{"a": 0, "b": n} for n in range(1, 6)]
    assert items[5] == {"a": 6, "b": 7}
    ex = traffic.make_items(dict(items="buffer_pairs", buffers=4), 4)
    assert ex == [{"i": i, "j": j} for i in range(4) for j in range(i + 1, 4)]
    calls = t["calls"]
    assert traffic.detects(calls, items[5]) == [(6, 0), (7, 1)]
    assert traffic.matched_buffers(calls, items[5]) == (0, 1)


def test_warp_identity_and_shift():
    img = images.bench_image(70, 90, np.random.default_rng(1))
    assert np.array_equal(images.warp_perspective(img, np.eye(3)), img)
    shift = np.array([[1, 0, 3], [0, 1, 2], [0, 0, 1.0]])
    out = images.warp_perspective(img, shift)
    assert np.array_equal(out[2:, 3:], img[:-2, :-3])
    assert (out[:2] == 0).all() and (out[:, :3] == 0).all()


def test_oxford_homography_is_the_protocol():
    hm = images.oxford_homography(3, 640, 480, 4.0, 0.05, (6, -4))
    ang, s = np.radians(8.0), 0.9
    centre = hm @ np.array([320, 240, 1.0])
    assert np.allclose(centre[:2], [332, 232])
    assert np.allclose(hm[:2, :2], s * np.array([[np.cos(ang), -np.sin(ang)],
                                                 [np.sin(ang), np.cos(ang)]]))
