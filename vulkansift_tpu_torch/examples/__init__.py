"""The JAX package's five examples (``examples/*.py``) on the port.

Each runs as ``python -m vulkansift_tpu_torch.examples.<name>`` with
``--device cuda`` (default) or ``--device cpu``, and has a ``main(argv)``
and a compute function that takes a numpy image and a device and returns
what the example prints: ``sift_detect.detect``, ``sift_match.match``,
``sift_error_handling.run``, ``sift_profile.profile`` and
``sift_show_pyramid.pyramid``. Input images are read by
``perf.harness.read_image`` (PGM/PPM without ``cv2``) or synthesized in
numpy; ``cv2`` is imported only to draw or write a picture.
"""
