"""The PyTorch port stands alone: importing it (every module, the staged
detector, ``parallel``, ``sfm``, ``golden``, ``utils.native_io``, ``perf``
and ``examples`` included, and chip_smoke.py's module-level code) loads no
JAX, nothing of the JAX package and none of ``cv2``, ``matplotlib`` and
``sklearn`` (which the card's machine lacks), and its entry points refuse
to drop quietly to the CPU when there is no CUDA."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib.util, sys
import vulkansift_tpu_torch
import vulkansift_tpu_torch.instance, vulkansift_tpu_torch.pipeline
from vulkansift_tpu_torch.ops import (backhalf, blur, cuda_lib, descriptor,
                                      extract, frontend, match, orientation,
                                      patches, scale_space)
import vulkansift_tpu_torch.utils.logging
import vulkansift_tpu_torch.detector
from vulkansift_tpu_torch.parallel import dp, mesh, ring_match, scaling
from vulkansift_tpu_torch.sfm import (bundle_adjustment, checkpoint, geometry,
                                      metrics, pose_graph, reconstruction)
import vulkansift_tpu_torch.golden.reference
import vulkansift_tpu_torch.utils.native_io
from vulkansift_tpu_torch.perf import harness, matching, parity, plot, runtime
from vulkansift_tpu_torch.examples import (common, sift_detect,
                                           sift_error_handling, sift_match,
                                           sift_profile, sift_show_pyramid)
import numpy as np
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m.startswith("vulkansift_tpu.")
             or m == "vulkansift_tpu" or m == "bench"
             or m.split(".")[0] in ("cv2", "matplotlib", "sklearn"))
print("BAD", bad)
import torch
assert not torch.cuda.is_available()
from vulkansift_tpu_torch import DeviceError, SiftInstance, make_detect_fn
cfg = vulkansift_tpu_torch.SiftConfig()
for make in (lambda: SiftInstance(),
             lambda: make_detect_fn(cfg, 64, 64),
             lambda: vulkansift_tpu_torch.SiftDetector(cfg),
             lambda: dp.make_dp_detect_fn(cfg, 64, 64, None),
             lambda: ring_match.make_ring_match_fn(None),
             lambda: mesh.init_distributed("tcp://localhost:1", 1, 0),
             lambda: reconstruction.reconstruct_sequence(
                 [], geometry.Camera(1.0, 1.0, 0.0, 0.0)),
             lambda: vulkansift_tpu_torch.features_from_numpy(
                 np.zeros(1, vulkansift_tpu_torch.FEATURE_DTYPE), 4)):
    try:
        make()
    except DeviceError:
        print("RAISED")
try:
    cuda_lib.library("blur_dog")
except DeviceError:
    print("BUILD RAISED")
print("RUNTIME", vulkansift_tpu_torch.load_runtime().name)
"""


def test_port_imports_no_jax_and_needs_cuda_or_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT),
               PATH="/usr/bin:/bin")
    env.pop("CUDA_HOME", None)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "BAD []" in lines, res.stdout
    assert lines.count("RAISED") == 8, res.stdout
    assert "BUILD RAISED" in lines, res.stdout
    assert "RUNTIME DEVICE_ERROR" in lines, res.stdout
