"""Benchmark harness (port of ``vulkansift_tpu/perf``; reference parity:
src/perf/*)."""

from .harness import (DETECTORS, Detector, DetectResult, OpenCvDetector,
                      VulkanSiftTpuTorchDetector, compute_metrics,
                      load_oxford_pairs, lowe_matches,
                      read_homography_file, repeatability_score,
                      run_matching_benchmark, run_runtime_benchmark,
                      synthesize_pairs)

__all__ = [
    "DETECTORS", "Detector", "DetectResult", "OpenCvDetector",
    "VulkanSiftTpuTorchDetector", "compute_metrics", "load_oxford_pairs",
    "lowe_matches", "read_homography_file", "repeatability_score",
    "run_matching_benchmark", "run_runtime_benchmark", "synthesize_pairs",
]
