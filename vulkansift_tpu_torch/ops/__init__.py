"""Stage operations of the detect path: plain PyTorch code and the wrappers
of the hand-written CUDA kernels (sources in ``vulkansift_tpu_torch/csrc``)."""
