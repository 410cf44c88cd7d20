"""Multi-device parallelism over ``torch.distributed`` (port of
``vulkansift_tpu/parallel``).

* :mod:`.mesh` -- process group and 1-D device mesh setup.
* :mod:`.dp` -- data-parallel batched detection (a sub-batch per rank).
* :mod:`.ring_match` -- sharded 2-NN matching (a send/recv ring of B
  shards).
* :mod:`.scaling` -- data-parallel scaling measurement and its CLI.
"""

from .mesh import DATA_AXIS, init_distributed, make_mesh
from .dp import make_dp_detect_fn, shard_batch
from .ring_match import make_ring_match_fn
from .scaling import measure_dp_scaling

__all__ = ["DATA_AXIS", "init_distributed", "make_mesh",
           "make_dp_detect_fn", "shard_batch", "make_ring_match_fn",
           "measure_dp_scaling"]
