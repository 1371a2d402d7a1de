from microimagelib_tpu_torch.parallel.mesh import batch_sharding, make_mesh, volume_sharding
from microimagelib_tpu_torch.parallel.sharded import (
    fusion_step_multichip,
    rl_decon_dual_batch_dp,
    rl_decon_dual_sharded,
    rl_decon_single_sharded,
)

__all__ = [
    "make_mesh",
    "volume_sharding",
    "batch_sharding",
    "rl_decon_single_sharded",
    "rl_decon_dual_sharded",
    "rl_decon_dual_batch_dp",
    "fusion_step_multichip",
]
