"""Distributed runs of the port on torch.distributed (counterpart of
cdlnet_tpu/dist/): one process a rank, a DeviceMesh with named dims
("data", "depth", "model", "replica"), data parallelism, depth (frame)
sharding with point-to-point halo exchange on the plain loop and on the
hand kernels, subband tensor parallelism, and the launcher
(python -m cdlnet_tpu_torch.dist.launch args.json)."""

from cdlnet_tpu_torch.dist.mesh import Mesh, make_mesh
from cdlnet_tpu_torch.dist.sharding import (
    batch_sharding,
    gather_subbands,
    make_dp_train_step,
    make_subband_train_step,
    replicate_sharding,
    shard_map_forward,
    subband_forward,
    subband_shardings,
)
from cdlnet_tpu_torch.dist.halo import halo_exchange, sharded_lista_3d_forward
from cdlnet_tpu_torch.dist.halo_fused import (
    fused_depth_shard_supported,
    sharded_fused_3d_train_forward,
    sharded_lista_3d_fused_forward,
)
from cdlnet_tpu_torch.dist.init import initialize_distributed, make_hybrid_mesh
