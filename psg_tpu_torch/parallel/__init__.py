"""Scale-out on ``torch.distributed`` (port of ``psg_tpu/parallel``): one
process per device, a ('data', 'model') ``DeviceMesh``, batches cut into
each rank's rows, and the UNet's tensor-parallel sharding rule."""

from psg_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from psg_tpu_torch.parallel.multihost import (
    initialize_distributed,
    make_multihost_mesh,
)
from psg_tpu_torch.parallel.sharding import (
    param_shardings,
    shard_state,
    unet_tp_rules,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "initialize_distributed",
    "make_multihost_mesh",
    "param_shardings",
    "shard_state",
    "unet_tp_rules",
]
