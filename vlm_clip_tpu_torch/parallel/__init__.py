"""Data parallelism over ``torch.distributed`` (port of
``vlm_clip_tpu/parallel``): the process group and rank gating
(``distributed``), the device mesh (``mesh``) and ZeRO-1 (``sharding``).
Tensor and pipeline parallelism are not ported yet
(:data:`~vlm_clip_tpu_torch.parallel.mesh.MESH_NOT_PORTED`)."""

from vlm_clip_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedConfig,
    config_from_env,
    global_mesh,
    is_primary,
    maybe_initialize,
    primary_only,
)
from vlm_clip_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    create_mesh,
    data_sharding,
    replicated,
    with_mesh,
)
from vlm_clip_tpu_torch.parallel.sharding import (  # noqa: F401
    Zero1Optimizer,
    zero1_place,
    zero1_specs,
)
