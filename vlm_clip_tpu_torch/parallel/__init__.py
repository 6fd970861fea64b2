"""Parallelism over ``torch.distributed`` (port of ``vlm_clip_tpu/parallel``):
the process group and rank gating (``distributed``), the device mesh
(``mesh``), tensor-parallel partition rules and ZeRO-1 (``sharding``),
the collectives of a tensor-parallel forward (``tensor_parallel``) and
pipeline parallelism for the Qwen decoder (``pipeline``)."""

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
    create_pipe_mesh,
    data_sharding,
    replicated,
    with_mesh,
)
from vlm_clip_tpu_torch.parallel.sharding import (  # noqa: F401
    Zero1Optimizer,
    clip_param_rules,
    partition_specs,
    qwen_param_rules,
    shard_params,
    spec_for_path,
    zero1_place,
    zero1_specs,
)
