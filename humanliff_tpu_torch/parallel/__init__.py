"""The data mesh over torch.distributed ranks and its collectives (the
reference's dist_util equivalent; port of ``humanliff_tpu/parallel``)."""

from humanliff_tpu_torch.parallel.mesh import (
    DataMesh,
    cli_mesh,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
    shard_stage1_params,
    zero_ranges,
)
