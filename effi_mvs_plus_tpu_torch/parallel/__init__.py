from effi_mvs_plus_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, ShardingPolicy, depth_split_error, layout_kinds, make_mesh,
    make_policy, row_blocks_of, row_split_error, use_policy, view_blocks,
)
from effi_mvs_plus_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier, global_mesh, hosts, initialize, is_main, mean_metrics, partition,
    rank, rank_device, world_size,
)
