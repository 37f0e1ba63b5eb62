from effi_mvs_plus_tpu_torch.fuse.dypcd import (  # noqa: F401
    consistency, consistency_scene, consistency_tank, fuse_scene,
    fuse_scene_device,
)
from effi_mvs_plus_tpu_torch.fuse.ply import read_ply, write_ply  # noqa: F401
