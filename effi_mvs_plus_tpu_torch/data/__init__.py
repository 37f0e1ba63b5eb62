from effi_mvs_plus_tpu_torch.data.pfm import read_pfm, save_pfm  # noqa: F401
from effi_mvs_plus_tpu_torch.data.cams import (  # noqa: F401
    read_cam_file, read_pair_file, write_cam_file,
)
from effi_mvs_plus_tpu_torch.data.registry import (  # noqa: F401
    find_dataset, register_dataset,
)
