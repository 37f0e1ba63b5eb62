from effi_mvs_plus_tpu_torch.io.jax_checkpoint import (  # noqa: F401
    checkpoint_format, read_jax_checkpoint,
)
from effi_mvs_plus_tpu_torch.io.torch_import import (  # noqa: F401
    complete_state_dict, load_npz_checkpoint, load_state_dict,
    load_torch_checkpoint, params_from_jax, save_npz, torch_leaves,
)
