from effi_mvs_plus_tpu_torch.io.torch_import import (  # noqa: F401
    load_npz_checkpoint, load_state_dict, params_from_jax,
)
