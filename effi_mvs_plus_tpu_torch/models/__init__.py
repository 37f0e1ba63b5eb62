from effi_mvs_plus_tpu_torch.models.blocks import freeze_kernel_weights  # noqa: F401
from effi_mvs_plus_tpu_torch.models.effi_mvs import EffiMVS, EffiMVSConfig  # noqa: F401
from effi_mvs_plus_tpu_torch.models.loader import build_model, load_model  # noqa: F401
