"""Build the network from a state dict or a shipped checkpoint."""

from __future__ import annotations

from effi_mvs_plus_tpu_torch.device import resolve_device
from effi_mvs_plus_tpu_torch.io import load_state_dict
from effi_mvs_plus_tpu_torch.models.effi_mvs import EffiMVS, EffiMVSConfig


def build_model(state_dict, cfg: EffiMVSConfig = EffiMVSConfig(),
                device=None) -> EffiMVS:
    """An ``EffiMVS`` in eval mode on ``device`` (``cuda`` unless the
    caller names another), with ``state_dict`` loaded strictly: no missing
    and no unexpected keys."""
    dev = resolve_device(device)
    model = EffiMVS(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def load_model(path, cfg: EffiMVSConfig = EffiMVSConfig(),
               device=None) -> EffiMVS:
    """``build_model`` from any checkpoint file ``io.load_state_dict``
    reads: a shipped ``checkpoints/*.npz``, a torch ``.ckpt`` or a JAX
    train checkpoint."""
    return build_model(load_state_dict(path), cfg, device)
