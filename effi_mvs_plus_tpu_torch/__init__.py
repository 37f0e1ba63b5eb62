"""effi_mvs_plus_tpu_torch — the PyTorch/CUDA port of effi_mvs_plus_tpu.

The JAX package beside it is the reference this package is held against.
Module paths and names mirror it (``core/geometry.py``,
``models/effi_mvs.py``, ``infer/engine.py`` ...), so each function has an
obvious counterpart.  Public functions keep the JAX layouts: channels-last
``(B, V, H, W, 3)`` images, ``(B, h, w)`` depths, ``(B, V, D, h, w)``
correlations.

The Pallas kernels of the serving and training paths are hand-written
CUDA C++ for Hopper (``csrc/``): the warp + correlation (K1) and its
backward (K3), and the ConvGRU step (K2), built with nvcc at first use and
bound with ctypes (``ops/_kernels.py``).  Each wrapper launches its kernel
for a CUDA tensor and takes the plain PyTorch version beside it only for a
CPU tensor.

Entry points (``InferenceEngine``, ``models.load_model``, the train and
eval steps of ``train/trainer.py``, ``cli/train.py``) run on ``cuda``
unless the caller passes ``device="cpu"``; with no GPU they raise.
"""

__version__ = "0.1.0"
