"""The reference's precision, and the controls and planted faults that the
limits are read against.

The reference computes in fp32 with TF32 off whatever the process's
switches were before: ``precision`` sets them for its own run and puts
them back after, so the program under test cannot move the yardstick's
precision.  A control is the reference computed one precision below
what the configuration states: fp8 (e4m3, one scale a tensor) for every
convolution's and the correlation's operands where the configuration
computes in bf16; TF32 (``precision(tf32=True)``, the only way the
benchmark turns it on) where it computes in fp32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0                     # the largest finite float8_e4m3fn


def fp8(t):
    """t rounded to fp8 e4m3 under one scale that maps its largest
    magnitude to the format's largest, and back to t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def switches():
    """(matmul TF32, cuDNN TF32, float32 matmul precision) as set now."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@contextlib.contextmanager
def precision(tf32=False):
    """Matrix products and cuDNN convolutions in true fp32 inside (TF32
    with ``tf32``), the switches restored on the way out."""
    saved = switches()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
