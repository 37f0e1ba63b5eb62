"""First probe of the stem chain kernel K4 on the card: build the kernels,
then time K4 against its plain version on random weights at three chain
shapes (the T&T feature conv0 3->8->8 and conv3 64->64->64, and the
context conv0 3->4->4), fp32 and bf16, printing one JSON line a case.

    python scripts/torch_probe_conv_chain.py

Needs a CUDA GPU and nvcc.  Inputs are uniform in [0, 1); weights at the
fan-in scale sqrt(2 / (9 Ci)), biases 0.1 N(0, 1); times are the mean of
5 calls between CUDA events after one warm-up.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from effi_mvs_plus_tpu_torch.device import resolve_device  # noqa: E402
from effi_mvs_plus_tpu_torch.ops import _kernels, cuda_conv  # noqa: E402

CASES = (((3, 8, 8), 11, 1056, 1920), ((64, 64, 64), 11, 132, 240),
         ((3, 4, 4), 1, 1056, 1920))


def mean_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    resolve_device("cuda")
    _kernels.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    for chans, B, H, W in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand((B, H, W, chans[0]), generator=g,
                           device="cuda").to(dtype)
            specs = [((2.0 / (9 * ci)) ** 0.5
                      * torch.randn((co, ci, 3, 3), generator=g,
                                    device="cuda"),
                      0.1 * torch.randn((co,), generator=g, device="cuda"))
                     for ci, co in zip(chans[:-1], chans[1:])]
            with torch.inference_mode():
                err = float((cuda_conv.conv_bn_relu_chain(x, specs).float()
                             - cuda_conv._chain_torch(x, specs).float()
                             ).abs().max())
                print(json.dumps({
                    "chans": chans, "shape": [B, H, W], "dtype": str(dtype),
                    "max_abs_err": err,
                    "ms": mean_ms(lambda: cuda_conv.conv_bn_relu_chain(
                        x, specs)),
                    "plain_ms": mean_ms(lambda: cuda_conv._chain_torch(
                        x, specs))}), flush=True)


if __name__ == "__main__":
    main()
