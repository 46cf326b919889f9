"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("qdm_tpu_torch runs on a CUDA device by default and none "
                           "is available; pass device='cpu' to run on the CPU")
    return dev
