"""Where the port runs: the one rule every entry point applies.

The card unless the caller asks for the CPU. With no card and no explicit
"cpu" the entry points raise instead of carrying on on the host, so a run
that believes it measured the GPU never silently measured the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch.device an entry point computes on.

    None means "cuda:0". "cpu" (or a CPU torch.device) is honoured as asked.
    A CUDA device requested without an available card raises RuntimeError.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
