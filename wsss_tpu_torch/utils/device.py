"""Device resolution for the port's public entry points."""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """The torch.device an entry point runs on.

    The default is the card: a CUDA device asked for on a machine without
    one raises instead of running on the CPU, which only an explicit
    ``device='cpu'`` selects.  On a CUDA device the reference's float32
    numerics are pinned: cuDNN convolutions and cuBLAS matmuls would
    otherwise be allowed to run in TF32."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {device!r} asked for but CUDA is not available; '
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:       # so 'cuda' and 'cuda:0' resolve alike
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r}')
    return dev
