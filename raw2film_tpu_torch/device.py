"""Device checks and the float32 precision settings of the port."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an NVIDIA GPU")
    return torch.device("cuda", 0)


def disable_tf32(verbose: bool = True) -> None:
    """Keep every float32 matmul and convolution in full float32.

    The chain's 3x3 colour mixes and resampling matrices must be exact
    float32; TF32 keeps about three decimal digits. This is the one place
    that sets both flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if verbose:
        print(
            "tf32: matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
        )
