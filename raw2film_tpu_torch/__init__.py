"""raw2film-tpu ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside the JAX one (``raw2film_tpu``), which stays the
reference. ``Processor(device=...).process()`` renders a RAW file (or an
XYZ image) to a uint8 film print, on the fused full-res path or the staged
one, through ten hand-written CUDA kernels (``csrc/``) on a CUDA device and
their plain PyTorch versions on the CPU. This package imports ``torch`` and
never ``jax``.
"""

from raw2film_tpu_torch.pipeline.processor import Processor
from raw2film_tpu_torch.pipeline.render import (
    RenderConfig,
    build_render_config,
    load_film_bundle,
    make_film_bundle,
    render_chain,
    render_chain_from_mosaic,
)

__all__ = [
    "Processor",
    "RenderConfig",
    "build_render_config",
    "load_film_bundle",
    "make_film_bundle",
    "render_chain",
    "render_chain_from_mosaic",
]
