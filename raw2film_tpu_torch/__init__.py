"""raw2film-tpu ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside the JAX one (``raw2film_tpu``), which stays the
reference; this one stands alone, with its own copies of the numpy modules
it needs (film science, RAW readers, the native decoders). It imports
``torch`` and never ``jax`` or ``raw2film_tpu``.

``Processor().process()`` renders a RAW file (or an XYZ image) to a uint8
film print on the fused full-res path or the staged one, and
``PreviewEngine`` drives it interactively. Every TPU kernel of the JAX
package has a hand-written CUDA counterpart (``csrc/``); the entry points
run on the first CUDA device unless given ``device="cpu"``, where the
kernels' plain PyTorch versions run.
"""

from raw2film_tpu_torch.pipeline.preview import PreviewEngine
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
    "PreviewEngine",
    "Processor",
    "RenderConfig",
    "build_render_config",
    "load_film_bundle",
    "make_film_bundle",
    "render_chain",
    "render_chain_from_mosaic",
]
