"""The port stands alone: it imports and renders in a process where neither
JAX nor the JAX package (``raw2film_tpu``) can be imported (the mosaic
render, Processor.process() of a DNG on both paths, chroma NR, grain mode 3,
a PreviewEngine frame), no file of it imports either, and its entry points
run on the card unless asked for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "raw2film_tpu_torch"

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["raw2film_tpu"] = None  # and so does any import of the JAX package
import threading
import numpy as np
import raw2film_tpu_torch as r2f
from raw2film_tpu_torch import data
bundle, cfg = r2f.load_film_bundle(
    h=64, w=384, halation=False, grain=2, sharpness=True, highlight_burn=0.3, device="cpu"
)
codes = np.random.default_rng(0).integers(600, 15000, (64, 384)).astype(np.uint16)
out = r2f.render_chain_from_mosaic(
    codes, data.REC709_TO_XYZ, bundle, cfg, 7, norm=(512.0, 1.0 / 15000.0), device="cpu"
)
assert out.dtype.is_floating_point is False and tuple(out.shape) == (3, 64, 384)
# halation on, with the 45 MP frame's mixture tier (K10 -> K2 -> K12 -> K14)
bundle, cfg = r2f.load_film_bundle(grain=2, sharpness=True, highlight_burn=0.3, device="cpu")
assert cfg.halation and cfg.scale / 4.0 * cfg.halation_size > 40.0
hal = r2f.render_chain_from_mosaic(
    codes, data.REC709_TO_XYZ, bundle, cfg, 7, norm=(512.0, 1.0 / 15000.0), device="cpu"
)
assert tuple(hal.shape) == (3, 64, 384)
# Processor.process() of a DNG: the staged half-size default, the fused
# full-res path, chroma NR, grain mode 3 (the field alone), then one frame
# of the PreviewEngine
import os, tempfile
from raw2film_tpu_torch.io import dng
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "f.dng")
    dng.write_dng(path, codes[:48, :72].astype(np.float64) * 4, white_level=60000)
    proc = r2f.Processor(device="cpu")
    kw = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima", seed=1)
    half = proc.process(path, **kw)
    full = proc.process(path, half_size=False, max_scale=None, **kw)
    nr = proc.process(path, chroma_nr=3, **kw)
    g3 = proc.process(path, grain=3, **kw)
    frames = []
    done = threading.Event()
    engine = r2f.PreviewEngine(proc, on_frame=lambda img, hist: (frames.append((img, hist)), done.set()),
                               on_error=lambda e: (frames.append(e), done.set()))
    engine.request(path, full_preview=True, **kw)
    assert done.wait(120)
    engine.close()
assert half.shape == nr.shape == g3.shape == (24, 36, 3) and full.shape == (48, 72, 3)
img, hist = frames[0]
assert img.shape == (24, 36, 3) and hist.shape == (100, 256, 4), (img.shape, hist.shape)
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert not loaded & {"jax", "raw2film_tpu"}, loaded & {"jax", "raw2film_tpu"}
print("rendered", tuple(out.shape), float(out.float().mean()))
"""


def test_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert "rendered (3, 64, 384)" in res.stdout


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    return files


def test_no_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _sources() if pattern.search(p.read_text())]
    assert not offenders


def test_no_file_imports_the_jax_package():
    """No import of ``raw2film_tpu`` (the port's own name aside), plain or
    through ``importlib`` or ``__import__``."""
    pattern = re.compile(r"^\s*(from|import)\s+raw2film_tpu\b", re.M)
    dynamic = re.compile(r"(import_module|find_spec|__import__)\(\s*f?[\"']raw2film_tpu\b")
    offenders = [
        str(p.relative_to(ROOT)) for p in _sources()
        if pattern.search(p.read_text()) or dynamic.search(p.read_text())
    ]
    assert not offenders


@pytest.mark.parametrize("entry", ["render_chain_from_mosaic", "load_film_bundle", "Processor",
                                   "generate_histogram"])
def test_entry_points_default_to_cuda(entry):
    """With no device given, an entry point takes the first CUDA device; on
    a machine without one it raises rather than run on the CPU."""
    import raw2film_tpu_torch as r2f
    from raw2film_tpu_torch import data
    from raw2film_tpu_torch.ops.histogram import generate_histogram

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    calls = {
        "render_chain_from_mosaic": lambda: r2f.render_chain_from_mosaic(
            np.zeros((8, 8), np.uint16), data.REC709_TO_XYZ,
            *r2f.load_film_bundle(h=8, w=8, device="cpu"), 0, norm=(0.0, 1.0)),
        "load_film_bundle": lambda: r2f.load_film_bundle(h=8, w=8),
        "Processor": lambda: r2f.Processor(),
        "generate_histogram": lambda: generate_histogram(np.zeros((3, 4, 4), np.uint8)),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
