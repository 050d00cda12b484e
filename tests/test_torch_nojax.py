"""The port imports and renders in a process where JAX cannot be imported
(the render chain, and Processor.process() of a DNG on both paths), and no
file of it imports JAX."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "raw2film_tpu_torch"

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import raw2film_tpu_torch as r2f
from raw2film_tpu_torch._reference import data
bundle, cfg = r2f.load_film_bundle(
    h=64, w=384, halation=False, grain=2, sharpness=True, highlight_burn=0.3
)
codes = np.random.default_rng(0).integers(600, 15000, (64, 384)).astype(np.uint16)
out = r2f.render_chain_from_mosaic(
    codes, data.REC709_TO_XYZ, bundle, cfg, 7, norm=(512.0, 1.0 / 15000.0)
)
assert out.dtype.is_floating_point is False and tuple(out.shape) == (3, 64, 384)
# halation on, with the 45 MP frame's mixture tier (K10 -> K2 -> K12 -> K14)
bundle, cfg = r2f.load_film_bundle(grain=2, sharpness=True, highlight_burn=0.3)
assert cfg.halation and cfg.scale / 4.0 * cfg.halation_size > 40.0
hal = r2f.render_chain_from_mosaic(
    codes, data.REC709_TO_XYZ, bundle, cfg, 7, norm=(512.0, 1.0 / 15000.0)
)
assert tuple(hal.shape) == (3, 64, 384)
# Processor.process() of a DNG: the staged half-size default and the fused
# full-res path
import os, tempfile
from raw2film_tpu_torch._reference import dng
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "f.dng")
    dng.write_dng(path, codes[:48, :72].astype(np.float64) * 4, white_level=60000)
    proc = r2f.Processor(device="cpu")
    kw = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima", seed=1)
    half = proc.process(path, **kw)
    full = proc.process(path, half_size=False, max_scale=None, **kw)
assert half.shape == (24, 36, 3) and full.shape == (48, 72, 3), (half.shape, full.shape)
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
print("rendered", tuple(out.shape), float(out.float().mean()))
"""


def test_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert "rendered (3, 64, 384)" in res.stdout


def test_no_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert files
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders
