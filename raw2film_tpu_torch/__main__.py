"""``python -m raw2film_tpu_torch`` entry point.

Mirrors the reference's frozen-app entry (reference:
src/raw2film/__main__.py, the Analysis entry script of raw2film.spec) and
doubles as the PyInstaller entry for raw2film_tpu_torch.spec.
"""

from __future__ import annotations

import sys

from raw2film_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
