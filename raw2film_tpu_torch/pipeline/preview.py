"""Interactive preview engine: latest-wins render coalescing.

The counterpart of ``raw2film_tpu/pipeline/preview.py``: one render thread,
a one-slot "latest request" mailbox and callbacks, so rapid slider changes
collapse into one render with the newest settings. It drives the port's
Processor, and the histogram counts run on the Processor's device.
"""

from __future__ import annotations

import threading
from collections.abc import Callable

import numpy as np

from raw2film_tpu_torch.ops.histogram import generate_histogram
from raw2film_tpu_torch.utils.trace import stage_timer


class PreviewEngine:
    """Drives a Processor for interactive use.

    ``request()`` may be called at any rate from any thread; renders run on
    one worker thread and intermediate requests are dropped (latest wins).
    ``on_frame(image_hwc_u8, histogram_rgba)`` fires per completed render;
    ``on_error(exc)`` on failures.
    """

    def __init__(
        self,
        processor,
        on_frame: Callable[[np.ndarray, np.ndarray], None],
        on_error: Callable[[Exception], None] | None = None,
        histogram_height: int = 100,
        simplified: bool = True,
    ):
        self.processor = processor
        self.on_frame = on_frame
        self.on_error = on_error or (lambda e: None)
        self.histogram_height = histogram_height
        self.simplified = simplified
        # Serializes Processor use between the preview worker and one-shot
        # jobs (e.g. a full-res export) sharing this processor.
        self.proc_lock = threading.Lock()
        self._lock = threading.Condition()
        self._pending: tuple | None = None
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def request(self, src, full_preview: bool = False, **params) -> None:
        """Queue a render with the newest settings (drops older pending)."""
        if not full_preview and self.simplified:
            # The simplified preview drops the conv-heavy stages.
            params = {**params, "sharpness": False, "grain": 0, "halation": False}
        with self._lock:
            self._pending = (src, params)
            self._lock.notify()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._lock.wait()
                if self._stop:
                    return
                src, params = self._pending
                self._pending = None
            try:
                with stage_timer("preview.render"), self.proc_lock:
                    image = self.processor.process(src, **params)
                with stage_timer("preview.histogram"):
                    hist = generate_histogram(
                        image.transpose(2, 0, 1), self.histogram_height,
                        device=self.processor.device,
                    )
                self.on_frame(image, hist)
            except Exception as e:  # keep the loop alive on bad settings
                self.on_error(e)
