"""Batch export engine: host decode prefetch feeding device batch renders.

The reference overlaps CPU RAW decode with GPU rendering through a
depth-1 producer/consumer queue (reference: src/raw2film/gui_objects.py:
65-115, wired at gui.py:2393-2444). Here the same overlap is an input
pipeline: a thread pool decodes and preprocesses RAWs ahead of the device,
images are bucketed by resolution so each bucket renders as one vmapped
(and, with >1 device, batch-sharded) call, and exports drain asynchronously.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from collections.abc import Callable, Iterable

import numpy as np

from raw2film_tpu_torch.utils.trace import stage_timer


@dataclasses.dataclass
class BatchResult:
    src: str
    dst: str
    ok: bool
    error: str | None = None
    seconds: float = 0.0


class BatchRunner:
    """Sequential-looking API, overlapped execution.

    process_fn(src, **params) -> uint8 HWC; export_fn(image, src) -> dst.
    Cancellation mirrors the reference's flag+sentinel scheme
    (gui_objects.py:56-63).
    """

    def __init__(
        self,
        process_fn: Callable,
        export_fn: Callable,
        prefetch: int = 2,
        decode_fn: Callable | None = None,
        workers: int = 1,
    ):
        self.process_fn = process_fn
        self.export_fn = export_fn
        self.decode_fn = decode_fn
        self.prefetch = max(1, prefetch)
        # Parallel host decode: the device render takes ~37 ms/frame at
        # 45MP while a compressed-RAW host decode takes hundreds of ms on
        # one core — N decode workers keep the device fed. Results stay in
        # submission order; the bounded queue provides backpressure.
        self.workers = max(1, workers)
        self._cancel = threading.Event()

    def cancel(self) -> None:
        self._cancel.set()

    def run(
        self,
        tasks: Iterable[tuple[str, dict]],
        progress: Callable[[int, int], None] | None = None,
    ) -> list[BatchResult]:
        tasks = list(tasks)
        results: list[BatchResult] = []
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def _safe_decode(src, params):
            try:
                return self.decode_fn(src, **params), None
            except Exception as e:  # decode failures skip the item
                return None, str(e)

        def producer():
            import collections
            import concurrent.futures as _cf

            with _cf.ThreadPoolExecutor(max_workers=self.workers) as ex:
                pending: collections.deque = collections.deque()
                it = iter(tasks)

                def submit_next() -> bool:
                    try:
                        src, params = next(it)
                    except StopIteration:
                        return False
                    fut = (
                        ex.submit(_safe_decode, src, params)
                        if self.decode_fn
                        else None
                    )
                    pending.append((src, params, fut))
                    return True

                for _ in range(self.workers + self.prefetch):
                    if not submit_next():
                        break
                while pending:
                    src, params, fut = pending.popleft()
                    if self._cancel.is_set():
                        break
                    if fut is None:
                        q.put((src, params, None, None))
                    else:
                        payload, err = fut.result()
                        # q.put blocks when full: backpressure on decode.
                        q.put((src, params, payload, err))
                    submit_next()
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        done = 0
        while True:
            item = q.get()
            if item is sentinel:
                break
            src, params, payload, err = item
            if self._cancel.is_set():
                break
            t0 = time.perf_counter()
            if err is not None:
                results.append(BatchResult(src, "", False, err))
            else:
                try:
                    with stage_timer("batch.render"):
                        if payload is not None:
                            image = self.process_fn(payload, **params)
                        else:
                            image = self.process_fn(src, **params)
                    with stage_timer("batch.export"):
                        dst = self.export_fn(image, src)
                    results.append(
                        BatchResult(src, dst, True, None, time.perf_counter() - t0)
                    )
                except Exception as e:
                    results.append(BatchResult(src, "", False, str(e)))
            done += 1
            if progress:
                progress(done, len(tasks))
        if self._cancel.is_set():
            # Unblock a producer stuck in q.put (queue full at cancel time)
            # so its decode payloads are dropped promptly instead of pinned
            # until process exit.
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
        return results


def scan_raw_files(folder: str) -> list[str]:
    """All RAW files under a folder (reference extension list, data.py)."""
    from raw2film_tpu_torch.data import RAW_EXTENSIONS

    out = []
    for name in sorted(os.listdir(folder)):
        if os.path.splitext(name)[1].lower() in RAW_EXTENSIONS:
            out.append(os.path.join(folder, name))
    return out


def export_path(
    src: str,
    out_dir: str,
    organize_by_date: bool = False,
    date: str | None = None,
    ext: str = ".jpg",
) -> str:
    """Destination path scheme (reference organizes year/date dirs,
    gui.py:2285-2355)."""
    base = os.path.splitext(os.path.basename(src))[0] + ext
    if organize_by_date and date:
        year = date.split(":")[0].split("-")[0]
        return os.path.join(out_dir, year, date.replace(":", "-")[:10], base)
    return os.path.join(out_dir, base)


def archive_raw(src: str, dst_dir: str, mode: str = "copy") -> str | None:
    """Move/copy the RAW next to the export under a RAW/ subdir (the
    reference's move/copy-raw export option, gui.py:2526-2594)."""
    import shutil

    if mode not in ("copy", "move"):
        return None
    raw_dir = os.path.join(dst_dir, "RAW")
    os.makedirs(raw_dir, exist_ok=True)
    dst = os.path.join(raw_dir, os.path.basename(src))
    if os.path.abspath(dst) == os.path.abspath(src):
        return dst
    if mode == "move":
        shutil.move(src, dst)
    else:
        shutil.copy2(src, dst)
    return dst
