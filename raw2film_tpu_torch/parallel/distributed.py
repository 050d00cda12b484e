"""Multi-process batch rendering: the file-list split of the export fleet.

The counterpart of ``raw2film_tpu/parallel/distributed.py``. The CLI's
``--num-processes``/``--process-id`` hand each process its own slice of the
file list (:func:`my_file_slice`), so RAW bytes never cross hosts. Joining
a process group and rendering one global batch across processes
(:func:`init_process`, :func:`distributed_batch_render`) are not ported
yet (ROADMAP.md, queue 1 item 7) and raise NotImplementedError.
"""

from __future__ import annotations

_NOT_PORTED = "{} is not ported yet (ROADMAP.md, queue 1 item 7)"


def init_process(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join a multi-process group (not ported: raises)."""
    raise NotImplementedError(_NOT_PORTED.format("joining a process group (--coordinator)"))


def my_file_slice(files: list, process_id: int, num_processes: int) -> list:
    """Round-robin file assignment — each process decodes only its own
    shard (docs/scaling.md Tier 2 step 3)."""
    return list(files)[process_id::num_processes]


def distributed_batch_render(mesh, cfg, local_xyz, bundle, local_keys):
    """Render a globally-batched image set from per-process local shards
    (not ported: raises)."""
    raise NotImplementedError(_NOT_PORTED.format("distributed_batch_render"))
