"""Multi-process batch rendering: the file-list split and the process group.

The counterpart of ``raw2film_tpu/parallel/distributed.py``. Every process
decodes its own slice of the file list (:func:`my_file_slice`), so RAW bytes
never cross hosts, and renders its own images over its own devices
(:func:`distributed_batch_render`). The batch axis needs no collective, so
only control messages cross processes: the group is ``torch.distributed``
on gloo (:func:`init_process`), which runs on any host, and two processes
can share one GPU, which NCCL ranks cannot.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def init_process(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the process group whose rank 0 listens at
    ``coordinator_address`` (host:port); blocks until all
    ``num_processes`` have joined."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def my_file_slice(files: list, process_id: int, num_processes: int) -> list:
    """Round-robin file assignment — each process decodes only its own
    shard (docs/scaling.md Tier 2 step 3)."""
    return list(files)[process_id::num_processes]


def distributed_batch_render(mesh, cfg, local_xyz, bundle, local_keys):
    """Render this process's part of a global batch over its own mesh.

    local_xyz: (B_local, 3, H, W) float32, this process's images, where the
    global batch is process-major (process 0's images first) with equal
    shares; local_keys: their B_local uint32 grain seeds (a JAX key k maps
    to k[0] ^ k[1]). Every process must hold the same local batch shape and
    config: checked across the group before rendering. Returns this
    process's (B_local, 3, H, W) uint8 as numpy."""
    from raw2film_tpu_torch.parallel.mesh import sharded_batch_render
    from raw2film_tpu_torch.utils.trace import to_device, to_host

    if not dist.is_initialized():
        raise RuntimeError("distributed_batch_render: join a process group first (init_process)")
    local_xyz = to_device(local_xyz, mesh.devices[0][0], torch.float32)
    mine = (tuple(local_xyz.shape), cfg)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if any(other != mine for other in every):
        raise RuntimeError(
            "distributed_batch_render: the processes hold different local batches or "
            f"configs: {[o[0] for o in every]}"
        )
    out = sharded_batch_render(mesh, cfg)(local_xyz, bundle, np.asarray(local_keys))
    return to_host(out).numpy()
