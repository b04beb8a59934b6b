"""Host mesh construction (port of ``repro.launch.mesh``'s group helpers).

``make_host_mesh`` is what the search CLI attaches to a session: a
``("data", "model")`` mesh over the ranks of the default
``torch.distributed`` process group.  Nothing happens at import time.
"""

from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile

import torch.distributed as dist

from repro_torch.core.distributed import Mesh
from repro_torch.kernels.common import resolve_device

__all__ = ["GROUP_TIMEOUT", "make_host_mesh", "mesh_axis_sizes"]

#: how long a collective of a group made here may wait
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def _init_one_rank_group(device) -> None:
    """A one-rank default group through a ``FileStore`` in a temporary
    directory: NCCL for a CUDA device, gloo for the CPU.  It is destroyed
    and its directory removed when the interpreter exits."""
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", store=store, rank=0, world_size=1,
        timeout=GROUP_TIMEOUT,
    )
    group = dist.group.WORLD

    def close():
        if dist.is_initialized() and dist.group.WORLD is group:
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)

    atexit.register(close)


def make_host_mesh(model_axis: int = 1, device=None) -> Mesh:
    """A ``("data", "model")`` mesh of shape ``(world // model_axis,
    model_axis)`` over the default process group, on ``device`` (default:
    the GPU; ``RuntimeError`` when there is none).  With no group
    initialised it starts a one-rank group itself; an initialised group
    is reused."""
    device = resolve_device(device)
    if not dist.is_initialized():
        _init_one_rank_group(device)
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the {world} ranks")
    return Mesh((world // model_axis, model_axis), ("data", "model"), device=device)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.shape)
