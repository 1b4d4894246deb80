"""Production mesh builders: the port of ``repro/launch/mesh.py`` as
``torch.distributed`` ``DeviceMesh``es.

Mesh axes, as the reference's:
  single-pod : (16, 16)      ("data", "model")         — 256 devices
  multi-pod  : (2, 16, 16)   ("pod", "data", "model")  — 512 devices
The "pod" axis is an outer data-parallel axis; params are FSDP-sharded
over ("pod", "data") in the multi-pod regime.

A mesh is built over the default process group, which the caller
initialises: ``launch/dryrun.py`` uses torch's fake backend (no device, no
communication) with 256 or 512 ranks; a real run one rank a device.
Nothing here runs at import.
"""
from __future__ import annotations

import math

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh_torch(multi_pod: bool = False,
                               device_type: str = "cpu"):
    """The (16, 16) or (2, 16, 16) production mesh over the default
    process group, which must hold at least 256 or 512 ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks, have "
            f"{have}; run under launch/dryrun.py, which initialises a fake "
            f"group of 256 or 512 ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh_torch(data: int = 1, model: int = 1,
                          device_type: str = "cpu"):
    """A small ("data", "model") mesh over the first ``data * model`` ranks
    of the default process group (tests)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = data * model
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"a ({data}, {model}) mesh needs a process group "
                           f"of at least {n} ranks")
    import torch
    ranks = torch.arange(n).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def dp_axes_torch(mesh) -> tuple:
    """The data-parallel (batch/FSDP) mesh axes for a mesh."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
