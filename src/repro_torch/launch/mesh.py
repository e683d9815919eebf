"""The meshes (port of ``repro/launch/mesh.py``).

Functions, never module-level constants: importing this module touches
no process group. Both build a named ``DeviceMesh`` over the initialised
default process group (``torch.distributed.init_process_group`` first;
``torchrun`` or the caller gives it its address, world size and rank),
on the card unless the caller names another device type."""
from __future__ import annotations

import torch.distributed as dist


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world} — launch one "
            f"rank per card, {n} in all (torchrun)")
    if world != n:
        raise RuntimeError(f"mesh {shape} needs a world of exactly {n} "
                           f"ranks, found {world}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1, device_type=None):
    """(world // model_axis, model_axis) mesh named ("data", "model") over
    the initialised process group (a world of one without one)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    data = world // model_axis
    if data * model_axis != world:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return init_device_mesh(_device_type(device_type), (data, model_axis),
                            mesh_dim_names=("data", "model"))
