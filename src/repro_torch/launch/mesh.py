"""Device meshes over the process group: the twin of
`repro.launch.mesh`.

`make_mesh` builds a `DeviceMesh` with named dimensions over the process
group that is already initialised; it never initialises one itself (a
caller gives `torch.distributed.init_process_group` its backend, store,
rank and world size, e.g. a one-rank NCCL group on one card, or a fake
group of 256 or 512 ranks in one process on the CPU).
`make_production_mesh` is the reference's 16x16 single-pod (256 chips) or
2x16x16 two-pod (512 chips) layout.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh", "batch_axes_for"]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` with dimensions named `axes`, over the
    first `prod(shape)` ranks of the initialised process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {tuple(shape)} needs an initialised process group of at "
            f"least {n} ranks: call torch.distributed.init_process_group "
            "(backend, store, rank, world_size) first")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 chips) or 2x16x16 two-pod (512 chips) mesh.

    Axis order is (pod,) data, model — "pod" is the slowest
    (DCN-connected) dimension, so only data-parallel collectives cross
    pods.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes_for(mesh, global_batch: int) -> Tuple[str, ...]:
    """Mesh axes for the logical "batch" dimension.

    Uses ("pod", "data") when both exist and divide the batch; degrades to
    ("data",) or () for small-batch (e.g. batch-1 long-context decode)
    shapes where batch sharding is impossible.
    """
    names = tuple(mesh.mesh_dim_names)
    axes = [a for a in ("pod", "data") if a in names]
    while axes:
        size = math.prod(mesh.size(names.index(a)) for a in axes)
        if global_batch % size == 0:
            return tuple(axes)
        axes.pop(0)         # drop "pod" first
    return ()
