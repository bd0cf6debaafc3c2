"""Device meshes: counterpart of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names``
are the reference's axis names (``"pod"``, ``"data"``, ``"model"``), so the
logical-axis rules of :mod:`repro_torch.parallel.sharding` resolve on it.
Building a mesh is collective: every rank of the process group calls the
same function with the same arguments.  Nothing here runs at import.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

# NVIDIA H100 SXM5 80 GB, per card: published peaks from NVIDIA's H100 Tensor
# Core GPU data sheet, not measurements of this port.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor core (data sheet)
HBM_BANDWIDTH = 3.35e12         # B/s, HBM3 (data sheet)
NVLINK_BANDWIDTH = 900e9        # B/s, NVLink 4, all 18 links, both directions (data sheet)
# B/s per card and direction between nodes: one ConnectX-7 NIC per GPU at NDR
# 400 Gb/s (NVIDIA DGX H100 data sheet).  A node holds 8 cards on NVLink, so
# a ring over any 16-wide production mesh axis crosses nodes, and its slowest
# hop, which paces every step of the ring, is this link, not NVLink: the
# roofline's collective term divides a device's wire bytes by it.
INTER_NODE_BANDWIDTH = 50e9


def init_process_group(device_type: str = "cuda", rank: int = 0, world_size: int = 1,
                       init_method: str | None = None) -> None:
    """Joins (or, for ``world_size`` 1, forms) the default process group:
    NCCL on ``"cuda"`` (the rank's card is ``rank % device_count``), gloo
    on ``"cpu"``.  ``init_method`` defaults to a free localhost TCP port,
    which suits a world of one process only; several ranks must share an
    address or a ``file://`` store."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device_type='cpu'")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_method is None:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            init_method = f"tcp://localhost:{s.getsockname()[1]}"
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None = None):
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)`` ranks
    of the world, on CUDA unless ``device_type`` says ``"cpu"``.

    Every rank of the world calls it.  A mesh smaller than the world (an
    elastic shrink from 4 ranks to 2) is built on all of them, and a rank
    outside it gets a mesh on which ``get_coordinate()`` is None: it takes no
    part in that mesh's collectives and may leave."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = device_type or "cuda"
    shape, axes = tuple(shape), tuple(axes)
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks; the world has {world}")
    if n == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The reference's production meshes: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``.  Raises
    unless the world has exactly 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks, not {world}")
    return make_mesh(shape, axes, device_type)


def mesh_chip_count(mesh) -> int:
    return math.prod(tuple(mesh.shape))
