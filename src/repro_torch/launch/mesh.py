"""Meshes: the production layouts and the meshes over this process group.

The PyTorch counterpart of the reference's ``repro.launch.mesh``.
Functions, not module-level constants: importing this module touches no
device and no process group.

Production topology (abstract: axis names and sizes, for specs only):
    single pod : (16, 16)    axes ("data", "model")          = 256 cards
    two pods   : (2, 16, 16) axes ("pod", "data", "model")   = 512 cards

"pod" composes with "data" for DP/FSDP; "model" carries TP/EP.

``make_host_mesh`` and ``make_data_mesh`` build ``DeviceMesh``es over
the world of the initialised ``torch.distributed`` process group (the
caller gives ``init_process_group`` its address, world size and rank);
without one they return a one-device :class:`AbstractMesh` and
initialise nothing.
"""

from __future__ import annotations

from ..sharding.partition import AbstractMesh


def init_from_env(device_type: str) -> bool:
    """Join the process group a launcher such as ``torchrun`` describes
    (``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` in the
    environment; a group of one rank too where the launcher gave
    ``MASTER_ADDR``): NCCL for ``cuda``, each rank on the card
    ``LOCAL_RANK`` names, gloo otherwise.  Returns whether a group of
    several ranks is up."""
    import os

    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and "MASTER_ADDR" not in os.environ:
        return False
    if not dist.is_initialized():
        if device_type == "cuda":
            import torch
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo")
    return dist.get_world_size() > 1


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(axes, shape)


def _world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """("data", "model") mesh over the process group's ranks, ``model``
    of size ``model_parallel`` cut to the world (as the reference cuts it
    to its devices; the world must be a multiple of the cut size); one
    device, an ``AbstractMesh`` of (1, 1), without a process group."""
    n = _world()
    if not n:
        return AbstractMesh(("data", "model"), (1, 1))
    from torch.distributed.device_mesh import init_device_mesh
    mp = max(1, min(model_parallel, n))
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def make_data_mesh(*, device_type: str = "cuda"):
    """1-D ("data",) mesh over every rank of the process group.

    The DWN classify path is embarrassingly data-parallel (the whole
    frozen model fits any single device), so serving shards only the
    batch axis: ``ServingEngine(data_parallel=True)`` splits a bucket's
    rows over this mesh.
    """
    n = _world()
    if not n:
        return AbstractMesh(("data",), (1,))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


# Hardware constants for bounds, per card: NVIDIA H100 SXM5 80GB HBM3
# at its 700 W limit (NVIDIA data sheet).
PEAK_FLOPS_BF16 = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
NVLINK_BW = 450e9                 # NVLink bytes/s per direction
#: bytes/s per direction between nodes, per card: a DGX H100 gives each
#: of its 8 GPUs one 400 Gb/s InfiniBand port (ConnectX-7; NVIDIA DGX
#: H100 user guide), so a collective whose group leaves an 8-GPU node
#: moves its bytes at this rate
INTERNODE_BW = 400e9 / 8
#: GPUs a node joins by NVLink (a DGX H100)
GPUS_PER_NODE = 8

__all__ = ["GPUS_PER_NODE", "HBM_BW", "INTERNODE_BW", "NVLINK_BW",
           "PEAK_FLOPS_BF16", "init_from_env", "make_data_mesh",
           "make_host_mesh", "make_production_mesh"]
