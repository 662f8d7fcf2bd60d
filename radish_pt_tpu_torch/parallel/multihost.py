"""Multi-process rendering on ``torch.distributed``.

Port of ``radish_pt_tpu/parallel/multihost.py``.  The single-process mesh
layer (parallel/sharding.py) renders tile by tile; across processes each
rank drives the tiles of its own devices, numbered contiguously by rank,
and the render code does not change.  This module adds the process-level
plumbing:

* :func:`initialize` / :func:`shutdown` — ``init_process_group`` with a
  ``tcp://`` rendezvous (NCCL for CUDA devices, gloo for the CPU) and its
  teardown.
* :func:`make_global_mesh` — the (tile, sample) mesh of all ranks, as seen
  by this one: its own rows, at its tile offset.
* :func:`replicate_scene_global` / :func:`make_sharded_zeros` /
  :func:`shard_state_global` — this rank's share of replicated and
  tile-sharded state (every rank loads the same scene).
* :func:`gather_image` — ``all_gather`` of the tiles, so that every rank
  holds the whole frame.

Launch one process per rank (``python -m
radish_pt_tpu_torch.parallel.multihost_render``, parallel/multihost_render.py).
gloo cannot gather CUDA tensors and NCCL takes one rank a GPU: on one card
run a world of one on NCCL; several CPU processes run on gloo.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import sharding as sh


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """Join the process group at ``tcp://coordinator_address`` as rank
    ``process_id`` of ``num_processes``: NCCL when ``device`` is a CUDA
    device, gloo for the CPU."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group (pairs with :func:`initialize`)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_devices(device="cuda") -> list:
    """This rank's devices: on CUDA the one GPU ``rank % device_count``,
    else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return [device]


def make_global_mesh(n_sample: int = 1, devices=None) -> sh.Mesh:
    """The (tile, sample) mesh over every rank's devices, as this rank
    sees it: its own ``devices`` (None: :func:`local_devices`) as
    ``len(devices) // n_sample`` tiles of ``n_sample`` replicas, and tile
    numbers contiguous by rank (rank r holds tiles r * k .. r * k + k - 1),
    so a display gather concatenates the ranks in order.  Every rank must
    bring as many devices."""
    devices = list(local_devices() if devices is None else devices)
    k = len(devices) // n_sample
    if k < 1:
        raise ValueError(f"{len(devices)} device(s) cannot hold a tile of {n_sample} "
                         f"sample replicas")
    rows = [devices[t * n_sample:(t + 1) * n_sample] for t in range(k)]
    return sh.Mesh(rows, tile_offset=dist.get_rank() * k, n_tile=dist.get_world_size() * k)


def replicate_scene_global(mesh: sh.Mesh, ds) -> dict:
    """The (identical on every rank) scene on this rank's devices."""
    return sh.replicate_scene(mesh, ds)


def make_sharded_zeros(mesh: sh.Mesh, shape, dtype=torch.float32) -> list:
    """This rank's tiles of a tile-sharded global zeros buffer of
    ``shape`` ([n_pad, ...]); no rank holds the whole buffer."""
    per = shape[0] // mesh.shape["tile"]
    return [torch.zeros((per, *shape[1:]), dtype=dtype, device=dev)
            for dev in mesh.tile_devices]


def shard_state_global(mesh: sh.Mesh, tree) -> list:
    """This rank's tiles of a per-rank-identical [n_pad, ...] state (a
    tensor or a dataclass of them)."""
    return sh.shard_image(mesh, tree)


def gather_image(tiles: list) -> np.ndarray:
    """All ranks' tiles, concatenated in tile order, as numpy on every
    rank: one ``all_gather`` of each rank's tiles (equal sizes)."""
    local = sh.gather(tiles).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts).cpu().numpy()
