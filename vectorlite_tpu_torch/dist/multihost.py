"""Multi-process mesh support on ``torch.distributed``.

Port of ``vectorlite_tpu/dist/multihost.py``. One process per host (or per
card), each holding only its own shards, joined by a process group into
one mesh (``sharding.make_mesh(devices, group=...)``). Shards are
rank-major: the global index of a process's s-th shard is ``rank *
local_shards + s``, so the merged results break ties in global-row order
as on one process. The backend follows the mesh's device: NCCL for CUDA
tensors, gloo on the CPU; a group of the other backend is refused, never
swapped for a fallback.

Each process passes the same full host array to :func:`place_global` and
uploads only the rows of its own shards; the merged ``[B, k]`` winners
are all-gathered (``all_gather_into_tensor``) and merged again, so every
process holds the result and :func:`fetch_replicated` needs no
collective.

``torch.distributed`` is imported as ``tdist`` here, never as ``dist``,
which names this package.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as tdist

from .sharding import Mesh, shard_rows


def backend_for(device) -> str:
    """The collective backend of tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device, *, rank: int, world_size: int, init_method: str):
    """Start the default process group with the backend ``device`` needs
    (``init_method``: ``tcp://localhost:<port>`` or ``file://<path>``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    tdist.init_process_group(
        backend_for(device), init_method=init_method, rank=rank,
        world_size=world_size,
    )


def check_backend(group, device) -> None:
    want = backend_for(device)
    got = str(tdist.get_backend(group)).lower()
    if got != want:
        raise ValueError(
            f"a mesh on {torch.device(device).type} needs a {want} process "
            f"group, not {got}"
        )


def place_global(mesh: Mesh, host) -> list:
    """This process's part of a ``[cap, ...]`` host array every process
    passes whole: the rows of its own shards, one tensor a shard on the
    shard's device (queries need no placing: the sharded engines copy
    them to each shard's device)."""
    return shard_rows(mesh, host)


def gather_ranks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` of every process, stacked rank-major: [world, *t.shape]."""
    t = t.contiguous()
    out = torch.empty((mesh.world * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with warnings.catch_warnings():
        # the name is deprecated in newer releases, but it is the one that
        # gloo and NCCL both serve across the supported versions
        warnings.simplefilter("ignore", FutureWarning)
        tdist.all_gather_into_tensor(out, t, group=mesh.group)
    return out.view(mesh.world, *t.shape)


def sum_ranks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of ``t`` over every process."""
    t = t.contiguous().clone()
    tdist.all_reduce(t, group=mesh.group)
    return t


def fetch_replicated(t: torch.Tensor) -> np.ndarray:
    """Host copy of a merged result: every process holds all of it, so
    the fetch needs no collective."""
    return t.cpu().numpy()


def barrier(mesh: Mesh | None = None) -> None:
    """Cross-process sync point (a no-op on one process)."""
    group = None if mesh is None else mesh.group
    if tdist.is_available() and tdist.is_initialized() and tdist.get_world_size(group) > 1:
        tdist.barrier(group=group)
