"""Device mesh and row sharding for one controlling process.

Counterpart of ``rag_foundation_tpu/parallel/mesh.py``. The JAX engine
is one process that drives every device through ``shard_map`` under
``jit``; here the same process holds the ``torch.device`` of each
shard, issues each shard's work on that shard's device and
gathers the small ``[Q, k]`` candidate sets to the lead device.

A device list may repeat a device: ``[cpu] * 8`` is the counterpart of
JAX's virtual CPU devices, and ``[cuda:0] * 4`` runs four logical shards
on one card (the same per-shard code, kernels and merge, the shards'
launches in turn on one device). Where a shard lives on the device its
rows already occupy, its block is a view of them, not a copy.

Not here yet: ``init_distributed`` (hosts joined into one mesh).
"""

from __future__ import annotations

import contextlib
from collections.abc import Sequence

import torch


class Mesh:
    """The devices of a mesh's "shard" axis, shard s on ``devices[s]``,
    with JAX ``Mesh``'s ``shape`` (axis name -> size) and ``axis_names``.
    The "data" axis is always 1: the sharded functions' outputs are
    replicated, so further rows of devices would only repeat the work."""

    axis_names = ("data", "shard")

    def __init__(self, devices: Sequence[torch.device | str]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"data": 1, "shard": len(self.devices)}

    @property
    def lead(self) -> torch.device:
        """Where the merged results are gathered."""
        return self.devices[0]


def make_mesh(n_shards: int | None = None, *, data: int = 1,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh over the first ``n_shards`` devices of ``devices`` (default:
    every visible CUDA card; ``n_shards`` defaults to all of them). Raises
    when there are fewer, as JAX's ``make_mesh`` does. ``data`` is JAX's
    signature; only 1 is served (see ``Mesh``)."""
    if data != 1:
        raise ValueError(f"data={data}: only one row of shards is served")
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = list(devices)
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1:
        raise ValueError(f"need at least one device, got n_shards="
                         f"{n_shards}")
    if n_shards > len(devices):
        raise ValueError(f"need {n_shards} devices, have {len(devices)}")
    return Mesh(devices[:n_shards])


def on_device(device: torch.device):
    """Context that makes ``device`` current for kernels launched inside
    (the CUDA wrappers launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def place(t: torch.Tensor, device: torch.device, *,
          copy: bool = False) -> torch.Tensor:
    """``t`` on ``device``: the tensor itself (a view stays a view) when
    it is there already, unless ``copy``. A copy to a card is queued
    without waiting (a copy to the host waits: its result is read next)."""
    if t.device == device and not copy:
        return t
    return t.to(device, copy=copy, non_blocking=device.type == "cuda")


def shard_rows(mesh: Mesh, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``[N, ...]`` split into ``n_shards`` equal row blocks, block s on
    shard s's device. N must divide by the shard count (pad and pass
    ``valid_counts`` to ``sharded_topk`` otherwise). Blocks on the
    tensor's own device are views of it."""
    n_shards = mesh.shape["shard"]
    if t.shape[0] % n_shards:
        raise ValueError(f"{t.shape[0]} rows do not divide by {n_shards} "
                         f"shards")
    rows = t.shape[0] // n_shards
    return tuple(place(t[s * rows:(s + 1) * rows], dev)
                 for s, dev in enumerate(mesh.devices))


def replicate(mesh: Mesh, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``t`` on every shard's device (the tensor itself where it is
    already there)."""
    return tuple(place(t, dev) for dev in mesh.devices)
