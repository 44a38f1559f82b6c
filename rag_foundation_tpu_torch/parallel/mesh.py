"""Device mesh, row sharding and processes joined into one mesh.

Counterpart of ``rag_foundation_tpu/parallel/mesh.py``. The JAX engine
is one program that drives every device through ``shard_map`` under
``jit``; here each process holds the ``torch.device`` of each of its
shards, issues each shard's work on that shard's device and gathers the
small ``[Q, k]`` candidate sets to its lead device.

A device list may repeat a device: ``[cpu] * 8`` is the counterpart of
JAX's virtual CPU devices, and ``[cuda:0] * 4`` runs four logical shards
on one card (the same per-shard code, kernels and merge, the shards'
launches in turn on one device). Where a shard lives on the device its
rows already occupy, its block is a view of them, not a copy.

Processes join one mesh through ``init_distributed`` (a
``torch.distributed`` process group): the "shard" axis then spans every
process, each process holds its own consecutive run of shards, and the
sharded searches all-gather their ``[Q, k]`` candidates across the
processes (``topk_merge.merge_over_mesh``), so every process returns the
same result.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
from collections.abc import Sequence

import torch
import torch.distributed as dist


# processes of the joined group on this host (None until
# ``init_distributed`` joins one); ``make_mesh``'s default devices
_LOCAL_PROCESSES: int | None = None


def init_distributed(*, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the processes of a pod into one process group.

    JAX's contract: reads ``RAGTPU_COORDINATOR`` /
    ``RAGTPU_NUM_PROCESSES`` / ``RAGTPU_PROCESS_ID`` where the arguments
    are omitted; with NO coordinator configured this is a no-op returning
    False; a coordinator without the other two raises ValueError naming
    the missing variable. The coordinator is ``host:port`` of process 0,
    which listens there (the store of ``init_method="tcp://host:port"``).

    Before joining, the processes tell each other their host and card
    count through that store (``host_layout``). ``backend`` extends
    JAX's signature (as ``device=`` does elsewhere): None picks
    ``choose_backend``'s (NCCL where every host has a card for each of
    its processes, else gloo, which also runs on the CPU and lets
    processes share a card). Where CUDA is present, the i-th process of
    a host makes that host's card ``i % device_count`` current. After a
    successful join, ``make_mesh(n_shards)`` spans every process.

    Returns True when the process group was initialized by this call."""
    global _LOCAL_PROCESSES
    coordinator = coordinator or os.environ.get("RAGTPU_COORDINATOR")
    if coordinator is None:
        return False
    try:
        num_processes = num_processes if num_processes is not None else \
            int(os.environ["RAGTPU_NUM_PROCESSES"])
        process_id = process_id if process_id is not None else \
            int(os.environ["RAGTPU_PROCESS_ID"])
    except KeyError as e:
        raise ValueError(
            f"RAGTPU_COORDINATOR is set but {e.args[0]} is not — all "
            f"three of COORDINATOR/NUM_PROCESSES/PROCESS_ID are "
            f"required together") from None
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host.strip("[]"), int(port), num_processes,
                          is_master=process_id == 0)
    layout = host_layout(store, num_processes, process_id)
    if backend is None:
        backend = choose_backend(layout)
    name, n_cards = layout[process_id]
    peers = [r for r, (h, _) in enumerate(layout) if h == name]
    _LOCAL_PROCESSES = len(peers)
    if n_cards:
        torch.cuda.set_device(peers.index(process_id) % n_cards)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    return True


def host_layout(store, num_processes: int,
                process_id: int) -> list[tuple[str, int]]:
    """(host name, CUDA cards) of every process, in rank order, exchanged
    through ``store``: each process sets its own entry and waits for
    the others'."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set(f"ragtpu/host/{process_id}",
              f"{n_cards} {socket.gethostname()}")
    keys = [f"ragtpu/host/{r}" for r in range(num_processes)]
    store.wait(keys)
    layout = []
    for key in keys:
        cards, name = store.get(key).decode().split(" ", 1)
        layout.append((name, int(cards)))
    return layout


def choose_backend(layout: Sequence[tuple[str, int]]) -> str:
    """``"nccl"`` when every host of ``layout`` (``host_layout``) has a
    CUDA card for each of its processes, else ``"gloo"`` (NCCL refuses
    two processes on one card). Every process computes it from the same
    layout, so all pick the same."""
    on_host = collections.Counter(name for name, _ in layout)
    ok = all(n_cards >= on_host[name] for name, n_cards in layout)
    return "nccl" if ok else "gloo"


def _local_processes(world: int) -> int:
    """Processes of the group on this host: as ``init_distributed``
    found them, else ``LOCAL_WORLD_SIZE`` (torchrun's), else all."""
    if _LOCAL_PROCESSES is not None:
        return _LOCAL_PROCESSES
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _process_group() -> tuple[int, int]:
    """(world size, rank) of the joined processes; (1, 0) when none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A ``data x shard`` grid of devices, with JAX ``Mesh``'s ``shape``
    (axis name -> size) and ``axis_names``.

    ``grid[r]`` is this process's row ``r`` of shards (global shards
    ``shard_offset`` onward); ``devices`` is row 0, the row the sharded
    searches read (their outputs are replicated, so every row would give
    the same result), with ``lead`` first; ``shape["shard"]`` counts the
    shards of every process."""

    axis_names = ("data", "shard")

    def __init__(self, grid: Sequence[Sequence[torch.device | str]], *,
                 n_shards: int | None = None, shard_offset: int = 0):
        self.grid = tuple(tuple(torch.device(d) for d in row)
                          for row in grid)
        if not self.grid or not self.grid[0]:
            raise ValueError("a mesh needs at least one device")
        if any(len(row) != len(self.grid[0]) for row in self.grid):
            raise ValueError("the rows of a mesh differ in length")
        self.devices = self.grid[0]
        self.shard_offset = shard_offset
        self.shape = {"data": len(self.grid),
                      "shard": n_shards or len(self.devices)}

    @property
    def lead(self) -> torch.device:
        """Where the merged results are gathered."""
        return self.devices[0]

    @property
    def spans_processes(self) -> bool:
        """Whether other processes hold some of the shards."""
        return self.shape["shard"] != len(self.devices)


def make_mesh(n_shards: int | None = None, *, data: int = 1,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A ``data x n_shards`` mesh, rows filled in order from ``devices``
    (default: every visible CUDA card; after ``init_distributed``, this
    process's current card where the host runs more than one process of
    the group). ``n_shards`` defaults to all of them over ``data``.
    Raises when there are fewer devices, as JAX's ``make_mesh`` does.

    In a process group of W processes, each holding ``devices``, the
    mesh has ``W * len(devices)`` devices: its "shard" axis spans the
    processes, process r holding shards ``[r * n, (r + 1) * n)`` with
    ``n = n_shards / W``. Such a mesh has one row (``data`` 1)."""
    world, rank = _process_group()
    if devices is None:
        if world > 1 and _local_processes(world) > 1 \
                and torch.cuda.is_available():
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            n_cards = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = list(devices)
    have = world * len(devices)
    if data < 1:
        raise ValueError(f"need at least one row of shards, got data="
                         f"{data}")
    if n_shards is None:
        n_shards = have // data
    if n_shards < 1:
        raise ValueError(f"need at least one device, got n_shards="
                         f"{n_shards}")
    if data * n_shards > have:
        raise ValueError(f"need {data * n_shards} devices, have {have}")
    if world == 1:
        return Mesh([devices[r * n_shards:(r + 1) * n_shards]
                     for r in range(data)])
    if data != 1:
        raise ValueError(f"data={data}: a mesh across {world} processes "
                         f"spans them with its shard axis only")
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} "
                         f"processes")
    local = n_shards // world
    return Mesh([devices[:local]], n_shards=n_shards,
                shard_offset=rank * local)


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
    without waiting (a copy to the host waits: its result is read next).
    Differentiable: the gradient of a copy flows back to ``t``."""
    if t.device == device and not copy:
        return t
    return t.to(device, copy=copy, non_blocking=device.type == "cuda")


def shard_rows(mesh: Mesh, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``[N, ...]`` split into ``mesh.shape["shard"]`` equal row blocks;
    this process's blocks, block s on ``mesh.devices[s]`` (on a mesh
    that spans processes, the blocks of its own shards). N must divide
    by the shard count (pad and pass ``valid_counts`` to
    ``sharded_topk`` otherwise). Blocks on the tensor's own device are
    views of it."""
    n_shards = mesh.shape["shard"]
    if t.shape[0] % n_shards:
        raise ValueError(f"{t.shape[0]} rows do not divide by {n_shards} "
                         f"shards")
    rows = t.shape[0] // n_shards
    return tuple(place(t[g * rows:(g + 1) * rows], dev)
                 for g, dev in enumerate(mesh.devices, mesh.shard_offset))


def replicate(mesh: Mesh, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``t`` on every shard's device (the tensor itself where it is
    already there)."""
    return tuple(place(t, dev) for dev in mesh.devices)
