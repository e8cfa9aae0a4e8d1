"""The process mesh and the multi-process bootstrap (counterpart of
``glass_tpu/parallel/mesh.py``).

The framework's two parallel axes:

- ``graph``: the node partition of the background graph
  (``parallel/partition.py``); its collectives are the halo exchange and
  the GraphNorm statistics;
- ``data``: subgraph-batch data parallelism (a replicated model, averaged
  gradients).

One process per rank and one device per rank: rank = d * graph_shards + g,
as JAX's ``devices.reshape(data, graph)`` lays them out. Call
:func:`initialize_distributed` first, then :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Collectives wait this long for a peer before they fail (a hung rank fails
# the run rather than stalling it).
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: Optional[str] = None,
    local_cpu_devices: Optional[int] = None,
) -> None:
    """Joins this process to the process group (a no-op once joined).

    ``coordinator_address`` "host:port" (``tcp://`` is prepended) or a full
    ``tcp://`` or ``file://`` URL, with ``num_processes`` and
    ``process_id``; with none of the three, torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), which
    ``--multihost`` selects. The backend is NCCL where a card is present,
    and ``cpu_collectives`` ("gloo" or "mpi") otherwise or when given: the
    collectives' backend, whatever device the tensors lie on (a gloo group
    with CUDA tensors moves them through the host, ``ops/collectives.py``).
    A CUDA rank binds to card LOCAL_RANK (or its rank) modulo the cards
    present. ``local_cpu_devices`` other than 1 raises: a rank owns one
    device."""
    if local_cpu_devices not in (None, 1):
        raise ValueError(
            f"local_cpu_devices={local_cpu_devices}: a torch rank owns one "
            "device; start one process per device instead")
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        init_method, kw = "env://", {}
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("--coordinator, --num_processes and "
                             "--process_id go together")
        init_method = coordinator_address
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
        kw = dict(world_size=int(num_processes), rank=int(process_id))
    backend = cpu_collectives or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            timeout=TIMEOUT, **kw)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, graph) mesh and the two subgroups it
    belongs to: ``graph_group`` (its data row's graph_shards ranks) and
    ``data_group`` (its graph column's data_shards ranks). A one-rank axis
    without a process group has group None."""

    data_shards: int
    graph_shards: int
    data_rank: int
    graph_rank: int
    data_group: Optional[object] = None
    graph_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.data_shards, "graph": self.graph_shards}

    @property
    def backend(self) -> Optional[str]:
        """The collectives' backend ("nccl", "gloo", ...), None without a
        process group."""
        return dist.get_backend() if dist.is_initialized() else None


def make_mesh(graph_shards: int = 1, data_shards: Optional[int] = None) -> Mesh:
    """Builds this rank's ('data', 'graph') mesh over the process group's
    ranks (world size = data_shards * graph_shards; ``data_shards``
    defaults to world size // graph_shards). Every rank must call it, in
    the same order as any other group creation; a shape built before in
    this process group reuses its subgroups. Without a process group only
    the 1 x 1 mesh exists."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data_shards is None:
        if n % graph_shards:
            raise ValueError(f"{n} devices not divisible by "
                             f"graph_shards={graph_shards}")
        data_shards = n // graph_shards
    if not dist.is_initialized() and data_shards * graph_shards > 1:
        raise RuntimeError(
            f"graph_shards x data_shards = {graph_shards * data_shards} ranks "
            "need a process group, one process per rank: launch them with "
            "torchrun and --multihost, or with --coordinator host:port "
            "--num_processes N --process_id i each "
            "(glass_tpu_torch.parallel.mesh.initialize_distributed)")
    if data_shards * graph_shards != n:
        raise ValueError(f"data_shards*graph_shards = "
                         f"{data_shards * graph_shards} != {n} devices")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0)
    d, g = divmod(dist.get_rank(), graph_shards)
    rows, columns = _subgroups(data_shards, graph_shards)
    return Mesh(data_shards, graph_shards, d, g, columns[g], rows[d])


# (data_shards, graph_shards) -> (the mesh's rows, its columns), for the
# process group _SUBGROUPS["world"]: a mesh built again reuses its groups
# (each new group holds communicators that nothing frees)
_SUBGROUPS: dict = {}


def _subgroups(data_shards: int, graph_shards: int) -> tuple:
    if _SUBGROUPS.get("world") is not dist.group.WORLD:
        _SUBGROUPS.clear()
        _SUBGROUPS["world"] = dist.group.WORLD
    key = (data_shards, graph_shards)
    if key not in _SUBGROUPS:
        # every rank creates every subgroup, in one order
        rows = [dist.new_group([dd * graph_shards + gg
                                for gg in range(graph_shards)])
                for dd in range(data_shards)]
        columns = [dist.new_group([dd * graph_shards + gg
                                   for dd in range(data_shards)])
                   for gg in range(graph_shards)]
        _SUBGROUPS[key] = rows, columns
    return _SUBGROUPS[key]
