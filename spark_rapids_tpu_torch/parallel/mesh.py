"""The rank mesh and the all_to_all block exchange.

[REF: sql-plugin/../shuffle/ucx/UCX.scala, RapidsShuffleServer/Client]

The counterpart of the JAX package's ``parallel/mesh.py``.  There a mesh
is a 1-D ``jax.sharding.Mesh`` over the devices and every shuffle stage
is one SPMD program around ``lax.all_to_all``.  Here a ``Mesh`` is an
ordered list of ranks, each with the ``torch.device`` that holds its
shard; ranks of a multi-executor run that live in other processes carry
no device in this one.

The JAX package's tests force eight virtual CPU devices through XLA's
``--xla_force_host_platform_device_count``, and its ICI plane turns on
only when the mesh has more than one device.  The port's counterpart
is a process-wide count of **virtual ranks**
(``TPUQ_VIRTUAL_RANKS=<n>`` in the environment, or
``set_virtual_ranks(n)`` before the first mesh): it is read once, when
the first mesh is built, and its ranks all share the device the
session runs on (``cuda:0`` on a one-card machine, the CPU in tests).
Without it, the rank count is the number of real devices of the
session's kind: the CUDA devices, or one CPU.  A mesh is always built
on the session's device kind: it never lands on the CPU when the session
runs on the card.

Ranks that share a device form one **group**; an exchange lays a group
out as one stacked tensor (``[ranks x rows]``), so that one launch
serves all of them.  On one device the all_to_all is a block exchange
on that device (a transpose of the ``[source, destination]`` blocks);
across devices of one process it is copies between them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch.runtime import lockdep

VIRTUAL_RANKS_ENV = "TPUQ_VIRTUAL_RANKS"

_lock = lockdep.tracked_lock("parallel.mesh._lock")
_virtual: Optional[int] = None
_latched = False


def set_virtual_ranks(n: Optional[int]) -> None:
    """Set the process-wide virtual rank count (None: the real devices).
    Must come before the first mesh is built; setting the count a mesh
    was already built with again is a no-op."""
    global _virtual
    if n is not None and int(n) < 1:
        raise ValueError(f"virtual rank count must be >= 1, got {n}")
    with _lock:
        want = None if n is None else int(n)
        if _latched and want != _virtual:
            raise RuntimeError(
                f"the virtual rank count is already {_virtual} (read when "
                "the first mesh was built); set it before any mesh exists")
        _virtual = want


def virtual_ranks() -> Optional[int]:
    """The virtual rank count, latched at its first read (None: unset)."""
    global _virtual, _latched
    with _lock:
        if not _latched:
            if _virtual is None:
                env = os.environ.get(VIRTUAL_RANKS_ENV, "").strip()
                if env:
                    n = int(env)
                    if n < 1:
                        raise ValueError(
                            f"{VIRTUAL_RANKS_ENV} must be >= 1, got {env}")
                    _virtual = n
            _latched = True
        return _virtual


def rank_count(device: torch.device) -> int:
    """Ranks a mesh on ``device``'s kind has in this process."""
    v = virtual_ranks()
    if v is not None:
        return v
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


class Mesh:
    """An ordered list of ranks.

    ``devices[r]`` holds rank r's shard (None for a rank of another
    process); ``process_of[r]`` is its executor process.  ``group_of``
    (optional) splits this process's ranks into groups explicitly;
    by default ranks group by device."""

    def __init__(self, devices: Sequence[Optional[torch.device]],
                 process_of: Optional[Sequence[int]] = None,
                 process_index: int = 0,
                 group_of: Optional[Sequence[int]] = None):
        self.devices: Tuple[Optional[torch.device], ...] = tuple(
            None if d is None else torch.device(d) for d in devices)
        self.process_of = tuple(process_of if process_of is not None
                                else [0] * len(self.devices))
        self.process_index = int(process_index)
        if group_of is None:
            group_of, key = [], {}
            for d in self.devices:
                group_of.append(key.setdefault(str(d), len(key)))
        self.group_of = tuple(group_of)
        for r in self.local_ranks():
            if self.devices[r] is None:
                raise ValueError(f"local rank {r} has no device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_ranks(self) -> List[int]:
        return [r for r in range(self.size)
                if self.process_of[r] == self.process_index]

    def groups(self) -> List[Tuple[torch.device, List[int]]]:
        """This process's ranks by group, in rank order: (device,
        ranks).  A group's ranks are contiguous and share a device."""
        out: List[Tuple[torch.device, List[int]]] = []
        for r in self.local_ranks():
            if out and self.group_of[out[-1][1][-1]] == self.group_of[r]:
                out[-1][1].append(r)
            else:
                out.append((self.devices[r], [r]))
        return out

    def __repr__(self):
        return (f"Mesh(size={self.size}, process={self.process_index}, "
                f"groups={[(str(d), r) for d, r in self.groups()]})")


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """Mesh over the first n ranks of the session's device kind (the
    executor group's global mesh in a multi-executor run).

    SQL shuffle parallelism is 1-D by nature (partitions), as in the JAX
    package: partition/shuffle parallelism IS the distribution
    mechanism."""
    from spark_rapids_tpu_torch.parallel.executor import get_executor
    ctx = get_executor()
    if ctx is not None:
        if n_devices is not None and n_devices != ctx.mesh.size:
            raise ValueError(
                f"a multi-executor mesh has {ctx.mesh.size} ranks; "
                f"{n_devices} were asked for")
        return ctx.mesh
    if device is None:
        # never a silent CPU mesh beside a session on the card
        raise ValueError("make_mesh needs the session's device")
    device = torch.device(device)
    count = rank_count(device)
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise ValueError(f"a mesh of {n} ranks on {device.type}: only "
                         f"{count} rank(s) exist")
    if virtual_ranks() is not None or device.type != "cuda":
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return Mesh([device] * n)
    return Mesh([torch.device("cuda", i) for i in range(n)])


def all_to_all_shuffle(mesh: Mesh, parts: Union[torch.Tensor,
                                                Sequence[torch.Tensor]]):
    """The collective exchange of blocks.

    ``parts[d, p]`` is the block rank d holds for rank p.  Returns
    ``out`` with ``out[d, p]`` the block rank d received FROM rank p.
    On one device ``parts`` is one ``[D, P, ...]`` tensor and the
    exchange is a transpose of its blocks on that device; with ranks on
    several devices ``parts`` is a list of per-rank ``[P, ...]`` tensors
    (each on its rank's device) and the blocks are copied across."""
    if isinstance(parts, torch.Tensor):
        return parts.transpose(0, 1).contiguous()
    d = len(parts)
    return [torch.stack([parts[p][r].to(mesh.devices[r])
                         for p in range(d)]) for r in range(d)]
