"""Device meshes and the process world of the sharded trainer and the
sharded serving router (twin of ``repro/launch/mesh.py:38-94``).

A :class:`Mesh` plays the role of a jax ``Mesh``: a named ``("data",
"model")`` grid of ``torch.device``s with ``.shape[axis]``,
``.axis_names`` and ``.devices`` (a numpy object array), which is all that
``sharding.rules`` and the router read.  Rank ``r`` of the initialised
world is flat grid position ``r``; :meth:`Mesh.device_mesh` builds the
``torch.distributed`` ``DeviceMesh`` over that world (whose size must equal
the grid's) and :meth:`Mesh.group` its process group along an axis.

On the card the grid holds ``cuda:i`` for rank ``i`` (one rank a card); on
the CPU, N times ``cpu``.  A grid of ``meta`` devices is a *placeholder*
mesh (:func:`make_production_mesh` outside a world, the dry run): it stands
for ranks that do not exist, its groups are ``sharding.comm``'s placeholder
groups, whose collectives move no data, and :meth:`Mesh.coordinate` takes
the rank explicitly (or the one ``comm.placeholder_world`` traces).  An
axis argument (``size_of``, ``index_of``, ``group``) is one axis name or a
tuple of them, as a placement's entry is (``("pod", "data")``: pod-major).
:func:`init_world` starts the world: from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) when
present, else a world of one, over NCCL for ``cuda`` and gloo for ``cpu``
(no other backend), and refuses more CUDA ranks than cards.

Both device overrides fail loudly (``ValueError``), as the reference's do:
``devices=`` (an explicit list) and ``$REPRO_HOST_DEVICES=N`` (the first N
devices the world exposes).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import comm

HOST_DEVICES_ENV = "REPRO_HOST_DEVICES"
AXES = ("data", "model")
# A collective that waits longer than this fails its rank (a dead peer must
# not hang the world).
WORLD_TIMEOUT = datetime.timedelta(seconds=60)


class Mesh:
    """A named grid of devices.  ``shape[axis]`` is the axis's size,
    ``devices`` the grid (numpy object array, one ``torch.device`` a
    position)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.placeholder = all(torch.device(d).type == "meta" for d in devices.flat)
        self._device_mesh = None

    def __repr__(self) -> str:
        if self.placeholder:
            return f"Mesh({self.shape}, placeholder)"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Grid position of ``rank`` by axis: by default this process's rank,
        or on a placeholder mesh the rank ``comm.placeholder_world`` traces
        (without one, a placeholder mesh needs ``rank``)."""
        if rank is None:
            if self.placeholder:
                rank = comm.placeholder_rank()
                if rank is None:
                    raise ValueError("a placeholder mesh stands for no process: pass the rank, or trace under "
                                     "sharding.comm.placeholder_world(rank)")
            else:
                rank = dist.get_rank()
        return {a: int(i) for a, i in zip(self.axis_names, np.unravel_index(rank, self.devices.shape))}

    def size_of(self, axes) -> int:
        """The number of ranks along ``axes`` (1 for None)."""
        return math.prod(self.shape[a] for a in _names(axes))

    def index_of(self, axes, rank: Optional[int] = None) -> int:
        """``rank``'s position along ``axes``, the first axis major."""
        coord, idx = self.coordinate(rank), 0
        for a in _names(axes):
            idx = idx * self.shape[a] + coord[a]
        return idx

    def device_mesh(self):
        """The ``DeviceMesh`` over the initialised world, rank ``r`` at flat
        position ``r`` (built once)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            if not dist.is_initialized():
                raise RuntimeError("the mesh's collectives need an initialised world (launch.mesh.init_world)")
            if dist.get_world_size() != self.size:
                raise ValueError(f"world of {dist.get_world_size()} rank(s) for a mesh of {self.size} devices "
                                 f"{self.shape}")
            kind = self.devices.flat[0].type
            grid = torch.arange(self.size).reshape(self.devices.shape)
            self._device_mesh = DeviceMesh(kind, grid, mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axes):
        """The process group of this rank's line along ``axes`` (one axis,
        or all of them: the world); on a placeholder mesh, a placeholder
        group of that size."""
        names = _names(axes)
        label = "+".join(names)
        if self.placeholder:
            return comm.PlaceholderGroup(label, self.size_of(names))
        if len(names) == 1:
            group = self.device_mesh().get_group(names[0])
        elif set(names) == set(self.axis_names):
            self.device_mesh()
            group = dist.group.WORLD
        else:
            raise NotImplementedError(f"a process group over axes {names} of a real world")
        return comm.name_group(group, label)


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: ``(16, 16)`` ``("data", "model")`` (256 cards a
    pod), or ``(2, 16, 16)`` with ``"pod"`` first.  Outside a world it is a
    placeholder grid of ``meta`` devices (the dry run).  In an initialised
    world it spans the world's ranks, whatever their number: ``model`` is
    ``gcd(world, 16)`` wide, the rest ``data`` (and, multi-pod, 2 pods)."""
    axes = ("pod", "data", "model") if multi_pod else AXES
    if not dist.is_initialized():
        shape = (2, 16, 16) if multi_pod else (16, 16)
        grid = np.empty(math.prod(shape), dtype=object)
        grid[:] = [torch.device("meta")] * grid.size
        return Mesh(grid.reshape(shape), axes)
    devices = world_devices()
    n = len(devices)
    m = math.gcd(n, 16)
    if multi_pod and (n // m) % 2:
        raise ValueError(f"a multi-pod mesh needs an even number of data rows; the world has {n} rank(s)")
    shape = (2, n // m // 2, m) if multi_pod else (n // m, m)
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def world_devices() -> list:
    """The devices the world exposes, one a rank: ``cuda:i`` for rank i of a
    CUDA world, ``cpu`` for each rank of a CPU world.  Outside a world:
    every visible card, else one ``cpu``."""
    if dist.is_initialized():
        n = dist.get_world_size()
        if dist.get_backend() == "nccl":
            return [torch.device("cuda", r) for r in range(n)]
        return [torch.device("cpu")] * n
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def host_devices(devices: Optional[Sequence] = None) -> list:
    """The device list host meshes (and the serving router) span:
    ``devices=`` wins; else ``$REPRO_HOST_DEVICES`` takes the first N of
    :func:`world_devices`; else all of them.  Raises ``ValueError`` on an
    empty list and on more devices asked for than exist."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("host_devices: empty explicit device list")
        return devices
    devices = world_devices()
    want = int(os.environ.get(HOST_DEVICES_ENV, "0") or 0)
    if want < 0:
        raise ValueError(f"{HOST_DEVICES_ENV}={want} must be >= 0")
    if want:
        if want > len(devices):
            raise ValueError(f"{HOST_DEVICES_ENV}={want} but the world only exposes {len(devices)} device(s) "
                             f"{[str(d) for d in devices]}: start one rank a device (torchrun --nproc-per-node)")
        devices = devices[:want]
    return devices


def make_host_mesh(model_axis: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """``("data", "model")`` mesh over :func:`host_devices`; ``model_axis``
    must divide the device count (a truncated mesh would desync the specs
    ``sharding.rules`` derives from it)."""
    devices = host_devices(devices)
    n = len(devices)
    if model_axis < 1:
        raise ValueError(f"model_axis={model_axis} must be >= 1")
    if n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the {n} available device(s) "
                         f"{[str(d) for d in devices]}: pick a divisor or adjust {HOST_DEVICES_ENV}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model_axis, model_axis))


def init_world(device="cuda", *, rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None) -> Tuple[torch.device, bool]:
    """Start (or join) the process world; returns (this rank's device,
    whether this call started the world).

    ``rank`` / ``world_size`` / ``init_method`` given: that world (the
    tests use a ``file://`` store).  Else ``torchrun``'s environment when
    ``RANK`` and ``WORLD_SIZE`` are set, else a world of one on an
    in-process store.  ``cuda`` ranks take ``cuda:$LOCAL_RANK`` and NCCL,
    ``cpu`` ranks gloo; a CUDA world with more ranks on this host than
    cards raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the sharded trainer runs on cuda or cpu ranks, not {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the world runs {dist.get_backend()}; {dev.type} ranks need {backend}")
        return _rank_device(dev), False
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) if env or init_method else world_size
        if not torch.cuda.is_available() or local > torch.cuda.device_count():
            raise RuntimeError(f"{local} CUDA rank(s) on this host but {torch.cuda.device_count()} card(s): "
                               f"one rank a card")
    kw = dict(backend=backend, rank=rank, world_size=world_size, timeout=WORLD_TIMEOUT)
    if init_method is not None:
        kw["init_method"] = init_method
    elif env:
        kw["init_method"] = "env://"
    else:
        kw["store"] = dist.HashStore()
    rdev = _rank_device(dev, rank)
    if rdev.type == "cuda":
        torch.cuda.set_device(rdev)
        kw["device_id"] = rdev            # NCCL binds the rank to its card
    dist.init_process_group(**kw)
    return rdev, True


def _rank_device(dev: torch.device, rank: Optional[int] = None) -> torch.device:
    if dev.type == "cpu":
        return dev
    if rank is None:
        rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
