"""Device meshes for one controlling process.

The port's counterpart of ``jax.sharding.Mesh`` and of
``repro.launch.mesh``: ``Mesh`` is an n-d array of ``torch.device`` with
named axes. ``make_mesh`` builds the one-axis meshes of the row-sharded
InCRS path and the pipeline; ``make_production_mesh`` JAX's LM meshes, 16 x
16 ``("data", "model")`` or 2 x 16 x 16 ``("pod", "data", "model")``;
``make_pipeline_mesh`` the ``("pipe", "data")`` mesh. Devices may repeat:
a mesh of one card named eight times holds eight shards, each its own
tensors and its own launches, as JAX's fake host devices do on the CPU;
``"meta"`` gives a mesh that allocates nothing (the dry run). The caller
names the device; nothing picks devices behind its back. Each mesh keeps
the count and bytes of the collectives run over it (``collectives``,
``models.spmd``).

One process runs every coordinate of a mesh by default. A mesh bound to
an initialised ``torch.distributed`` process group (``process_group=True``,
or ``make_process_mesh``) has one process a coordinate instead: rank r
runs coordinate r, and every collective is the backend's across the
processes (``models.spmd``). The caller initialises the group and so
names the backend: gloo (a card may repeat; CUDA tensors are staged
through host memory, decided here once) or NCCL (one card a rank).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis.

    ``devices`` is a numpy object array (its ``shape`` the mesh's),
    ``axis_names`` the axes in order, ``shape`` a dict axis -> size, as
    JAX's ``Mesh.shape``. Identity equality: two meshes of the same
    devices are two placements.

    With ``process_group``, the mesh is bound to the initialised default
    process group, whose world size must be the mesh's size: ``rank`` is
    this process's coordinate (None in one process), ``backend`` the
    group's, ``stage_on_host`` whether collectives copy CUDA tensors to
    host memory and back (gloo with CUDA devices), and ``groups`` one
    process group a set of coordinates that some combination of axes
    groups (by their sorted ranks), made here in one order on every
    rank, as ``torch.distributed.new_group`` needs."""

    def __init__(self, devices, axis_names: Sequence[str], *,
                 process_group: bool = False):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices,
                                                       dtype=object)))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-d devices need as many "
                             f"axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted({d.type for d in flat})}")
        self._coords = tuple(
            dict(zip(self.axis_names, map(int, np.unravel_index(
                i, self.devices.shape)))) for i in range(self.size))
        self.rank: Optional[int] = None
        self.backend: Optional[str] = None
        self.stage_on_host = False
        self.groups: Dict[Tuple[int, ...], object] = {}
        if process_group:
            self._bind(flat)
        self.reset_collectives()

    def _bind(self, flat) -> None:
        import torch.distributed as dist

        from ..models import spmd
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a process mesh needs torch.distributed."
                               "init_process_group first")
        world, backend = dist.get_world_size(), dist.get_backend()
        if world != self.size:
            raise ValueError(f"the process group has {world} ranks, the "
                             f"mesh {self.size} coordinates")
        kind = flat[0].type
        if backend not in ("gloo", "nccl") or kind == "meta":
            raise ValueError(f"a process mesh runs gloo or nccl on cpu or "
                             f"cuda devices, got {backend} on {kind}")
        if backend == "nccl":
            if kind != "cuda" or any(d.index is None for d in flat):
                raise ValueError("NCCL needs a card with an index at every "
                                 "coordinate")
            if len(set(flat)) != len(flat):
                raise ValueError(f"NCCL takes one rank a card; the mesh "
                                 f"names a card twice: "
                                 f"{[str(d) for d in flat]}")
        self.rank, self.backend = dist.get_rank(), backend
        self.stage_on_host = backend == "gloo" and kind == "cuda"
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                for grp in spmd.groups(self, axes):
                    key = tuple(sorted(grp))
                    if len(key) > 1 and key not in self.groups:
                        self.groups[key] = dist.new_group(list(key))

    def reset_collectives(self) -> None:
        """Zero ``collectives``: {kind: {"count", "result_bytes",
        "wire_bytes"}} per device, the kinds of ``models.spmd.KINDS``;
        and ``transport``, what this process's collectives cost under a
        process group: host seconds in the backend's calls
        (``collective_s``), and where the mesh stages, the seconds and
        bytes of the copies to host memory and back (``stage_s``,
        ``staged_bytes``; each copy after the card's queue is drained, so
        compute is not counted)."""
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all")}
        self.transport: Dict[str, float] = {
            "collective_s": 0.0, "stage_s": 0.0, "staged_bytes": 0}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self) -> Tuple[Dict[str, int], ...]:
        """Each coordinate (axis -> index) in row-major order, the order
        of ``device_list``."""
        return self._coords

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        """Every device in row-major order, repeats kept."""
        return tuple(self.devices.ravel())

    def __repr__(self) -> str:
        bound = "" if self.rank is None else \
            f", rank={self.rank}, backend={self.backend}"
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list]}{bound})")


def make_mesh(n: int, device=None, *, axis: str = "data") -> Mesh:
    """A one-axis mesh of ``n`` shards (the axis ``"data"``, or
    ``"pipe"`` for pipeline stages). ``device`` None or
    ``"cuda"``: the first ``n`` visible cards, raising if fewer are
    visible; a device with an index (``"cuda:0"``) or ``"cpu"``: that
    device ``n`` times."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
    return Mesh(_devices(n, device, f"a {n}-shard mesh"), (axis,))


def _devices(n: int, device, what: str):
    """``n`` devices: distinct cards for None / ``"cuda"``, else the named
    device ``n`` times."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU unless the "
                "caller passes device='cpu'")
        if dev.index is None:
            have = torch.cuda.device_count()
            if have < n:
                raise ValueError(
                    f"{what} over distinct cards needs {n} visible CUDA "
                    f"devices, have {have} (name one card, e.g. 'cuda:0', to "
                    f"hold every shard on it)")
            return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def make_process_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
                      device) -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` bound to the initialised
    default process group (its world size the mesh's): rank r runs
    coordinate r, row-major. ``device``: ``"cpu"``, a card with an index
    (``"cuda:0"``: that card at every coordinate, which gloo takes and
    NCCL refuses) or ``"cuda"`` (coordinate i on card i, raising where
    fewer are visible). Under NCCL each rank should make its own card
    current (``torch.cuda.set_device``) before the first collective."""
    n = int(np.prod(tuple(shape)))
    devs = np.empty(n, dtype=object)
    devs[:] = _devices(n, device, f"a {'x'.join(map(str, shape))} mesh")
    return Mesh(devs.reshape(tuple(shape)), axis_names, process_group=True)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """JAX's LM mesh: 16 x 16 = 256 devices ``("data", "model")``, or with
    ``multi_pod`` 2 x 16 x 16 = 512 ``("pod", "data", "model")``, the
    "pod" axis an outer data-parallel axis. ``device``: None or
    ``"cuda"`` distinct cards (raising if fewer are visible), a device
    with an index, ``"cpu"`` or ``"meta"`` that device at every
    coordinate."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = _devices(n, device, f"a {'x'.join(map(str, shape))} mesh")
    return Mesh(devs.reshape(shape), axes)


def make_pipeline_mesh(n_stages: int = 8, device=None) -> Mesh:
    """The ``("pipe", "data")`` mesh of the GPipe executor: every visible
    card for None / ``"cuda"`` (JAX's every device), split into
    ``n_stages`` rows; a device with an index, ``"cpu"`` or ``"meta"``
    named once a stage. Raises where the stages do not divide the
    devices."""
    if n_stages < 1:
        raise ValueError(f"a pipeline needs n_stages >= 1, got {n_stages}")
    dev = torch.device("cuda" if device is None else device)
    n_devices = n_stages
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU unless the "
                "caller passes device='cpu'")
        n_devices = torch.cuda.device_count()
    if n_devices % n_stages != 0:
        raise ValueError(f"{n_devices} devices do not divide into "
                         f"{n_stages} pipeline stages")
    devs = np.empty(n_devices, dtype=object)
    devs[:] = _devices(n_devices, device, f"a {n_stages}-stage pipeline")
    return Mesh(devs.reshape(n_stages, n_devices // n_stages),
                ("pipe", "data"))


__all__ = ["Mesh", "make_mesh", "make_pipeline_mesh", "make_process_mesh",
           "make_production_mesh"]
