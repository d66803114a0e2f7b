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
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis.

    ``devices`` is a numpy object array (its ``shape`` the mesh's),
    ``axis_names`` the axes in order, ``shape`` a dict axis -> size, as
    JAX's ``Mesh.shape``. Identity equality: two meshes of the same
    devices are two placements."""

    def __init__(self, devices, axis_names: Sequence[str]):
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
        self.reset_collectives()

    def reset_collectives(self) -> None:
        """Zero ``collectives``: {kind: {"count", "result_bytes",
        "wire_bytes"}} per device, the kinds of ``models.spmd.KINDS``."""
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all")}

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
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list]})")


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


__all__ = ["Mesh", "make_mesh", "make_pipeline_mesh",
           "make_production_mesh"]
