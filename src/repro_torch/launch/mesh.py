"""The device mesh of the row-sharded InCRS path.

The port's counterpart of the ``jax.sharding.Mesh`` that ``shard_map``
runs over, for one controlling process: ``Mesh`` is an n-d array of
``torch.device`` with named axes, and ``make_mesh`` builds the
one-axis meshes the sharded path uses. Devices may repeat: a mesh of one
card named eight times holds eight shards, each its own panel and its own
launch, as JAX's fake host devices do on the CPU. The caller builds the
mesh; nothing picks devices behind its back. JAX's TPU-pod mesh functions
(``make_production_mesh``, ``make_pipeline_mesh``) belong to the LM stack
and are not ported.
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
                    f"a {n}-shard mesh over distinct cards needs {n} visible "
                    f"CUDA devices, have {have} (name one card, e.g. "
                    f"'cuda:0', to hold every shard on it)")
            return Mesh([torch.device("cuda", i) for i in range(n)],
                        (axis,))
    return Mesh([dev] * n, (axis,))


__all__ = ["Mesh", "make_mesh"]
