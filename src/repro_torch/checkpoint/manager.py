"""Fault-tolerant checkpointing: atomic, async, retained, elastic.

The port of ``repro.checkpoint.manager``, with its on-disk contract: one
``step_<8 digits>.npz`` a step and a ``manifest.json`` listing the steps
written.

  * ATOMIC     — write to ``<dir>/tmp.<step>.<pid>`` then ``os.rename``
                 (POSIX atomic); the manifest records completion, so a
                 crash mid-write never corrupts the latest checkpoint.
  * ASYNC      — ``save`` copies the tree to host numpy on the caller's
                 thread (always a copy, never a view of a live CPU
                 tensor) and a writer thread writes it; ``save`` blocks
                 only on the previous pending write, ``wait`` on all.
  * RETENTION  — keep the newest ``keep`` checkpoints (+ every
                 ``keep_every`` milestone).
  * ELASTIC    — arrays are stored whole, on the host; ``restore`` puts
                 them on each template leaf's device, on ``device=``, or
                 (the row-sharded family) on the shards of ``mesh=``. A
                 ``models.model.ShardedModel`` and its sharded AdamW state
                 (``spmd.Sharded`` leaves, layer-owned moments included)
                 are saved as whole arrays under the one-device keys, so a
                 sharded checkpoint is the one-device checkpoint of the
                 same weights; a ``ShardedModel`` template on any mesh and
                 rule table, or a one-device ``Model``, takes it back,
                 each leaf cut by the template's spec (JAX's
                 ``restore(step, template, shardings)``). On a mesh
                 bound to a process group every rank calls ``save``:
                 the sharded leaves are gathered to rank 0, which alone
                 builds the host copy and writes the same file (at
                 once, not on the writer thread), and a barrier
                 follows, so a ``restore`` that comes after it finds
                 the file on every rank, each cutting its own shard.
  * AUTO-RESUME — ``latest_step`` + ``restore`` pick up after preemption;
                 partial writes are ignored (no manifest entry), a corrupt
                 manifest reads as empty.
  * PATTERNS   — sparsity-lifecycle nodes save their pattern (mask +
                 version) beside the values; ``restore`` repacks the
                 template to the saved pattern first, so a job resumes
                 MID-SCHEDULE with the exact pruned shapes. Nodes are
                 found through the ``sparse.pattern`` family registry,
                 ``sparse.Linear`` modules included.

A tree is nested dicts, lists and tuples over tensors, numpy arrays,
Python numbers, the sparse families' params nodes (their ``values``;
the static meta is rebuilt from the template), ``torch.nn.Module``s
(their own parameters and buffers and their child modules, by name; a
``sparse.Linear`` is its ``inner`` node), ``ShardedModel``s (their
parameters and masks by the module names of the one-device model:
``blocks.0.mixer.wq`` is ``blocks/0/mixer/wq``) and ``spmd.Sharded``
tensors. Paths join keys with ``/``.
A tensor is stored in its dtype, bf16 as f32 (exact); ``restore`` casts
each leaf to its template leaf's dtype and takes its shape from the
file. Modules in the template are restored in place (a parameter keeps
its object; a ``sparse.Linear`` takes the restored node by
``set_inner``); every other leaf is returned new.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..models import spmd
from ..models.model import ShardedModel
from ..sparse import api
from ..sparse import linear as lin
from ..sparse import pattern as spat

_PATTERN_PREFIX = "__pattern__/"
_NUMBER = (bool, int, float, np.generic)


def _is_node(x: Any) -> bool:
    """A params node of a registered sparse-linear family."""
    return type(x) in spat._FAMILIES


def _sharded_tree(sm: ShardedModel) -> Dict[str, Any]:
    """A ``ShardedModel``'s parameters (``spmd.Sharded``) and masks (one
    coordinate's copy) nested by their module names, as the one-device
    ``Model`` walks."""
    tree: Dict[str, Any] = {}
    leaves = list(sm.params.items()) + [(n, c[0])
                                        for n, c in sm.masks.items()]
    for name, leaf in leaves:
        *head, last = name.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _children(x: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node of a tree; None for a leaf."""
    if isinstance(x, ShardedModel):
        return list(_sharded_tree(x).items())
    if isinstance(x, dict):
        return [(str(k), v) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    if isinstance(x, api.Linear):
        return [("inner", x.inner)]
    if _is_node(x):
        return [("values", x.values)]
    if isinstance(x, torch.nn.Module):
        return ([(n, p) for n, p in x._parameters.items() if p is not None]
                + [(n, b) for n, b in x._buffers.items() if b is not None]
                + [(n, m) for n, m in x._modules.items() if m is not None])
    return None


def _walk(tree: Any, stop: Callable[[Any], bool] = lambda x: False,
          path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) over the tree, in order; ``stop`` makes a node a
    leaf."""
    kids = None if stop(tree) else _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from _walk(v, stop, f"{path}/{k}" if path else k)


def _host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it: the writer
    thread reads it while the next step writes the live tensors in
    place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    if isinstance(leaf, (np.ndarray,) + _NUMBER):
        return np.array(leaf, copy=True)
    raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")


def _process_mesh(tree: Any):
    """The process-group mesh of the tree's sharded leaves, or None."""
    for _, leaf in _walk(tree, lambda x: isinstance(x, ShardedModel)):
        if isinstance(leaf, (ShardedModel, spmd.Sharded)) and \
                leaf.mesh.rank is not None:
            return leaf.mesh
    return None


def _flatten(tree: Any, mesh=None) -> Dict[str, np.ndarray]:
    """path -> host array for every leaf, a ``spmd.Sharded`` assembled
    whole. Under a process group (``mesh``, bound to it) the sharded
    leaves are gathered to rank 0; the other ranks send their shards and
    keep nothing (an empty dict)."""
    keep = mesh is None or mesh.rank == 0
    out: Dict[str, np.ndarray] = {}
    seen = set()
    for key, leaf in _walk(tree):
        if key in seen:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        seen.add(key)
        if isinstance(leaf, spmd.Sharded):
            leaf = leaf.full("cpu", root=0)
        if keep:
            out[key] = _host(leaf)
    return out


# ----------------------------------------------------------------------
def _pattern_nodes(tree: Any) -> Dict[str, Any]:
    """path -> lifecycle node, for every pattern-carrying sparse node in
    the tree (a ``sparse.Linear``'s under its ``inner`` segment)."""
    return {p: n for p, n in _walk(tree, _is_node)
            if spat.is_lifecycle_node(n)}


def _pattern_arrays(tree: Any) -> Dict[str, np.ndarray]:
    """Per lifecycle node, its packed mask bits and a [d_in, d_out,
    version] state vector under reserved keys."""
    out = {}
    for path, node in _pattern_nodes(tree).items():
        pat = spat.get_pattern(node)
        out[f"{_PATTERN_PREFIX}{path}/mask"] = np.packbits(pat.mask)
        out[f"{_PATTERN_PREFIX}{path}/state"] = np.asarray(
            [pat.mask.shape[0], pat.mask.shape[1], pat.version], np.int64)
    return out


def _saved_patterns(flat: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    """Reserved keys -> {node path: (mask, version)}."""
    out = {}
    for key in flat:
        if key.startswith(_PATTERN_PREFIX) and key.endswith("/state"):
            path = key[len(_PATTERN_PREFIX):-len("/state")]
            d_in, d_out, version = (int(x) for x in flat[key])
            bits = flat[f"{_PATTERN_PREFIX}{path}/mask"]
            mask = np.unpackbits(bits, count=d_in * d_out).astype(bool)
            out[path] = (mask.reshape(d_in, d_out), version)
    return out


# ----------------------------------------------------------------------
class _Restorer:
    """One restore: the file's arrays into a template's structure.

    Nodes of the template that shared one meta object (a layer and its
    moment mirrors) are repacked through one donor and ``repack_onto``,
    and placed through one moved meta, so they share the new meta too."""

    def __init__(self, flat, saved, device, mesh):
        self.flat, self.saved = flat, saved
        self.device = None if device is None else ops.resolve_device(device)
        self.mesh = mesh
        self.donors: Dict[tuple, Any] = {}
        self.metas: Dict[int, Any] = {}

    def array(self, path: str) -> np.ndarray:
        if path not in self.flat:
            raise KeyError(f"checkpoint is missing array {path!r}")
        return self.flat[path]

    def tensor(self, path: str, like: torch.Tensor, device=None
               ) -> torch.Tensor:
        dev = device if device is not None else (self.device or like.device)
        return torch.from_numpy(np.array(self.array(path))).to(
            device=dev, dtype=like.dtype)

    def sharded(self, x: spmd.Sharded, path: str) -> spmd.Sharded:
        """The array at ``path`` cut by ``x``'s spec onto its coordinates
        (those that hold a shard), in ``x``'s dtype: a new ``Sharded``."""
        arr = self.array(path)
        if tuple(arr.shape) != tuple(x.shape):
            raise ValueError(f"checkpoint array {path!r} has shape "
                             f"{tuple(arr.shape)}, the template "
                             f"{tuple(x.shape)}")
        full = torch.from_numpy(np.array(arr))
        shards = [None if t is None else
                  full[x.slices(i)].to(device=t.device, dtype=t.dtype)
                  .contiguous() for i, t in enumerate(x.shards)]
        return spmd.Sharded(x.mesh, x.spec, x.shape, shards)

    def sharded_model(self, x: ShardedModel, path: str) -> ShardedModel:
        """Each parameter's shards and each mask's copies of ``x``
        overwritten in place from the file (every key of the one-device
        model, and no other under ``path``)."""
        want = {p for p, _ in _walk(x, path=path)}
        pre = f"{path}/" if path else ""
        have = {k for k in self.flat if k.startswith(pre)}
        if have != want:
            raise ValueError(f"the checkpoint's model under {path!r} is not "
                             f"the template's: {sorted(have ^ want)[:4]} "
                             f"differ")
        with torch.no_grad():
            for name, p in x.params.items():
                new = self.sharded(p, pre + name.replace(".", "/"))
                for t, src in zip(p.shards, new.shards):
                    t.copy_(src)
            for name, copies in x.masks.items():
                arr = self.array(pre + name.replace(".", "/"))
                for t in copies:
                    t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
        return x

    def build(self, x: Any, path: str) -> Any:
        def sub(k):
            return f"{path}/{k}" if path else k
        if isinstance(x, ShardedModel):
            return self.sharded_model(x, path)
        if isinstance(x, spmd.Sharded):
            return self.sharded(x, path)
        if isinstance(x, api.Linear):
            x.set_inner(self.node(x.inner, sub("inner")))
            return x
        if _is_node(x):
            return self.node(x, path)
        if isinstance(x, torch.nn.Module):
            for n, p in x._parameters.items():
                if p is not None:
                    p.data = self.tensor(sub(n), p)
            for n, b in x._buffers.items():
                if b is not None:
                    x._buffers[n] = self.tensor(sub(n), b)
            for n, m in x._modules.items():
                if m is not None:
                    self.build(m, sub(n))
            return x
        if isinstance(x, dict):
            return {k: self.build(v, sub(str(k))) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            out = [self.build(v, sub(str(i))) for i, v in enumerate(x)]
            return out if isinstance(x, list) else type(x)(out)
        if isinstance(x, torch.Tensor):
            return self.tensor(path, x)
        if isinstance(x, np.ndarray):
            return np.array(self.array(path), dtype=x.dtype)
        if isinstance(x, _NUMBER):
            return type(x)(self.array(path))
        raise TypeError(f"cannot restore into a {type(x).__name__}")

    def node(self, x: Any, path: str) -> Any:
        x = self.retarget(x, path)
        meta = self.placed_meta(x.meta)
        vals = x.values
        vpath = f"{path}/values" if path else "values"
        if isinstance(vals, torch.Tensor):
            dev = meta.fwd_idx.device if isinstance(
                getattr(meta, "fwd_idx", None), torch.Tensor) else None
            new = self.tensor(vpath, vals, device=dev)
        else:
            new = tuple(self.tensor(f"{vpath}/{s}", v, device=d)
                        for s, (v, d) in enumerate(zip(vals, meta.devices)))
        return dataclasses.replace(x, values=new, meta=meta)

    def retarget(self, x: Any, path: str) -> Any:
        """Repack ``x`` to its saved pattern, where that differs."""
        if path not in self.saved or not spat.is_lifecycle_node(x):
            return x
        mask, version = self.saved[path]
        cur = spat.get_pattern(x)
        if cur.version == version and np.array_equal(cur.mask, mask):
            return x
        key = (id(x.meta), mask.tobytes(), version)
        donor = self.donors.get(key)
        if donor is None:
            donor = self.donors[key] = spat.repack(x, mask, version=version)
            return donor
        return spat.repack_onto(x, donor)

    def placed_meta(self, meta: Any) -> Any:
        """``meta`` with its device tensors where the restore puts them:
        a sharded meta's on ``mesh``'s shard devices, a single-device
        meta's on ``device``; once per meta object."""
        got = self.metas.get(id(meta))
        if got is not None:
            return got
        new = meta
        if isinstance(meta, lin.ShardedInCRSLinearMeta):
            if self.mesh is not None:
                devs = ops.shard_devices(self.mesh, meta.axes)
                if len(devs) != meta.n_shards:
                    raise ValueError(
                        f"a {meta.n_shards}-shard layer cannot restore onto "
                        f"a mesh of {len(devs)} shards along {meta.axes}")
                new = dataclasses.replace(meta, **{
                    f: tuple(t.to(d) for t, d in zip(getattr(meta, f), devs))
                    for f in ("fwd_idx", "bwd_idx", "t_gather")},
                    mesh=self.mesh)
        elif self.device is not None:
            new = lin.meta_to(meta, self.device)
        if new is not meta and new.pattern is not None:
            new.pattern.packed[
                "incrs_sharded" if isinstance(new, lin.ShardedInCRSLinearMeta)
                else "incrs"] = new
        self.metas[id(meta)] = new
        return new


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_every: Optional[int] = None, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def _manifest_path(self):
        return os.path.join(self.dir, "manifest.json")

    def _load_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"steps": []}

    def _write_manifest(self, man):
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.rename(tmp, self._manifest_path())

    # ------------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray]):
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.rename(tmp, path)                       # atomic publish
        man = self._load_manifest()
        man["steps"] = sorted(set(man["steps"] + [step]))
        man["updated"] = time.time()
        self._write_manifest(man)
        self._gc(man)

    def _gc(self, man):
        steps = man["steps"]
        protect = set(steps[-self.keep:])
        if self.keep_every:
            protect |= {s for s in steps if s % self.keep_every == 0}
        drop = [s for s in steps if s not in protect]
        for s in drop:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except FileNotFoundError:
                pass
        man["steps"] = [s for s in steps if s in protect]
        self._write_manifest(man)

    def _writer(self):
        while True:
            step, flat = self._q.get()
            try:
                self._write(step, flat)
            except BaseException as e:     # surfaced on next save/wait
                self._err = e
            self._q.task_done()

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        """Copy the tree to host numpy now, then write it (on the writer
        thread, or inline when ``async_write=False``). Sparsity patterns
        of lifecycle nodes ride along."""
        if self._err:
            raise RuntimeError("async checkpoint writer failed") from self._err
        mesh = _process_mesh(tree)
        flat = _flatten(tree, mesh)
        if mesh is not None:
            import torch.distributed as dist
            if mesh.rank == 0:
                flat.update(_pattern_arrays(tree))
                self.wait()
                self._write(step, flat)
            dist.barrier()
            return
        flat.update(_pattern_arrays(tree))
        if self._thread is None:
            self._write(step, flat)
        else:
            self._q.put((step, flat))     # blocks if previous still writing

    def wait(self):
        self._q.join()
        if self._err:
            raise RuntimeError("async checkpoint writer failed") from self._err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self._load_manifest()["steps"]
        return steps[-1] if steps else None

    def restore(self, step: int, template, *, device=None, mesh=None):
        """The checkpoint of ``step`` in ``template``'s structure and
        dtypes. Each array goes to its template leaf's device, or to
        ``device`` when given; a row-sharded node's shards go to ``mesh``'s
        shard devices when given (the same shard count), else stay on
        the template's. A ``ShardedModel`` in the template is filled in
        place, each parameter cut by its spec on its mesh; a
        ``spmd.Sharded`` leaf (a sharded AdamW state's moments, built for
        the template's mesh by ``trainer.init_sharded_opt_state``) comes
        back cut by its spec onto the coordinates that hold it. A template
        whose model keys or shapes are not the file's raises.

        When the checkpoint carries sparsity patterns, the template's
        lifecycle nodes are REPACKED to the saved pattern (mask + version)
        first — a fresh template restores straight into a
        mid-prune-schedule state."""
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        saved = _saved_patterns(flat)
        flat = {k: v for k, v in flat.items()
                if not k.startswith(_PATTERN_PREFIX)}
        return _Restorer(flat, saved, device, mesh).build(template, "")


__all__ = ["CheckpointManager"]
