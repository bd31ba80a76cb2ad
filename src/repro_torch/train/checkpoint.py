"""Checkpoints: atomic, checksummed, async, shard-aware
(``repro/train/checkpoint.py``).

Layout, one directory a step, file for file JAX's, so either package reads
the other's::

    <dir>/step_000100/
        manifest.json   keys, shapes, dtypes, sha256 of each file, format
                        (and, sharded, num_shards and shard_info)
        arrays.npz      leaf data (the ``full`` format), or
        shard_<k>.npz   model shard k's slice of every leaf (``sharded``)
    <dir>/LATEST        the last complete step directory's name

Keys are JAX's ``_flatten`` paths: dict keys joined by ``/``, list items by
index, and a :class:`~repro_torch.quant.QuantizedTensor` stored as children
``0`` (int8 payload), ``1`` (scale) and ``2`` (act scale, where there is
one).  numpy has no bf16 or fp8, so those leaves are stored as their raw
bytes (a uint8 view, as JAX stores them) and the manifest's dtype turns
them back; the views go through torch's own dtypes, not ``ml_dtypes``.

A save writes into a temporary directory, fsyncs the manifest, renames the
directory into place and only then moves ``LATEST``, so a crash never
leaves a half-written restore point; ``keep_last`` old steps survive, and
a step another writer is still producing is never collected.

The ``sharded`` format (``save_sharded``; written offline by
``python -m repro_torch.train.checkpoint_converter``): ``shard_info`` maps
each key to its slicing rule (``distributed.tp.Segments`` JSON, or
``"replicated"``) and the manifest's shapes are the per-shard local ones.
:func:`restore` and :func:`load_params` reassemble the full tree bit for
bit; ``tp.load_sharded_params`` reads one rank's shard only
(:func:`read_shard`).  The ranks of a training mesh save and restore
together (:func:`save_on_mesh`, :func:`restore_on_mesh`): the ``full``
format from rank 0 where every rank holds the whole state, else the
``sharded`` one with a shard a (data, model) rank, each rank writing and
reading only its own; its ``shard_info`` entries name the split dims
(``{"mesh": [D, M], "data_dim": i, "model_dim": j}``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.core import QuantizedTensor, is_quantized

# stored as raw bytes: numpy has no such dtype
_RAW_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _to_storable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if _dtype_name(t) in _RAW_DTYPES:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype_name in _RAW_DTYPES:
        return t.view(_RAW_DTYPES[dtype_name])
    return t


def _flatten(tree, prefix=()) -> list:
    """``(key, leaf)`` pairs in JAX's order and spelling: dicts by sorted
    key, lists and tuples by index, a QuantizedTensor as ``0``/``1``/``2``
    (act scale only where there is one)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (i,))]
    if is_quantized(tree):
        kids = [tree.q, tree.scale] + ([] if tree.act_scale is None
                                       else [tree.act_scale])
        return [kv for i, v in enumerate(kids)
                for kv in _flatten(v, prefix + (i,))]
    if tree is None:
        return []
    return [("/".join(str(p) for p in prefix), torch.as_tensor(tree))]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, state, step: int, *, keep_last: int = 3) -> str:
    """Synchronous atomic save of a tree of tensors.  Returns the step's
    path."""
    return _write(ckpt_dir, {"arrays.npz": dict(_flatten(state))}, step,
                  keep_last)


def save_sharded(ckpt_dir: str, shards: list, step: int, *,
                 shard_info: dict, keep_last: int = 3) -> str:
    """Write a ``format: "sharded"`` checkpoint from per-shard flat dicts
    (JAX's ``save_sharded``): ``shards[k]`` maps a checkpoint key to shard
    ``k``'s already sliced array (a tensor or a numpy array);
    ``shard_info`` maps each key to its slicing rule.  Keys and local
    shapes agree across shards: slicing is always even."""
    shards = [{k: torch.as_tensor(v) for k, v in s.items()} for s in shards]
    keys = sorted(shards[0])
    for m, s in enumerate(shards[1:], start=1):
        if sorted(s) != keys:
            raise ValueError(f"shard {m} keys differ from shard 0")
    files = {f"shard_{m}.npz": s for m, s in enumerate(shards)}
    extra = {"format": "sharded", "num_shards": len(shards),
             "shard_info": dict(shard_info)}
    return _write(ckpt_dir, files, step, keep_last, extra=extra)


# Concurrent writers (two save_async calls, or save_async racing a sync
# save) must not interleave the final rename, the LATEST update and the
# sweep, and the sweep must never collect a step another writer is still
# producing: process-wide, as the directories are.
_LOCK = threading.Lock()
_PENDING: list[threading.Thread] = []
_IN_FLIGHT: set[tuple[str, str]] = set()   # (abs ckpt_dir, step dir name)


def save_async(ckpt_dir: str, state, step: int, *, keep_last: int = 3
               ) -> threading.Thread:
    """Copy the tree to host memory now (a device-to-host copy, so later
    updates of the tensors do not reach the file), write it in a
    background thread; :func:`wait_pending` joins it."""
    host = {k: v.detach().cpu().clone() for k, v in _flatten(state)}
    t = threading.Thread(target=_write, args=(ckpt_dir, {"arrays.npz": host},
                                              step, keep_last), daemon=True)
    with _LOCK:
        _PENDING.append(t)
    t.start()
    return t


def wait_pending() -> None:
    with _LOCK:
        pending = list(_PENDING)
    for t in pending:
        t.join()
        with _LOCK:
            if t in _PENDING:
                _PENDING.remove(t)


def _write(ckpt_dir: str, files: dict, step: int, keep_last: int, *,
           extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    token = (os.path.abspath(ckpt_dir), name)
    with _LOCK:
        _IN_FLIGHT.add(token)
    try:
        tmp = tempfile.mkdtemp(prefix=f".tmp_{name}_", dir=ckpt_dir)
        try:
            host = files.get("arrays.npz", files.get("shard_0.npz"))
            sha = {fname: _save_npz(os.path.join(tmp, fname), data)
                   for fname, data in files.items()}
            _seal(tmp, _manifest(step, host, sha, extra))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return _publish(ckpt_dir, tmp, name, keep_last)
    finally:
        with _LOCK:
            _IN_FLIGHT.discard(token)


def _save_npz(path: str, data: dict) -> str:
    """One npz of ``{key: tensor}``; returns its sha256."""
    np.savez(path, **{k.replace("/", "__"): _to_storable(v)
                      for k, v in data.items()})
    return _sha256(path)


def _manifest(step: int, host: dict, sha: dict,
              extra: Optional[dict]) -> dict:
    manifest = {
        "step": step,
        "keys": sorted(host),
        # sharded: the per-shard local shapes (an even split, so every
        # shard agrees); full: the global ones
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": {k: _dtype_name(v) for k, v in host.items()},
        "sha256": sha,
        "format": "full",
    }
    if extra:
        manifest.update(extra)
    return manifest


def _seal(tmp: str, manifest: dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def _publish(ckpt_dir: str, tmp: str, name: str, keep_last: int) -> str:
    """Rename a sealed temporary directory into place, then move
    ``LATEST`` and sweep old steps."""
    final = os.path.join(ckpt_dir, name)
    try:
        with _LOCK:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with _LOCK:
        latest = os.path.join(ckpt_dir, "LATEST")
        current = ""
        if os.path.exists(latest):
            with open(latest) as f:
                current = f.read().strip()
        # a slow writer of an older step must not move LATEST back (the
        # names sort: zero-padded)
        if name >= current:
            with open(latest + ".tmp", "w") as f:
                f.write(name)
                f.flush()
                os.fsync(f.fileno())
            os.replace(latest + ".tmp", latest)
        _gc(ckpt_dir, keep_last)
    return final


def save_on_mesh(ckpt_dir: str, state, step: int, *, mesh, plan=None,
                 keep_last: int = 3) -> None:
    """A train state saved by the ranks of a bound ``(data, model)`` mesh,
    every rank calling this together; all leave at one barrier.

    Where every rank holds the whole state (``plan`` None, or a
    ``sharding.MeshPlan`` that splits nothing) rank 0 writes the ``full``
    format alone.  Otherwise every rank writes its blocks as
    ``shard_<r>.npz`` of the ``sharded`` format, ``r`` its rank on the
    mesh (row-major), the manifest's ``mesh`` ``[D, M]`` and each split
    key's ``shard_info`` its placement (``tp.state_shard_info``: the
    moments as their params); rank 0 seals the manifest and publishes the
    step.  :func:`restore` and the converter reassemble it whole."""
    import torch.distributed as dist
    if plan is None or not plan.sharded:
        if dist.get_rank() == 0:
            save(ckpt_dir, state, step, keep_last=keep_last)
        dist.barrier()
        return
    from repro_torch.distributed import tp
    r = mesh.index(tuple(mesh.axis_names))
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}_mesh")
    if r == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    dist.barrier()
    flat = dict(_flatten(state))
    fname = f"shard_{r}.npz"
    sha = _save_npz(os.path.join(tmp, fname), flat)
    shas = [None] * mesh.size
    dist.all_gather_object(shas, (fname, sha))
    if r == 0:
        extra = {"format": "sharded", "num_shards": mesh.size,
                 "mesh": [plan.data, plan.model],
                 "shard_info": tp.state_shard_info(plan, flat)}
        _seal(tmp, _manifest(step, flat, dict(shas), extra))
        _publish(ckpt_dir, tmp, name, keep_last)
    dist.barrier()


def restore_on_mesh(ckpt_dir: str, state_like, *, mesh, plan=None,
                    step: Optional[int] = None, verify: bool = True):
    """A checkpoint back into this rank's ``state_like``: the mesh's own
    (a ``sharded`` one written by :func:`save_on_mesh` on this mesh) by
    reading only this rank's shard, bit for bit; any other (``full``, or
    sharded for another layout) reassembled whole and cut to this rank's
    blocks by ``plan`` (the mesh's ``sharding.MeshPlan``; None: whole).
    Returns ``(state, step)``."""
    from repro_torch.distributed import tp
    manifest, _ = _read_manifest(ckpt_dir, step)
    shape = [mesh.shape.get("data", 1), mesh.shape.get("model", 1)]
    if (manifest.get("format") == "sharded" and manifest.get("mesh") == shape
            and int(manifest["num_shards"]) == mesh.size):
        manifest, flat = read_shard(ckpt_dir,
                                    mesh.index(tuple(mesh.axis_names)),
                                    step=manifest["step"], verify=verify)
        return _fill(state_like, flat), manifest["step"]
    manifest, flat = _load_flat(ckpt_dir, manifest["step"], verify)
    if plan is not None:
        di, mi = tp.mesh_coords(mesh.index(tuple(mesh.axis_names)), plan)
        flat = {k: (v if plan.placement(k) is None else tp.mesh_local(
            plan.placement(k), v, di, mi, plan.data, plan.model))
            for k, v in flat.items()}
    return _fill(state_like, flat), manifest["step"]


def _gc(ckpt_dir: str, keep_last: int) -> None:
    """Drop all but the newest ``keep_last`` steps.  The caller holds
    ``_LOCK``; a step another writer is producing is never collected."""
    busy = {n for d, n in _IN_FLIGHT if d == os.path.abspath(ckpt_dir)}
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        if d not in busy:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip().split("_")[1])


def _read_manifest(ckpt_dir: str, step: Optional[int]) -> tuple[dict, str]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f), path


def _load_npz(path: str, manifest: dict, verify: bool) -> dict:
    """One checkpoint npz as ``{key: tensor}``, its checksum checked
    against the manifest first."""
    if verify:
        want = manifest["sha256"][os.path.basename(path)]
        got = _sha256(path)
        if got != want:
            raise IOError(f"checksum mismatch in {path}: {got} != {want}")
    flat = {}
    with np.load(path) as data:
        for key in manifest["keys"]:
            flat[key] = _from_storable(data[key.replace("/", "__")],
                                       manifest["dtypes"][key])
    return flat


def _sharded_manifest(ckpt_dir: str, step: Optional[int]) -> tuple[dict, str]:
    manifest, path = _read_manifest(ckpt_dir, step)
    if manifest.get("format") != "sharded":
        raise ValueError(f"checkpoint at {path} has format "
                         f"'{manifest.get('format')}', expected 'sharded'")
    return manifest, path


def read_shard(ckpt_dir: str, k: int, *, step: Optional[int] = None,
               verify: bool = True) -> tuple[dict, dict]:
    """Shard ``k`` of a sharded checkpoint as ``(manifest, flat dict)``:
    only ``shard_<k>.npz`` is read (a rank's pre-partitioned load)."""
    manifest, path = _sharded_manifest(ckpt_dir, step)
    if not 0 <= k < int(manifest["num_shards"]):
        raise ValueError(f"shard {k} of a checkpoint with "
                         f"{manifest['num_shards']} shards")
    return manifest, _load_npz(os.path.join(path, f"shard_{k}.npz"),
                               manifest, verify)


def read_sharded(ckpt_dir: str, *, step: Optional[int] = None,
                 verify: bool = True) -> tuple[dict, list]:
    """A sharded checkpoint as ``(manifest, per-shard flat dicts)``: each
    shard's dict holds only its local slices, nothing is concatenated."""
    manifest, path = _sharded_manifest(ckpt_dir, step)
    return manifest, [
        _load_npz(os.path.join(path, f"shard_{m}.npz"), manifest, verify)
        for m in range(int(manifest["num_shards"]))]


def _reassemble(manifest: dict, shards: list) -> dict:
    """The full flat state from per-shard slices: the bit-exact inverse of
    the converter's slicing, driven by the manifest's ``shard_info``."""
    from repro_torch.distributed.tp import Segments, mesh_unshard
    info = manifest["shard_info"]
    full = {}
    for key in manifest["keys"]:
        obj = info.get(key, "replicated")
        parts = [s[key] for s in shards]
        if isinstance(obj, dict) and "mesh" in obj:   # save_on_mesh's
            full[key] = mesh_unshard(parts, obj["data_dim"],
                                     obj["model_dim"], *obj["mesh"])
            continue
        rule = Segments.from_json(obj)
        full[key] = parts[0] if rule is None else rule.unslice(parts)
    return full


def _load_flat(ckpt_dir: str, step: Optional[int], verify: bool
               ) -> tuple[dict, dict]:
    """``(manifest, {key: tensor})`` of either format, a sharded one
    reassembled to the full arrays."""
    manifest, path = _read_manifest(ckpt_dir, step)
    if manifest.get("format") == "sharded":
        manifest, shards = read_sharded(ckpt_dir, step=manifest["step"],
                                        verify=verify)
        return manifest, _reassemble(manifest, shards)
    return manifest, _load_npz(os.path.join(path, "arrays.npz"), manifest,
                               verify)


def restore(ckpt_dir: str, state_like, *, step: Optional[int] = None,
            verify: bool = True):
    """Restore into the structure of ``state_like`` (shapes checked; each
    leaf cast to the like leaf's dtype and put on its device; a sharded
    checkpoint reassembled bit for bit).  Returns ``(state, step)``."""
    manifest, flat = _load_flat(ckpt_dir, step, verify)
    return _fill(state_like, flat), manifest["step"]


def _fill(state_like, flat: dict):
    """``state_like``'s structure from a flat ``{key: tensor}`` (shapes
    checked, each leaf cast to the like leaf's dtype and put on its
    device)."""
    def fill(like, prefix):
        if isinstance(like, dict):
            return {k: fill(v, prefix + (k,)) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(fill(v, prefix + (i,))
                              for i, v in enumerate(like))
        if is_quantized(like):
            kids = [fill(v, prefix + (i,)) for i, v in enumerate(
                [like.q, like.scale] + ([] if like.act_scale is None
                                        else [like.act_scale]))]
            return QuantizedTensor(kids[0], kids[1], like.axis,
                                   kids[2] if len(kids) > 2 else None)
        key = "/".join(str(p) for p in prefix)
        arr = flat[key]
        like = torch.as_tensor(like)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint key {key}: shape "
                             f"{tuple(arr.shape)}, expected "
                             f"{tuple(like.shape)}")
        return arr.to(device=like.device, dtype=like.dtype)
    return fill(state_like, ())


def load_params(ckpt_dir: str, *, step: Optional[int] = None,
                verify: bool = True, device="cuda"):
    """Restore without a ``state_like``: the nested dict tree from the
    manifest's keys alone, on ``device``, stored dtypes kept.  A key group
    ``<stem>/0`` (int8) + ``<stem>/1`` (scale) [+ ``<stem>/2``] is how a
    QuantizedTensor is stored, and loads as one.  Returns ``(tree,
    step)``."""
    dev = resolve_device(device)
    manifest, flat = _load_flat(ckpt_dir, step, verify)
    keys = set(flat)
    tree: dict = {}
    consumed: set[str] = set()

    def insert(key: str, leaf):
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    for key in sorted(keys):
        if key in consumed:
            continue
        stem, _, child = key.rpartition("/")
        if (child == "0" and stem and flat[key].dtype == torch.int8
                and stem + "/1" in keys):
            q, scale = flat[stem + "/0"], flat[stem + "/1"]
            act = flat.get(stem + "/2")
            consumed.update(k for k in (stem + "/0", stem + "/1", stem + "/2")
                            if k in keys)
            insert(stem, QuantizedTensor(
                q.to(dev), scale.to(dev),
                # -1, not ndim - 1: channel-last also for a stacked payload
                -1 if scale.dim() else None,
                None if act is None else act.to(dev)))
        else:
            insert(key, flat[key].to(dev))
    return tree, manifest["step"]
