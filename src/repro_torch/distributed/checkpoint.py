"""Checkpointing with atomic commit and an integrity manifest, in the
reference package's layout, so that each package opens the other's.

The layout (one directory per step):
    ckpt_dir/step_000123/
        manifest.json      — leaf -> file map, shapes, dtypes, step,
                             extra (the data cursor), adler32 per leaf
        shard_000.npz ...  — leaves chunked into ~256 MB files

  * atomic: written to step_X.tmp, then renamed — a crash mid-write never
    corrupts the latest checkpoint;
  * async: ``AsyncCheckpointer.save_async`` snapshots the tensors to host
    memory and hands them to a writer thread, so the train loop resumes;
  * self-validating: per-leaf adler32 checksums verified on load.

A tree is nested dicts (and lists) of tensors; a leaf's key is its path
joined by "/".  Where a leaf's own key is a parameter name of the port's
``LM`` (``blocks.0.layers.0.attn.wq``), the reference's path
(``blocks/layers/0/attn/wq``, from ``models.transformer.reference_path``)
takes its place, and the port's leaves of one reference leaf are stacked
along the reference's stacked dimensions, in the order of their index.  So
``{"params": ..., "opt": ...}`` of a port training run is written under
the reference's keys, shapes, dtypes and bytes: for the same state the two
packages' manifests are equal.  On load the stacked leaves are split back
onto the port's leaves, each on the device and dtype of the leaf it
replaces.  A checkpoint in the port's earlier layout (dotted names,
unstacked) is refused.

Tensors are snapshot with ``.detach().cpu()`` (a CUDA tensor cannot be read
by NumPy) into a copy, so later in-place updates never reach a pending
save.  NumPy has no bfloat16: a bfloat16 leaf is stored as its raw uint16
bits with ``"dtype": "bfloat16"`` in the manifest, the bytes and manifest
entry that the reference's ``ml_dtypes`` array gives (which NumPy stores as
2-byte void); either is read back as bfloat16.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import reference_path

_SHARD_BYTES = 256 * 2**20
_BF16 = "bfloat16"


def _map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(key, leaf)`` over the leaves of nested dicts / lists / tuples,
    keeping the structure; ``key`` is the path joined by "/"."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _leaf_paths(tree: Any) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}

    def fn(key, leaf):
        flat[key] = leaf
    _map_with_path(fn, tree)
    return flat


class _HostLeaf:
    """A leaf copied to host memory; a bfloat16 tensor as its uint16 bits."""
    __slots__ = ("arr", "bf16")

    def __init__(self, leaf: Any, bf16: bool = False):
        self.bf16 = bf16 or isinstance(leaf, torch.Tensor) \
            and leaf.dtype == torch.bfloat16
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            self.arr = (t.view(torch.uint16) if self.bf16 else t).numpy()
        else:
            self.arr = np.array(leaf)


def _split_key(key: str) -> Tuple[str, Tuple[int, ...]]:
    """A leaf's key -> its key in the reference's layout and its index
    along that leaf's stacked dimensions: the last component, where it is
    a parameter name of the port, becomes the reference's path."""
    head, _, name = key.rpartition("/")
    path, idx = reference_path(name)
    return (f"{head}/{path}" if head else path), idx


def _stacked(flat: Dict[str, _HostLeaf]) -> Dict[str, _HostLeaf]:
    """The leaves under the reference's keys, those of one stacked leaf
    stacked (row-major over the stacked dimensions)."""
    groups: Dict[str, Dict[Tuple[int, ...], _HostLeaf]] = {}
    for key, leaf in flat.items():
        ref, idx = _split_key(key)
        groups.setdefault(ref, {})[idx] = leaf
    out = {}
    for ref, parts in groups.items():
        if list(parts) == [()]:
            out[ref] = parts[()]
            continue
        idxs = sorted(parts)
        dims = tuple(max(i[d] for i in idxs) + 1
                     for d in range(len(idxs[0])))
        if len(idxs) != int(np.prod(dims)):
            raise ValueError(f"{ref}: {len(idxs)} leaves do not fill a "
                             f"stack of {dims}")
        first = parts[idxs[0]]
        out[ref] = _HostLeaf(np.stack([parts[i].arr for i in idxs]).reshape(
            dims + first.arr.shape), bf16=first.bf16)
    return out


def snapshot(tree: Any) -> Any:
    """The tree with every leaf copied to host memory."""
    return _map_with_path(lambda key, leaf: _HostLeaf(leaf), tree)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> Path:
    return _write(ckpt_dir, step, snapshot(tree), extra, keep)


def _write(ckpt_dir: str, step: int, host_tree: Any,
           extra: Optional[Dict], keep: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat = _stacked(_leaf_paths(host_tree))
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    shard_idx, shard_sz = 0, 0
    shard: Dict[str, np.ndarray] = {}

    def flush():
        nonlocal shard_idx, shard_sz, shard
        if shard:
            np.savez(tmp / f"shard_{shard_idx:03d}.npz", **shard)
            shard_idx += 1
            shard_sz, shard = 0, {}

    for key, leaf in sorted(flat.items()):
        arr = leaf.arr
        fkey = key.replace("/", "__")
        manifest["leaves"][key] = {
            "file": f"shard_{shard_idx:03d}.npz", "name": fkey,
            "shape": list(arr.shape),
            "dtype": _BF16 if leaf.bf16 else str(arr.dtype),
            "adler32": zlib.adler32(np.ascontiguousarray(arr).tobytes()),
        }
        shard[fkey] = arr
        shard_sz += arr.nbytes
        if shard_sz >= _SHARD_BYTES:
            flush()
    flush()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)  # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = sorted(int(d.name.split("_")[1]) for d in p.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp"))
    return steps[-1] if steps else None


def load(ckpt_dir: str, tree_like: Any,
         step: Optional[int] = None) -> Tuple[int, Any, Dict]:
    """Restore into the structure of ``tree_like``: every leaf becomes a
    tensor on the device and of the dtype of the ``tree_like`` leaf at its
    key, cut out of its stacked leaf where the reference stacks it.  Reads
    a checkpoint of either package.  Raises ``IOError`` on a checksum
    mismatch and ``ValueError`` for a checkpoint in the port's earlier
    layout."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    dotted = [k for k in manifest["leaves"] if "." in k]
    if dotted:
        raise ValueError(
            f"{d} is in the port's earlier checkpoint layout (one leaf a "
            f"parameter, under its dotted name, e.g. {dotted[0]!r}); this "
            f"version reads the reference's stacked layout only "
            f"(e.g. 'params/blocks/layers/0/attn/wq')")
    files: Dict[str, Any] = {}
    stacked: Dict[str, np.ndarray] = {}

    def read(ref: str) -> np.ndarray:
        if ref not in stacked:
            meta = manifest["leaves"][ref]
            if meta["file"] not in files:
                files[meta["file"]] = np.load(d / meta["file"])
            arr = files[meta["file"]][meta["name"]]
            if zlib.adler32(np.ascontiguousarray(arr).tobytes()) \
                    != meta["adler32"]:
                raise IOError(f"checksum mismatch for {ref} in {d}")
            if meta["dtype"] == _BF16:
                arr = arr.view(np.uint16)
            stacked[ref] = arr
        return stacked[ref]

    def rebuild(key, leaf):
        ref, idx = _split_key(key)
        arr = read(ref)[idx] if idx else read(ref)
        t = torch.from_numpy(np.array(arr))
        if manifest["leaves"][ref]["dtype"] == _BF16:
            t = t.view(torch.bfloat16)
        if isinstance(leaf, torch.Tensor):
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} in {d}, "
                                 f"expected {tuple(leaf.shape)}")
            return t.to(device=leaf.device, dtype=leaf.dtype)
        return t
    try:
        tree = _map_with_path(rebuild, tree_like)
    finally:
        for f in files.values():
            f.close()
    return manifest["step"], tree, manifest.get("extra", {})


class AsyncCheckpointer:
    """Background writer thread; at most one save in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        host_tree = snapshot(tree)  # copied before returning

        def work():
            try:
                _write(self.ckpt_dir, step, host_tree, extra, self.keep)
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self.last_error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
