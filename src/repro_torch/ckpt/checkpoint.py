"""Numpy checkpoints in the JAX package's on-disk format.

Each leaf is one ``.npy`` under the checkpoint directory, next to a JSON
manifest of leaf paths, dtypes, shapes and the step — the format of
`repro/ckpt/checkpoint.py`, read and written here without JAX, so a table
the JAX package saves is served by this package unchanged.  Leaves are
ordered and named as JAX's tree flattening names them: dict keys sorted,
NamedTuple fields in order as ``.<field>`` (the optimizer states), list and
tuple entries by index, path parts joined with ``/``.  bfloat16
leaves are stored as 2-byte void words (``<V2``) with dtype ``bfloat16``
in the manifest, as numpy writes them for the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if hasattr(tree, "_fields"):
        return [kv for k in tree._fields
                for kv in _flatten(getattr(tree, k), prefix + ("." + k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like: Any, leaves: Dict[str, Any],
               prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), leaves,
                                       prefix + ("." + k,))
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array as written, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, tree: Any, step: int,
         extra: Optional[Dict] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(ckpt_dir, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "dtype": dtype,
             "shape": list(arr.shape)})
    tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))


def load(ckpt_dir: str, like: Any = None):
    """Restore numpy leaves.  Returns ``(tree, step)``: ``tree`` has the
    structure of ``like`` (whose leaves give the expected shapes), or is a
    flat ``{path: array}`` dict when ``like`` is None."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    wanted = (_flatten(like) if like is not None
              else [(p, None) for p in by_path])
    out = {}
    for path, leaf in wanted:
        ent = by_path.get(path)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(os.path.join(ckpt_dir, ent["file"]))
        if leaf is not None and tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {path}: ckpt {arr.shape} vs "
                f"model {tuple(leaf.shape)}")
        out[path] = arr
    tree = _unflatten(like, out) if like is not None else out
    return tree, manifest["step"]


def latest_step(base_dir: str) -> Optional[str]:
    """Newest ``step_*`` checkpoint directory under ``base_dir``."""
    if not os.path.isdir(base_dir):
        return None
    cands = sorted(d for d in os.listdir(base_dir) if d.startswith("step_"))
    return os.path.join(base_dir, cands[-1]) if cands else None


def table_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """A checkpoint leaf as a tensor on ``device`` (None: ``cuda``): the
    bits of a bfloat16 leaf (stored as 2-byte words) become a bfloat16
    tensor; every other dtype converts as numpy's."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))
