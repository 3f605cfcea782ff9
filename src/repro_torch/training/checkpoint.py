"""Mid-solve checkpoints: atomic step directories, a manifest with the mesh
shape, keep-last-k clean-up, and restore into a template (counterpart of
``repro.training.checkpoint``, with its layout on disk, so that a snapshot
either package writes restores into the other)::

    <dir>/step_<n>/manifest.json   {"step": n, "mesh": [...], "leaves": [...],
                                    "dtypes": [...], "shapes": [...]}
    <dir>/step_<n>/arrays.npz      leaf_<i>: the raw bytes of leaf i
    <dir>/LATEST                   the last durable step

A save writes ``step_<n>.tmp`` and renames it only after an fsync, so a
crash mid-save never corrupts the last durable snapshot.

A tree is flattened in JAX's leaf order: a dict by sorted keys, a tuple,
list or named tuple in order, ``None`` as no leaf; tensors, numpy arrays
and scalars are leaves.  Leaves are saved from the host and restored onto
the device of the template's leaf (``torch.utils._pytree`` would keep a
dict's insertion order instead).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable

import numpy as np
import torch

# torch dtypes by the names numpy (and the reference's manifest) give them.
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields
                for pair in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, x in enumerate(tree)
                for pair in _flatten(x, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(template: Any, leaves: Callable[[Any], Any]) -> Any:
    """``template`` with each leaf replaced by ``leaves(old_leaf)``, taken
    in :func:`_flatten`'s order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return leaves(template)


def _host(x: Any) -> np.ndarray:
    """A leaf as a host array; bf16 as its ``uint16`` bits (numpy has no
    bf16), named ``bfloat16`` in the manifest as the reference names it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Any, *, mesh_shape=None,
         keep_last: int = 3) -> str:
    """Save ``tree`` for ``step`` (synchronously); returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    pairs = _flatten(tree)
    host = [_host(x) for _, x in pairs]
    dtypes = ["bfloat16" if isinstance(x, torch.Tensor)
              and x.dtype == torch.bfloat16 else str(a.dtype)
              for (_, x), a in zip(pairs, host)]
    np.savez(
        os.path.join(tmp, "arrays.npz"),
        **{f"leaf_{i}": np.frombuffer(np.ascontiguousarray(a).tobytes(),
                                      np.uint8)
           for i, a in enumerate(host)},
    )
    manifest = {
        "step": step,
        "mesh": list(mesh_shape) if mesh_shape else None,
        "leaves": [p for p, _ in pairs],
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in host],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # the same step saved again replaces it
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest = os.path.join(ckpt_dir, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest + ".tmp", latest)

    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    """Keep the last ``keep_last`` steps; remove orphaned ``.tmp``
    directories of crashed saves."""
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _leaf_from_host(a: np.ndarray, dtype: str, like: Any) -> Any:
    """A restored leaf: a tensor on the template leaf's device (numpy
    arrays and scalars as numpy)."""
    if not isinstance(like, torch.Tensor):
        return a
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy()).to(_TORCH_DTYPES.get(dtype, like.dtype))
    return t.to(like.device)


def restore(ckpt_dir: str, tree_like: Any, *, step: int | None = None,
            expect_mesh=None):
    """Restore the snapshot of ``step`` (default the latest) into the
    structure of ``tree_like``; returns ``(tree, step)``.

    ``expect_mesh`` pins the mesh shape of a mid-solve carry (which is
    meaningful only on the topology that wrote it): a snapshot written on
    another one is refused with the reference's message."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if expect_mesh is not None:
        want = list(expect_mesh)
        got = manifest.get("mesh")
        if got != want:
            raise ValueError(
                f"checkpoint at {d} was written on mesh {got}, but this "
                f"solve runs on mesh {want}: a mid-solve carry cannot "
                f"restore across topologies (re-run from scratch, or "
                f"resume on the original mesh)"
            )
    with np.load(os.path.join(d, "arrays.npz")) as z:
        host = []
        for i in range(len(z.files)):
            dtype = manifest["dtypes"][i]
            raw = np.dtype("uint16") if dtype == "bfloat16" else np.dtype(dtype)
            host.append(np.frombuffer(z[f"leaf_{i}"].tobytes(), dtype=raw)
                        .reshape(tuple(manifest["shapes"][i])))
    templates = [x for _, x in _flatten(tree_like)]
    if len(host) != len(templates):
        raise ValueError(
            f"checkpoint has {len(host)} leaves, tree expects "
            f"{len(templates)}")
    it = iter(range(len(host)))

    def leaf(like):
        i = next(it)
        return _leaf_from_host(host[i], manifest["dtypes"][i], like)

    return _unflatten(tree_like, leaf), step
