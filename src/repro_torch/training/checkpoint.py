"""Fault-tolerant checkpointing, in the reference's layout.

Layout:  <dir>/step_<N>/proc<k>/<leaf-path>.npy  +  manifest.json, and
``COMMITTED`` in ``step_<N>`` once process 0's part is complete.  A leaf's
path joins its dict keys and list indices with ``__``
(``params__stages__blocks__attn__wq``).  Writes go to a temp directory
that is then renamed, so a crash mid-save never corrupts the latest
checkpoint.  ``save_async`` copies every tensor to the host before its
thread starts, so the train loop may go on updating the state in place.
``restore`` checks each leaf's shape against the target tree.

A float32 (or int) checkpoint written by either package restores into
the other.  numpy has no bfloat16 here, so the port writes a bfloat16
leaf as its uint16 bits with ``"bfloat16"`` as the manifest's dtype, and
reads such a leaf back by those bits; the reference reads numbers, so a
bfloat16 leaf does not cross from the port to it.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.common.pytree import tree_map, tree_map_with_path


def _leaf_paths(tree) -> list[tuple[str, object]]:
    out: list = []
    tree_map_with_path(
        lambda path, leaf: out.append(("__".join(map(str, path)), leaf)),
        tree)
    return out


def _host(x):
    """A leaf as a host copy that no later in-place update touches."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = x.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def save(state, directory, step: int, *, process_index: int = 0,
         keep: int = 3) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}_p{process_index}"
    proc = tmp / f"proc{process_index}"
    proc.mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "leaves": {}}
    for key, leaf in _leaf_paths(state):
        arr, dtype = _to_numpy(leaf)
        np.save(proc / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    (proc / "manifest.json").write_text(json.dumps(manifest))

    final.mkdir(parents=True, exist_ok=True)
    dst = final / f"proc{process_index}"
    if dst.exists():
        shutil.rmtree(dst)
    proc.rename(dst)
    shutil.rmtree(tmp, ignore_errors=True)
    # mark complete (single-process: immediately; multi-host: proc0 decides)
    if process_index == 0:
        (final / "COMMITTED").write_text(str(step))
    _gc(directory, keep)
    return final


def save_async(state, directory, step: int, **kw) -> threading.Thread:
    host_state = tree_map(_host, state)
    t = threading.Thread(target=save, args=(host_state, directory, step),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def latest_step(directory) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "COMMITTED").exists()]
    return max(steps) if steps else None


def _load(proc: pathlib.Path, key: str, info: dict, leaf) -> torch.Tensor:
    arr = np.load(proc / f"{key}.npy")
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                         f"{tuple(leaf.shape)}")
    if info["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def restore(target, directory, step: int | None = None, *,
            process_index: int = 0):
    """Restore into the structure, dtypes and devices of ``target`` (a
    tree of tensors).  Returns the restored tree."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    proc = directory / f"step_{step:08d}" / f"proc{process_index}"
    manifest = json.loads((proc / "manifest.json").read_text())

    def one(path, leaf):
        key = "__".join(map(str, path))
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _load(proc, key, info, leaf)

    return tree_map_with_path(one, target)


def _gc(directory: pathlib.Path, keep: int):
    steps = sorted(
        (p for p in directory.glob("step_*") if (p / "COMMITTED").exists()),
        key=lambda p: int(p.name.split("_")[1]))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
