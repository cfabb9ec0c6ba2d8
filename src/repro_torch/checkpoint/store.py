"""Checkpointing: atomic commit, async writer, restore onto a device.

Port of ``repro/checkpoint/store.py``, with its on-disk layout, so that
either package reads what the other wrote: ``<dir>/step_<k:08d>/`` with one
``.npy`` a leaf, named by the leaf's path joined with ``__`` (a dict key
as it is, a NamedTuple field by its name, a list index as ``i<idx>``),
and ``manifest.json`` with each leaf's shape and dtype.  Writes go to
``step_<k>.tmp`` and are renamed on completion: a reader never sees a
partial checkpoint, and a crash mid-write leaves the previous one intact.

A tree is nested dicts, lists and NamedTuples (``optim.AdamWState``) of
tensors, numpy arrays or scalars.  ``restore`` is the one-device form of
the reference's ``restore_sharded``: each leaf is read and placed on the
device in the dtype of the ``like`` leaf, with its ``requires_grad``; the
resharded restore onto a mesh belongs to the distributed runtime
(ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "__"


def _items(tree: Tree, path: tuple = ()):
    """(path parts, leaf) in order: dicts by key, NamedTuples by field name,
    lists and tuples by index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (f"i{i}",))
    else:
        yield path, tree


def _rebuild(tree: Tree, fn: Callable[[str, Any], Any], path: tuple = ()) -> Tree:
    """``tree`` with each leaf replaced by fn(key, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, n), fn, path + (n,))
                            for n in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (f"i{i}",))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path) or "leaf", tree)


def _flatten(tree: Tree) -> dict:
    out = {}
    for path, leaf in _items(tree):
        key = _SEP.join(path) or "leaf"
        assert key not in out, key
        out[key] = leaf
    return out


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array (a copy of its own where ``copy``: the
    training step updates its tensors in place)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Tree) -> Path:
    """Blocking save with atomic commit, a leaf at a time.  Returns the
    final path."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        arr = _host(leaf)
        np.save(tmp / f"{key}.npy", arr)
        manifest[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def _source(ckpt_dir: Path, step: Optional[int]) -> Tuple[int, Path, dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:08d}"
    return step, src, json.loads((src / "manifest.json").read_text())


def _check_keys(like: Tree, manifest: dict) -> None:
    like_keys = set(_flatten(like))
    assert like_keys == set(manifest["leaves"]), (
        sorted(like_keys ^ set(manifest["leaves"]))[:5])


def load_checkpoint(ckpt_dir: str | Path, step: Optional[int] = None,
                    like: Optional[Tree] = None) -> Tuple[int, Tree]:
    """Load (step, tree) of numpy arrays.  ``like`` supplies the structure;
    without it a flat {path: array} dict is returned."""
    step, src, manifest = _source(Path(ckpt_dir), step)
    if like is None:
        return step, {k: np.load(src / f"{k}.npy") for k in manifest["leaves"]}
    _check_keys(like, manifest)
    return step, _rebuild(like, lambda key, _: np.load(src / f"{key}.npy"))


def restore(ckpt_dir: str | Path, like: Tree,
            device: "torch.device | str" = "cuda",
            step: Optional[int] = None) -> Tuple[int, Tree]:
    """(step, tree of fresh tensors on ``device``) in ``like``'s structure,
    each leaf in the dtype of its ``like`` leaf and with its
    ``requires_grad``; read and placed one leaf at a time, so the host
    holds at most one leaf."""
    step, src, manifest = _source(Path(ckpt_dir), step)
    _check_keys(like, manifest)

    def place(key, leaf):
        t = torch.from_numpy(np.load(src / f"{key}.npy")).to(device)
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.dtype).requires_grad_(leaf.requires_grad)
        return t

    return step, _rebuild(like, place)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight).

    ``save`` snapshots to host memory synchronously (cheap relative to a
    step) and commits to disk on a background thread; ``wait`` joins the
    in-flight write (call before exit or before deleting old steps).
    """

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        host_tree = _rebuild(tree, lambda key, leaf: _host(leaf, copy=True))

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:        # noqa: BLE001
                self.error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            raise self.error

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for p in self.ckpt_dir.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}",
                          ignore_errors=True)
