"""Atomic, optionally asynchronous checkpointing (counterpart of
`repro.checkpoint.ckpt`), with the reference's on-disk layout, so that a
checkpoint either package writes restores into the other.

Layout: <dir>/step_<N>/
    meta.json              — step, leaf names, wall time, extra metadata
    arrays/<leaf-path>.npy — one file per leaf, the path's "/" as "__"

A save writes into `step_<N>.tmp`, fsyncs the metadata and renames the
directory into place; with `async_save` it runs on a background thread that
`wait()` joins (and whose error it raises) before the next save or restore.
Leaf paths are those of `jax.tree_util.tree_flatten_with_path`: dict keys
sorted, tuple and list indices as digits, NamedTuple fields by name in
order, None an empty subtree. The files hold full arrays and no topology:
a state saved from a mesh is gathered first (`sharding.lm.gather_tree`),
and `restore(..., shardings=)` cuts each leaf to this rank's block on the
current mesh (elastic: any mesh, or one device).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs.clock import wall_s

SEP = "/"


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in the reference's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order and names."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, child in kids:
        for sub, leaf in flatten_with_paths(child):
            out.append((key + SEP + sub if sub else key, leaf))
    return out


def map_leaves(fn: Callable, tree):
    """`tree` with every leaf replaced by fn(leaf), its containers kept;
    fn sees the leaves in `flatten_with_paths` order."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    mapped = [map_leaves(fn, c) for _, c in kids]
    if hasattr(tree, "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (a CPU tensor is copied too: training updates
    it in place while an asynchronous save writes). bfloat16 is saved as
    raw 2-byte records ('V2'), as numpy writes the reference's bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.array(leaf)


def to_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a host array; a 2-byte record array (a restored 'V2'
    leaf, or the reference's bfloat16 handed over as numpy) holds
    bfloat16 bits."""
    arr = np.array(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_into(dst: torch.Tensor, arr) -> None:
    """Copy a restored array (or a tensor: a block cut by `restore`'s
    shardings) into `dst` in place, on dst's device and in its dtype."""
    src = arr if isinstance(arr, torch.Tensor) else to_tensor(arr)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"restored shape {tuple(src.shape)} is not "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _leaf_file(arrays_dir: str, name: str) -> str:
    return os.path.join(arrays_dir, name.replace(SEP, "__") + ".npy")


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ----------------------------------------------------------- save
    def save(self, step: int, state: dict, extra_meta: dict | None = None):
        """state: a tree of tensors or arrays (e.g. {"params": ...}),
        copied to the host before this returns."""
        self.wait()
        host_state = map_leaves(_host, state)

        def write():
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            arrays_dir = os.path.join(tmp, "arrays")
            os.makedirs(arrays_dir, exist_ok=True)
            leaves = flatten_with_paths(host_state)
            for name, leaf in leaves:
                np.save(_leaf_file(arrays_dir, name), leaf)
            meta = {"step": step, "leaves": [n for n, _ in leaves],
                    "time": wall_s(), **(extra_meta or {})}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()

        if self.async_save:
            def run():
                try:
                    write()
                except BaseException as e:   # raised again by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        """Join a pending asynchronous save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None,
                shardings=None) -> tuple[int, Any]:
        """The checkpoint at `step` (default: the latest) as numpy arrays
        in the structure of `like`, whose leaves give only the names. With
        `shardings` (a tree of `sharding.rules.NamedSharding` on the
        current mesh, the structure of `like`; a None leaf is kept whole)
        each leaf comes back as a CPU tensor of this rank's block."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        arrays_dir = os.path.join(self.directory, f"step_{step:08d}",
                                  "arrays")
        names = [name for name, _ in flatten_with_paths(like)]
        arrays = [np.load(_leaf_file(arrays_dir, name)) for name in names]
        if shardings is not None:
            held = dict(flatten_with_paths(shardings))
            arrays = [held[name].local(to_tensor(a))
                      if held.get(name) is not None else a
                      for name, a in zip(names, arrays)]
        loaded = iter(arrays)
        return step, map_leaves(lambda _: next(loaded), like)

