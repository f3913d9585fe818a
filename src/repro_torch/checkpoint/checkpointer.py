"""Fault-tolerant checkpointing, in the JAX package's on-disk layout.

* Atomic: writes land in `step_XXXXXXXX.tmp-<nonce>/` and are renamed into
  place only after the manifest is fsync'd — a crash mid-save can never
  corrupt the latest valid checkpoint.
* Async: `save()` snapshots tensors to host (blocking only for the
  device->host copy) and hands serialization to a background thread.
* Portable: one ``leaf_NNNNN.bin`` of raw bytes per leaf plus its numpy
  dtype string and shape in ``manifest.json``; leaves are named by their
  path with dict keys in sorted order, as `jax.tree_util` flattens them,
  so a checkpoint written by either package restores in the other.
  ``bfloat16`` has no numpy dtype here: its leaves are written and read
  through torch as 16-bit words under the dtype string ``"bfloat16"``.
* Restore: leaves come back as CPU tensors in the structure of ``like``;
  ``devices=`` (one device, or a tree of devices mirroring ``like``)
  places them instead.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``(path name, leaf)`` pairs in `jax.tree_util`'s order: dict keys
    sorted, sequences by index, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (i,))
        return out
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(like, leaves: Iterator):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> Any:
    """A leaf as a host array it owns: a CPU tensor for torch leaves (a
    copy, so the caller may update its own in place while the save runs),
    numpy otherwise."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            words = leaf.contiguous().view(torch.int16).numpy()
            return words.tobytes(), list(leaf.shape), BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_from_bytes(buf: bytes, shape: List[int], dtype: str
                     ) -> torch.Tensor:
    if dtype == BF16:
        words = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ----------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot to host, then serialize (async unless async_save=False)."""
        self._submit(step, [(name, _to_host(leaf))
                            for name, leaf in _flatten_with_paths(tree)],
                     extra)

    def _submit(self, step: int, host: List[Tuple[str, Any]],
                extra: Optional[Dict]):
        """Serialize ``(path name, host leaf)`` pairs that the caller no
        longer writes (async unless async_save=False)."""
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves: List[Tuple[str, Any]], extra: Dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (name, leaf) in enumerate(leaves):
            buf, shape, dtype = _leaf_bytes(leaf)
            fn = f"leaf_{i:05d}.bin"
            with open(os.path.join(tmp, fn), "wb") as f:
                f.write(buf)
            manifest["leaves"].append(
                {"name": name, "file": fn, "shape": shape, "dtype": dtype})
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore ---------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and ".tmp" not in d and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                devices: Optional[Any] = None) -> Tuple[int, Any, Dict]:
        """Restore into the structure of `like`: CPU tensors, or on
        ``devices`` (one device for every leaf, or a tree of devices
        mirroring `like`) — the port's counterpart of the JAX package's
        ``shardings=`` re-layout for an elastic restart.

        With ``step=None``, a checkpoint that turns out damaged on read (a
        crash can truncate or delete leaf files even after the manifest
        landed — e.g. a torn filesystem, or an operator partially cleaning
        the directory) is skipped and the next-older intact step is used;
        an explicitly requested ``step`` still raises on damage.
        """
        if step is not None:
            return self._restore_step(step, like, devices)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return self._restore_step(s, like, devices)
            except (OSError, ValueError, KeyError) as e:
                last_err = e    # damaged: fall back to the next-older step
        raise FileNotFoundError(
            f"no intact checkpoint in {self.dir}: {last_err}")

    def _restore_step(self, step: int, like: Any,
                      devices: Optional[Any]) -> Tuple[int, Any, Dict]:
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrs = []
        for entry in manifest["leaves"]:
            with open(os.path.join(path, entry["file"]), "rb") as f:
                buf = f.read()
            arrs.append(_leaf_from_bytes(buf, entry["shape"],
                                         entry["dtype"]))
        n_like = len(_flatten_with_paths(like))
        if len(arrs) != n_like:
            raise ValueError(f"step {step} holds {len(arrs)} leaves, the "
                             f"restore target {n_like}")
        if devices is not None:
            if isinstance(devices, (str, torch.device)):
                arrs = [a.to(devices) for a in arrs]
            else:
                devs = [d for _, d in _flatten_with_paths(devices)]
                arrs = [a.to(d) for a, d in zip(arrs, devs)]
        tree = _unflatten(like, iter(arrs))
        return step, tree, manifest.get("extra", {})


def load_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                    devices: Optional[Any] = None):
    return Checkpointer(directory).restore(like, step, devices)
