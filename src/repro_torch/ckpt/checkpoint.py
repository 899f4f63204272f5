"""Atomic, asynchronous checkpoints of trees of tensors (the port's
`repro.ckpt.checkpoint`, in the reference's on-disk layout).

Layout (one directory per step):
    <dir>/step_00000120.tmp-<nonce>/   while writing
        manifest.json                  leaf names, shapes, dtypes, extra
        proc00000/arr_00000.npy ...    each leaf, in the tree's leaf order
    <dir>/step_00000120/               atomic rename on completion

A leaf's name is its path through the tree, dict keys and sequence
indices joined by ``/`` (``params/embed``, ``opt/m/segments/0/1/...``),
as the reference names its pytree paths; leaves go in `repro_torch.tree`
order (dict keys sorted), which is JAX's. bfloat16 leaves are written as
2-byte records (``<V2``, the reference's files) and read back bit for
bit. A host integer leaf (the optimizer's step count) is a 0-d int32
array, as the reference's device counter. One process writes: the port
trains on one device a process, so there is one ``proc00000`` shard per
leaf, the reference's single-process layout. A checkpoint the reference
wrote restores into the port through `models.convert.train_state_from_
checkpoint` (its periods are stacked on a leading axis).

Fault-tolerance contract:
  * save is atomic (tmp dir + rename) — a crash mid-save never corrupts
    the latest complete checkpoint;
  * `CheckpointManager.save_async` copies the tree to the host, then
    serializes on a daemon thread behind a queue of 1 (back-pressure
    instead of unbounded memory growth);
  * `latest_step` / `restore` skip incomplete (``.tmp-*``) directories.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map, unflatten

_SEP = "/"
_V2 = np.dtype("V2")  # how numpy writes a bfloat16 leaf


def _named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path name, leaf) pairs in `leaves` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}{_SEP}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _named_leaves(t, f"{prefix}{i}{_SEP}")]
    return [(prefix[:-1], tree)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (bfloat16 as ``<V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(_V2)
        return t.cpu().numpy()
    if isinstance(leaf, (bool, int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(directory: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Blocking atomic save of `tree` (+ JSON-serializable `extra`)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    procdir = os.path.join(tmp, "proc00000")
    os.makedirs(procdir, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(_named_leaves(tree)):
        arr = _to_host(leaf)
        np.save(os.path.join(procdir, f"arr_{i:05d}.npy"), arr)
        manifest["leaves"].append({"i": i, "name": name,
                                   "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf, arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # atomic publish; a re-save of the same step (a restart replaying the
    # step range) swaps the old directory out first
    if os.path.isdir(final):
        old = final + f".old-{uuid.uuid4().hex[:8]}"
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    return final


def _complete_steps(directory: str) -> List[int]:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and ".tmp" not in d and ".old" not in d
        and os.path.exists(os.path.join(directory, d, "manifest.json")))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def load_leaves(directory: str, step: int
                ) -> Tuple[List[Tuple[Dict, np.ndarray]], Dict]:
    """Every leaf of checkpoint `step` as (manifest entry, numpy array),
    in file order, and the manifest's `extra`. A bfloat16 leaf comes as
    its uint16 bit patterns."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    procdir = os.path.join(final, "proc00000")
    out = []
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(procdir, f"arr_{meta['i']:05d}.npy"))
        if meta["dtype"] == "bfloat16" or arr.dtype == _V2:
            arr = arr.view(np.uint16)
        out.append((meta, arr))
    return out, manifest["extra"]


def leaf_tensor(meta: Dict, arr: np.ndarray, dtype=None,
                device="cpu") -> torch.Tensor:
    """One loaded leaf as a tensor (bfloat16 bit for bit), cast to
    `dtype` when given."""
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def restore(directory: str, step: int, target_tree) -> Tuple[Any, Dict]:
    """Restore checkpoint `step` into the structure of `target_tree`:
    each leaf takes its target's dtype and device (a host integer leaf
    comes back as an int). Raises on a structure or shape mismatch.
    Returns (tree, extra)."""
    got, extra = load_leaves(directory, step)
    flat_t = leaves(target_tree)
    if len(flat_t) != len(got):
        raise ValueError(f"checkpoint has {len(got)} leaves, target expects "
                         f"{len(flat_t)} — structure mismatch")
    out = []
    for (meta, arr), tgt in zip(got, flat_t):
        if not isinstance(tgt, torch.Tensor):
            out.append(type(tgt)(arr.item()))
            continue
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"leaf {meta['name']}: checkpoint shape "
                             f"{tuple(arr.shape)} != target "
                             f"{tuple(tgt.shape)}")
        out.append(leaf_tensor(meta, arr, tgt.dtype, tgt.device))
    return unflatten(target_tree, out), extra


class CheckpointManager:
    """Rotation (`keep` newest) + async save + restore-latest."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree, extra = item
                save(self.directory, step, tree, extra)
                self._gc()
            except Exception as e:  # kept, and raised by the next call
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        for s in _complete_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # tmp dirs of crashed saves (this writer is the only one)
        for d in os.listdir(self.directory):
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("previous async save failed") from err

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        """Copy `tree` to the host now (the training step may then update
        its tensors in place) and queue its save; blocks while the one
        earlier save is still queued."""
        self._raise_pending()
        host = tree_map(lambda x: x.detach().to("cpu", copy=True)
                        if isinstance(x, torch.Tensor) else x, tree)
        self._q.put((step, host, extra))

    def wait(self):
        """Block until every queued save is on disk."""
        self._q.join()
        self._raise_pending()

    def close(self):
        """Finish the queued saves and stop the writer thread."""
        self.wait()
        self._q.put(None)
        self._worker.join()

    def restore_latest(self, target_tree):
        """(step, tree, extra) of the newest complete checkpoint, or None."""
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, extra = restore(self.directory, step, target_tree)
        return step, tree, extra
