"""Fault-tolerant sharded checkpoints for per-rank state.

Counterpart of ``repro.checkpoint.manager`` for ``torch.distributed``,
where every rank holds its own shard:

  * **atomic**: a step is written into ``step_N.tmp/`` and renamed to
    ``step_N/`` by the first rank only once every rank's files and the
    manifest are on disk (fsync'd), so a writer that dies never corrupts
    the latest complete checkpoint;
  * **sharded**: each rank writes only its own shards, one ``.npy`` per
    (leaf, shard), ``<leaf>.shard<rank>.npy``; no traffic between ranks at
    save.  A tensor leaf is this rank's shard of a logical array
    concatenated over the ranks in rank order; a numpy or Python leaf is
    a host value every rank holds alike, written once, by the first rank;
  * **manifest of logical layouts**: per leaf its kind, shard shape,
    logical shape and dtype, and the world size that wrote it, never
    device ids; ``restore`` lays the shards out for the current ranks of a
    mesh of the same shape and axis names (rank r reads shard r);
  * **resumable**: :meth:`latest_step` reads complete steps only; a crash
    during a save leaves a ``.tmp`` directory that is ignored and removed
    when the next manager opens the directory;
  * **async**: ``save(..., blocking=False)`` snapshots to host memory and
    writes on a background thread, so the caller's next step overlaps the
    write;
  * retention: the ``keep`` newest checkpoints are kept.

The ranks meet through the file system only (a shared directory): each
rank marks its part done with a file holding a fresh token, the first
rank waits for every mark before it commits, and every other rank's
:meth:`wait` returns once the committed step holds its own mark.  The
only collective is one barrier when the manager is made, so that no rank
writes before the leftovers of a crashed job are gone.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.utils import _pytree as pytree

__all__ = ["CheckpointManager"]

WAIT_S = 600.0  # how long a rank waits for the other ranks' files of a step


def _flatten_with_names(tree: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    flat, spec = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                        for p in path)
        out.append((name, leaf))
    return out, spec


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` and its dtype's name; bfloat16, which numpy
    lacks, is stored as its 16-bit patterns."""
    dtype = str(t.dtype).removeprefix("torch.")
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu").numpy().copy(), dtype


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    # np.ascontiguousarray makes a 0-d array 1-d: keep the saved shape
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    """Atomic, sharded, restorable checkpoints of per-rank state (module
    docstring).  ``group`` is the process group whose ranks share the
    directory (the default group when ``torch.distributed`` is
    initialised, else one process).

    >>> import tempfile
    >>> ck = CheckpointManager(tempfile.mkdtemp())
    >>> ck.save(1, {"w": torch.arange(4), "level": np.int32(1)})
    >>> ck.latest_step()
    1
    >>> ck.restore(1, {"w": torch.zeros(4, dtype=torch.int64)})["w"].tolist()
    [0, 1, 2, 3]
    """

    def __init__(self, directory: str, keep: int = 3, group: Any = None):
        self.dir = directory
        self.keep = keep
        if tdist.is_initialized():
            self.rank = tdist.get_rank(group)
            self.world = tdist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        if self.rank == 0:
            self._gc_tmp()
        if self.world > 1:
            tdist.barrier(group=group)

    # ---------------------------------------------------------- paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _gc_tmp(self) -> None:
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        """Newest *complete* checkpoint step, or None.

        >>> import tempfile
        >>> CheckpointManager(tempfile.mkdtemp()).latest_step() is None
        True
        """
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "MANIFEST.json")):
                    steps.append(int(d[5:]))
        return max(steps) if steps else None

    def _manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    def read_leaf(self, step: int, name: str) -> torch.Tensor:
        """One leaf of a checkpoint by its flattened path name, as a CPU
        tensor, without reading the rest: a sharded leaf as its logical
        array (the shards concatenated in rank order).  This is how a
        restorer whose state *shapes* depend on saved metadata bootstraps:
        read the scalar, build ``like``, then ``restore``.

        >>> import tempfile
        >>> ck = CheckpointManager(tempfile.mkdtemp())
        >>> ck.save(3, {"level": np.int32(2), "k": torch.arange(8)})
        >>> int(ck.read_leaf(3, "level"))
        2
        """
        d = self._step_dir(step)
        meta = self._manifest(step)["leaves"][name]
        if meta["kind"] == "replicated":
            return _from_numpy(np.load(os.path.join(d, meta["file"])), meta["dtype"])
        parts = [np.load(os.path.join(d, meta["file"].format(rank=r)))
                 for r in range(meta["shards"])]
        return _from_numpy(np.concatenate(parts), meta["dtype"])

    # ---------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        """Checkpoint ``state`` (a pytree of tensors, this rank's shards, and
        numpy / Python values every rank holds alike) at ``step``.  Every
        rank of the group calls it with the same structure."""
        self.wait()  # one save in flight at a time
        named, _ = _flatten_with_names(state)
        # the snapshot to host memory: the only part an async save waits on
        host: Dict[str, Tuple[str, np.ndarray, str]] = {}
        for name, leaf in named:
            if leaf is None:
                continue
            if isinstance(leaf, torch.Tensor):
                arr, dtype = _to_numpy(leaf)
                host[name] = ("shard", arr, dtype)
            else:
                arr = np.asarray(leaf)
                host[name] = ("replicated", arr, str(arr.dtype))
        token = uuid.uuid4().hex

        def write() -> None:
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            leaves = {}
            for name, (kind, arr, dtype) in host.items():
                stem = name.replace("/", "__")
                if kind == "shard":
                    np.save(os.path.join(tmp, f"{stem}.shard{self.rank}.npy"), arr)
                    leaves[name] = {
                        "kind": kind, "file": stem + ".shard{rank}.npy",
                        "shards": self.world, "shape": list(arr.shape),
                        "logical_shape": [self.world * arr.shape[0]] + list(arr.shape[1:])
                        if arr.ndim else [self.world],
                        "dtype": dtype,
                    }
                else:
                    if self.rank == 0:
                        np.save(os.path.join(tmp, stem + ".npy"), arr)
                    leaves[name] = {"kind": kind, "file": stem + ".npy",
                                    "shape": list(arr.shape), "dtype": dtype}
            self._write(os.path.join(tmp, f"DONE.{self.rank}"), token)
            final = self._step_dir(step)
            if self.rank == 0:
                for r in range(1, self.world):
                    self._await(lambda r=r: os.path.exists(os.path.join(tmp, f"DONE.{r}")),
                                f"rank {r}'s part of step {step}")
                self._write(os.path.join(tmp, "MANIFEST.json"),
                            json.dumps({"step": step, "world": self.world, "leaves": leaves}))
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # the atomic commit
                self._retain()
            else:
                mark = os.path.join(final, f"DONE.{self.rank}")
                self._await(lambda: os.path.exists(mark) and open(mark).read() == token,
                            f"the commit of step {step}")

        if blocking:
            write()
            return

        def run() -> None:
            try:
                write()
            except BaseException as exc:  # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @staticmethod
    def _write(path: str, text: str) -> None:
        with open(path, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())

    def _await(self, ready, what: str) -> None:
        t_end = time.monotonic() + WAIT_S
        while not ready():
            if time.monotonic() > t_end:
                raise TimeoutError(f"waited {WAIT_S} s for {what} in {self.dir}")
            time.sleep(0.002)

    def wait(self) -> None:
        """Wait for the save in flight: on return its step is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _retain(self) -> None:
        steps = sorted(int(d[5:]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: a tensor leaf gets this
        rank's shard, on that leaf's device, with its shape and dtype
        checked; any other leaf the host value.  The checkpoint must come
        from as many ranks as the group has (a mesh of the same shape)."""
        d = self._step_dir(step)
        manifest = self._manifest(step)
        if manifest["world"] != self.world:
            raise ValueError(f"step {step} was written by {manifest['world']} ranks; this "
                             f"group has {self.world}")
        named, spec = _flatten_with_names(like)
        leaves = []
        for name, leaf in named:
            if leaf is None:
                leaves.append(None)
                continue
            meta = manifest["leaves"][name]
            if meta["kind"] == "replicated":
                leaves.append(np.load(os.path.join(d, meta["file"])))
                continue
            t = _from_numpy(np.load(os.path.join(d, meta["file"].format(rank=self.rank))),
                            meta["dtype"])
            if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                raise ValueError(f"{name}: checkpoint {tuple(t.shape)} {t.dtype} vs "
                                 f"{tuple(leaf.shape)} {leaf.dtype}")
            leaves.append(t.to(leaf.device))
        return pytree.tree_unflatten(leaves, spec)
