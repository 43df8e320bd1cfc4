"""Checkpoint / restart for the port's trainer.

Port of the JAX package's ``distributed/checkpoint.py``, same layout:

    <dir>/step_<N>/
        manifest.json        # step, time, n_arrays, metadata, leaf dtypes
        arrays.npz           # the state's leaves, keyed by "/"-joined paths
        scheduler.json       # scheduler state (a dict)

Writes are crash-safe (temporary directory, then an atomic rename, the
manifest last) and optionally asynchronous (at most one writer in
flight; the next save waits). Restore picks the newest complete
snapshot.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not
use: a bfloat16 leaf is stored as its 16-bit patterns (uint16) and the
manifest's ``"dtypes"`` names its dtype, so a round trip is bit-exact.
A float32 tree is interchangeable with the JAX manager's files both
ways.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).split(".")[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy(), name
    return t.numpy().copy(), name


def _from_numpy(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    a = np.array(a, order="C")        # keeps a 0-dim leaf 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 2,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._writer: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             scheduler_state: Optional[dict] = None,
             metadata: Optional[dict] = None) -> str:
        """``state``: a nested dict of tensors (e.g. {"params": ...,
        "opt": ...}). Leaves are copied to the host before this returns;
        the files are written by a background thread when
        ``async_write``."""
        self.wait()  # at most one write in flight
        arrays, dtypes = {}, {}
        for path, t in _flatten(state).items():
            arrays[path], dtypes[path] = _to_numpy(t)
        sched = dict(scheduler_state or {})
        meta = {"step": int(step), "time": time.time(),
                "n_arrays": len(arrays), **(metadata or {}), "dtypes": dtypes}
        final = os.path.join(self.directory, f"step_{step:08d}")

        def _write():
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "scheduler.json"), "w") as f:
                json.dump(sched, f)
            # manifest last: its presence marks the snapshot complete
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_write:
            self._writer = threading.Thread(target=_write, daemon=True)
            self._writer.start()
        else:
            _write()
        return final

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any, dict]:
        """Returns (step, state, scheduler_state). ``template`` is a
        nested dict of tensors with the target structure and shapes;
        each restored leaf lands on its template leaf's device, in the
        dtype it was saved in."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        flat = {}
        for path, leaf in _flatten(template).items():
            if path not in arrays:
                raise KeyError(f"checkpoint missing array {path!r}")
            arr = arrays[path]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint shape mismatch at {path}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            flat[path] = _from_numpy(arr, dtypes.get(path)).to(leaf.device)

        def build(node, prefix=""):
            return {k: (build(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else flat[f"{prefix}{k}"]) for k, v in node.items()}

        with open(os.path.join(d, "scheduler.json")) as f:
            sched = json.load(f)
        return step, build(template), sched
