"""Checkpoints with async save and atomic commit (the reference's
``ckpt/checkpoint.py``, for the port's flat state).

Layout per step::

    <dir>/step_000123/
        <key>.npy ...      one file per tensor, named by its key
                           (state-dict keys, ``opt.m.<name>``,
                           ``opt.v.<name>``, ``opt.step``)
        manifest.json      keys, shapes, dtypes
        COMMITTED          written last: the step is complete

* ``save`` copies the tensors to the host, then writes them on a background
  thread: the loop is blocked only for the copy. One save is in flight at
  a time.
* A step without ``COMMITTED`` (a preemption mid-write) is ignored by
  ``latest_step`` and ``restore``, so a restart never reads a torn step.
* ``restore`` loads onto any device. The data pipeline resumes from the
  step number alone (``data/pipeline.py``).

The reference keys leaves by their place in a flattened pytree; the port
keys them by name. Tensors must have a numpy dtype (the port's masters are
float32, its step int32).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: dict, blocking: bool = False):
        """Checkpoint ``tree`` (key -> tensor or array) as step ``step``."""
        self.wait()
        # Copies: the loop updates its tensors in place while the writer runs.
        host = {k: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t)).copy() for k, t in tree.items()}
        manifest = {"step": step, "keys": list(host),
                    "shapes": [list(a.shape) for a in host.values()],
                    "dtypes": [str(a.dtype) for a in host.values()]}

        def write():
            path = self._step_dir(step)
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for k, a in host.items():
                np.save(os.path.join(tmp, f"{k}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(path, ignore_errors=True)
            os.rename(tmp, path)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        """Block until the save in flight, if any, has committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_") and not d.endswith(".tmp")
                 and os.path.exists(os.path.join(self.dir, d, "COMMITTED"))]
        return max(steps) if steps else None

    def restore(self, template: dict, step: int | None = None,
                device=None):
        """(tree, step): the tensors of ``template``'s keys (key -> tensor
        or anything with ``.shape``) from ``step`` (default the latest
        committed one), on ``device`` (default the CPU). Raises
        FileNotFoundError without a committed step, ValueError on a shape
        mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self._step_dir(step)
        out = {}
        for k, t in template.items():
            a = np.load(os.path.join(path, f"{k}.npy"))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {k} shape {a.shape} != "
                                 f"template {tuple(t.shape)}")
            out[k] = torch.from_numpy(a).to(device or "cpu")
        return out, step

    # -- internals ------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
