"""Checkpoints and resume (ref: core/checkpoints.py).

``CheckpointManager(train_dir, keep)`` saves the whole train state into
``<train_dir>/checkpoints/<step>/``, the directory the JAX package's
manager uses, and the train, eval and inference CLIs read it back.  The
format needs neither orbax nor torch to read (:meth:`CheckpointManager.load_arrays`
uses numpy alone): one ``.npy`` per leaf and a
``manifest.json`` listing each leaf's name, file, shape and dtype.  A bf16
leaf is stored as its uint16 bits with ``"bfloat16"`` in the manifest
(numpy has no bf16).  Leaves are named by their path in the JAX package's
``state_to_tree(state)``: ``step``, ``params/<flax path>``,
``batch_stats/<flax path>`` and ``opt_state/<optax path>``
(``core/optimizers.py``), so the two packages' states compare leaf by leaf.

- A save is written into a temporary directory ``<step>.tmp-…`` beside the
  steps and renamed to ``<step>`` once complete, so :meth:`latest_step`
  never sees a half-written step: a process killed mid-save leaves the
  previous checkpoint the latest.  The next save removes such leftovers.
- ``keep`` follows ``--keep_checkpoint_max``: None or 0 keeps every step,
  N the newest N.
- A checkpoint of ``--bf16_params`` holds bf16 parameters and the f32
  master, one of ``--fused_adam`` bf16 parameters, m and ν; the eval and
  inference CLIs read their parameters widened to f32 (exact).
- :meth:`restore` puts every tensor on the caller's device and, given the
  live state, checks the leaf names, shapes and dtypes against it; a
  mismatch raises and names the leaf.

The eval and inference CLIs also take a weights-only ``variables.npz``
(``core/weights.py#save_variables_npz``) at step 0 when ``--train_dir``
names such a file, or a directory without ``checkpoints/``
(:func:`latest_weights_step`, :func:`load_weights`).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from learnablepoolingmethods_torch.core.weights import (
    NPZ_NAME,
    bf16_bits_to_f32,
    load_variables_npz,
    unflatten_tree,
)

log = logging.getLogger(__name__)

MANIFEST = "manifest.json"
_TMP = re.compile(r"^\d+\.tmp-")


def dtype_name(value) -> str:
    """``"float32"``, ``"bfloat16"``, … of a torch tensor or numpy array."""
    return str(value.dtype).replace("torch.", "")


def to_numpy(value) -> np.ndarray:
    """A tensor or array as the numpy array stored for it, on the host: a
    bf16 tensor as its uint16 bits."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).cpu().numpy().view(np.uint16)
        return value.cpu().numpy()
    return np.asarray(value)


def to_tensor(arr: np.ndarray, dtype: str, device=None) -> torch.Tensor:
    """The torch tensor of a stored leaf (bf16 from its 16-bit pattern), on
    ``device``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device) if device is not None else t


def check_against(tree: Mapping[str, object], like: Mapping[str, object]) -> None:
    """Raise ValueError naming the first leaf where ``tree`` (name → tensor
    or array, or name → (shape, dtype)) differs from ``like`` in its names,
    shapes or dtypes."""
    missing = sorted(set(like) - set(tree))
    extra = sorted(set(tree) - set(like))
    if missing or extra:
        raise ValueError(f"checkpoint leaves differ from the live state: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}")
    for name, want in like.items():
        got = tree[name]
        got_sd = got if isinstance(got, tuple) else (tuple(got.shape), dtype_name(got))
        want_sd = (tuple(want.shape), dtype_name(want))
        if (tuple(got_sd[0]), got_sd[1]) != want_sd:
            raise ValueError(f"checkpoint leaf {name}: shape {tuple(got_sd[0])} {got_sd[1]}, "
                             f"the live state has {want_sd[0]} {want_sd[1]}")


class CheckpointManager:
    """Step-numbered checkpoints under ``<train_dir>/checkpoints`` (module
    docstring)."""

    def __init__(self, train_dir: str, keep: Optional[int] = None):
        self.directory = os.path.join(os.path.abspath(train_dir), "checkpoints")
        self.keep = keep if keep else None

    def all_steps(self) -> List[int]:
        """The complete steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, MANIFEST)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Mapping[str, object]) -> bool:
        """Write ``tree`` (name → tensor or array) as step ``step``; False
        (and nothing written) if that step exists already."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            if not os.path.isfile(os.path.join(final, MANIFEST)):  # e.g. the JAX package's orbax step
                raise ValueError(f"{final} holds a checkpoint of another format; use another train_dir")
            log.info("checkpoint at step %d exists; not saved again", step)
            return False
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):  # left by a save that was killed
            if _TMP.match(name):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix=f"{step}.tmp-", dir=self.directory)
        leaves = []
        for i, (name, value) in enumerate(tree.items()):
            arr = to_numpy(value)
            file = f"{i:05d}.npy"
            np.save(os.path.join(tmp, file), arr, allow_pickle=False)
            leaves.append({"name": name, "file": file, "shape": list(arr.shape), "dtype": dtype_name(value)})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": int(step), "leaves": leaves}, f)
        os.rename(tmp, final)
        if self.keep:
            for old in self.all_steps()[:-self.keep]:
                doomed = os.path.join(self.directory, f"{old}.tmp-removed")
                os.rename(os.path.join(self.directory, str(old)), doomed)
                shutil.rmtree(doomed)
        return True

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, str(step), MANIFEST)) as f:
            return json.load(f)

    def load_arrays(self, step: int, prefixes: Tuple[str, ...] = ()) -> Dict[str, Tuple[np.ndarray, str]]:
        """name → (stored array, dtype) of step ``step``, needing only
        numpy; with ``prefixes`` only the leaves whose names start with one."""
        out = {}
        for leaf in self.manifest(step)["leaves"]:
            if prefixes and not leaf["name"].startswith(prefixes):
                continue
            arr = np.load(os.path.join(self.directory, str(step), leaf["file"]), allow_pickle=False)
            out[leaf["name"]] = (arr, leaf["dtype"])
        return out

    def restore(self, step: int, like: Optional[Mapping[str, object]] = None, device=None):
        """name → tensor of step ``step``.  With ``like`` (the live state,
        name → tensor) the names, shapes and dtypes must match it and each
        tensor goes to its live counterpart's device; else to ``device``."""
        if like is not None:
            check_against({leaf["name"]: (tuple(leaf["shape"]), leaf["dtype"])
                           for leaf in self.manifest(step)["leaves"]}, like)
        out = {}
        for name, (arr, dtype) in self.load_arrays(step).items():
            out[name] = to_tensor(arr, dtype, like[name].device if like is not None else device)
        return out

    def restore_latest(self, like=None, device=None):
        """(step, tree) of the latest step, or None."""
        step = self.latest_step()
        return None if step is None else (step, self.restore(step, like, device))

    def variables(self, step: int) -> dict:
        """The flax ``{params, batch_stats}`` tree of step ``step`` as nested
        dicts of numpy arrays (what the eval and inference CLIs read); bf16
        leaves widened to f32, which is exact."""
        arrays = self.load_arrays(step, ("params/", "batch_stats/"))
        tree = unflatten_tree({name: bf16_bits_to_f32(arr) if dtype == "bfloat16" else arr
                               for name, (arr, dtype) in arrays.items()})
        return {"params": tree.get("params", {}), "batch_stats": tree.get("batch_stats", {})}


def latest_weights_step(train_dir: str) -> Optional[int]:
    """The step of the weights ``--train_dir`` holds: a ``variables.npz``
    file, or a directory without ``checkpoints/`` that holds one, is step 0;
    a directory with ``checkpoints/`` its latest complete step; None while
    there is nothing to read."""
    if os.path.isfile(train_dir):
        return 0
    mngr = CheckpointManager(train_dir)
    if os.path.isdir(mngr.directory):
        return mngr.latest_step()
    return 0 if os.path.isfile(os.path.join(train_dir, NPZ_NAME)) else None


def load_weights(train_dir: str, step: int) -> dict:
    """The flax ``{params, batch_stats}`` tree of :func:`latest_weights_step`'s
    source at ``step``."""
    mngr = CheckpointManager(train_dir)
    if os.path.isfile(train_dir) or not os.path.isdir(mngr.directory):
        return load_variables_npz(train_dir)
    return mngr.variables(step)
