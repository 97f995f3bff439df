"""Checkpoint / resume.

The reference saves a dict checkpoint {epoch, model, optimizer, scheduler,
min_loss, best_epoch} every N epochs and on each new best, plus a
weights-only ``model/model.pt`` for inference
(``experiments/train_test.py:262-286``). Here:

  * ``checkpoint.npz`` — full train state (params + optimizer state +
    step) + scalar metadata;
  * ``model.npz``      — weights-only export for inference.

Both are plain numpy ``.npz`` archives with one array per leaf, keyed by
the leaf's path in its tree (``params/layers_0/op/weight``,
``opt_state/0/mu/conv1/conv/kernel``, ``meta/epoch``). Loading needs a
template of the same structure (a freshly built state or param tree); a
missing key or a shape mismatch raises.

Schedules are pure functions of the step count, so restoring the step
restores the learning-rate schedule exactly (the reference must serialize
its stateful torch scheduler instead).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "save_params",
           "load_params", "AsyncCheckpointer", "tree_to_arrays",
           "tree_from_arrays"]


def _key_str(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _path_str(path) -> str:
    return "/".join(_key_str(k) for k in path)


def tree_to_arrays(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a pytree into ``{path: numpy array}``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + _path_str(path)] = np.asarray(leaf)
    return out


def tree_from_arrays(template, arrays, prefix: str = ""):
    """Rebuild ``template``'s structure from ``{path: array}``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    new = []
    for path, leaf in leaves:
        key = prefix + _path_str(path)
        if key not in arrays:
            raise KeyError(f"checkpoint has no entry {key!r}")
        value = np.asarray(arrays[key])
        if tuple(value.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key!r}: checkpoint shape {value.shape} != "
                             f"template shape {tuple(np.shape(leaf))}")
        new.append(value.astype(leaf.dtype) if hasattr(leaf, "dtype")
                   else value)
    return jax.tree_util.tree_unflatten(treedef, new)


def _write_npz(path, arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never corrupts the checkpoint


def _read_npz(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_checkpoint(path, state, epoch: int, min_loss: float,
                    best_epoch: Optional[int]) -> None:
    arrays = tree_to_arrays(state.params, "params/")
    arrays.update(tree_to_arrays(state.opt_state, "opt_state/"))
    arrays["step"] = np.asarray(state.step)
    arrays["meta/epoch"] = np.asarray(int(epoch))
    arrays["meta/min_loss"] = np.asarray(float(min_loss))
    arrays["meta/best_epoch"] = np.asarray(
        -1 if best_epoch is None else int(best_epoch))
    _write_npz(path, arrays)


def load_checkpoint(path, state):
    """Restore (state, epoch, min_loss, best_epoch) from a checkpoint,
    using ``state`` as the structure template."""
    arrays = _read_npz(path)
    state = state.__class__(
        step=np.asarray(arrays["step"]).astype(np.int32),
        params=tree_from_arrays(state.params, arrays, "params/"),
        opt_state=tree_from_arrays(state.opt_state, arrays, "opt_state/"),
        apply_fn=state.apply_fn, tx=state.tx)
    best_epoch = int(arrays["meta/best_epoch"])
    return (state, int(arrays["meta/epoch"]),
            float(arrays["meta/min_loss"]),
            None if best_epoch < 0 else best_epoch)


def save_params(path, params) -> None:
    _write_npz(path, tree_to_arrays(params))


def load_params(path, params_template):
    """Load a weights-only export into ``params_template``'s structure."""
    return tree_from_arrays(params_template, _read_npz(path))


class AsyncCheckpointer:
    """Asynchronous checkpoint writer: the device->host snapshot happens
    synchronously (cheap), serialization + disk IO run in a background
    thread so the train loop never blocks on storage. At most one write is
    in flight; a new save waits for the previous one (ordering preserved,
    and the atomic replace means a crash mid-write never corrupts the
    previous checkpoint)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, fn, *args):
        try:
            fn(*args)
        except BaseException as e:  # surfaced by the next wait()/close()
            self._error = e

    def _start(self, fn, *args) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(fn,) + args,
                                        daemon=True)
        self._thread.start()

    def save(self, path, state, epoch: int, min_loss: float,
             best_epoch: Optional[int]) -> None:
        host_state = jax.tree_util.tree_map(np.asarray, state)
        self._start(save_checkpoint, path, host_state, epoch, min_loss,
                    best_epoch)

    def save_params(self, path, params) -> None:
        self._start(save_params, path,
                    jax.tree_util.tree_map(np.asarray, params))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            # a silently dropped checkpoint/best-model write would report
            # success while losing data — fail the run instead
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def load(self, path, state):
        return load_checkpoint(path, state)

    def exists(self, path) -> bool:
        return os.path.exists(path)

    def close(self) -> None:
        self.wait()
