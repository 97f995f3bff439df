"""Jitted train / eval / predict steps.

The reference's eager per-batch loop (``experiments/train_test.py:140-214``)
becomes three compiled functions; label remap + one-hot happen on device
inside the step so the host only ships raw integer labels.

All steps are pure (state, batch) -> outputs and compose with any
``jax.sharding`` placement: run them under a Mesh with sharded inputs and
XLA inserts the gradient psum (data parallelism) and spatial collectives
(volume sharding) automatically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import optax

from ..utils.labels import remap_labels, to_categorical

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "make_eval_step", "make_predict_step"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Params + optimizer state + step count, as one pytree. ``apply_fn``
    and ``tx`` are static (part of the tree structure, not leaves)."""
    step: Any
    params: Any
    opt_state: Any
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True))

    @classmethod
    def create(cls, *, apply_fn, params, tx) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return dataclasses.replace(
            self, step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state)


jax.tree_util.register_dataclass(TrainState)


def create_train_state(model, params, tx, apply_fn=None) -> TrainState:
    return TrainState.create(apply_fn=apply_fn or model.apply,
                             params=params, tx=tx)


def make_train_step(loss_fn: Callable, num_labels: int,
                    label_mapping: Optional[Dict[int, int]] = None,
                    donate: bool = True,
                    augment_fn: Optional[Callable] = None,
                    augment_seed: int = 0):
    """Build the jitted training step.

    Args:
        loss_fn: (y_pred, y_true_onehot) -> scalar.
        num_labels: number of classes for one-hot.
        label_mapping: optional {old: new} label remap applied on device.
        augment_fn: optional on-device augmentation (key, x, y) -> (x, y)
            (see ``data.augmentation_device.make_device_augment``), applied
            inside the jitted step with a per-step PRNG key.
    """

    def step(state: TrainState, x, y):
        if augment_fn is not None:
            key = jax.random.fold_in(jax.random.PRNGKey(augment_seed),
                                     state.step)
            x, y = augment_fn(key, x.astype(jnp.float32),
                              y.astype(jnp.float32))
        y = remap_labels(y, label_mapping)
        y1h = to_categorical(y, num_labels)

        def compute_loss(params):
            y_pred = state.apply_fn({"params": params}, x)
            return loss_fn(y_pred, y1h)

        loss, grads = jax.value_and_grad(compute_loss)(state.params)
        return state.apply_gradients(grads=grads), loss

    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_eval_step(loss_fn: Callable, num_labels: int,
                   label_mapping: Optional[Dict[int, int]] = None):
    def step(state: TrainState, x, y):
        y = remap_labels(y, label_mapping)
        y1h = to_categorical(y, num_labels)
        y_pred = state.apply_fn({"params": state.params}, x)
        return loss_fn(y_pred, y1h)

    return jax.jit(step)


def make_predict_step(model, apply_fn=None):
    """Forward + argmax to uint8 labels (reference
    ``experiments/train_test.py:395-410``): argmax happens on device so only
    the small label volume crosses back to host. ``apply_fn`` overrides
    ``model.apply``."""
    apply = apply_fn or model.apply

    def step(params, x):
        y_pred = apply({"params": params}, x)
        return jnp.argmax(y_pred, axis=1).astype(jnp.uint8)

    return jax.jit(step)
