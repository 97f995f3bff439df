"""Convergence smoke tests: the models actually learn.

Trains tiny configs on synthetic blob data and asserts the loss drops and
the prediction recovers the structure — end-to-end evidence that gradients
flow correctly through the pruned spectral chains, virtual concats, and
the optimizer/schedule stack.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation import losses, models
from multimodal_3d_image_segmentation.runtime import (
    build_optimizer, build_schedule, create_train_state, make_train_step)


def _blob_batch(rng, batch=2, shape=(16, 16, 12), n_classes=3):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    xs, ys = [], []
    for _ in range(batch):
        c = [s // 2 + rng.integers(-3, 4) for s in shape]
        r2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        seg = np.zeros(shape, np.int32)
        seg[r2 < 25] = 1
        seg[r2 < 6] = 2
        x = np.stack([seg * 2.0 + rng.standard_normal(shape) * 0.3,
                      -seg + rng.standard_normal(shape) * 0.3])
        xs.append(x.astype(np.float32))
        ys.append(seg[None])
    return jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(ys))


@pytest.mark.parametrize("model", [
    models.HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4)),
    models.HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4), use_deep_supervision=True),
    models.NeuralOperatorSeg(2, 3, 6, 2, (3, 4, 4), "Hartley"),
], ids=["hnosegxs", "hnosegxs-deepsup", "hnoseg"])
def test_model_learns_blobs(model):
    rng = np.random.default_rng(0)
    x, y = _blob_batch(rng)

    schedule = build_schedule(
        {"scheduler_name": "CosineAnnealingWarmRestarts", "eta_min": 1e-3},
        5e-3, steps_per_epoch=1, num_epochs=60)
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 5e-3}, schedule)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    state = create_train_state(model, params, tx)
    step = make_train_step(losses.pcc_loss, num_labels=3)

    first_loss = None
    for i in range(60):
        state, loss = step(state, x, y)
        if first_loss is None:
            first_loss = float(loss)
    final_loss = float(loss)
    assert final_loss < first_loss * 0.5, (first_loss, final_loss)

    probs = model.apply({"params": state.params}, x)
    pred = np.asarray(jnp.argmax(probs, axis=1))
    true = np.asarray(y)[:, 0]
    # Dice on the foreground union
    inter = np.count_nonzero((pred > 0) & (true > 0))
    dice = 2 * inter / (np.count_nonzero(pred > 0)
                        + np.count_nonzero(true > 0))
    assert dice > 0.7, dice


def test_bf16_training_converges():
    """bfloat16 activations (fp32 params/accum) still train."""
    model = models.HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4),
                            compute_dtype="bfloat16")
    rng = np.random.default_rng(1)
    x, y = _blob_batch(rng)
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 5e-3})
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    state = create_train_state(model, params, tx)
    step = make_train_step(losses.pcc_loss, num_labels=3)
    first = None
    for _ in range(40):
        state, loss = step(state, x, y)
        if first is None:
            first = float(loss)
    assert float(loss) < first * 0.6, (first, float(loss))
