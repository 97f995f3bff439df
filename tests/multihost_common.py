"""Shared model/step/data definitions for the multi-process test: the
worker processes and the single-process oracle must build bit-identical
computations."""
import numpy as np

GLOBAL_BATCH = 8
SHAPE = (GLOBAL_BATCH, 2, 12, 12, 8)  # (B, C, D, H, W)
NUM_CLASSES = 3


def global_data():
    rng = np.random.default_rng(1234)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES,
                     (GLOBAL_BATCH, 1) + SHAPE[2:]).astype(np.int32)
    return x, y


def build_step():
    """A real (small) model + optimizer + jitted train step."""
    import jax
    import jax.numpy as jnp
    from multimodal_3d_image_segmentation import losses, models
    from multimodal_3d_image_segmentation.runtime import (
        build_optimizer, create_train_state)
    from multimodal_3d_image_segmentation.runtime.steps import (
        make_train_step)

    model = models.HNOSegXS(SHAPE[1], NUM_CLASSES, 4, [1], (3, 3, 3))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1,) + SHAPE[1:]))["params"]
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 1e-2})
    state = create_train_state(model, params, tx)
    step = make_train_step(losses.pcc_loss, NUM_CLASSES, None)
    return state, step
