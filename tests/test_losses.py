"""Loss parity vs reference (torch) and analytic sanity checks."""
import numpy as np
import jax.numpy as jnp
import pytest

from multimodal_3d_image_segmentation import losses
from tests.reference_oracle import get_reference_nets


def _probs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    return x / x.sum(axis=1, keepdims=True)


def _onehot(shape, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, shape[1], size=(shape[0],) + shape[2:])
    return np.eye(shape[1], dtype=np.float32)[labels].transpose(
        (0, labels.ndim) + tuple(range(1, labels.ndim)))


@pytest.mark.parametrize("shape", [(2, 4, 8, 9, 7), (3, 3, 12, 10)])
def test_losses_match_reference(shape):
    nets, torch = get_reference_nets()
    from nets import custom_losses as ref

    y_pred = _probs(shape, 0)
    y_true = _onehot(shape, 1)
    tp, tt = torch.from_numpy(y_pred), torch.from_numpy(y_true)
    jp, jt = jnp.asarray(y_pred), jnp.asarray(y_true)

    np.testing.assert_allclose(
        float(losses.pcc_loss(jp, jt)), float(ref.PCCLoss()(tp, tt)),
        atol=1e-6)
    np.testing.assert_allclose(
        float(losses.dice_loss(jp, jt)), float(ref.DiceLoss()(tp, tt)),
        atol=1e-6)
    np.testing.assert_allclose(
        float(losses.exp_dice_loss(jp, jt, 0.3)),
        float(ref.ExpDiceLoss(0.3)(tp, tt)), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(losses.corrcoef(jp, jt)),
        ref.corrcoef(tp, tt).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(losses.dice_coef(jp, jt)),
        ref.dice_coef(tp, tt).numpy(), atol=1e-6)


def test_perfect_prediction_limits():
    y = _onehot((2, 3, 6, 6, 6), 2)
    jy = jnp.asarray(y)
    assert float(losses.dice_loss(jy, jy)) < 1e-5
    assert float(losses.pcc_loss(jy, jy)) < 1e-3


def test_loss_registry():
    assert isinstance(losses.get_loss("PCCLoss"), losses.PCCLoss)
    assert isinstance(losses.get_loss("ExpDiceLoss", exp=0.5),
                      losses.ExpDiceLoss)
    with pytest.raises(ValueError):
        losses.get_loss("NopeLoss")


def test_cross_entropy_matches_torch():
    """The CE fallback matches the REFERENCE pipeline's semantics: the
    reference hands the models' softmax probabilities straight to
    torch.nn.CrossEntropyLoss (``experiments/run.py:105-110``), which
    applies log_softmax to them as if they were logits — so parity means
    reproducing that 'double softmax', honoring weight= with torch
    semantics; unsupported args raise instead of silently vanishing."""
    torch = pytest.importorskip("torch")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = rng.integers(0, 3, (2, 4, 5))
    y1h = np.eye(3, dtype=np.float32)[y].transpose(0, 3, 1, 2)
    for w in (None, [0.2, 1.0, 3.0]):
        kw = {} if w is None else {"weight": w}
        ours = float(losses.get_loss("CrossEntropyLoss", **kw)(
            jnp.asarray(probs), jnp.asarray(y1h)))
        ref = torch.nn.CrossEntropyLoss(
            weight=None if w is None else torch.tensor(w))(
            torch.tensor(probs), torch.tensor(y, dtype=torch.long))
        np.testing.assert_allclose(ours, float(ref), atol=1e-5)
    with pytest.raises(ValueError):
        losses.get_loss("CrossEntropyLoss", reduction="sum")
