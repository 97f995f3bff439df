"""Checkpoint migration: import reference (PyTorch) weights into this
framework's parameter trees.

Users of the reference repo can load a trained ``model.pt`` state dict and
run it here unchanged — layer semantics are identical, so imported weights
reproduce reference outputs to float tolerance (verified by the golden
parity tests in ``tests/test_model_parity.py``).

Layout conversions:
  * conv kernels: torch (O, I, *k)            -> ours (*k, I, O)
  * transposed conv kernels: torch (I, O, *k) -> ours (*k, I, O)
  * spectral operator weights: identical layout (O, I, *modes)
  * biases: broadcast shapes (1, O, 1, ...)   -> ours (O,)
  * GroupNorm: weight/bias                    -> scale/bias
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import jax.numpy as jnp
import numpy as np

__all__ = ["import_reference_state_dict", "export_reference_state_dict"]


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, *k) -> (*k, I, O)."""
    nd = w.ndim
    return np.ascontiguousarray(w.transpose(tuple(range(2, nd)) + (1, 0)))


def _conv_transpose_kernel(w: np.ndarray) -> np.ndarray:
    """(I, O, *k) -> (*k, I, O)."""
    nd = w.ndim
    return np.ascontiguousarray(w.transpose(tuple(range(2, nd)) + (0, 1)))


def _translate_segment(seg: str, model=None) -> str:
    """Translate one of our module names to the reference's dotted
    path fragment."""
    m = re.fullmatch(r"layers_(\d+)", seg)
    if m:
        return f"layers.{m.group(1)}"
    m = re.fullmatch(r"conv_blocks_(\d+)", seg)
    if m:
        return f"conv_blocks.{m.group(1)}"
    m = re.fullmatch(r"encode_(\d+)_conv_(\d+)", seg)
    if m:
        return f"encode_layers.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"encode_(\d+)_residual", seg)
    if m:
        i = int(m.group(1))
        return f"encode_layers.{i}.{model.num_blocks[i]}"
    m = re.fullmatch(r"encode_(\d+)_down", seg)
    if m:
        i = int(m.group(1))
        idx = model.num_blocks[i] + (1 if model.use_residual else 0)
        return f"encode_layers.{i}.{idx}"
    m = re.fullmatch(r"decode_(\d+)_up", seg)
    if m:
        return f"decode_layers.{m.group(1)}.0"
    m = re.fullmatch(r"decode_(\d+)_conv_(\d+)", seg)
    if m:
        return f"decode_layers.{m.group(1)}.{int(m.group(2)) + 1}"
    m = re.fullmatch(r"decode_(\d+)_residual", seg)
    if m:
        i = int(m.group(1))
        return f"decode_layers.{i}.{model.num_blocks[i] + 1}"
    return seg


def _ref_key(path, model):
    """Map our param path (tuple of str) to the reference state-dict key."""
    segs = [_translate_segment(s, model) for s in path[:-1]]
    leaf = path[-1]

    # ConvNormAct wraps its conv under 'conv' and norm under 'norm';
    # the reference wraps them under 'op' and 'normalization'.
    segs = ["op" if s == "conv" else s for s in segs]
    segs = ["normalization" if s == "norm" else s for s in segs]

    if leaf == "kernel":
        return ".".join(segs + ["weight"])
    if leaf == "scale":  # GroupNorm
        return ".".join(segs + ["weight"])
    # weight / weight_real / weight_imag / weight_query / ... / bias*
    return ".".join(segs + [leaf])


def import_reference_state_dict(model, params: Mapping[str, Any],
                                state_dict: Mapping[str, np.ndarray]
                                ) -> Dict[str, Any]:
    """Fill our param tree with reference weights.

    Args:
        model: the model instance (used for index arithmetic on VNetDS).
        params: our initialized param tree (template for structure/shapes).
        state_dict: reference state dict as numpy arrays
            (e.g. ``{k: v.numpy() for k, v in torch_model.state_dict().items()}``).

    Returns:
        A new param tree with imported values.
    """
    sd = dict(state_dict)
    used = set()

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, Mapping):
                out[k] = walk(v, p)
                continue
            key = _ref_key(p, model)
            if key not in sd:
                raise KeyError(
                    f"reference state dict is missing {key!r} "
                    f"(for our param {'/'.join(p)})")
            w = np.asarray(sd[key])
            used.add(key)
            leaf = p[-1]
            if leaf == "kernel":
                tf = (_conv_transpose_kernel
                      if any(s.endswith("_up") for s in p) else _conv_kernel)
                w = tf(w)
            elif leaf == "bias" and w.ndim > 1:
                w = w.reshape(-1)
            elif leaf.startswith("bias_") and w.ndim > 2:
                # MHA biases (1, Z, K, 1, ...) -> (Z, K); bias_out -> (O,)
                w = w.reshape(v.shape)
            if tuple(w.shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch for {key!r}: reference {w.shape} vs "
                    f"ours {v.shape}")
            out[k] = jnp.asarray(w, dtype=v.dtype)
        return out

    new_params = walk(params, ())
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unused reference parameters: {sorted(unused)}")
    return new_params


def export_reference_state_dict(model, params: Mapping[str, Any]
                                ) -> Dict[str, np.ndarray]:
    """Inverse of `import_reference_state_dict`: convert our param tree to
    a reference-layout state dict (numpy), loadable into the PyTorch
    reference via ``ref_model.load_state_dict({k: torch.from_numpy(v)})``.
    Bias leaves are reshaped to the reference's broadcast shapes —
    ``load_state_dict`` shape-checks strictly, so (O,) would be rejected
    where the reference stores (1, O, 1, ..., 1). Enables moving weights
    trained here back to the reference ecosystem.
    """
    out: Dict[str, np.ndarray] = {}
    # spatial broadcast dims; bare op modules carry no ndim field (3D
    # assumed — models always set it)
    sp1 = (1,) * (getattr(model, "ndim", 5) - 2)

    def walk(tree, path):
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, Mapping):
                walk(v, p)
                continue
            key = _ref_key(p, model)
            w = np.asarray(v)
            leaf = p[-1]
            if leaf == "kernel":
                nd = w.ndim
                if any(s.endswith("_up") for s in p):
                    # (*k, I, O) -> torch transposed-conv (I, O, *k)
                    w = np.ascontiguousarray(
                        w.transpose((nd - 2, nd - 1) + tuple(range(nd - 2))))
                else:
                    # (*k, I, O) -> torch conv (O, I, *k)
                    w = np.ascontiguousarray(
                        w.transpose((nd - 1, nd - 2) + tuple(range(nd - 2))))
            elif leaf == "bias" and "kernel" not in tree:
                # spectral-operator bias: the reference Parameter is
                # (1, O) + (1,)*(ndim-2) (``nets/fourier_operator.py:79``,
                # ``nets/hartley_operator.py:79``); conv biases (sibling
                # 'kernel') stay (O,) like torch's
                w = w.reshape((1, -1) + sp1)
            elif leaf.startswith("bias_"):
                # MHA biases: (1, Z, K) + (1,)*(ndim-2) for q/k/v,
                # (1, O) + (1,)*(ndim-2) for bias_out
                # (``nets/hartley_mha.py:102-109``)
                w = w.reshape((1,) + w.shape + sp1)
            if key in out:
                raise ValueError(f"duplicate reference key {key!r}")
            out[key] = w

    walk(params, ())
    return out
