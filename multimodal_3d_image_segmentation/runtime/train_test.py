"""Training and testing engine.

Re-design of reference ``experiments/train_test.py:31-426`` with identical
run artifacts and selection semantics:

  * epoch loop with train/valid phases; loss averaged per epoch;
  * the LR schedule advances per *batch* (encoded in the optax schedule);
  * best model = lowest validation loss after ``selection_epoch_portion``
    of the epochs; weights-only export to ``model/model.npz``;
  * checkpoint every ``checkpoint_epoch`` epochs and on each new best;
    resume restores epoch/state/min_loss/best_epoch and truncates
    ``stdout.txt`` back to the last checkpoint line so the log-derived
    loss curves stay consistent;
  * everything printed is teed to ``stdout.txt``; ``plot_loss.pdf`` is
    re-parsed from that log by regex (the log is the metrics database);
  * ``model_summary.txt`` written from ``nn.tabulate`` (one row per module
    call with its output shapes and parameter count);
  * testing: per-volume prediction with warm-up exclusion, argmax on
    device, ``{pid}_true/_pred.nii.gz`` outputs, timing + device memory
    stats to ``prediction_time_memory.txt``.

Steps are jit-compiled once per (shape, dtype); the host loop only ships
numpy batches and reads back scalar losses. With a mesh configured,
batches are sharded over (data, spatial) axes and the state is replicated
— XLA inserts the collectives.

matplotlib is optional: without it ``plot_loss.pdf`` and
``model_graph.pdf`` are not written, and ``stdout.txt`` says so.
"""
from __future__ import annotations

import os
import re
import time
from os.path import join

import numpy as np

import jax
import jax.numpy as jnp

from .. import nn
from ..data.nifti import write_image
from ..parallel.mesh import batch_sharding, replicated, volume_sharding
from ..utils.labels import remap_labels
from ..utils.prefetch import device_prefetch
from .checkpoint import AsyncCheckpointer, load_params
from .steps import (create_train_state, make_eval_step, make_predict_step,
                    make_train_step)

__all__ = ["training", "testing", "plot_losses", "get_losses_from_file",
           "save_model_summary", "save_model_graph", "save_output"]


class _Tee:
    """Print to stdout (optionally) and append to stdout.txt — the
    reference's print-and-tee pattern
    (``experiments/train_test.py:177-184``)."""

    def __init__(self, path, is_print=True):
        self.path = path
        self.is_print = is_print

    def __call__(self, *args, file_only=False, **kwargs):
        if self.is_print and not file_only:
            print(*args, **kwargs)
        with open(self.path, "a") as f:
            print(*args, file=f, **kwargs)


def _pyplot():
    """matplotlib's pyplot with a file backend, or None if not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    if "DISPLAY" not in os.environ:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_model_summary(model, input_shape, path=None):
    """Write a layer table via nn.tabulate (analog of torchinfo summary,
    reference ``experiments/utils.py:122-134``)."""
    txt, _ = nn.tabulate(model, jnp.zeros(input_shape, jnp.float32))
    if path is not None:
        with open(path, "w") as f:
            f.write(txt)
    return txt


def save_model_graph(model, input_shape, path):
    """Render the architecture as a call-graph PDF (``model_graph.pdf``).

    Analog of the reference's torchview rendering
    (``experiments/train_test.py:117-122``): one box per module call in
    execution order, indented by module-tree depth, annotated with output
    shapes and parameter counts; edges follow the execution order. The
    trace is shape-only (``eval_shape`` under the hood) — nothing runs on
    device. Returns False (and writes nothing) without matplotlib.
    """
    plt = _pyplot()
    if plt is None:
        return False
    _, rows = nn.tabulate(model, jnp.zeros(input_shape, jnp.float32))
    n = len(rows)
    box_h, gap = 0.7, 0.35
    fig_h = max(2.0, n * (box_h + gap) + 1.0)
    fig, ax = plt.subplots(figsize=(11, fig_h))
    ax.set_axis_off()
    depth_colors = ["#4c72b0", "#55a868", "#c44e52", "#8172b2", "#ccb974",
                    "#64b5cd"]
    centers = []
    for i, (mpath, type_name, shapes, n_params) in enumerate(rows):
        depth = len(mpath)
        y = -i * (box_h + gap)
        x = 0.5 * depth
        label = ".".join(mpath) if mpath else model.__class__.__name__
        shape_txt = ", ".join(str(s) for s in shapes) or "-"
        text = f"{label}  [{type_name}]\nout: {shape_txt}"
        if n_params:
            text += f"   params: {n_params:,}"
        color = depth_colors[depth % len(depth_colors)]
        ax.text(x, y, text, fontsize=8, family="monospace",
                verticalalignment="center",
                bbox=dict(boxstyle="round,pad=0.35", facecolor="white",
                          edgecolor=color, linewidth=1.4))
        centers.append((x, y))
    for (x0, y0), (x1, y1) in zip(centers, centers[1:]):
        ax.annotate("", xy=(x1, y1 + box_h / 2), xytext=(x0, y0 - box_h / 2),
                    arrowprops=dict(arrowstyle="->", color="#888888",
                                    shrinkA=2, shrinkB=2))
    ax.set_xlim(-0.5, 10.5)
    ax.set_ylim(-n * (box_h + gap) - 0.5, box_h)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True


def save_output(y, data_lists_test, idx_sample, output_dir,
                output_origin=None, suffix=""):
    """Save a label map as ``{pid}{suffix}.nii.gz`` with the patient ID
    taken from the parent folder name (reference
    ``experiments/utils.py:234-257``)."""
    y = np.asarray(y, dtype=np.uint8)
    fname = data_lists_test[0][idx_sample]
    pid = fname.split("/")[-2]
    out = os.path.join(output_dir, f"{pid}{suffix}.nii.gz")
    write_image(y, out, origin=output_origin)


def training(model, input_data, output_dir, loss_fn, tx,
             label_mapping=None, num_epochs=100,
             selection_epoch_portion=0.8, checkpoint_epoch=10,
             is_plot_model=False, is_print=True, plot_epoch_portion=None,
             mesh=None, seed=0, params=None, augment_fn=None,
             augment_seed=None):
    """Train a model; returns the final (best-on-valid) params.

    Args mirror the reference ``training``
    (``experiments/train_test.py:31-68``); ``tx`` is the optax optimizer
    (schedule already bound), ``mesh`` optionally distributes the step.
    """
    model_dir = join(output_dir, "model")
    model_path = join(model_dir, "model.npz")
    chkpt_path = join(model_dir, "checkpoint.npz")
    stdout_file = join(output_dir, "stdout.txt")
    os.makedirs(model_dir, exist_ok=True)
    tee = _Tee(stdout_file, is_print)

    num_labels = model.out_channels
    image_size = input_data.get_train_image_size()
    input_shape = (input_data.batch_size, model.in_channels) + tuple(
        image_size)

    if params is None:
        params = model.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1,) + input_shape[1:]))["params"]

    state = create_train_state(model, params, tx)

    if mesh is not None:
        state = jax.device_put(state, replicated(mesh))

    # the on-device augmentation stream is keyed by its own seed when the
    # config provides one, so it can be varied/reproduced independently
    # of weight init
    train_step = make_train_step(
        loss_fn, num_labels, label_mapping, augment_fn=augment_fn,
        augment_seed=seed if augment_seed is None else augment_seed)
    eval_step = make_eval_step(loss_fn, num_labels, label_mapping)

    # async saves: train loop never blocks on IO
    ckpt = AsyncCheckpointer()

    if ckpt.exists(chkpt_path):
        state, epoch, min_loss, best_epoch = ckpt.load(chkpt_path, state)
        start_epoch = epoch + 1
        if start_epoch >= num_epochs:
            raise RuntimeError(
                f"Checkpoint detected, but start_epoch ({start_epoch}) >= "
                f"num_epochs ({num_epochs})")
        if is_print:
            print(f"Checkpoint loaded for epoch {start_epoch}")
        # Truncate stdout.txt after the checkpoint marker of the epoch
        # actually restored so the regex-parsed loss curves stay
        # consistent (reference ``experiments/train_test.py:90-100``).
        # Saves are asynchronous, so the log's LAST marker can belong to
        # a write that never committed (crash between tee and the
        # background os.replace) — match the marker to the restored
        # epoch, falling back to the last marker.
        if os.path.exists(stdout_file):
            with open(stdout_file) as f:
                lines = f.readlines()
            cur = None
            idx = last_any = None
            for i, ln in enumerate(lines):
                m = re.match(r"Epoch:\s*(\d+)", ln.strip())
                if m:
                    cur = int(m.group(1))
                if "checkpoint" in ln:
                    last_any = i
                    if cur == epoch:
                        idx = i
            if idx is None:
                idx = last_any
            if idx is not None:
                with open(stdout_file, "w") as f:
                    f.writelines(lines[:idx + 1])
    else:
        start_epoch = 0
        min_loss = float("inf")
        best_epoch = None

        tee("train_num_batches:", input_data.get_train_num_batches())
        tee("valid_num_batches:", input_data.get_valid_num_batches())
        tee()
        save_model_summary(model, (1,) + input_shape[1:],
                           join(output_dir, "model_summary.txt"))
        if is_plot_model and not save_model_graph(
                model, (1,) + input_shape[1:],
                join(output_dir, "model_graph.pdf")):
            tee("model_graph.pdf not written: matplotlib is not installed")

    train_flow = input_data.get_train_flow(shuffle=True)
    valid_flow = input_data.get_valid_flow()

    def put(x, y):
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y)
        if mesh is not None:
            x = jax.device_put(x, batch_sharding(mesh, x.shape))
            y = jax.device_put(y, batch_sharding(mesh, y.shape))
        return x, y

    if is_print:
        print("Training started")
        print(output_dir)

    start_time = time.time()

    for epoch in range(start_epoch, num_epochs):
        # Training phase: double-buffered host->device feeding (the next
        # batch ships to the device while the current step executes)
        train_losses = []
        for x, y in device_prefetch(train_flow, lambda b: put(*b)):
            state, loss = train_step(state, x, y)
            train_losses.append(loss)
        train_loss = float(np.mean([float(l) for l in train_losses]))
        tee("\n-------------------------")
        tee(f"Epoch: {epoch}")
        tee(f"train_loss: {train_loss}")

        # Validation phase
        valid_losses = []
        for x, y in device_prefetch(valid_flow, lambda b: put(*b)):
            valid_losses.append(eval_step(state, x, y))
        valid_loss = float(np.mean([float(l) for l in valid_losses]))
        tee(f"valid_loss: {valid_loss}")

        # best-model selection BEFORE the periodic checkpoint save, so a
        # checkpoint written at an epoch that is also a new best carries
        # the updated min_loss/best_epoch (stale metadata would make a
        # resumed run re-select a worse 'best' and overwrite the export)
        selection_epoch = int(num_epochs * selection_epoch_portion)
        is_best = ((epoch > selection_epoch or epoch == num_epochs - 1)
                   and valid_loss < min_loss)
        if is_best:
            min_loss = valid_loss
            best_epoch = epoch
            ckpt.save_params(model_path, state.params)

        if (epoch + 1) % checkpoint_epoch == 0:
            ckpt.save(chkpt_path, state, epoch, min_loss, best_epoch)
            tee("Standard checkpoint saved.")
        elif is_best:
            ckpt.save(chkpt_path, state, epoch, min_loss, best_epoch)
            tee("Best checkpoint saved.")

    end_time = time.time()
    ckpt.wait()

    if best_epoch is not None:
        params = load_params(model_path, state.params)
    else:  # no training (num_epochs == 0) or no finite valid loss
        params = state.params
        ckpt.save_params(model_path, params)
    ckpt.close()

    # Plot losses from the log
    start_plot_epoch = (int(num_epochs * plot_epoch_portion)
                        if plot_epoch_portion is not None else 0)
    losses = get_losses_from_file(stdout_file)
    if not plot_losses(num_epochs, start_plot_epoch, losses, ["r", "b--"],
                       ["Train loss", "Valid loss"],
                       join(output_dir, "plot_loss.pdf")):
        tee("plot_loss.pdf not written: matplotlib is not installed")

    tee(f"\nTime used: {end_time - start_time:.2f} seconds.")
    tee(f"Best epoch: {best_epoch}")
    tee(f"Min loss: {min_loss}")

    if hasattr(train_flow, "close"):
        train_flow.close()
    if hasattr(valid_flow, "close"):
        valid_flow.close()

    return params


#: Scalar-series patterns recoverable from a training log. Extend this dict
#: to make additional per-epoch scalars plottable.
LOG_SERIES = {
    "train_loss": re.compile(r"\btrain_loss:\s*(\S+)"),
    "valid_loss": re.compile(r"\bvalid_loss:\s*(\S+)"),
}


def get_losses_from_file(filename):
    """Recover the per-epoch loss series from a ``stdout.txt`` training log.

    The log is the source of truth for the loss curves (same contract as
    reference ``experiments/train_test.py``: the plot is reconstructed from
    the log, so a resumed run's truncated log yields a consistent plot).
    Returns ``(train_loss, valid_loss)`` lists of equal length.
    """
    series = {name: [] for name in LOG_SERIES}
    with open(filename) as f:
        for line in f:
            for name, pattern in LOG_SERIES.items():
                m = pattern.search(line)
                if m:
                    series[name].append(float(m.group(1)))
    train_loss, valid_loss = series["train_loss"], series["valid_loss"]
    if len(train_loss) != len(valid_loss):
        raise ValueError(
            f"unbalanced loss log: {len(train_loss)} train_loss vs "
            f"{len(valid_loss)} valid_loss entries in {filename}")
    return train_loss, valid_loss


def plot_losses(num_epochs, start_plot_epoch, losses, styles, labels,
                output_file):
    """Write the loss-curve figure (``plot_loss.pdf`` artifact).

    Same artifact role as the reference's loss plot; rendering is our own.
    ``losses`` is a sequence of per-epoch series; epochs before
    ``start_plot_epoch`` are omitted (early epochs dominate the y-range).
    Returns False (and writes nothing) without matplotlib.
    """
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(10, 5))
    epochs = np.arange(num_epochs)
    for series, style, label in zip(losses, styles, labels):
        y = np.asarray(series)[start_plot_epoch:num_epochs]
        ax.plot(epochs[start_plot_epoch:start_plot_epoch + len(y)], y,
                style, label=label)
    ax.set_xlabel("Epoch", fontsize=16)
    ax.set_ylabel("Value", fontsize=16)
    ax.tick_params(labelsize=14)
    ax.grid(True, which="both", alpha=0.5)
    ax.legend(loc="upper right", fontsize=14)
    fig.savefig(output_file, bbox_inches="tight")
    plt.close(fig)
    return True


def _device_memory_stats():
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0)
        in_use = stats.get("bytes_in_use", 0)
        return peak / 1024 ** 2, in_use / 1024 ** 2
    except Exception:
        return float("nan"), float("nan")


def testing(model, params, input_data, output_dir, label_mapping=None,
            output_origin=None, is_print=True, mesh=None, save_npz=False):
    """Per-volume prediction on the test split
    (reference ``experiments/train_test.py:332-426``). ``save_npz``
    additionally writes a bulk ``y_true_pred.npz`` (TF-tree parity,
    ``tensorflow/experiments/train_test.py:292``)."""
    assert input_data.batch_size == 1, (
        "testing() follows the reference's per-volume protocol "
        "(experiments/train_test.py:384-414): set [input_args] "
        "batch_size = 1 for test/statistics runs")
    os.makedirs(output_dir, exist_ok=True)
    npz_true, npz_pred = [], []

    test_num_batches = input_data.get_test_num_batches()
    data_lists_test = input_data.data_lists_test

    if is_print:
        print("test_num_batches:", test_num_batches)
        print()
        print("Testing started")
        print(output_dir)

    predict_step = make_predict_step(model)
    if mesh is not None:
        params = jax.device_put(params, replicated(mesh))

    test_flow = input_data.get_test_flow()
    start_time = time.time()
    predict_times = []

    for i, xy in enumerate(test_flow):
        s_time = time.time()
        y_true = None
        if isinstance(xy, (tuple, list)):
            x, y = xy
            y_true = np.asarray(y, dtype=np.uint8)[0, 0]
        else:
            x = xy
        x = jnp.asarray(x, jnp.float32)
        if mesh is not None:
            x = jax.device_put(x, volume_sharding(mesh, x.shape))

        y_pred = np.asarray(predict_step(params, x))  # readback = completion
        e_time = time.time()

        if y_true is not None:
            save_output(y_true, data_lists_test, i,
                        os.path.join(output_dir, "images"), output_origin,
                        "_true")
        y_pred = y_pred[0]
        if label_mapping is not None:
            y_pred = remap_labels(y_pred, label_mapping)
        save_output(y_pred, data_lists_test, i,
                    os.path.join(output_dir, "images"), output_origin,
                    "_pred")
        if save_npz:
            npz_true.append(y_true)
            npz_pred.append(y_pred)

        if i != 0:  # first iteration includes compilation
            predict_times.append(e_time - s_time)

    end_time = time.time()

    if save_npz:
        arrays = {"y_pred": np.stack(npz_pred)}
        if all(t is not None for t in npz_true):
            arrays["y_true"] = np.stack(npz_true)
        # unlabeled test sets have no y_true; stacking Nones would build
        # a corrupt object array
        np.savez_compressed(os.path.join(output_dir, "y_true_pred.npz"),
                            **arrays)
    peak_mib, in_use_mib = _device_memory_stats()
    avg_time = float(np.mean(predict_times)) if predict_times else float("nan")

    if is_print:
        print(f"\nTime used: {end_time - start_time:.2f} seconds.")
        print(f"Average prediction time: {avg_time}")
        print(f"peak_device_memory: {peak_mib:.2f} MiB")
        print(f"device_memory_in_use: {in_use_mib:.2f} MiB")
    with open(os.path.join(output_dir, "prediction_time_memory.txt"),
              "w") as f:
        print(f"Average prediction time: {avg_time}", file=f)
        print(f"peak_device_memory: {peak_mib:.2f} MiB", file=f)
        print(f"device_memory_in_use: {in_use_mib:.2f} MiB", file=f)

    if hasattr(test_flow, "close"):
        test_flow.close()
