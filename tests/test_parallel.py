"""Distributed tests on the virtual 8-device CPU mesh: sharded train steps
and the distributed spectral transform must match single-device numerics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_3d_image_segmentation import models, losses
from multimodal_3d_image_segmentation.parallel import (
    batch_sharding, make_mesh, replicated, volume_sharding)
from multimodal_3d_image_segmentation.runtime import (
    build_optimizer, create_train_state, make_train_step)
from multimodal_3d_image_segmentation.ops import spectral


def _model_and_data(batch=4):
    model = models.HNOSegXS(2, 3, 8, [2, 2], (3, 4, 4))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 2, 16, 16, 12)).astype(np.float32)
    y = rng.integers(0, 3, size=(batch, 1, 16, 16, 12)).astype(np.int32)
    return model, jnp.asarray(x), jnp.asarray(y)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_distributed_dht_matches_single_device():
    """Spatially sharded pruned DHT == unsharded (XLA inserts the
    collectives for the sharded contraction)."""
    mesh = make_mesh(n_data=1, n_spatial=8)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((1, 24, 16, 8, 3)).astype(np.float32))

    f = jax.jit(lambda v: spectral.dht_pad_inverse(
        spectral.dht_crop(v, (4, 3, 2)), v.shape[1:-1]))
    want = np.asarray(f(x))

    sharded = jax.device_put(
        x, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "spatial", None, None)))
    got = np.asarray(f(sharded))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n_data,n_spatial", [(8, 1), (2, 4)])
def test_sharded_train_step_matches_single_device(n_data, n_spatial):
    model, x, y = _model_and_data(batch=8)
    tx = build_optimizer({"optimizer_name": "Adamax", "lr": 1e-3})
    params = model.init(jax.random.PRNGKey(0), x[:1])["params"]

    step = make_train_step(losses.pcc_loss, num_labels=3, donate=False)

    # single-device
    state = create_train_state(model, params, tx)
    state1, loss1 = step(state, x, y)

    # sharded
    mesh = make_mesh(n_data=n_data, n_spatial=n_spatial)
    xs = jax.device_put(x, batch_sharding(mesh, x.shape))
    ys = jax.device_put(y, batch_sharding(mesh, y.shape))
    state_r = jax.device_put(create_train_state(model, params, tx),
                             replicated(mesh))
    state2, loss2 = step(state_r, xs, ys)

    np.testing.assert_allclose(float(loss1), float(loss2), atol=1e-5)
    for p1, p2 in zip(jax.tree_util.tree_leaves(state1.params),
                      jax.tree_util.tree_leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-5)


def test_single_volume_spatial_sharding_inference():
    """Whole-volume inference with the volume split across all 8 devices."""
    model, x, y = _model_and_data(batch=1)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    fwd = jax.jit(lambda p, v: model.apply({"params": p}, v))
    want = np.asarray(fwd(params, x))

    mesh = make_mesh(n_data=1, n_spatial=8)
    xs = jax.device_put(x, volume_sharding(mesh, x.ndim, spatial_axis=0))
    ps = jax.device_put(params, replicated(mesh))
    got = np.asarray(fwd(ps, xs))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_multihost_helpers_single_process():
    from multimodal_3d_image_segmentation.parallel import multihost
    assert not multihost.is_multihost()
    assert multihost.process_count() == 1
    items = list(range(10))
    assert multihost.shard_list_for_process(items, 0, 2) == [0, 2, 4, 6, 8]
    assert multihost.shard_list_for_process(items, 1, 2) == [1, 3, 5, 7, 9]

    mesh = make_mesh(n_data=8, n_spatial=1)
    local = np.ones((8, 3), np.float32)
    ga = multihost.global_batch(mesh, local)
    assert ga.shape == (8, 3)
    np.testing.assert_allclose(np.asarray(ga), local)


@pytest.mark.slow
def test_dryrun_multichip_bare_subprocess():
    """Invoke __graft_entry__.dryrun_multichip(8) exactly the way the
    driver does: a fresh interpreter with NO conftest and NO
    XLA_FLAGS/JAX_PLATFORMS provisioning in the environment; this pins
    that calling convention.
    """
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(8)"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout + "\n" + proc.stderr)[-2000:]
    assert "dryrun_multichip(8)" in proc.stdout


@pytest.mark.slow
def test_multihost_two_process_train_step(tmp_path):
    """REAL multi-process path: two workers (4 virtual CPU devices each)
    join via jax.distributed.initialize, lift process-local batches with
    multihost.global_batch, and run one DP train step — the loss and
    updated params must match a single-process 8-device run of the same
    global batch (exercises parallel/multihost.py end to end)."""
    import os
    import json
    import socket
    import subprocess
    import sys

    # free port for the coordinator
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    out_json = str(tmp_path / "proc0.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, coordinator, "2", str(i), out_json],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=os.path.join(os.path.dirname(__file__), ".."))
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    with open(out_json) as f:
        result = json.load(f)
    assert result["devices"] == 8

    # single-process oracle on the in-process 8-device mesh
    from tests.multihost_common import build_step, global_data
    x_all, y_all = global_data()
    mesh = make_mesh(n_data=8)
    x = jax.device_put(jnp.asarray(x_all), batch_sharding(mesh, x_all.shape))
    y = jax.device_put(jnp.asarray(y_all), batch_sharding(mesh, y_all.shape))
    state, step = build_step()
    state = jax.device_put(state, replicated(mesh))
    state, loss = step(state, x, y)
    fp = float(sum(jnp.sum(jnp.abs(p)) for p in
                   jax.tree_util.tree_leaves(state.params)))

    np.testing.assert_allclose(result["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(result["param_fingerprint"], fp, rtol=1e-5)
