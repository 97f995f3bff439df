"""Worker process for the multi-process (multi-host) test.

Invoked as: python multihost_worker.py <coordinator> <num_procs> <proc_id>
            <out_json>

Each process provisions 4 virtual CPU devices (a fake 2-host x 4-device
pod), joins the JAX distributed runtime, loads its process-local half of a
deterministic global batch, lifts it with ``multihost.global_batch``, and
runs ONE data-parallel train step. Process 0 writes the resulting loss and
a parameter fingerprint to ``out_json`` for comparison against the
single-process oracle.
"""
import json
import os
import sys

DEVICES_PER_PROC = 4


def main():
    coordinator, num_procs, proc_id, out_json = sys.argv[1:5]
    num_procs, proc_id = int(num_procs), int(proc_id)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES_PER_PROC}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from multimodal_3d_image_segmentation.parallel import multihost

    multihost.initialize(coordinator_address=coordinator,
                         num_processes=num_procs, process_id=proc_id)
    assert multihost.is_multihost()
    assert multihost.process_count() == num_procs
    assert jax.device_count() == num_procs * DEVICES_PER_PROC

    import numpy as np
    import jax.numpy as jnp
    from multimodal_3d_image_segmentation.parallel.mesh import (
        make_mesh, replicated)
    from tests.multihost_common import (GLOBAL_BATCH, SHAPE, build_step,
                                        global_data)

    mesh = make_mesh(n_data=jax.device_count())

    # Every process computes the same full global batch deterministically,
    # then keeps only its contiguous process-local rows (what a per-host
    # data loader would produce).
    x_all, y_all = global_data()
    per = GLOBAL_BATCH // num_procs
    x_local = x_all[proc_id * per:(proc_id + 1) * per]
    y_local = y_all[proc_id * per:(proc_id + 1) * per]

    from jax.sharding import PartitionSpec as P
    x = multihost.global_batch(mesh, x_local)
    y = multihost.global_batch(mesh, y_local)

    state, step = build_step()
    state = jax.device_put(state, replicated(mesh))
    state, loss = step(state, x, y)

    loss = float(loss)
    # parameter fingerprint: sum of |params| (replicated -> same everywhere)
    fp = float(sum(jnp.sum(jnp.abs(p)) for p in
                   jax.tree_util.tree_leaves(state.params)))
    if proc_id == 0:
        with open(out_json, "w") as f:
            json.dump({"loss": loss, "param_fingerprint": fp,
                       "devices": jax.device_count()}, f)
    print(f"proc {proc_id}: loss={loss} fp={fp}")


if __name__ == "__main__":
    main()
