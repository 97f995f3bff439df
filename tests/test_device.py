"""Where the program meets the device: the compile cache's place, the
imports the main path needs, what the code may branch on, and the
processes that may open the device."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "multimodal_3d_image_segmentation")


def _python(code, env=None, timeout=600):
    full = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return proc.stdout


_CACHE = """
import jax
from multimodal_3d_image_segmentation.utils.profiling import (
    setup_compilation_cache)
print(setup_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_honours_env(tmp_path):
    out = _python(_CACHE, env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    ret, cfg = out.split("\n")[:2]
    # JAX reads the variable itself; the code sets nothing else
    assert ret == str(tmp_path) and cfg == str(tmp_path)


def test_compile_cache_defaults_to_checkout():
    ret, cfg = _python(_CACHE).split("\n")[:2]
    assert ret == cfg == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_path_is_fixed():
    """The path is part of the cache key: no pid, time or random part."""
    from multimodal_3d_image_segmentation.utils import profiling
    code = ("from multimodal_3d_image_segmentation.utils import profiling;"
            "print(profiling.CACHE_DIR)")
    a = _python(code).strip()
    b = _python(code).strip()
    assert a == b == profiling.CACHE_DIR
    assert str(os.getpid()) not in a
    assert not re.search(r"\d{6,}", a)


_BLOCK = """
import sys
for name in ("flax", "orbax", "orbax.checkpoint", "pandas", "matplotlib",
             "matplotlib.pyplot"):
    sys.modules[name] = None
"""


def test_main_path_needs_no_optional_packages(tmp_path):
    """Build, one train step, save and load with flax, orbax, pandas and
    matplotlib unimportable."""
    code = _BLOCK + f"""
import jax, jax.numpy as jnp, numpy as np
from multimodal_3d_image_segmentation import losses, models
from multimodal_3d_image_segmentation.runtime import (
    build_optimizer, create_train_state, make_train_step)
from multimodal_3d_image_segmentation.runtime.checkpoint import (
    load_checkpoint, save_checkpoint)
m = models.HNOSegXS(2, 3, 4, [1, 1], (3, 3, 3))
x = jnp.ones((1, 2, 8, 8, 8))
p = m.init(jax.random.PRNGKey(0), x)["params"]
tx = build_optimizer({{"optimizer_name": "Adamax", "lr": 1e-3}})
s, loss = make_train_step(losses.pcc_loss, 3, donate=False)(
    create_train_state(m, p, tx), x, jnp.zeros((1, 1, 8, 8, 8), jnp.int32))
save_checkpoint({str(tmp_path / "c.npz")!r}, s, 0, float(loss), 0)
r, *_ = load_checkpoint({str(tmp_path / "c.npz")!r},
                        create_train_state(m, p, tx))
assert int(r.step) == 1 and np.isfinite(float(loss))
for mod in ("flax", "orbax", "pandas", "matplotlib"):
    assert sys.modules.get(mod) is None
print("ok")
"""
    assert _python(code).strip().endswith("ok")


def test_pipeline_without_matplotlib_says_so(tmp_path):
    """run() trains, tests and computes statistics without the optional
    packages; stdout.txt records the plots it could not write."""
    code = _BLOCK + f"""
import numpy as np
sys.path.insert(0, "tests")
from test_integration import _make_dataset, _write_lists, _config
from pathlib import Path
from multimodal_3d_image_segmentation.runtime.run import run
tmp = Path({str(tmp_path)!r})
lists = _make_dataset(tmp / "data", n=3, shape=(12, 12, 8))
tr = _write_lists(tmp, {{k: v[:1] for k, v in lists.items()}}, "tr")
va = _write_lists(tmp, {{k: v[1:2] for k, v in lists.items()}}, "va")
te = _write_lists(tmp, {{k: v[2:] for k, v in lists.items()}}, "te")
cfg = _config(tmp, str(tmp / "exp"), tr, va, te, num_epochs=1)
cfg["train"]["is_plot_model"] = True
run(cfg)
print(open(tmp / "exp" / "stdout.txt").read())
"""
    out = _python(code)
    assert "plot_loss.pdf not written: matplotlib is not installed" in out
    assert "model_graph.pdf not written: matplotlib is not installed" in out
    assert os.path.isfile(tmp_path / "exp" / "model" / "model.npz")
    assert os.path.isfile(tmp_path / "exp" / "test" /
                          "results_regional.csv")


def _program_files():
    files = [os.path.join(ROOT, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for base in (PKG, os.path.join(ROOT, "tools")):
        for dirpath, _, names in os.walk(base):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return files


def test_no_kernel_backend_branch_or_env_switch():
    """No program file imports Pallas (no hand-written kernel remains),
    compares the backend with a platform other than the GPU or the CPU,
    reaches interpret mode or reads an M3SEG_* switch."""
    bad = re.compile(r"experimental\.pallas|experimental import pallas|"
                     r"platform\s*[=!]=\s*[\"'](?!gpu[\"']|cpu[\"'])|"
                     r"default_backend\(\)\s*[=!]=|"
                     r"interpret\s*=\s*True|M3SEG_")
    hits = []
    for path in _program_files():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if bad.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)


def test_importing_the_package_loads_no_pallas():
    code = """
import pkgutil, importlib, sys
import multimodal_3d_image_segmentation as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print([m for m in sys.modules if m.startswith("jax.experimental.pallas")])
"""
    assert _python(code).strip() == "[]"


def test_loader_workers_do_not_initialize_a_backend(tmp_path):
    """The data loader's spawn workers read and augment with numpy only:
    no worker imports JAX, so none can open the device."""
    import spawn_probe
    from multimodal_3d_image_segmentation.data.dataset import InputData
    files = [str(tmp_path / f"f{i}") for i in range(4)]
    data = InputData(reader=spawn_probe.probe_reader,
                     data_lists_train=[files, files],
                     idx_x_modalities=[0], idx_y_modalities=[1],
                     batch_size=1, num_workers=2)
    flow = data.get_train_flow(shuffle=False)
    try:
        seen = [x[0, 0] for x, _ in flow]
    finally:
        flow.close()
    pids = {int(s[2]) for s in seen}
    assert len(seen) == 4 and os.getpid() not in pids
    assert all(s[0] == 0.0 and s[1] == 0.0 for s in seen), seen


def test_statistics_workers_import_no_jax():
    """What a statistics pool worker imports to run
    ``compute_sample_metrics`` pulls in no JAX at all."""
    code = """
import sys
from multimodal_3d_image_segmentation.metrics import compute_sample_metrics
import multimodal_3d_image_segmentation.data.dataset
print("jax" in sys.modules)
"""
    assert _python(code).strip() == "False"


@pytest.mark.parametrize("script", [
    "bench.py", "tools/bench_spectral.py", "tools/bench_precision.py",
    "tools/bf16_quality_check.py"])
def test_gpu_scripts_refuse_the_cpu(script):
    """The timing and quality scripts fail without a GPU and print no
    result line."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"metric"' not in proc.stdout and '"value"' not in proc.stdout
