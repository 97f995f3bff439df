"""chip_smoke.py off the card: it refuses the CPU, its CLI selects its
phases, and each phase runs at tiny shapes on CPU devices passed in
explicitly (the GPU run uses the same functions at full size)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

SMALL = {"filters": 8, "num_transform_blocks": [2, 2, 2],
         "num_modes": (3, 4, 4)}
SMALL_KW = dict(in_channels=4, out_channels=4, filters=8,
                num_transform_blocks=[2, 2, 2], num_modes=(3, 4, 4))
LAST_LINE = ('{"ok": true, "device": {"platform": "gpu", '
             '"kind": "NVIDIA H100 80GB HBM3", "count": %d}}')


def test_exits_nonzero_off_the_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not 'gpu'" in proc.stderr


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def _fake_card(monkeypatch, calls, n_devices):
    devs = [_Dev() for _ in range(n_devices)]
    monkeypatch.setattr(chip_smoke.jax, "devices",
                        lambda *a: devs if not a else jax.local_devices())
    monkeypatch.setattr(chip_smoke, "setup_compilation_cache", lambda: "")
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda d, require: calls.append("device") or "card")

    def record(name, ret=None):
        def f(*a, **k):
            calls.append(name)
            return ret
        return f

    monkeypatch.setattr(chip_smoke, "phase_train",
                        record("train", ("out", None, {})))
    monkeypatch.setattr(chip_smoke, "phase_serve", record("serve"))
    monkeypatch.setattr(chip_smoke, "phase_compare", record("compare"))
    monkeypatch.setattr(chip_smoke, "phase_gpu_tests", record("gpu_tests"))
    monkeypatch.setattr(chip_smoke, "phase_four", record("four"))


def test_four_selects_only_its_phase(monkeypatch, capsys, tmp_path):
    calls = []
    _fake_card(monkeypatch, calls, 4)
    chip_smoke.main(["--four", "--workdir", str(tmp_path / "w")])
    assert calls == ["device", "four"]
    assert capsys.readouterr().out.splitlines()[-1] == LAST_LINE % 4


def test_last_line_is_the_exact_json(monkeypatch, capsys, tmp_path):
    calls = []
    _fake_card(monkeypatch, calls, 1)
    chip_smoke.main(["--workdir", str(tmp_path / "w")])
    assert calls == ["device", "train", "serve", "compare", "gpu_tests"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == LAST_LINE % 1
    assert json.loads(lines[-1])["device"]["count"] == 1
    assert any(line.startswith("card: ") for line in lines[:-1])
    assert not os.path.exists(tmp_path / "w")  # work dir removed


def test_device_phase_requires_the_platform():
    devs = jax.devices()
    assert chip_smoke.phase_device(devs, require="cpu") == "none"
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.phase_device(devs, require="gpu")


def test_train_and_serve_phases_tiny(tmp_path):
    out, params, info = chip_smoke.phase_train(
        str(tmp_path), 0, shape=(12, 16, 16), n_cases=3, num_epochs=2,
        model_overrides=SMALL, num_workers=0, device=jax.devices()[0])
    assert len(info["train_loss"]) == 2 and info["step_s"] > 0
    assert os.path.isfile(os.path.join(out, "model", "model.npz"))
    res = chip_smoke.phase_serve(str(tmp_path), out, 0, shape=(20, 24, 24),
                                 n_volumes=3, num_workers=0,
                                 model_overrides=SMALL)
    assert np.isfinite(res["per_volume_s"])


def test_compare_phase_tiny():
    from multimodal_3d_image_segmentation import models
    cpu = jax.devices()
    model = models.HNOSegXS(**SMALL_KW)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, 4, 12, 16, 16), np.float32))["params"]
    res = chip_smoke.phase_compare(
        params, 0, cpu[0], cpu[1], serve_shape=(20, 24, 24),
        train_shape=(12, 16, 16), model_kwargs=SMALL_KW,
        block_grid=(9, 11, 11, 8), modes=(3, 4, 4))
    assert res["forward_highest_max_abs"] <= 1e-6
    assert res["grad_cpu_vs_f64"] <= chip_smoke.TOL_HIGHEST_GRAD
    assert max(res["dht_highest"]) <= 1e-5


def test_four_card_phase_on_virtual_devices():
    res = chip_smoke.phase_four(jax.devices()[:4], 0, train_shape=(12, 16, 16),
                                serve_shape=(20, 24, 24),
                                model_kwargs=SMALL_KW)
    assert res["forward_diff"] <= 1e-4 and res["train_param_diff"] <= 1e-4
    assert res["train_grad_diff"] <= chip_smoke.TOL_FOUR_GRAD


@pytest.mark.parametrize("scale, want", [(1.0, 0.0), (4.0, 3.0),
                                         (0.25, 0.75), (1.001, 1e-3)],
                         ids=["same", "psum", "mean-twice", "tiny"])
def test_grad_error_sees_the_gradient_scale(scale, want):
    """A data-parallel step that sums instead of averaging (or any other
    scale error) shows in the per-leaf ratio; leaves that are nought up to
    rounding are left out of it."""
    rng = np.random.default_rng(0)
    ref = {"w": rng.standard_normal((3, 4)), "b": np.full(4, 1e-12),
           "k": rng.standard_normal(5)}
    got = {k: v * scale for k, v in ref.items()}
    worst, leaf, out = chip_smoke.grad_error(got, ref)
    assert out == 1 and leaf in ("['k']", "['w']")
    np.testing.assert_allclose(worst, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("grid, modes", [
    ((9, 11, 11, 8), (3, 4, 4)),
    ((8, 12, 10, 4), (4, 6, 5)),
    ((7, 9, 12, 3), (2, 3, 5)),
    ((6, 13, 8, 2), (1, 6, 2)),
], ids=["odd", "even-full", "mixed", "thin"])
def test_float64_dht_references_match_pruned_transforms(grid, modes):
    """The compare phase's float64 numpy DHT (crop and zero-pad inverse)
    agrees with the pruned transforms at fp32 'highest'."""
    from multimodal_3d_image_segmentation.ops import spectral
    x = np.random.default_rng(4).standard_normal((1,) + grid)
    want = chip_smoke._numpy_dht_crop(x, modes)
    got = np.asarray(spectral.dht_crop(x.astype(np.float32), modes))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.max(np.abs(want)))
    want_inv = chip_smoke._numpy_dht_pad_inverse(want, grid[:3])
    got_inv = np.asarray(spectral.dht_pad_inverse(want.astype(np.float32),
                                                  grid[:3]))
    np.testing.assert_allclose(got_inv, want_inv,
                               atol=1e-5 * np.max(np.abs(want_inv)))
