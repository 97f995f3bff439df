"""Data layer tests: NIfTI round-trip, normalization, augmentation
semantics, dataset/input pipeline, partitioning."""
import os

import numpy as np
import pytest

from multimodal_3d_image_segmentation.data import (
    ImageTransform, InputData, MultimodalImageDataset, NiftiImage,
    apply_transform, normalize_data, normalize_modalities, read_image,
    read_img, write_image, get_spacing)
from multimodal_3d_image_segmentation.data.partitioning import (
    natural_sorted, partitioning)


# -- NIfTI -------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_nifti_roundtrip(tmp_path, suffix, dtype):
    rng = np.random.default_rng(0)
    if np.issubdtype(dtype, np.integer):
        arr = rng.integers(0, 100, size=(5, 6, 7)).astype(dtype)
    else:
        arr = rng.standard_normal((5, 6, 7)).astype(dtype)
    fn = str(tmp_path / f"vol{suffix}")
    write_image(arr, fn, spacing=(1.5, 2.0, 2.5), origin=(0.0, -239.0, 0.0))

    img = read_image(fn)
    np.testing.assert_array_equal(img.array, arr)
    np.testing.assert_allclose(img.spacing, (1.5, 2.0, 2.5))
    np.testing.assert_allclose(img.origin, (0.0, -239.0, 0.0), atol=1e-5)
    np.testing.assert_allclose(get_spacing(fn), (1.5, 2.0, 2.5))
    assert read_img(fn).dtype == np.float32


def test_nifti_roundtrip_2d(tmp_path):
    arr = np.arange(20, dtype=np.float32).reshape(4, 5)
    fn = str(tmp_path / "img.nii.gz")
    write_image(arr, fn)
    np.testing.assert_array_equal(read_image(fn).array, arr)


def test_nifti_matches_external_readers(tmp_path):
    """If torch ecosystem readers are around, cross-check; otherwise verify
    the raw layout by hand: data must be x-fastest."""
    arr = np.zeros((2, 3, 4), np.uint8)  # (z, y, x)
    arr[0, 0, 1] = 7  # x = 1
    fn = str(tmp_path / "t.nii")
    write_image(arr, fn)
    raw = open(fn, "rb").read()
    data = np.frombuffer(raw[352:], np.uint8)
    assert data[1] == 7  # second voxel in file = x index 1


# -- normalization -----------------------------------------------------------

def test_normalize_data_masked():
    data = np.array([[0, 0, 2.0], [4.0, 6.0, 0]], np.float32)
    out = normalize_data(data, mask_val=0)
    sel = np.array([2.0, 4.0, 6.0], np.float32)
    want = (sel - sel.mean()) / sel.std()
    np.testing.assert_allclose(out[0, 2], want[0], rtol=1e-6)
    assert out[0, 0] == 0 and out[1, 2] == 0


def test_normalize_modalities_independent():
    rng = np.random.default_rng(1)
    x = rng.random((3, 4, 5, 6)).astype(np.float32) + 1
    out = normalize_modalities(x)
    for c in range(3):
        np.testing.assert_allclose(out[c].mean(), 0, atol=1e-5)
        np.testing.assert_allclose(out[c].std(), 1, atol=1e-4)


def test_normalize_clip():
    data = np.array([1.0, 100.0, -100.0], np.float32)
    out = normalize_data(data, clip_val=(-2, 2))
    assert np.isfinite(out).all()


# -- augmentation ------------------------------------------------------------

def test_apply_transform_identity():
    x = np.random.default_rng(2).random((2, 5, 6, 7)).astype(np.float32)
    m = np.eye(4)
    np.testing.assert_allclose(apply_transform(x, m, 0.0), x)


def test_apply_transform_integer_shift():
    """A pure integer shift in (x, y, z) equals an index roll with fill."""
    x = np.random.default_rng(3).random((1, 6, 7, 8)).astype(np.float32)
    m = np.eye(4)
    m[:3, 3] = [2, 0, 0]  # shift +2 along x (last array axis)
    got = apply_transform(x, m, -1.0)
    # input_index = output_index + 2 -> output[..., j] = input[..., j + 2]
    want = np.full_like(x, -1.0)
    want[..., :-2] = x[..., 2:]
    np.testing.assert_allclose(got, want)


def test_image_transform_labels_stay_integral():
    t = ImageTransform(rotation_range=[20, 10, 5], shift_range=[.1, .1, .1],
                       zoom_range=[0.8, 1.2], flip=[1, 1, 1],
                       augmentation_probability=1.0, seed=0)
    rng = np.random.default_rng(4)
    x = rng.random((2, 10, 11, 12)).astype(np.float32)
    y = rng.integers(0, 4, size=(1, 10, 11, 12)).astype(np.float32)
    x2, y2 = t(x, y)
    assert x2.shape == x.shape and y2.shape == y.shape
    assert set(np.unique(y2)).issubset({0.0, 1.0, 2.0, 3.0})


def test_image_transform_probability_gate_and_seed():
    t0 = ImageTransform(shift_range=[.3, .3, .3],
                        augmentation_probability=0.0, seed=1)
    x = np.random.default_rng(5).random((1, 6, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(t0(x), x)  # gate off -> identity

    a = ImageTransform(shift_range=[.3, .3, .3], zoom_range=[.8, 1.2],
                       flip=[1, 1, 1], seed=42)(x.copy())
    b = ImageTransform(shift_range=[.3, .3, .3], zoom_range=[.8, 1.2],
                       flip=[1, 1, 1], seed=42)(x.copy())
    np.testing.assert_allclose(a, b)  # same seed, same transform


def test_image_transform_2d():
    t = ImageTransform(rotation_range=30, shift_range=[.1, .1],
                       zoom_range=[0.9, 1.1], seed=2)
    x = np.random.default_rng(6).random((3, 12, 13)).astype(np.float32)
    assert t(x).shape == x.shape


# -- dataset / input pipeline -------------------------------------------------

def _make_npy_dataset(tmp_path, n=6, shape=(6, 7, 8)):
    rng = np.random.default_rng(7)
    lists = [[], []]
    for i in range(n):
        xfn = str(tmp_path / f"p{i}" / "img.npy")
        yfn = str(tmp_path / f"p{i}" / "seg.npy")
        os.makedirs(os.path.dirname(xfn), exist_ok=True)
        np.save(xfn, rng.random(shape).astype(np.float32))
        np.save(yfn, rng.integers(0, 3, shape).astype(np.float32))
        lists[0].append(xfn)
        lists[1].append(yfn)
    return lists


def test_multimodal_dataset_and_flows(tmp_path):
    lists = _make_npy_dataset(tmp_path)
    ds = MultimodalImageDataset(lists, reader=np.load,
                                idx_x_modalities=[0], idx_y_modalities=[1])
    x, y = ds[0]
    assert x.shape == (1, 6, 7, 8) and y.shape == (1, 6, 7, 8)

    input_data = InputData(reader=np.load, data_lists_train=lists,
                           data_lists_valid=lists, data_lists_test=lists,
                           idx_x_modalities=[0], idx_y_modalities=[1],
                           batch_size=2, num_workers=0, seed=0)
    assert input_data.get_train_num_batches() == 3
    assert input_data.get_train_image_size() == (6, 7, 8)
    assert input_data.get_num_x_modalities() == 1

    batches = list(input_data.get_train_flow(shuffle=True))
    assert len(batches) == 3
    bx, by = batches[0]
    assert bx.shape == (2, 1, 6, 7, 8) and by.shape == (2, 1, 6, 7, 8)


def test_flow_multiprocess_workers(tmp_path):
    lists = _make_npy_dataset(tmp_path, n=5)
    input_data = InputData(
        reader=np.load, data_lists_train=lists, idx_x_modalities=[0],
        idx_y_modalities=[1], batch_size=2, num_workers=2,
        transform_kwargs=dict(shift_range=[.1, .1, .1], seed=0))
    flow = input_data.get_train_flow(shuffle=False)
    seen = 0
    for bx, by in flow:
        seen += bx.shape[0]
        assert bx.shape[1:] == (1, 6, 7, 8)
    assert seen == 5
    flow.close()


def test_flow_worker_augmentation_reproducible(tmp_path):
    """Same config seed -> same augmented batches with num_workers > 0
    (regression: per-worker os.urandom reseeding silently broke the
    documented reproducibility contract)."""
    lists = _make_npy_dataset(tmp_path, n=5)

    def run_once():
        input_data = InputData(
            reader=np.load, data_lists_train=lists, idx_x_modalities=[0],
            idx_y_modalities=[1], batch_size=2, num_workers=2, seed=7,
            transform_kwargs=dict(shift_range=[.3, .3, .3],
                                  rotation_range=[20., 20., 20.], seed=7,
                                  augmentation_probability=1.0))
        flow = input_data.get_train_flow(shuffle=True)
        out = [np.array(bx) for bx, _ in flow]
        flow.close()
        return out

    a, b = run_once(), run_once()
    assert len(a) == len(b)
    for xa, xb in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
    # and the augmentation actually ran (shift/rotation changed voxels)
    raw = np.load(lists[0][0])
    assert not np.array_equal(a[0][0, 0], raw)


def test_flow_worker_augmentation_honors_transform_seed(tmp_path):
    """The [augmentation] seed alone (no flow seed) must make worker-pool
    augmentation deterministic (regression: task seeds used to come from
    the unseeded flow rng, silently overriding the transform seed)."""
    lists = _make_npy_dataset(tmp_path, n=4)

    def run_once():
        input_data = InputData(
            reader=np.load, data_lists_train=lists, idx_x_modalities=[0],
            idx_y_modalities=[1], batch_size=2, num_workers=2,
            transform_kwargs=dict(shift_range=[.3, .3, .3], seed=11,
                                  augmentation_probability=1.0))
        flow = input_data.get_train_flow(shuffle=False)
        out = [np.array(bx) for bx, _ in flow]
        flow.close()
        return out

    for xa, xb in zip(run_once(), run_once()):
        np.testing.assert_array_equal(xa, xb)


# -- partitioning ------------------------------------------------------------

def test_natural_sorted():
    assert natural_sorted(["id10", "id2", "id1"]) == ["id1", "id2", "id10"]
    # case-sensitive string tokens (byte order, like natsort.os_sorted
    # under the C locale): uppercase sorts before lowercase
    assert natural_sorted(["brats_2", "BRATS_10"]) == ["BRATS_10", "brats_2"]


def test_partitioning_split(tmp_path):
    for i in range(10):
        os.makedirs(tmp_path / f"case{i}")
    tr, va, te = partitioning(str(tmp_path), 0.6, 0.1, 0.3,
                              modalities=["t1c", "seg"], ext="nii.gz",
                              seed=100)
    assert len(tr["t1c"]) == 6 and len(va["t1c"]) == 1 and len(te["t1c"]) == 3
    assert tr["t1c"][0].endswith("-t1c.nii.gz")
    # same seed -> same split
    tr2, _, _ = partitioning(str(tmp_path), 0.6, 0.1, 0.3,
                             modalities=["t1c"], ext="nii.gz", seed=100)
    assert tr["t1c"] == tr2["t1c"]


def test_partitioning_brats19_naming(tmp_path):
    for i in range(4):
        os.makedirs(tmp_path / f"case{i}")
    tr, _, _ = partitioning(str(tmp_path), 0.5, 0.25, 0.25,
                            modalities=["t1"], ext="nii.gz", seed=1,
                            naming="brats19")
    assert tr["t1"][0].endswith("_t1.nii.gz")


def test_load_np_data(tmp_path):
    from multimodal_3d_image_segmentation.utils.io import load_np_data
    a = np.arange(6).reshape(2, 3)
    np.save(tmp_path / "a.npy", a)
    np.savez(tmp_path / "b.npz", data=a * 2)
    np.testing.assert_array_equal(load_np_data(str(tmp_path / "a.npy")), a)
    np.testing.assert_array_equal(load_np_data(str(tmp_path / "b.npz")),
                                  a * 2)
    assert load_np_data(None) is None


def test_native_fallback_equivalence():
    """Native C++ kernels and the numpy fallbacks agree (z-score path)."""
    from multimodal_3d_image_segmentation.data import native
    rng = np.random.default_rng(11)
    d = rng.random((20, 22, 18)).astype(np.float32) * 50
    d[d < 10] = 0
    want = normalize_data(d.copy(), mask_val=0)  # dispatches to native if built
    # force the numpy path
    sel = d[d != 0]
    manual = (d - sel.mean()) / sel.std()
    manual[d == 0] = 0
    np.testing.assert_allclose(want, manual, atol=2e-5)


def test_shipped_split_examples():
    """Frozen split-example corpus (examples/split_examples): disjoint by
    patient ID, consistent across modalities, full 1251-case coverage."""
    import re
    root = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "split_examples")
    modalities = ["t1c", "t1n", "t2f", "t2w", "seg"]
    splits = {"train-0.6": 751, "valid-0.1": 125, "test-0.3": 375}

    def ids_of(path):
        with open(path) as f:
            return [re.search(r"/(BraTS-GLI-\d+-\d+)/", ln).group(1)
                    for ln in f if ln.strip()]

    per_split = {}
    for split, n in splits.items():
        ref_ids = None
        for m in modalities:
            ids = ids_of(os.path.join(root, f"{m}_{split}.txt"))
            assert len(ids) == n
            if ref_ids is None:
                ref_ids = ids
            else:  # same IDs in the same order for every modality
                assert ids == ref_ids
        per_split[split] = set(ref_ids)

    all_ids = set().union(*per_split.values())
    assert len(all_ids) == 1251
    assert sum(len(s) for s in per_split.values()) == 1251  # disjoint


def test_native_gunzip_matches_python(tmp_path):
    """Native zlib decompressor returns byte-identical content; batch and
    single paths agree with the Python reader."""
    import gzip
    from multimodal_3d_image_segmentation.data import native, nifti
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(1)
    paths, arrays = [], []
    for i in range(3):
        arr = rng.integers(0, 500, (20, 24, 18)).astype(np.int16)
        fn = str(tmp_path / f"v{i}.nii.gz")
        nifti.write_image(arr, fn, spacing=(1.0, 1.5, 2.0))
        paths.append(fn)
        arrays.append(arr)

    buf = native.gunzip(paths[0])
    with gzip.open(paths[0]) as f:
        assert buf is not None and buf.tobytes() == f.read()

    imgs = nifti.read_images(paths)
    for img, arr in zip(imgs, arrays):
        np.testing.assert_array_equal(img.array, arr)
        np.testing.assert_allclose(img.spacing, (1.0, 1.5, 2.0), rtol=1e-6)

    # corrupted trailer -> native declines, Python reader raises cleanly
    bad = str(tmp_path / "bad.nii.gz")
    with open(bad, "wb") as f:
        f.write(b"\x1f\x8b" + b"\x00" * 20)
    assert native.gunzip(bad) is None

    # non-gz path still works through read_images
    plain = str(tmp_path / "v.nii")
    nifti.write_image(arrays[0], plain)
    np.testing.assert_array_equal(nifti.read_images([plain])[0].array,
                                  arrays[0])
