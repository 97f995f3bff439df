"""Evaluation-metric unit tests with analytic oracles."""
import numpy as np
import pytest

from multimodal_3d_image_segmentation.metrics import (
    compute_regional_metrics, dice_binary, get_labels_union, hd95_binary,
    statistics_regional, surface_dice_binary)


def test_dice_binary():
    a = np.zeros((4, 4, 4), bool)
    b = np.zeros((4, 4, 4), bool)
    a[:2], b[:2] = True, True
    assert dice_binary(a, b) == 1.0
    b[:] = False
    b[:1] = True
    assert dice_binary(a, b) == pytest.approx(2 * 16 / (32 + 16))
    assert np.isnan(dice_binary(np.zeros_like(a), b))  # absent label -> NaN


def test_get_labels_union():
    y = np.array([0, 1, 2, 3, 2])
    np.testing.assert_array_equal(get_labels_union(y, [1, 3]),
                                  [False, True, False, True, False])
    np.testing.assert_array_equal(get_labels_union(y, 2),
                                  [False, False, True, False, True])


def test_surface_dice_perfect_and_shifted():
    a = np.zeros((12, 12, 12), bool)
    a[3:9, 3:9, 3:9] = True
    assert surface_dice_binary(a, a, (1.0, 1.0, 1.0)) == 1.0

    b = np.roll(a, 1, axis=0)  # 1-voxel shift: all surfaces within 1mm
    sd = surface_dice_binary(a, b, (1.0, 1.0, 1.0))
    assert sd == 1.0
    # anisotropic spacing: the 3mm shift along axis 0 exceeds the
    # tolerance (= mean spacing 5/3 mm), so agreement drops
    sd_aniso = surface_dice_binary(a, b, (3.0, 1.0, 1.0))
    assert 0.5 < sd_aniso < 1.0


def test_hd95_shifted_cube():
    a = np.zeros((16, 16, 16), bool)
    a[4:12, 4:12, 4:12] = True
    b = np.roll(a, 2, axis=1)
    hd = hd95_binary(a, b, (1.0, 1.0, 1.0))
    assert 1.0 <= hd <= 3.0  # ~2mm shift
    assert np.isnan(hd95_binary(np.zeros_like(a), b, (1.0, 1.0, 1.0)))


def test_compute_regional_metrics_keys():
    a = np.zeros((8, 8, 8), np.uint8)
    a[2:6, 2:6, 2:6] = 1
    out = compute_regional_metrics(a, a, (1, 1, 1), labels=[1])
    assert out["dice"] == 1.0 and out["surface_dice"] == 1.0
    # hd95 applies the reference's binary_opening denoising to the
    # prediction (experiments/metrics.py:158-163), which erodes cube
    # corners, so even identical masks give a small nonzero HD95
    assert out["hd95"] <= 2.0
    out2 = compute_regional_metrics(a, a, labels=[1], use_surface_dice=False,
                                    use_hd95=False)
    assert set(out2) == {"dice"}


def test_statistics_regional_outputs(tmp_path):
    from multimodal_3d_image_segmentation.data.nifti import write_image
    rng = np.random.default_rng(0)
    y_true, y_pred, files = [], [], []
    for i in range(3):
        t = rng.integers(0, 3, (6, 6, 6)).astype(np.uint8)
        p = t.copy()
        p[0, 0, 0] = (p[0, 0, 0] + 1) % 3
        fn = str(tmp_path / f"case{i}" / "seg.nii.gz")
        write_image(t, fn)
        y_true.append(t)
        y_pred.append(p)
        files.append(fn)

    out = statistics_regional(y_true, y_pred, files, str(tmp_path),
                              region_names=["bg", "fg"],
                              region_labels=[[0], [1, 2]], is_print=False)
    assert (tmp_path / "results_regional.csv").exists()
    assert (tmp_path / "average_results_regional.txt").exists()
    assert out["dice"].shape == (3, 2)
    assert np.all(out["dice"] > 0.9)

    # parallel path produces the same values
    out2 = statistics_regional(y_true, y_pred, files, str(tmp_path),
                               region_names=["bg", "fg"],
                               region_labels=[[0], [1, 2]], is_print=False,
                               nproc=2)
    np.testing.assert_allclose(out2["dice"], out["dice"])


# ---------------------------------------------------------------------------
# Subvoxel surfel construction (surfels.py) — closed-form golden cases
# ---------------------------------------------------------------------------

def test_surfel_table_closed_forms():
    from multimodal_3d_image_segmentation.surfels import (
        neighbour_code_to_surface_area)
    t = neighbour_code_to_surface_area((1.0, 1.0, 1.0))
    assert t[0] == 0.0 and t[255] == 0.0
    # one corner inside: triangle over three edge midpoints = sqrt(3)/8
    for c in range(8):
        assert t[1 << c] == pytest.approx(np.sqrt(3) / 8)
        # one corner OUTSIDE: same cut, same polygon
        assert t[255 ^ (1 << c)] == pytest.approx(np.sqrt(3) / 8)
    # half cell (one face's corners inside): unit midplane
    assert t[0b11110000] == pytest.approx(1.0)
    assert t[0b00001111] == pytest.approx(1.0)
    # adjacent corner pair: planar quad of area sqrt(2)/2
    assert t[0b11000000] == pytest.approx(np.sqrt(2) / 2)

    # anisotropic scaling: midplane cut normal to d has area h*w spacing
    ta = neighbour_code_to_surface_area((2.0, 3.0, 5.0))
    assert ta[0b11110000] == pytest.approx(3.0 * 5.0)


def test_surfel_table_rotation_equivariant():
    """Total area must be invariant under the 24 cube rotations."""
    import itertools
    from multimodal_3d_image_segmentation.surfels import (
        neighbour_code_to_surface_area)
    t = neighbour_code_to_surface_area((1.0, 1.0, 1.0))
    corners = [np.array(c) for c in itertools.product((0, 1), repeat=3)]
    mats = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            m = np.zeros((3, 3), int)
            for r, (p, s) in enumerate(zip(perm, signs)):
                m[r, p] = s
            if round(np.linalg.det(m)) == 1:
                mats.append(m)
    assert len(mats) == 24

    def rotate_code(code, m):
        out = 0
        for c in range(8):
            if (code >> (7 - c)) & 1:
                q = m @ (corners[c] - 0.5) + 0.5
                out |= 1 << (7 - (int(q[0]) * 4 + int(q[1]) * 2 + int(q[2])))
        return out

    for m in mats:
        for code in range(256):
            assert t[code] == pytest.approx(t[rotate_code(code, m)],
                                            abs=1e-12)


def test_surfel_map_single_voxel_and_slab():
    from multimodal_3d_image_segmentation.surfels import surfel_map
    m = np.zeros((7, 7, 7), bool)
    m[3, 3, 3] = True  # octahedron around one voxel: 8 corner triangles
    assert surfel_map(m, (1, 1, 1)).sum() == pytest.approx(np.sqrt(3))

    # interior slab: two 5x5 midplanes + 4 sides of 2x5 + rounded rims;
    # exact total derivable per cell row, sanity-bound it instead
    s = np.zeros((9, 9, 9), bool)
    s[3:5, 2:7, 2:7] = True
    area = surfel_map(s, (1, 1, 1)).sum()
    assert 2 * 25 < area < 2 * 25 + 4 * 10 + 20


def test_subvoxel_distances_parallel_planes():
    """gt slab vs 1-voxel-shifted slab: plane-to-plane distances are 1mm
    on the face sheets; surface dice at tol>=1 is 1, at tol<1 is < 1."""
    from multimodal_3d_image_segmentation.metrics import (
        compute_robust_hausdorff, compute_surface_dice_at_tolerance,
        compute_surface_distances)
    a = np.zeros((16, 16, 16), bool)
    a[4:8, 4:12, 4:12] = True
    b = np.roll(a, 1, axis=0)
    d = compute_surface_distances(a, b, (1.0, 1.0, 1.0))
    assert set(d) >= {"distances_gt_to_pred", "distances_pred_to_gt",
                      "surfel_areas_gt", "surfel_areas_pred"}
    # sorted ascending with aligned weights
    assert np.all(np.diff(d["distances_gt_to_pred"]) >= 0)
    assert len(d["surfel_areas_gt"]) == len(d["distances_gt_to_pred"])
    assert d["distances_gt_to_pred"].max() == pytest.approx(1.0)
    assert compute_surface_dice_at_tolerance(d, 1.0) == pytest.approx(1.0)
    assert compute_surface_dice_at_tolerance(d, 0.4) < 1.0
    assert compute_robust_hausdorff(d, 100) == pytest.approx(1.0)
    assert compute_robust_hausdorff(d, 50) <= 1.0

    # empty prediction -> inf distances
    d0 = compute_surface_distances(a, np.zeros_like(a), (1, 1, 1))
    assert np.isinf(d0["distances_gt_to_pred"]).all()
    assert len(d0["distances_pred_to_gt"]) == 0
    assert compute_robust_hausdorff(d0, 95) == np.inf


def test_voxel_method_still_available():
    from multimodal_3d_image_segmentation.metrics import (
        compute_surface_dice_at_tolerance, compute_surface_distances)
    a = np.zeros((10, 10, 10), bool)
    a[3:7, 3:7, 3:7] = True
    d = compute_surface_distances(a, a, (1, 1, 1), method="voxel")
    assert "surfel_areas_gt" not in d
    assert compute_surface_dice_at_tolerance(d, 0.0) == 1.0
    with pytest.raises(ValueError):
        compute_surface_distances(a, a, (1, 1, 1), method="nope")


def test_subvoxel_matches_surface_distance_package():
    """Bit-parity with DeepMind's surface-distance package when installed
    (not in this image; the golden cases above pin the construction)."""
    sd_pkg = pytest.importorskip("surface_distance")
    from multimodal_3d_image_segmentation.metrics import (
        compute_robust_hausdorff, compute_surface_dice_at_tolerance,
        compute_surface_distances)
    rng = np.random.default_rng(0)
    a = rng.random((24, 20, 22)) > 0.7
    b = rng.random((24, 20, 22)) > 0.7
    ours = compute_surface_distances(a, b, (1.0, 1.5, 0.8))
    theirs = sd_pkg.compute_surface_distances(a, b, (1.0, 1.5, 0.8))
    np.testing.assert_allclose(
        compute_surface_dice_at_tolerance(ours, 1.2),
        sd_pkg.compute_surface_dice_at_tolerance(theirs, 1.2), rtol=1e-9)
    np.testing.assert_allclose(
        compute_robust_hausdorff(ours, 95),
        sd_pkg.compute_robust_hausdorff(theirs, 95), rtol=1e-9)


def test_surfel_2d_closed_forms_and_rotation():
    """2D marching-squares boundary lengths: closed forms, 4-fold rotation
    equivariance, single-pixel total, and 2D distances through the metric
    entry points (exercised by the 2D pipeline/statistics path)."""
    import itertools
    from multimodal_3d_image_segmentation.surfels import (
        neighbour_code_to_surface_length, surfel_map)
    from multimodal_3d_image_segmentation.metrics import (
        compute_surface_dice_at_tolerance, compute_surface_distances,
        hd95_binary, surface_dice_binary)

    t = neighbour_code_to_surface_length((1.0, 1.0))
    assert t[0] == 0.0 and t[15] == 0.0
    for c in range(4):  # one corner in or out: half-diagonal segment
        assert t[1 << c] == pytest.approx(np.sqrt(2) / 2)
        assert t[15 ^ (1 << c)] == pytest.approx(np.sqrt(2) / 2)
    assert t[0b1100] == pytest.approx(1.0)  # half cell: straight unit cut
    ta = neighbour_code_to_surface_length((2.0, 5.0))
    assert ta[0b1100] == pytest.approx(5.0)  # cut normal to h: w-spacing
    assert ta[0b1010] == pytest.approx(2.0)  # cut normal to w: h-spacing

    corners = [np.array(c) for c in itertools.product((0, 1), repeat=2)]

    def rot(code):
        out = 0
        for c in range(4):
            if (code >> (3 - c)) & 1:
                p = corners[c] - 0.5
                q = np.array([-p[1], p[0]]) + 0.5
                out |= 1 << (3 - (int(q[0]) * 2 + int(q[1])))
        return out

    for code in range(16):
        assert t[code] == pytest.approx(t[rot(code)], abs=1e-12)

    m = np.zeros((9, 9), bool)
    m[4, 4] = True
    assert surfel_map(m, (1, 1)).sum() == pytest.approx(2 * np.sqrt(2))

    a = np.zeros((16, 16), bool)
    a[4:10, 4:12] = True
    b = np.roll(a, 1, axis=0)
    d = compute_surface_distances(a, b, (1.0, 1.0))
    assert d["distances_gt_to_pred"].max() == pytest.approx(1.0)
    assert compute_surface_dice_at_tolerance(d, 1.0) == pytest.approx(1.0)
    assert surface_dice_binary(a, a, (1.0, 1.0)) == 1.0
    assert np.isfinite(hd95_binary(a, b, (1.0, 1.0)))


def test_surface_metrics_regression_fixture():
    """Committed regression pin: 12 precomputed (mask-pair -> surface
    Dice / HD95 / HD100) cases over varied shapes/spacings. Guards the
    constructive surfel model against accidental changes; the
    surface-distance package cross-check above remains the external
    oracle when the package is installable."""
    import json
    import os
    from multimodal_3d_image_segmentation.metrics import (
        compute_robust_hausdorff, compute_surface_dice_at_tolerance,
        compute_surface_distances)

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "surface_metrics_golden.json")
    with open(path) as f:
        fixture = json.load(f)
    rng = np.random.default_rng(42)
    for case in fixture["cases"]:
        shape = tuple(case["shape"])
        a = rng.random(shape) > case["threshold"]
        b = rng.random(shape) > case["threshold"]
        d = compute_surface_distances(a, b, tuple(case["spacing"]))
        np.testing.assert_allclose(
            compute_surface_dice_at_tolerance(d, case["tolerance_mm"]),
            case["surface_dice"], rtol=1e-12)
        np.testing.assert_allclose(compute_robust_hausdorff(d, 95),
                                   case["hd95"], rtol=1e-12)
        np.testing.assert_allclose(compute_robust_hausdorff(d, 100),
                                   case["hd100"], rtol=1e-12)


def test_surfel_area_complement_symmetry_nonambiguous():
    """First-principles invariant of marching cubes: for cells with NO
    ambiguous face (no diagonal inside/outside pattern), the isosurface
    of the complemented occupancy is the SAME polygon set, so the area
    table must be exactly complement-symmetric there. Ambiguous codes
    legitimately break this (the inside-corner-separation convention
    flips which diagonal gets separated) — they are excluded, not
    tolerated."""
    from multimodal_3d_image_segmentation.surfels import (
        _FACES, neighbour_code_to_surface_area)

    def ambiguous(code):
        inside = [(code >> (7 - c)) & 1 == 1 for c in range(8)]
        for ring in _FACES:
            v = [inside[c] for c in ring]
            if v in ([True, False, True, False],
                     [False, True, False, True]):
                return True
        return False

    for spacing in [(1.0, 1.0, 1.0), (1.3, 0.7, 2.1), (3.0, 0.5, 1.1)]:
        t = neighbour_code_to_surface_area(spacing)
        checked = 0
        for code in range(256):
            if not ambiguous(code):
                assert t[code] == pytest.approx(t[255 - code], abs=1e-12)
                checked += 1
        assert checked == 136  # 256 - 120 ambiguous codes


def test_surfel_area_smooth_surface_estimator():
    """Independent differential-geometry check of the whole 256-entry
    table + spacing handling: the total surfel area of a digitized ball
    must track 4*pi*r^2 with the KNOWN direction-averaged overestimate
    of midpoint marching cubes on binary data (~+5..8% — vertices sit at
    edge midpoints, not interpolated crossings; the DeepMind convention
    shares this bias), and the ratio must be RESOLUTION-STABLE (the
    estimator converges). Catches any wrong table entry or mis-scaled
    spacing without referencing this repo's own construction."""
    from multimodal_3d_image_segmentation.surfels import surfel_map

    def ball_ratio(n, r, spacing):
        gs = [(np.arange(n) - (n - 1) / 2) * s for s in spacing]
        z, y, x = np.meshgrid(*gs, indexing="ij")
        m = (z ** 2 + y ** 2 + x ** 2) <= r ** 2
        return surfel_map(m, spacing).sum() / (4 * np.pi * r ** 2)

    r48 = ball_ratio(48, 20.0, (1.0, 1.0, 1.0))
    r96 = ball_ratio(96, 42.0, (1.0, 1.0, 1.0))
    assert 1.0 < r48 < 1.12 and 1.0 < r96 < 1.12
    assert abs(r96 - r48) < 0.02  # estimator is resolution-stable

    # anisotropic spacing, same PHYSICAL sphere: spacing must enter the
    # table (not just the distance transform); staircase bias grows with
    # anisotropy but stays bounded
    gs = [(np.arange(n) - (n - 1) / 2) * s
          for n, s in zip((36, 72, 144), (2.0, 1.0, 0.5))]
    z, y, x = np.meshgrid(*gs, indexing="ij")
    m = (z ** 2 + y ** 2 + x ** 2) <= 18.0 ** 2
    ratio = surfel_map(m, (2.0, 1.0, 0.5)).sum() / (4 * np.pi * 18.0 ** 2)
    assert 1.0 < ratio < 1.25

    # 2D analog: digitized disk boundary length vs 2*pi*r
    g = np.arange(128) - 63.5
    yy, xx = np.meshgrid(g, g, indexing="ij")
    d = (yy ** 2 + xx ** 2) <= 55.0 ** 2
    ratio2d = surfel_map(d, (1.0, 1.0)).sum() / (2 * np.pi * 55.0)
    assert 1.0 < ratio2d < 1.10
