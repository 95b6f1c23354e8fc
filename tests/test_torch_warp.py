"""The port's warp tools against the JAX package's, on the CPU.

* `triangle_indices`, `get_triangle_points`, `warp_triangle` (a
  destination partly outside the image included) and `warp_face` on the
  same seeded landmarks and image: exactly equal;
* `show_bboxes` on a PIL image and on an array: exactly equal;
* the warp_images CLI against JAX's on the same [orig|edited] pairs, with
  the seeded MTCNN and MobileNet-GDConv files of test_torch_landmarks.py
  (the cascade finds a face in each half): the strips within ±1 per
  uint8, with and without --warp.
"""

import os

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.cli import warp_images as jax_warp_images
from stylemc_tpu.cv import warp as jwarp
from stylemc_tpu.models.mtcnn import visualize as jvis
from stylemc_torch.cli import warp_images
from stylemc_torch.cv import warp as twarp
from stylemc_torch.models.mtcnn import visualize as tvis
from test_torch_landmarks import _photo, weights  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _landmarks(seed, n=68, size=128):
    """Face-like landmarks: a jittered ellipse of n points around the
    middle of a size² image, fractional as a detector's are."""
    rs = np.random.RandomState(seed)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = size * (0.25 + 0.1 * rs.rand(n))
    pts = np.stack([size / 2 + r * np.cos(a), size / 2 + r * np.sin(a)], 1)
    return (pts + rs.randn(n, 2)).astype(np.float32)


def test_triangles_match_jax():
    src = _landmarks(0)
    tris = twarp.triangle_indices(src)
    assert tris == jwarp.triangle_indices(src) and len(tris) > 50
    img = _photo(128, seed=3)
    for tri in tris[:10]:
        got = twarp.get_triangle_points(src, tri, img)
        want = jwarp.get_triangle_points(src, tri, img)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_warp_face_matches_jax():
    img = _photo(128, seed=4)
    src, dst = _landmarks(1), _landmarks(1) + np.float32(3.5)
    got = twarp.warp_face(img, src, dst)
    np.testing.assert_array_equal(got, jwarp.warp_face(img, src, dst))
    assert np.abs(got.astype(int) - img).max() > 0
    # a destination triangle partly outside the image is clipped to it
    out_t, out_j = img.copy(), img.copy()
    tri_src = np.float32([[10, 10], [60, 20], [30, 70]])
    tri_dst = np.float32([[-20, 100], [40, 110], [10, 150]])
    twarp.warp_triangle(img, out_t, tri_src, tri_dst)
    jwarp.warp_triangle(img, out_j, tri_src, tri_dst)
    np.testing.assert_array_equal(out_t, out_j)


def test_show_bboxes_matches_jax():
    img = _photo(96, seed=5)
    boxes = np.float32([[10.5, 12, 60, 70, 0.9], [40, 30, 90, 95, 0.8]])
    marks = np.float32([[20, 30, 40, 25, 35, 30, 32, 45, 55, 56],
                        [50, 60, 70, 55, 65, 50, 52, 70, 80, 81]])
    for inp in (img, Image.fromarray(img)):
        got = tvis.show_bboxes(inp, boxes, marks)
        want = jvis.show_bboxes(inp, boxes, marks)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.abs(np.asarray(got).astype(int) - img).max() > 0
    np.testing.assert_array_equal(np.asarray(tvis.show_bboxes(img, [])), img)


def test_warp_images_cli_matches_jax(weights, tmp_path,  # noqa: F811
                                     monkeypatch):
    d, path, _, _ = weights
    monkeypatch.setenv("STYLEMC_MTCNN_DIR", d)
    monkeypatch.setenv("STYLEMC_MOBILENET", path)
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for i in range(2):
        pair = np.concatenate([_photo(128, seed=20 + i),
                               _photo(128, seed=30 + i)], axis=1)
        Image.fromarray(pair).save(pairs / f"pair{i}.png")
    for flag, panels in (("--warp", 3), ("--no-warp", 2)):
        outs = {}
        for name, cli, extra in (("jax", jax_warp_images.main, []),
                                 ("torch", warp_images.main,
                                  ["--device", "cpu"])):
            outs[name] = str(tmp_path / f"{name}{flag}")
            r = CliRunner().invoke(cli, ["--indir", str(pairs), "--outdir",
                                         outs[name], flag] + extra,
                                   catch_exceptions=False)
            assert r.exit_code == 0, r.output
            assert "processed 2/2" in r.output
        for i in range(2):
            a, b = (np.asarray(Image.open(os.path.join(
                outs[n], f"pair{i}_warp.jpeg")), int) for n in ("torch", "jax"))
            assert a.shape == (128, 128 * panels, 3)
            assert np.abs(a - b).max() <= 1


def test_warp_images_needs_its_landmark_files(tmp_path, monkeypatch):
    monkeypatch.delenv("STYLEMC_MTCNN_DIR", raising=False)
    r = CliRunner().invoke(warp_images.main, [
        "--indir", str(tmp_path), "--outdir", str(tmp_path / "o"),
        "--device", "cpu"])
    assert isinstance(r.exception, FileNotFoundError)
    assert "STYLEMC_MTCNN_DIR" in str(r.exception)


@pytest.mark.parametrize("module", [twarp, tvis])
def test_cv2_and_pil_are_imported_where_used(module):
    src = open(module.__file__).read()
    head = src[:src.index("\ndef ")]
    assert "import cv2" not in head and "from PIL" not in head
