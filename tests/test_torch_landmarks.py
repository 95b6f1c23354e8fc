"""The port's landmarks stack against the JAX package's, on the CPU.

The same numpy weights (the port's seeded initialisers', carried across
by `convert.params_from_numpy`) and the same seeded numpy inputs go through
both packages:

* the landmark losses, the differentiable crop (values and the gradient
  to the image), MobileNet-GDConv at 224² and the MTCNN P/R/O nets: 1e-5
  (rtol, and atol 1e-5·max|ref|: fp32 summation order differs);
* NMS through the native library against the numpy path and JAX's; the
  crop extraction against JAX's; `detect_faces` on a seeded 128² photo:
  the same boxes within 1e-3 px; crop_face: equal; `Landmarker.detect`:
  rtol 1e-4, atol 1e-4·max|ref|; `align_face` and the align_faces CLI:
  ±1 per uint8;
* the weight files: the port writes the reference formats ({p,r,o}net.npy,
  a 'state_dict' .pth.tar) and both packages read back the same arrays;
* the trainer's landmarks paths: test_torch_landmarks_train.py.

The MTCNN nets are the initialiser's with the face logit's bias raised
by `FACE_BIAS` at every stage, so the cascade passes candidates at each
stage and finds faces (random nets as drawn pass almost none); MobileNet's
last layer is scaled by `HEAD_SCALE` around 0.5, so its landmarks lie in
the crop as real ones do.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.cli import align_faces as jax_align_faces
from stylemc_tpu import native as jax_native
from stylemc_tpu.cv import align as jalign
from stylemc_tpu.cv import landmarks as jlm
from stylemc_tpu.io import load_state_dict_numpy as jax_load_state
from stylemc_tpu.models import mobilenet as jmb
from stylemc_tpu.models.mtcnn import detect as jdet
from stylemc_tpu.models.mtcnn import nets as jnets
from stylemc_tpu.ops import image as jimage
from stylemc_torch import native
from stylemc_torch.cli import align_faces
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.cv import align, landmarks
from stylemc_torch.losses import landmarks_loss as tloss
from stylemc_torch.models import mobilenet as tmb
from stylemc_torch.models.mtcnn import detect as tdet
from stylemc_torch.models.mtcnn import nets as tnets
from stylemc_torch.ops import image as timage
from torch_threads import one_torch_thread  # noqa: F401

# the package's __init__ exports a function under this module's name
jloss = importlib.import_module("stylemc_tpu.losses.landmarks_loss")
NETS = ("pnet", "rnet", "onet")
CLASSIFIER = {"pnet": "conv4_1", "rnet": "conv5_1", "onet": "conv6_1"}
FACE_BIAS = 2.0
# MobileNet's last layer scaled, its bias 0.5: crop-normalised landmarks
# near the crop's centre, in [0, 1] as real ones are
HEAD_SCALE = 0.01
LANDMARKS_COEF = 0.025


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def mtcnn_weights(seed=0):
    """{net: numpy params}: the port's initialiser's, the face logit's bias
    raised by FACE_BIAS."""
    out = {}
    for i, which in enumerate(NETS):
        p = params_to_numpy(tnets.init_net_params(_gen(seed + i), which,
                                                  device="cpu"))
        p[f"{CLASSIFIER[which]}.bias"][1] += FACE_BIAS
        out[which] = p
    return out


def write_landmark_weights(root, seed=0):
    """The MTCNN .npy dir and the MobileNet .pth.tar in the reference
    formats, written by the port; → (mtcnn dir, mobilenet path, numpy
    weights, numpy mobilenet params)."""
    nets = mtcnn_weights(seed)
    d = os.path.join(root, "mtcnn")
    os.makedirs(d, exist_ok=True)
    for which, p in nets.items():
        tnets.save_net_weights(os.path.join(d, f"{which}.npy"), p)
    mb = params_to_numpy(tmb.init_mobilenet_gdconv_params(_gen(seed + 3),
                                                          device="cpu"))
    mb["linear1"]["conv"] *= HEAD_SCALE
    mb["linear1"]["bn"]["bias"][:] = 0.5
    path = os.path.join(root, "mobilenet_224_model_best_gdconv_external.pth.tar")
    torch.save({"state_dict": tmb.params_to_torch_state(mb)}, path)
    return d, path, nets, mb


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_landmark_weights(str(tmp_path_factory.mktemp("lm")))


@pytest.fixture(scope="module")
def landmarkers(weights):
    d, path, _, _ = weights
    return (jlm.default_landmarker(d, path),
            landmarks.default_landmarker(d, path, device="cpu"))


def _photo(size=128, seed=8):
    rs = np.random.RandomState(seed)
    ramp = np.linspace(0, 255, size)[None, :, None] * rs.rand(1, 1, 3)
    return np.clip(ramp + rs.randn(size, size, 3) * 20, 0, 255
                   ).astype(np.uint8)


# ------------------------------------------------------------- ops, losses


def test_landmark_losses_match_jax():
    rs = np.random.RandomState(0)
    a, b = (rs.randn(3, 68, 2).astype(np.float32) * 8 for _ in range(2))
    for name in ("landmarks_loss", "wing_loss"):
        got = getattr(tloss, name)(torch.from_numpy(a), torch.from_numpy(b))
        want = getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b))
        _close(float(got), float(want))
    # the jawline (points 0-16) is left out
    b2 = a.copy()
    b2[:, :17] += 100.0
    assert float(tloss.landmarks_loss(torch.from_numpy(a),
                                      torch.from_numpy(b2))) == 0.0


def test_crop_resize_bilinear_and_its_gradient_match_jax():
    rs = np.random.RandomState(1)
    img = rs.randn(2, 3, 40, 48).astype(np.float32)
    # in bounds, and past the top-left and bottom-right borders
    boxes = np.array([[6.0, 4.0, 38.0, 36.0], [-8.0, -4.0, 52.0, 56.0]],
                     np.float32)
    cot = rs.randn(2, 3, 64, 64).astype(np.float32)
    x = torch.from_numpy(img).requires_grad_(True)
    got = timage.crop_resize_bilinear(x, boxes, 64)
    g, = torch.autograd.grad(got, x, torch.from_numpy(cot))
    want, vjp = jax.vjp(
        lambda im: jimage.crop_resize_bilinear(im, boxes, 64),
        jnp.asarray(img))
    _close(got.detach().numpy(), want)
    _close(g.numpy(), vjp(jnp.asarray(cot))[0])
    for box in ([10, 12, 60, 70, 0.9], [3.5, 5, 90, 88.25, 0.5]):
        np.testing.assert_array_equal(timage.square_crop_box(box),
                                      jimage.square_crop_box(box))


# -------------------------------------------------------------------- nets


def test_mobilenet_matches_jax(weights):
    _, _, _, mb = weights
    x = np.random.RandomState(2).randn(2, 3, 224, 224).astype(np.float32)
    got = tmb.mobilenet_gdconv_apply(params_from_numpy(mb, "cpu"),
                                     torch.from_numpy(x))
    want = jax.jit(jmb.mobilenet_gdconv_apply)(mb, jnp.asarray(x))
    assert got.shape == (2, 136)
    _close(got.numpy(), want)


@pytest.mark.parametrize("which,shape", [
    ("pnet", (2, 3, 37, 45)), ("rnet", (5, 3, 24, 24)),
    ("onet", (5, 3, 48, 48))])
def test_mtcnn_nets_match_jax(weights, which, shape):
    p = weights[2][which]
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    got = getattr(tnets, f"{which}_apply")(params_from_numpy(p, "cpu"),
                                           torch.from_numpy(x))
    want = getattr(jnets, f"{which}_apply")(p, jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_weight_files_read_back_by_both_packages(weights):
    d, path, nets, mb = weights
    for which in NETS:
        f = os.path.join(d, f"{which}.npy")
        for loaded in (jnets.load_net_weights(f),
                       tnets.load_net_weights(f, "cpu")):
            assert set(loaded) == set(nets[which])
            for k, v in nets[which].items():
                np.testing.assert_array_equal(np.asarray(loaded[k]), v)
    state = jax_load_state(path, key="state_dict")
    assert all(k.startswith("module.") for k in state)
    for got in (jmb.params_from_torch_state(state),
                tmb.params_from_torch_state(state)):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
            got, mb)


def test_init_layouts_match_jax():
    def shapes(tree):
        return jax.tree_util.tree_map(lambda t: tuple(t.shape), tree)

    key = jax.random.PRNGKey(0)
    for which in NETS:
        got = tnets.init_net_params(_gen(0), which, device="cpu")
        assert shapes(got) == shapes(jax.eval_shape(
            lambda k, w=which: jnets.init_net_params(k, w), key))
    got = tmb.init_mobilenet_gdconv_params(_gen(0), device="cpu")
    assert shapes(got) == shapes(jax.eval_shape(
        jmb.init_mobilenet_gdconv_params, key))


# --------------------------------------------------------------- the cascade


def test_native_library_builds_and_counts_its_calls():
    assert native.native_available()
    assert native.build_host_ops().name == "libhost_ops.so"
    before = dict(native.calls)
    tdet.nms(np.array([[0, 0, 10, 10, 0.9]], np.float32))
    assert native.calls["nms"] == before["nms"] + 1


@pytest.mark.parametrize("mode", ["union", "min"])
def test_nms_native_matches_numpy_and_jax(monkeypatch, mode):
    rs = np.random.RandomState(4)
    xy = rs.rand(300, 2) * 100
    wh = rs.rand(300, 2) * 30 + 2
    boxes = np.hstack([xy, xy + wh, rs.rand(300, 1)]).astype(np.float32)
    got = tdet.nms(boxes, 0.4, mode)
    assert got == jdet.nms(boxes, 0.4, mode)
    monkeypatch.setattr(native, "get_host_ops", lambda: None)
    calls = native.calls["nms"]
    assert tdet.nms(boxes, 0.4, mode) == got
    assert native.calls["nms"] == calls  # the numpy path ran


def test_image_boxes_match_jax(monkeypatch):
    img = _photo(64)
    boxes = np.array([[4, 6, 40, 42, 0.9], [-10, -6, 30, 34, 0.8],
                      [30, 28, 80, 78, 0.7]], np.float32)
    got = tdet.get_image_boxes(boxes, img, 24)
    np.testing.assert_array_equal(got, jdet.get_image_boxes(boxes, img, 24))
    assert got.shape == (3, 3, 24, 24)
    # without the library: the numpy path (a PIL resize), as JAX's
    monkeypatch.setattr(native, "get_host_ops", lambda: None)
    monkeypatch.setattr(jax_native, "extract_image_boxes_native",
                        lambda *a: None)
    calls = native.calls["extract_image_boxes"]
    np.testing.assert_array_equal(tdet.get_image_boxes(boxes, img, 24),
                                  jdet.get_image_boxes(boxes, img, 24))
    assert native.calls["extract_image_boxes"] == calls


def test_detect_faces_matches_jax(weights):
    nets = weights[2]
    img = _photo(128)
    jm = jdet.MTCNN(*(nets[w] for w in NETS))
    tm = tdet.MTCNN(*(params_from_numpy(nets[w], "cpu") for w in NETS))
    jb, jl = jdet.detect_faces(img, jm, min_face_size=40.0)
    tb, tl = tdet.detect_faces(img, tm, min_face_size=40.0)
    assert len(tb) == len(jb) > 0
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    # the nets as drawn (no face bias) find nothing
    plain = tdet.MTCNN(*(tnets.init_net_params(
        torch.Generator().manual_seed(i), w, "cpu")
        for i, w in enumerate(NETS)))
    assert tdet.detect_faces(img, plain, min_face_size=40.0) == ([], [])


def test_crop_face_matches_jax():
    img = _photo(96)
    for box in ([10, 12, 60, 70, 0.9], [-6, 40, 50, 120, 0.9]):
        got = landmarks.crop_face(img, [np.array(box)], 64)
        want = jlm.crop_face(img, [np.array(box)], 64)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_landmarker_matches_jax(landmarkers):
    jl, tl = landmarkers
    img = _photo(128)
    want = jl.detect(img)
    got = tl.detect(img)
    assert got.shape == want.shape == (68, 2)
    _close(got, want, rtol=1e-4, atol_rel=1e-4)
    batch = tl.detect_batch([img, img])
    np.testing.assert_array_equal(batch[1], got)


def test_default_landmarker_needs_its_files(monkeypatch, tmp_path):
    monkeypatch.delenv("STYLEMC_MTCNN_DIR", raising=False)
    monkeypatch.delenv("STYLEMC_MOBILENET", raising=False)
    with pytest.raises(FileNotFoundError, match="STYLEMC_MTCNN_DIR"):
        landmarks.default_landmarker(device="cpu")
    with pytest.raises(FileNotFoundError, match="STYLEMC_MOBILENET"):
        landmarks.default_landmarker(str(tmp_path), device="cpu")


# --------------------------------------------------------------- alignment


def test_align_face_matches_jax():
    img = np.random.RandomState(0).randint(0, 255, (160, 160, 3), np.uint8)
    lm = np.zeros((68, 2))
    lm[36:42] = [60, 80]
    lm[42:48] = [100, 80]
    lm[48] = [65, 120]
    lm[54] = [95, 120]
    lm[48:60] += np.random.RandomState(0).randn(12, 2)
    got = np.asarray(align.align_face(img, lm, output_size=64,
                                      transform_size=256))
    want = np.asarray(jalign.align_face(img, lm, output_size=64,
                                        transform_size=256))
    assert got.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_align_faces_cli_matches_jax(weights, tmp_path, monkeypatch):
    d, path, _, _ = weights
    monkeypatch.setenv("STYLEMC_MTCNN_DIR", d)
    monkeypatch.setenv("STYLEMC_MOBILENET", path)
    photos = tmp_path / "photos"
    photos.mkdir()
    for i in range(2):
        Image.fromarray(_photo(128, seed=10 + i)).save(photos / f"p{i}.png")
    args = ["--images_dir", str(photos), "--output_size", "64",
            "--transform_size", "256"]
    for name, cli, extra in (("jax", jax_align_faces.main, []),
                             ("torch", align_faces.main,
                              ["--device", "cpu"])):
        r = CliRunner().invoke(cli, args + ["--out_dir", str(tmp_path / name)]
                               + extra, catch_exceptions=False)
        assert r.exit_code == 0, r.output
        assert "aligned 2/2" in r.output
    for i in range(2):
        a, b = (np.asarray(Image.open(tmp_path / n / f"p{i}.png"))
                for n in ("torch", "jax"))
        assert a.shape == (64, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
