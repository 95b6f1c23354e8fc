"""Real-image serving in the port against the JAX package's, on the CPU.

The same numpy weights (the port's seeded initialisers; the e4e body is the
tiny `TINY_E4E_LAYOUT` one) go into both BatchEditors: `invert_images`
agrees within rtol 1e-4, atol 1e-4·max|ref|, and `edit_images` renders
within ±1 per uint8. POST /edit_image answers 200 with the editor's own
render, 400 without an inverter or with a bad body length, 404 on other
paths and 500 (counted by /stats) on a body that is not an image.
"""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from stylemc_tpu.models.e4e import psp as jpsp
from stylemc_tpu.models.stylegan2.generator import GeneratorConfig as JaxConfig
from stylemc_tpu.serve import BatchEditor as JaxEditor
from stylemc_torch.cli.serve import build_server
from stylemc_torch.convert import params_to_numpy
from stylemc_torch.models.e4e import encoders, psp
from stylemc_torch.models.stylegan2.generator import (
    GeneratorConfig, N_STYLE_CHANNELS, init_generator_params)
from stylemc_torch.serve import BatchEditor
from tiny import TINY_E4E_LAYOUT
from torch_threads import one_torch_thread  # noqa: F401

CFG_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)


def _direction(row=2, value=0.5):
    d = np.zeros((1, N_STYLE_CHANNELS, 512), np.float32)
    d[:, row, :64] = value
    return d


@pytest.fixture(scope="module")
def nets():
    """(generator params, encoder params, latent_avg), numpy."""
    gen = init_generator_params(torch.Generator().manual_seed(0),
                                GeneratorConfig(**CFG_KW), device="cpu")
    enc = encoders.init_encoder_params(torch.Generator().manual_seed(1), 32,
                                       layout=TINY_E4E_LAYOUT, device="cpu")
    la = (np.random.RandomState(2).randn(8, 512) * 0.1).astype(np.float32)
    return params_to_numpy(gen), params_to_numpy(enc), la


def _psp(nets, size=32, jax=False):
    gen, enc, la = nets
    mod = jpsp if jax else psp
    cfg = mod.PSPConfig(size, encoder_layout=TINY_E4E_LAYOUT)
    if jax:
        return jpsp.PSP(cfg, enc, JaxConfig(**CFG_KW), gen, la)
    return psp.PSP(cfg, enc, GeneratorConfig(**CFG_KW), gen,
                   torch.from_numpy(la))


def _editor(nets, **kw):
    kw.setdefault("max_batch", 2)
    ed = BatchEditor(GeneratorConfig(**CFG_KW), nets[0],
                     direction=_direction(), device="cpu", **kw)
    ed.attach_inverter(_psp(nets))
    return ed


@pytest.fixture(scope="module")
def photos():
    return np.random.RandomState(3).randint(0, 256, (3, 256, 256, 3),
                                            np.uint8)


@pytest.fixture(scope="module")
def jax_editor(nets):
    jed = JaxEditor(JaxConfig(**CFG_KW), nets[0], direction=_direction(),
                    max_batch=2)
    jed.attach_inverter(_psp(nets, jax=True))
    return jed


def test_invert_images_matches_jax(nets, photos, jax_editor):
    # three photos through buckets of at most 2: one full chunk and one
    # padded chunk
    got = _editor(nets).invert_images(photos)
    want = np.asarray(jax_editor.invert_images(photos))
    assert got.shape == (3, N_STYLE_CHANNELS, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_edit_images_matches_jax(nets, photos, jax_editor):
    ed = _editor(nets)
    got = ed.edit_images(photos, change_power=2.0, pairs=True)
    want = jax_editor.edit_images(photos, change_power=2.0, pairs=True)
    assert got.shape == (3, 32, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    left, right = got[:, :, :32].astype(int), got[:, :, 32:].astype(int)
    assert np.abs(left - right).max() > 0
    # power 0: the edit is the reconstruction
    same = ed.edit_images(photos[:2], change_power=0.0, pairs=True)
    np.testing.assert_array_equal(same[:, :, :32], same[:, :, 32:])


def test_inverter_checks(nets):
    ed = BatchEditor(GeneratorConfig(**CFG_KW), nets[0],
                     direction=_direction(), max_batch=2, device="cpu")
    assert not ed.has_inverter
    with pytest.raises(ValueError, match="no inverter"):
        ed.invert_images(np.zeros((1, 256, 256, 3), np.uint8))
    with pytest.raises(ValueError, match="64px"):
        ed.attach_inverter(_psp(nets, size=64))
    ed.attach_inverter(_psp(nets))
    assert ed.has_inverter and ed._inverter.decoder_params == {}
    with pytest.raises(ValueError, match="uint8"):
        ed.invert_images(np.zeros((1, 256, 256, 3), np.float32))


def test_warmup_inverts_every_bucket(nets):
    ed = _editor(nets, max_batch=4, pipeline_chunk=2)
    inverted, rendered = [], []
    invert, edit = ed.invert_images, ed.edit_styles

    def spy_invert(x):
        inverted.append(x.shape[0])
        return invert(x)

    def spy_edit(s, **kw):
        rendered.append(s.shape[0])
        return edit(s, **kw)

    ed.invert_images, ed.edit_styles = spy_invert, spy_edit
    ed.warmup()
    assert inverted == [1, 2, 4] and rendered == [1, 2]


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("coalesce_ms", [0.0, 3.0])
def test_http_edit_image(nets, coalesce_ms):
    ed = BatchEditor(GeneratorConfig(**CFG_KW), nets[0],
                     direction=_direction(), max_batch=2, device="cpu")
    server, service = build_server(ed, host="127.0.0.1", port=0,
                                   coalesce_ms=coalesce_ms)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    photo = np.random.RandomState(4).randint(0, 256, (300, 280, 3), np.uint8)

    def post(path="/edit_image", body=_png(photo)):
        return urllib.request.urlopen(urllib.request.Request(
            f"{base}{path}", data=body, method="POST",
            headers={"Content-Type": "image/png"}))

    def status(**kw):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(**kw)
        return e.value.code

    try:
        assert status() == 400  # no inverter yet
        ed.attach_inverter(_psp(nets))
        r = post("/edit_image?power=2.0&pairs=1&format=png")
        assert r.headers["Content-Type"] == "image/png"
        img = np.asarray(Image.open(io.BytesIO(r.read())))
        resized = np.asarray(Image.fromarray(photo).resize(
            (256, 256), Image.BICUBIC), np.uint8)
        np.testing.assert_array_equal(
            img, ed.edit_images(resized[None], pairs=True)[0])
        assert img.shape == (32, 64, 3)
        assert status(path="/elsewhere") == 404
        assert status(body=b"not an image") == 500
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/edit_image")
        conn.putheader("Content-Length", str(32 * 1024 * 1024 + 1))
        conn.endheaders()
        assert conn.getresponse().status == 400
        conn.close()
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["requests"] == 1 and stats["errors"] == 1
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    t.join(timeout=10)
    assert not t.is_alive()
