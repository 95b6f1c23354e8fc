"""The torch BatchEditor and HTTP front end against the JAX ones, on the CPU.

Same JAX-initialised weights, same seeds and directions: uint8 renders agree
within ±1 (fp32 summation order can move a value across a rounding edge).
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from stylemc_tpu.models.stylegan2.generator import (
    GeneratorConfig as JaxConfig, init_generator_params)
from stylemc_tpu.serve import BatchEditor as JaxEditor
from stylemc_torch.models.stylegan2.generator import (GeneratorConfig,
                                                      N_STYLE_CHANNELS,
                                                      synthesis)
from stylemc_torch.ops import conv2d_resample
from stylemc_torch.serve import BatchEditor, CoalescingDispatcher
from torch_threads import one_torch_thread  # noqa: F401

CFG_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)


def _direction(row=2, value=0.5):
    d = np.zeros((1, N_STYLE_CHANNELS, 512), np.float32)
    d[:, row, :64] = value
    return d


@pytest.fixture(scope="module")
def jax_params():
    return init_generator_params(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))


def _editor(jax_params, **kw):
    kw.setdefault("max_batch", 4)
    return BatchEditor(GeneratorConfig(**CFG_KW), jax_params,
                       direction=_direction(), device="cpu", **kw)


def _within_one(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_edit_seeds_pairs_and_named_direction_match_jax(jax_params):
    jed = JaxEditor(JaxConfig(**CFG_KW), jax_params, direction=_direction(),
                    max_batch=4)
    ted = _editor(jax_params)
    for ed in (jed, ted):
        ed.add_direction("eyes", _direction(row=5, value=-0.8))
    np.testing.assert_allclose(
        ted.styles_from_seeds([1, 2, 3]).numpy(),
        np.asarray(jed.styles_from_seeds([1, 2, 3])), rtol=1e-5, atol=1e-4)
    want = jed.edit_seeds([1, 2, 3], change_power=2.0, pairs=True)
    got = ted.edit_seeds([1, 2, 3], change_power=2.0, pairs=True)
    assert got.shape == (3, 32, 64, 3)
    _within_one(got, want)
    left, right = got[:, :, :32].astype(int), got[:, :, 32:].astype(int)
    assert np.abs(left - right).max() > 0
    _within_one(ted.edit_seeds([4], change_power=1.5, direction_name="eyes"),
                jed.edit_seeds([4], change_power=1.5, direction_name="eyes"))


def test_precision_variants_match_jax_loosely(jax_params):
    for precision in ("bf16-upper", "bf16"):
        jed = JaxEditor(JaxConfig(**CFG_KW), jax_params,
                        direction=_direction(), max_batch=2,
                        precision=precision)
        got = _editor(jax_params, max_batch=2, precision=precision
                      ).edit_seeds([1, 2], change_power=1.0)
        want = jed.edit_seeds([1, 2], change_power=1.0)
        # bf16 rounds at other places in the two frameworks
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 8
    with pytest.raises(ValueError):
        _editor(jax_params, precision="fp8")


def test_zero_power_identity_and_bucketing(jax_params):
    ed = _editor(jax_params)
    out = ed.edit_seeds([5], change_power=0.0, pairs=True)
    np.testing.assert_array_equal(out[0, :, :32], out[0, :, 32:])
    styles = ed.styles_from_seeds([1, 2, 3, 4, 5])
    all_at_once = ed.edit_styles(styles, change_power=1.0)
    one_by_one = np.concatenate([ed.edit_styles(styles[i:i + 1],
                                                change_power=1.0)
                                 for i in range(5)])
    _within_one(all_at_once, one_by_one)
    assert ed._bucket(3) == 4 and ed._bucket(9) == 4 and ed._bucket(1) == 1


def test_editor_renders_through_polyphase_up_convs(jax_params):
    ed = _editor(jax_params)
    counts = conv2d_resample.up_convs
    before = dict(counts)
    ed.edit_seeds([1, 2, 3], change_power=2.0)   # one bucket-4 call
    assert counts["pad_dilate"] == before["pad_dilate"]
    assert counts["polyphase"] - before["polyphase"] == \
        len(ed.cfg.block_resolutions) - 1         # one conv0 a block
    styles = ed.styles_from_seeds([1, 2, 3]) + 2.0 * ed.direction
    pad_cfg = dataclasses.replace(ed.cfg, up_conv_impl="pad_dilate")
    with torch.inference_mode():
        got = synthesis(ed.params, ed.cfg, styles)
        want = synthesis(ed.params, pad_cfg, styles)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_pipeline_chunks_match_one_shot(jax_params):
    styles = _editor(jax_params).styles_from_seeds(list(range(7)))
    one_shot = _editor(jax_params, max_batch=8, pipeline_chunk=0
                       ).edit_styles(styles, pairs=True)
    chunked = _editor(jax_params, max_batch=8, pipeline_chunk=2)
    chunked.max_inflight_chunks = 1
    _within_one(chunked.edit_styles(styles, pairs=True), one_shot)


def test_unknown_or_missing_direction_raises(jax_params):
    ed = _editor(jax_params)
    with pytest.raises(KeyError):
        ed.edit_seeds([1], direction_name="nope")
    bare = BatchEditor(GeneratorConfig(**CFG_KW), jax_params, max_batch=2,
                       device="cpu")
    with pytest.raises(ValueError):
        bare.edit_seeds([1])


def test_warmup_covers_padded_bucket_of_pipeline_chunk(jax_params):
    ed = _editor(jax_params, max_batch=64, pipeline_chunk=24)
    warmed = []
    orig = ed.edit_styles

    def spy(styles, **kw):
        warmed.append(styles.shape[0])
        return orig(styles, **kw)

    ed.edit_styles = spy
    ed.warmup()
    assert max(warmed) == 32, warmed  # chunk 24 pads to bucket 32
    assert 64 not in warmed


def test_from_files_native_npz(jax_params, tmp_path):
    from stylemc_torch.io import save_native

    net = str(tmp_path / "net.npz")
    save_native(net, GeneratorConfig(**CFG_KW), jax_params)
    dpath = str(tmp_path / "d.npz")
    np.savez(dpath, s=_direction())
    ed = BatchEditor.from_files(net, direction=dpath,
                                directions={"d0": dpath}, max_batch=2,
                                device="cpu")
    assert sorted(ed.directions) == ["d0"]
    np.testing.assert_array_equal(ed.edit_seeds([3], direction_name="d0"),
                                  ed.edit_seeds([3]))


@pytest.mark.parametrize("coalesce_ms", [0.0, 3.0])
def test_http_server_endpoints(jax_params, coalesce_ms):
    from PIL import Image

    from stylemc_torch.cli.serve import _parse_seeds, build_server

    assert _parse_seeds("1-3,7") == [1, 2, 3, 7]
    ed = _editor(jax_params)
    ed.add_direction("d0", _direction(row=3))
    server, service = build_server(ed, host="127.0.0.1", port=0,
                                   coalesce_ms=coalesce_ms)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
        assert json.loads(urllib.request.urlopen(
            f"{base}/directions").read()) == ["d0"]
        r = urllib.request.urlopen(
            f"{base}/edit?seeds=1-2&power=2.0&pairs=1&format=png")
        assert r.headers["Content-Type"] == "image/png"
        img = np.asarray(Image.open(io.BytesIO(r.read())))
        assert img.shape == (2 * 32, 64, 3)
        np.testing.assert_array_equal(
            img, np.concatenate(list(ed.edit_seeds([1, 2], pairs=True))))
        r = urllib.request.urlopen(f"{base}/edit?seeds=3&direction=d0")
        assert np.asarray(Image.open(io.BytesIO(r.read()))).shape == \
            (32, 32, 3)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["requests"] == 2 and "p50_ms" in stats
        # the queue wait is the dispatcher's share of each request's time
        assert ("queue_wait_p50_ms" in stats) == (coalesce_ms > 0)
        if coalesce_ms > 0:
            assert 0 <= stats["queue_wait_p50_ms"] <= \
                stats["queue_wait_p99_ms"] <= stats["p99_ms"]
            assert stats["batched_calls"] == 2
        for bad in ("seeds=notanumber", "seeds=1&direction=nope"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/edit?{bad}")
            assert e.value.code in (400, 500)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nothing")
        assert e.value.code == 404
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_coalescing_dispatcher_merges_and_splits():
    calls = []

    def fn(rows):
        calls.append(rows.shape[0])
        return rows * 10

    disp = CoalescingDispatcher(max_batch=64, max_wait_ms=200.0)
    results = {}

    def submit(i):
        results[i] = disp.submit("k", np.array([i, i + 100]), fn)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    disp.close()
    assert sum(calls) == 8 and len(calls) < 4
    for i in range(4):
        np.testing.assert_array_equal(results[i], [10 * i, 10 * (i + 100)])
    assert disp.coalesced_items == 4

    def boom(rows):
        raise RuntimeError("device fault")

    disp = CoalescingDispatcher(max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="device fault"):
        disp.submit("k", np.zeros(1), boom)
    disp.close()


def test_editor_never_runs_on_cpu_unasked(jax_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchEditor(GeneratorConfig(**CFG_KW), jax_params)
