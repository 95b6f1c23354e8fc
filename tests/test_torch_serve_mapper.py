"""Serving with a latent mapper: the port's BatchEditor(mapper_params=)
against the JAX one, on the CPU, with JAX's generator and mapper weights
carried across. Renders agree within ±1 per uint8 (test_torch_serve.py's
tolerance); per-chunk mapper directions across a chunk boundary;
from_files(mapper=) and serve --mapper through the HTTP handler.
"""

import io
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.models import mapper as jmap
from stylemc_tpu.models.stylegan2.generator import (
    GeneratorConfig as JaxConfig, init_generator_params)
from stylemc_tpu.serve import BatchEditor as JaxEditor
from stylemc_torch.models import mapper as tmap
from stylemc_torch.models.stylegan2.generator import GeneratorConfig
from stylemc_torch.serve import BatchEditor
from torch_threads import one_torch_thread  # noqa: F401

CFG_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)
SLOPE = 0.05


@pytest.fixture(scope="module")
def weights():
    gp = init_generator_params(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))
    # small weights: an edit of a few tenths, so the renders stay in range
    mp = jax.tree_util.tree_map(
        lambda a: a * 0.1, jmap.init_mapper_params(jax.random.PRNGKey(6)))
    return gp, mp


def _within_one(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    from stylemc_torch.io import save_native

    gp, mp = weights
    root = tmp_path_factory.mktemp("serve_mapper")
    net, mapper = str(root / "net.npz"), str(root / "mapper_a_face.pth")
    save_native(net, GeneratorConfig(**CFG_KW), gp)
    torch.save({k: torch.from_numpy(v) for k, v in
                jmap.params_to_torch_state(mp).items()}, mapper)
    return net, mapper


def test_mapper_editor_matches_jax_across_chunks(weights):
    gp, mp = weights
    jed = JaxEditor(JaxConfig(**CFG_KW), gp, mapper_params=mp,
                    mapper_neg_slope=SLOPE, max_batch=4, pipeline_chunk=2)
    ted = BatchEditor(GeneratorConfig(**CFG_KW), gp,
                      mapper_params=jmap.params_to_torch_state(mp),
                      mapper_neg_slope=SLOPE, max_batch=4, pipeline_chunk=2,
                      device="cpu")
    assert isinstance(ted.mapper_params, tmap.Mapper)
    seeds = [1, 2, 3, 4, 5]  # chunks of 2, 2 and 1 (padded to 1)
    got = ted.edit_seeds(seeds, change_power=1.5, pairs=True)
    _within_one(got, jed.edit_seeds(seeds, change_power=1.5, pairs=True))
    assert got.shape == (5, 32, 64, 3)
    left, right = got[:, :, :32].astype(int), got[:, :, 32:].astype(int)
    assert np.abs(left - right).max() > 0
    # each chunk's directions come from its own styles: the same as one
    # chunk of all five
    whole = BatchEditor(GeneratorConfig(**CFG_KW), gp,
                        mapper_params=tmap.params_from_torch_state(
                            jmap.params_to_torch_state(mp), "cpu"),
                        mapper_neg_slope=SLOPE, max_batch=8,
                        pipeline_chunk=8, device="cpu")
    _within_one(whole.edit_seeds(seeds, change_power=1.5, pairs=True), got)
    # a named direction still wins over the mapper
    d = np.zeros((1, 26, 512), np.float32)
    d[:, 3, :64] = 0.4
    for ed in (jed, ted):
        ed.add_direction("d", d)
    _within_one(ted.edit_seeds([6], direction_name="d"),
                jed.edit_seeds([6], direction_name="d"))


def test_from_files_mapper_and_serve_cli(files, monkeypatch):
    from stylemc_torch.cli import serve as cli

    net, mapper = files
    ed = BatchEditor.from_files(net, mapper=mapper, mapper_neg_slope=SLOPE,
                                max_batch=2, device="cpu")
    want = tmap.load_mapper(mapper, device="cpu")
    for k, v in ed.mapper_params.state_dict().items():
        torch.testing.assert_close(v, want.state_dict()[k], rtol=0, atol=0)
    assert ed.direction is None

    # serve --mapper: the CLI builds its editor with the mapper; that
    # editor then answers GET /edit through the HTTP handler
    built = {}
    real_build = cli.build_server

    class _NoLoop:
        def serve_forever(self):
            pass

    def capture(editor, host, port, coalesce_ms=0.0, max_batch=64):
        built["editor"] = editor
        return _NoLoop(), None

    monkeypatch.setattr(cli, "build_server", capture)
    r = CliRunner().invoke(cli.main, ["--network", net, "--mapper", mapper,
                                      "--max_batch", "2", "--no-warmup",
                                      "--device", "cpu"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    editor = built["editor"]
    assert isinstance(editor.mapper_params, tmap.Mapper)
    server, service = real_build(editor, host="127.0.0.1", port=0,
                                 coalesce_ms=0.0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.server_address[1]}"
            "/edit?seeds=1-2&power=2.0&pairs=1&format=png").read()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    t.join(timeout=10)
    img = np.asarray(Image.open(io.BytesIO(body)))
    assert img.shape == (2 * 32, 64, 3)
    # the CLI's editor runs the default slope 0.01
    np.testing.assert_array_equal(
        img, np.concatenate(list(editor.edit_seeds([1, 2], change_power=2.0,
                                                   pairs=True))))
    jed = JaxEditor.from_files(net, mapper=mapper, max_batch=2)
    _within_one(img, np.concatenate(list(jed.edit_seeds(
        [1, 2], change_power=2.0, pairs=True))))
