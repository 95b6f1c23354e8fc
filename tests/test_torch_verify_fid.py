"""The verify harness's Inception check and FID split, the port's against
the JAX package's, on seeded files written as `test_torch_verify.py`
writes them (a file of its own: each package's FID spends ~10 s in scipy's
sqrtm at 2048 features)."""

import pytest

from test_torch_verify import RES, _compare_reports, _run, write_files
from stylemc_tpu.cli.verify_weights import main as jax_verify
from stylemc_torch.cli.verify_weights import main as torch_verify
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(str(tmp_path_factory.mktemp("verify_fid")),
                       ("inception",))


def test_inception_and_fid_split_match_jax(files):
    args = ["--network", files["network"], "--inception", files["inception"],
            "--seeds", "0-3", "--fid_samples", "8"]
    jr, jrep = _run(jax_verify, files, "jax_fid.json", args, device=False)
    tr, trep = _run(torch_verify, files, "torch_fid.json", args)
    assert tr.exit_code == jr.exit_code == 0, (tr.output, jr.output)
    assert list(trep["checks"]) == ["generator", "inception", "fid_sanity"]
    assert trep["checks"]["inception"]["details"]["feat_dim"] == 2048
    assert trep["checks"]["fid_sanity"]["details"]["samples_per_side"] == 8
    assert RES == trep["checks"]["generator"]["details"]["resolution"]
    _compare_reports(trep, jrep)
