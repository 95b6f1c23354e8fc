"""One-command weights verification harness.

Runs every importer on the files given, renders from the generator,
compares the renders with a recorded set (--golden_renders), trains a
direction and holds it against a recorded one (--torch_direction, the
per-channel cosine acceptance metric), and computes a same-distribution
FID as a detector sanity check, writing a machine-readable report.

    python -m stylemc_torch verify \\
        --network ffhq.pkl --e4e e4e_ffhq_encode.pt \\
        --clip_dir /weights/clip --arcface model_ir_se50.pth \\
        --inception pt_inception-2015-12-05-6726825d.pth \\
        --deeplab deeplab_model.pth \\
        --torch_direction direction_from_reference_run.npz \\
        --report verify_report.json

Every section is optional: checks run for whatever paths are supplied, and
the report records requested/ok/error and seconds per check. The same
report keys, thresholds and exit codes as `stylemc_tpu`'s harness.

Exit code: 0 if every requested check passed, 1 otherwise.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict

import click
import numpy as np
import torch


def _check(report: Dict[str, Any], name: str, fn) -> None:
    t0 = time.time()
    entry: Dict[str, Any] = {"requested": True}
    try:
        details = fn() or {}
        entry["ok"] = bool(details.pop("_ok", True))
        entry["details"] = details
    except Exception as e:  # noqa: BLE001 — every failure belongs in the report
        import traceback
        traceback.print_exc(file=sys.stderr)
        entry["ok"] = False
        entry["error"] = f"{type(e).__name__}: {e}"
    entry["seconds"] = round(time.time() - t0, 2)
    report["checks"][name] = entry
    status = "OK " if entry["ok"] else "FAIL"
    print(f"[{status}] {name:18s} ({entry['seconds']:.1f}s)"
          + (f"  {entry.get('error', '')}" if not entry["ok"] else ""))


def _load_state(path: str):
    """A checkpoint's {name: array}: a flat state dict, or the reference's
    {'state_dict': {...}} wrapping of one."""
    from ..io import load_state_dict_numpy

    return load_state_dict_numpy(path) or load_state_dict_numpy(
        path, key="state_dict")


def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of a linear resize with half-pixel centres and,
    when shrinking, the triangle kernel widened by the scale (antialiased):
    the weights `jax.image.resize(..., "bilinear")` uses, computed in
    float32 as it computes them."""
    f = np.float32
    inv_scale = f(1) / (f(out_size) / f(in_size))
    kernel_scale = max(inv_scale, f(1))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) \
        / kernel_scale
    w = np.maximum(f(0), f(1) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1)), f(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0)).T.astype(f)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N, C, H, W] → [N, C, size, size], antialiased when shrinking."""
    if x.shape[-2:] == (size, size):
        return x
    ky = torch.from_numpy(_resize_matrix(x.shape[-2], size)).to(x)
    kx = torch.from_numpy(_resize_matrix(x.shape[-1], size)).to(x)
    return torch.matmul(torch.matmul(ky, x), kx.T)


@click.command()
@click.option("--network", type=str, default=None,
              help="NVIDIA persistence .pkl (or native .npz)")
@click.option("--tf_network", type=str, default=None,
              help="TF1 (dnnlib.tflib) legacy pickle: exercises the "
                   "io/tf_legacy.py conversion. With no --network, the "
                   "downstream checks run against this network instead.")
@click.option("--e4e", "e4e_path", type=str, default=None,
              help="e4e/pSp rosinality checkpoint .pt")
@click.option("--clip_dir", type=str, default=None,
              help="dir with OpenAI CLIP .pt files (ViT-B-32.pt, ViT-B-16.pt)")
@click.option("--arcface", "arcface_path", type=str, default=None,
              help="model_ir_se50.pth")
@click.option("--inception", "inception_path", type=str, default=None,
              help="pt_inception-2015-12-05 or torchvision inception .pth")
@click.option("--deeplab", "deeplab_path", type=str, default=None,
              help="deeplab_model.pth (CelebAMask face parsing)")
@click.option("--mobilenet", "mobilenet_path", type=str, default=None,
              help="mobilenet_224_model_best_gdconv_external.pth.tar")
@click.option("--golden_renders", type=str, default=None,
              help="npz with {images: uint8 [N,H,W,3], seeds, trunc} from "
                   "another framework's render of the SAME network: "
                   "enables the golden render comparison")
@click.option("--write_golden_renders", type=str, default=None,
              help="write this run's renders to an npz in the "
                   "golden_renders format (for cross-framework comparison)")
@click.option("--torch_direction", type=str, default=None,
              help="direction npz recorded from a reference find_direction "
                   "run: enables the direction cosine check (runs a full "
                   "direction optimization; needs CLIP and ArcFace)")
@click.option("--text_prompt", type=str,
              default="a photo of a face of a feminine woman with no makeup",
              help="prompt the torch_direction was trained with")
@click.option("--seeds", type=str, default="0-7", help="render seeds")
@click.option("--trunc", type=float, default=0.7)
@click.option("--fid_samples", type=int, default=64, show_default=True,
              help="generated samples per side for the FID sanity split")
@click.option("--direction_cosine_threshold", type=float, default=0.99,
              show_default=True, help="direction acceptance threshold")
@click.option("--psnr_threshold", type=float, default=30.0, show_default=True,
              help="golden render pass bound (uint8 PSNR, dB)")
@click.option("--report", "report_path", type=str,
              default="verify_report.json", show_default=True)
@click.option("--device", default="cuda", show_default=True)
def main(network, tf_network, e4e_path, clip_dir, arcface_path,
         inception_path, deeplab_path, mobilenet_path, golden_renders,
         write_golden_renders, torch_direction, text_prompt, seeds, trunc,
         fid_samples, direction_cosine_threshold, psnr_threshold,
         report_path, device):
    from ..convert import params_from_numpy
    from ..device import disable_tf32, resolve_device
    from ..edit import to_u8_nhwc
    from ..models.stylegan2.generator import mapping, synthesis, w_to_s
    from ..utils.misc import num_range
    from ..utils.profiling import count_params

    dev = resolve_device(device)
    disable_tf32(dev)

    def _parse_seeds(spec):
        return [s for part in spec.split(",") for s in num_range(part)]

    report: Dict[str, Any] = {"checks": {}, "argv": sys.argv[1:]}
    seed_list = _parse_seeds(seeds)
    state: Dict[str, Any] = {}

    @torch.inference_mode()
    def render(params, cfg, z):
        ws = mapping(params, cfg, z, truncation_psi=trunc)
        styles = w_to_s(params, cfg, ws)
        return styles, synthesis(params, cfg, styles, noise_mode="const")

    # ---------------------------------------------------------- generator
    def _generator_sanity(path, install):
        """Load + render sanity for any generator format `load_generator`
        accepts. install=True makes this the network the downstream checks
        (golden renders, e4e, FID, direction) run against."""
        from ..io import load_generator

        cfg, params = load_generator(path, device=dev)
        zs = np.concatenate(
            [np.random.RandomState(s).randn(1, cfg.z_dim)
             for s in seed_list]).astype(np.float32)
        styles, imgs = render(params, cfg, torch.from_numpy(zs).to(dev))
        imgs_u8 = to_u8_nhwc(imgs).cpu().numpy()
        renders_pm1 = imgs.float().cpu().numpy()
        if install:
            state["cfg"], state["params"] = cfg, params
            state["styles"] = styles.cpu().numpy()
            state["renders_u8"] = imgs_u8
            state["renders_pm1"] = renders_pm1
        finite = bool(np.isfinite(renders_pm1).all())
        spread = float(imgs_u8.astype(np.float32).std())
        # a real checkpoint renders structured images: every seed distinct
        # and non-constant
        distinct = len({imgs_u8[i].tobytes()
                        for i in range(imgs_u8.shape[0])})
        return {"resolution": cfg.img_resolution,
                "n_params": count_params(params),
                "finite": finite, "uint8_std": round(spread, 2),
                "distinct_renders": distinct,
                "_ok": finite and spread > 1.0
                and distinct == len(seed_list)}

    if network:
        _check(report, "generator",
               lambda: _generator_sanity(network, install=True))
    if tf_network:
        # the TF1 → ADA conversion; the active network only when no
        # --network was given
        _check(report, "tf_generator",
               lambda: _generator_sanity(tf_network, install=not network))

    # ------------------------------------------------------ golden renders
    if golden_renders and "renders_u8" in state:
        def golden_check():
            g = np.load(golden_renders)
            want = g["images"]
            got = state["renders_u8"][:want.shape[0]]
            if want.shape != got.shape:
                return {"_ok": False,
                        "shape_mismatch": [list(want.shape), list(got.shape)]}
            err = got.astype(np.float64) - want.astype(np.float64)
            mse = float(np.mean(np.square(err)))
            psnr = float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
            return {"psnr_db": round(psnr, 2),
                    "max_abs": int(np.abs(err).max()),
                    "threshold_db": psnr_threshold,
                    "_ok": psnr >= psnr_threshold}

        _check(report, "golden_renders", golden_check)
    if write_golden_renders and "renders_u8" in state:
        np.savez(write_golden_renders, images=state["renders_u8"],
                 seeds=np.asarray(seed_list), trunc=trunc)
        print(f"wrote renders to {write_golden_renders}")

    # ----------------------------------------------------------------- clip
    if clip_dir:
        def clip_check():
            from ..losses.clip_loss import make_text_direction
            from ..models.clip import tokenize
            from ..utils.model_zoo import load_clip_models

            models, tokenizer = load_clip_models(
                "double", allow_random_init=False, clip_dir=clip_dir,
                device=dev)
            state["clip_models"], state["tokenizer"] = models, tokenizer
            t_pos = tokenize([text_prompt], tokenizer=tokenizer)
            t_neg = tokenize(["a face"], tokenizer=tokenizer)
            details = {}
            with torch.inference_mode():
                for name, (ccfg, cparams) in models.items():
                    d = make_text_direction(cparams, ccfg, t_pos, t_neg)
                    n = float(torch.linalg.norm(d.float()))
                    details[name] = {"embed_dim": ccfg.embed_dim,
                                     "text_direction_norm": round(n, 4)}
            details["_ok"] = all(np.isfinite(v["text_direction_norm"])
                                 and v["text_direction_norm"] > 1e-4
                                 for v in details.values()
                                 if isinstance(v, dict))
            return details

        _check(report, "clip", clip_check)

    # -------------------------------------------------------------- arcface
    if arcface_path:
        def arcface_check():
            from ..losses.id_loss import extract_feats
            from ..utils.model_zoo import load_arcface

            arc = load_arcface(arcface_path, device=dev)
            state["arcface"] = arc
            det: Dict[str, Any] = {"loaded": True}
            if "renders_pm1" in state:
                # extract_feats resizes and face-crops internally and
                # returns L2-normalized features
                x = torch.from_numpy(state["renders_pm1"][:2]).to(dev)
                f = extract_feats(arc, x).float().cpu().numpy()
                cross = float(f[0] @ f[1])
                det.update(feat_dim=int(f.shape[1]),
                           finite=bool(np.isfinite(f).all()),
                           cross_seed_cosine=round(cross, 4))
                # a real ArcFace maps distinct identities far apart; a
                # near-1 cross-cosine is suspicious but is also what random
                # weights give, so it warns rather than fails the import
                det["warn_identity_collapse"] = bool(abs(cross) > 0.999)
                det["_ok"] = det["finite"]
            return det

        _check(report, "arcface", arcface_check)

    # ------------------------------------------------------------------ e4e
    if e4e_path:
        def e4e_check():
            from ..models.e4e.psp import load_psp_from_checkpoint

            size = state["cfg"].img_resolution if "cfg" in state else 1024
            psp = load_psp_from_checkpoint(e4e_path, stylegan_size=size,
                                           device=dev)
            state["psp"] = psp
            det: Dict[str, Any] = {
                "stylegan_size": psp.cfg.stylegan_size,
                "has_latent_avg": psp.latent_avg is not None}
            if "renders_pm1" in state:
                x = resize_bilinear(
                    torch.from_numpy(state["renders_pm1"][:2]).to(dev), 256)
                with torch.inference_mode():
                    codes = psp.encode(x).float().cpu().numpy()
                det.update(codes_shape=list(codes.shape),
                           codes_finite=bool(np.isfinite(codes).all()),
                           codes_std=round(float(codes.std()), 4))
                det["_ok"] = det["codes_finite"] and det["codes_std"] > 1e-4
            return det

        _check(report, "e4e", e4e_check)

    # ------------------------------------------------- inception + FID sanity
    if inception_path:
        def inception_check():
            from ..io import load_state_dict_numpy
            from ..metrics import inception as inc

            params = params_from_numpy(inc.params_from_torch_state(
                load_state_dict_numpy(inception_path)), dev)
            state["inception"] = params
            det: Dict[str, Any] = {"loaded": True}
            if "renders_u8" in state:
                with torch.inference_mode():
                    f = inc.inception_features(
                        params, state["renders_u8"][:4]).cpu().numpy()
                det.update(feat_dim=int(f.shape[1]),
                           finite=bool(np.isfinite(f).all()))
                det["_ok"] = det["finite"]
            return det

        _check(report, "inception", inception_check)

    if inception_path and network and "inception" in state:
        def fid_sanity():
            # two disjoint same-distribution generated batches → a small
            # FID; a broken detector import reads as a huge or non-finite one
            from ..metrics.feature_stats import FeatureStats
            from ..metrics.inception import inception_features
            from ..metrics.scores import fid_from_stats

            cfg, params = state["cfg"], state["params"]
            stats = [FeatureStats(capture_mean_cov=True,
                                  max_items=fid_samples) for _ in range(2)]
            bs = 16
            for side in range(2):
                rs = np.random.RandomState(1000 + side)
                done = 0
                while done < fid_samples:
                    z = rs.randn(bs, cfg.z_dim).astype(np.float32)
                    _, img = render(params, cfg, torch.from_numpy(z).to(dev))
                    with torch.inference_mode():
                        f = inception_features(state["inception"],
                                               to_u8_nhwc(img))
                    stats[side].append(f)
                    done += bs
            m0, c0 = stats[0].get_mean_cov()
            m1, c1 = stats[1].get_mean_cov()
            fid = float(fid_from_stats(m0, c0, m1, c1))
            return {"fid_same_distribution": round(fid, 3),
                    "samples_per_side": fid_samples,
                    # a small-sample FID of one distribution is noisy but
                    # bounded; 100+ signals a detector or import problem
                    "_ok": bool(np.isfinite(fid) and fid < 100.0)}

        _check(report, "fid_sanity", fid_sanity)

    # -------------------------------------------------------------- deeplab
    if deeplab_path:
        def deeplab_check():
            from ..models import deeplab as dl

            params = dl.params_from_torch_state(_load_state(deeplab_path))
            det: Dict[str, Any] = {"loaded": True}
            if "renders_u8" in state:
                seg = dl.Segmenter(params, device=dev).segment(
                    state["renders_u8"][0])
                det.update(classes_seen=int(len(np.unique(seg))),
                           max_class=int(seg.max()))
                det["_ok"] = bool(0 <= seg.min()
                                  and seg.max() < len(dl.CLASSES))
            return det

        _check(report, "deeplab", deeplab_check)

    # ------------------------------------------------------------ landmarks
    if mobilenet_path:
        def mobilenet_check():
            from ..io import strip_prefix
            from ..models import mobilenet as mb

            sd = _load_state(mobilenet_path)
            params = params_from_numpy(mb.params_from_torch_state(
                strip_prefix(sd, "module.")), dev)
            det: Dict[str, Any] = {"loaded": True}
            if "renders_pm1" in state:
                x = resize_bilinear(
                    torch.from_numpy(state["renders_pm1"][:1]).to(dev), 224)
                x01 = (x + 1.0) / 2.0
                mean = torch.tensor(mb.IMAGENET_MEAN,
                                    device=dev).reshape(1, 3, 1, 1)
                std = torch.tensor(mb.IMAGENET_STD,
                                   device=dev).reshape(1, 3, 1, 1)
                with torch.inference_mode():
                    lm = mb.mobilenet_gdconv_apply(
                        params, (x01 - mean) / std).float().cpu().numpy()
                det.update(landmarks_shape=list(lm.shape),
                           finite=bool(np.isfinite(lm).all()))
                det["_ok"] = det["finite"] and lm.shape[-1] == 136
            return det

        _check(report, "mobilenet_landmarks", mobilenet_check)

    # --------------------------------------- direction cosine vs torch run
    if torch_direction:
        def direction_check():
            if "clip_models" not in state or "arcface" not in state:
                raise RuntimeError(
                    "--torch_direction needs --clip_dir and --arcface "
                    "(the optimization uses both)")
            from ..train.find_direction import (FindDirectionConfig,
                                                find_direction)

            fdc = FindDirectionConfig(
                text_prompt=text_prompt,
                resolution=min(256, state["cfg"].img_resolution))
            d, info = find_direction(
                state["params"], state["cfg"], state["styles"],
                state["clip_models"], state["arcface"], fdc,
                tokenizer=state["tokenizer"])
            ours = d.float().cpu().numpy().reshape(26, 512)
            theirs = np.load(torch_direction)["s"].reshape(26, 512)
            cs = []
            for i in range(26):
                na, nb = np.linalg.norm(ours[i]), np.linalg.norm(theirs[i])
                if na > 1e-8 and nb > 1e-8:
                    cs.append(float(ours[i] @ theirs[i] / (na * nb)))
            mean_cos = float(np.mean(cs)) if cs else 0.0
            return {"cosine_mean": round(mean_cos, 4),
                    "cosine_min": round(min(cs), 4) if cs else None,
                    "steps": info["iterations"],
                    "threshold": direction_cosine_threshold,
                    "_ok": mean_cos >= direction_cosine_threshold}

        _check(report, "direction_vs_torch", direction_check)

    # ----------------------------------------------------------------- wrap
    requested = dict(report["checks"])
    report["all_ok"] = bool(requested) and all(
        v["ok"] for v in requested.values())
    report["n_checks"] = len(requested)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\n{sum(v['ok'] for v in requested.values())}/{len(requested)} "
          f"checks passed → {report_path}")
    sys.exit(0 if report["all_ok"] else 1)


if __name__ == "__main__":
    main()
