"""Optimize a global S-space direction for a text prompt, or for a sweep of
prompts (counterpart of `stylemc_tpu/cli/find_direction.py`).

Same flags, defaults, console lines and output files as the JAX CLI:
{outdir}/direction_{prompt}.npz with key 's' (spaces in the prompt turned
into underscores), direction_last.npz every 1000 iterations, and the run log
wandb_log.jsonl. Runs on --device (cuda unless told otherwise).

Model weights: the generator comes from --network; CLIP weights resolve via
STYLEMC_CLIP_DIR (OpenAI .pt files), ArcFace via --arcface_weights or
STYLEMC_ARCFACE (model_ir_se50.pth). --allow_random_init substitutes random
weights from fixed seeds for missing perception models. The landmarks term
reads the MTCNN and MobileNet-GDConv weights from STYLEMC_MTCNN_DIR and
STYLEMC_MOBILENET; without them the logging-only metric reads 0, and
--landmarks_grad stops.

  python -m stylemc_torch.cli.find_direction --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face"
  python -m stylemc_torch.cli.find_direction --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompts "an old face|a \
      young face" --batch_prompts

--text_prompts writes one direction_<prompt>.npz per prompt (and
direction_last_<prompt>.npz every 1000 iterations with --batch_prompts);
--resume may then name a directory of them. --data_parallel (on by
default) splits each step's batch over the process's cards
(`data_mesh(max_size=batch_size)`), and a --batch_prompts sweep's prompts
and batch over them (`best_zoo_mesh`); on one card or the CPU it trains
as without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import click
import numpy as np


def _resolve_zoo_resume(resume, prompts):
    """Per-prompt resume directions for --batch_prompts.

    `resume` may be one .npz (every prompt resumes from it) or a directory:
    each prompt looks up direction_{tag}.npz, then direction_last_{tag}.npz
    (tag: the prompt with spaces as underscores); a prompt with no file
    starts fresh. None when nothing resolves."""
    if not resume:
        return None
    if os.path.isdir(resume):
        out = []
        for p in prompts:
            tag = p.replace(" ", "_")
            d = None
            for name in (f"direction_{tag}.npz", f"direction_last_{tag}.npz"):
                path = os.path.join(resume, name)
                if os.path.exists(path):
                    d = np.load(path)["s"].astype(np.float32)
                    print(f"Resuming {p!r} from {path}")
                    break
            out.append(d)
        return out if any(d is not None for d in out) else None
    d = np.load(resume)["s"].astype(np.float32)
    print(f"Resuming all {len(prompts)} prompts from {resume}")
    return [d] * len(prompts)


@click.command()
@click.option("--network", "network_pkl", required=True)
@click.option("--noise-mode", type=click.Choice(["const", "random", "none"]),
              default="const", show_default=True)
@click.option("--s_input", type=str, required=True)
@click.option("--outdir", type=str, required=True)
@click.option("--text_prompt", type=str, required=True,
              default="a photo of a face of a feminine woman with no makeup")
@click.option("--text_prompts", type=str, default=None,
              help="'|'-separated prompt sweep over one precompute "
                   "(DirectionEngine); one direction_<prompt>.npz per "
                   "prompt. Overrides --text_prompt.")
@click.option("--batch_prompts/--no-batch_prompts", default=False,
              show_default=True,
              help="With --text_prompts: train all prompts at once, the "
                   "prompt axis folded into the image batch (P x "
                   "batch_size images a step)")
@click.option("--negative_text_prompt", type=str, required=False,
              default="a photo of a face of a masculine man")
@click.option("--negative_text_prompts", type=str, default=None,
              help="With --text_prompts: '|'-separated per-prompt negative "
                   "anchors (as many as the prompts). Default: "
                   "--negative_text_prompt for every prompt.")
@click.option("--clip_type", type=str, default="double", show_default=True)
@click.option("--clip_loss_type", type=str, default="default", show_default=True)
@click.option("--resolution", type=int, default=256, show_default=True)
@click.option("--batch_size", type=int, default=4, show_default=True)
@click.option("--learning_rate", type=float, default=1.5, show_default=True)
@click.option("--n_epochs", type=int, default=4, show_default=True)
@click.option("--resume", type=str, default=None)
@click.option("--identity_loss_coef", type=float, default=0.6, show_default=True)
@click.option("--landmarks_loss_coef", type=float, default=25.0, show_default=True)
@click.option("--landmarks_grad", is_flag=True, default=False,
              help="Backpropagate the landmarks loss (MTCNN boxes found "
                   "once, a differentiable crop and MobileNet in the step); "
                   "by default the term is logging-only, as in the "
                   "reference. Needs the MTCNN and MobileNet weights.")
@click.option("--l2_reg_coef", type=float, default=0.1, show_default=True)
@click.option("--clip_loss_coef", type=float, default=1.0, show_default=True)
@click.option("--arcface_weights", type=str, default=None)
@click.option("--allow_random_init", is_flag=True, default=False,
              help="Random-init missing perception weights (smoke test only)")
@click.option("--data_parallel/--no-data_parallel", default=True,
              help="Shard each step's batch over all local CUDA devices "
                   "(1-axis data mesh); a --batch_prompts sweep shards "
                   "prompts, then batches")
@click.option("--split_step", is_flag=True, default=False,
              help="Accepted; the same per-step loop and numbers")
@click.option("--bf16", is_flag=True, default=False,
              help="bfloat16 synthesis on the top num_fp16_res blocks")
@click.option("--perception_bf16", is_flag=True, default=False,
              help="Run CLIP/ArcFace in bfloat16")
@click.option("--remat", is_flag=True, default=False,
              help="Recompute synthesis blocks in the backward pass "
                   "(torch.utils.checkpoint); same numbers")
@click.option("--steps_per_dispatch", type=str, default="1",
              show_default=True,
              help="Accepted (an integer or 'epoch'); the same per-step "
                   "loop and numbers")
@click.option("--trace_dir", type=str, default=None,
              help="Write a torch.profiler trace of the optimization "
                   "(Chrome trace JSON) into this directory")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, noise_mode, s_input, outdir, text_prompt, text_prompts,
         batch_prompts, negative_text_prompt, negative_text_prompts,
         clip_type, clip_loss_type, resolution,
         batch_size, learning_rate, n_epochs, resume, identity_loss_coef,
         landmarks_loss_coef, landmarks_grad, l2_reg_coef, clip_loss_coef,
         arcface_weights, allow_random_init, data_parallel, split_step, bf16,
         perception_bf16, remat, steps_per_dispatch, trace_dir, device):
    if negative_text_prompts and not text_prompts:
        raise click.BadParameter(
            "--negative_text_prompts requires --text_prompts")
    if negative_text_prompts and len(negative_text_prompts.split("|")) != \
            len(text_prompts.split("|")):
        raise click.BadParameter(
            "--negative_text_prompts count must match --text_prompts")
    if text_prompts and landmarks_grad:
        raise click.BadParameter(
            "--landmarks_grad is not supported with --text_prompts (the "
            "prompt-sweep DirectionEngine has no in-graph landmarks loss); "
            "run find_direction per prompt instead")
    if resume and os.path.isdir(resume) and not (text_prompts and
                                                 batch_prompts):
        raise click.BadParameter(
            "--resume as a directory (per-prompt direction_<tag>.npz "
            "lookup) requires --text_prompts --batch_prompts; pass a "
            "single .npz otherwise")
    if steps_per_dispatch != "epoch":
        try:
            steps_per_dispatch = int(steps_per_dispatch)
        except ValueError:
            raise click.BadParameter(
                "--steps_per_dispatch must be an integer or 'epoch'")

    from ..device import resolve_device
    from ..io import load_generator
    from ..parallel.mesh import cli_mesh
    from ..train.find_direction import FindDirectionConfig, find_direction
    from ..utils.logging import RunLogger
    from ..utils.model_zoo import load_arcface, load_clip_models
    from ..utils.profiling import trace

    dev = resolve_device(device)
    logger = RunLogger("stylegan2_latent_mapper", config=dict(
        text_prompt=text_prompt, negative_text_prompt=negative_text_prompt,
        resolution=resolution, batch_size=batch_size,
        learning_rate=learning_rate, n_epochs=n_epochs), outdir=outdir)

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=dev)
    if bf16 or remat:
        cfg = dataclasses.replace(
            cfg, remat=remat,
            low_precision_dtype="bfloat16" if bf16 else cfg.low_precision_dtype)
    os.makedirs(outdir, exist_ok=True)

    fdc = FindDirectionConfig(
        text_prompt=text_prompt, negative_text_prompt=negative_text_prompt,
        resolution=resolution, batch_size=batch_size,
        learning_rate=learning_rate, n_epochs=n_epochs,
        identity_loss_coef=identity_loss_coef,
        landmarks_loss_coef=landmarks_loss_coef,
        landmarks_in_graph=landmarks_grad,
        l2_reg_coef=l2_reg_coef, clip_loss_coef=clip_loss_coef,
        clip_type=clip_type, clip_loss_type=clip_loss_type,
        noise_mode=noise_mode, split_step=split_step,
        perception_dtype="bfloat16" if perception_bf16 else "float32",
        steps_per_dispatch=1 if steps_per_dispatch == "epoch"
        else steps_per_dispatch)

    clip_models, tokenizer = load_clip_models(
        fdc.clip_type, allow_random_init=allow_random_init, device=dev)
    arcface_params = load_arcface(arcface_weights,
                                  allow_random_init=allow_random_init,
                                  device=dev)

    styles_array = np.load(s_input)["s"].astype(np.float32)
    if steps_per_dispatch == "epoch":
        print(f"steps_per_dispatch=epoch -> "
              f"{math.ceil(styles_array.shape[0] / batch_size)} steps per "
              "dispatch")

    resume_direction = None
    if resume and not os.path.isdir(resume):
        resume_direction = np.load(resume)["s"].astype(np.float32)
        print(f"Loaded direction from {resume}")

    prompt_tag = text_prompt.replace(" ", "_")
    t1 = time.time()

    def callback(it, loss, aux, lr, grad_norm, direction):
        logger.log({"loss": loss, "lr": lr, "grad_norm": grad_norm, **aux},
                   step=it)
        print(f"Iteration {it}, gradient norm: {grad_norm:.4f}, lr {lr:.4f}")
        print(f"Total loss: {loss:.4f}, clip loss: {aux['clip_loss']:.4f}, "
              f"identity loss: {aux['identity_loss']:.4f}, "
              f"landmarks loss: {aux.get('landmarks_loss', 0.0):.4f}, "
              f"l2 loss: {aux['l2_loss']:.4f}")
        if it % 1000 == 990:
            np.savez(f"{outdir}/direction_last.npz", s=np.asarray(direction))

    # landmarks: the logging-only metric (no gradient, as in the
    # reference) or, with --landmarks_grad, the in-graph loss
    landmarks_metric_fn = None
    landmarker = None
    if text_prompts and landmarks_loss_coef != 0:
        print("note: the landmarks metric is not computed on the "
              "--text_prompts sweep path (it is logging-only and carries "
              "no gradient; see --landmarks_grad)")
    elif landmarks_loss_coef != 0:
        from ..cv.landmarks import default_landmarker
        from ..train.find_direction import make_landmarks_metric_fn

        try:
            landmarker = default_landmarker(device=dev)
            if not landmarks_grad:
                landmarks_metric_fn = make_landmarks_metric_fn(
                    params, cfg, fdc, landmarker)
        except FileNotFoundError:
            if landmarks_grad:
                raise
            print("landmark model weights unavailable — landmarks metric "
                  "reported as 0 (it carries no gradient either way)")

    tracing = (trace(trace_dir, "find_direction_trace.json", dev)
               if trace_dir else contextlib.nullcontext())
    with tracing:
        if text_prompts:
            _sweep(params, cfg, styles_array, clip_models, arcface_params,
                   fdc, tokenizer, text_prompts, negative_text_prompts,
                   batch_prompts, resume, resume_direction, outdir, logger,
                   data_parallel, dev)
        else:
            mesh = cli_mesh(data_parallel, batch_size, dev)
            if mesh is not None:
                print(f"data-parallel training over {mesh.size} devices")
            direction, info = find_direction(
                params, cfg, styles_array, clip_models, arcface_params, fdc,
                tokenizer=tokenizer, mesh=mesh,
                resume_direction=resume_direction,
                callback=callback, landmarks_metric_fn=landmarks_metric_fn,
                landmarker=landmarker if landmarks_grad else None)
    if text_prompts:
        print("time passed:", time.time() - t1)
        logger.finish()
        return

    np.savez(f"{outdir}/direction_{prompt_tag}.npz",
             s=direction.cpu().numpy().astype(np.float32))
    steady = info.get("steady_ms_per_step")
    if steady:
        print(f"steady step time: {steady:.0f} ms/step "
              f"(first step {info['first_step_time']:.1f} s: kernel builds "
              "and library set-up)")
    print("time passed:", time.time() - t1)
    logger.finish()


def _sweep(params, cfg, styles_array, clip_models, arcface_params, fdc,
           tokenizer, text_prompts, negative_text_prompts, batch_prompts,
           resume, resume_direction, outdir, logger, data_parallel, dev):
    """--text_prompts: every prompt over one DirectionEngine, at once
    (--batch_prompts, over `best_zoo_mesh` with --data_parallel) or one
    after another; a direction_<tag>.npz each."""
    from ..parallel.mesh import cli_zoo_mesh
    from ..train.find_direction import DirectionEngine

    engine = DirectionEngine(params, cfg, styles_array, clip_models,
                             arcface_params, fdc, tokenizer=tokenizer)
    prompts = [p.strip() for p in text_prompts.split("|")]
    negatives = [p.strip() for p in negative_text_prompts.split("|")] \
        if negative_text_prompts else None
    tags = [p.replace(" ", "_") for p in prompts]

    def save(name, direction):
        np.savez(os.path.join(outdir, name),
                 s=np.asarray(direction, np.float32))

    if batch_prompts:
        def zoo_callback(it, losses, auxs, lr, dirs):
            logger.log({"loss_mean": float(np.mean(losses)), "lr": lr},
                       step=it)
            if it % 1000 == 990:
                for tag, d in zip(tags, dirs):
                    save(f"direction_last_{tag}.npz", d)

        bmesh = cli_zoo_mesh(data_parallel, len(prompts), fdc.batch_size,
                             dev)
        directions, info = engine.optimize_batch(
            prompts, negative_text_prompts=negatives, mesh=bmesh,
            resume_directions=_resolve_zoo_resume(resume, prompts),
            callback=zoo_callback)
        for tag, d in zip(tags, directions.cpu().numpy()):
            save(f"direction_{tag}.npz", d)
        steady = info.get("steady_ms_per_step")
        print(f"{len(prompts)} prompts in one batched run: "
              f"{info['time']:.1f} s"
              + (f" ({steady:.0f} ms/step steady)" if steady else "")
              + (f", mesh {bmesh.shape}" if bmesh is not None else ""))
        return
    for i, (prompt, tag) in enumerate(zip(prompts, tags)):
        tp = time.time()
        direction, info = engine.optimize(
            prompt, negative_text_prompt=negatives[i] if negatives else None,
            resume_direction=resume_direction)
        save(f"direction_{tag}.npz", direction.cpu().numpy())
        steady = info.get("steady_ms_per_step")
        print(f"{prompt!r}: {time.time() - tp:.1f} s"
              + (f" ({steady:.0f} ms/step steady)" if steady else ""))


if __name__ == "__main__":
    main()
