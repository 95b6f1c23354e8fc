"""Optimize a global S-space direction for a text prompt (counterpart of
`stylemc_tpu/cli/find_direction.py`, single-prompt path).

Same flags, defaults, console lines and output files as the JAX CLI:
{outdir}/direction_{prompt}.npz with key 's' (spaces in the prompt turned
into underscores), direction_last.npz every 1000 iterations, and the run log
wandb_log.jsonl. Runs on --device (cuda unless told otherwise).

Model weights: the generator comes from --network; CLIP weights resolve via
STYLEMC_CLIP_DIR (OpenAI .pt files), ArcFace via --arcface_weights or
STYLEMC_ARCFACE (model_ir_se50.pth). --allow_random_init substitutes random
weights from fixed seeds for missing perception models.

  python -m stylemc_torch.cli.find_direction --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face"

Not ported yet: --text_prompts (the prompt-sweep engine, ROADMAP A10) and
--landmarks_grad (ROADMAP A11) are refused; --data_parallel runs on one
card (multi-GPU training is ROADMAP A17).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import click
import numpy as np


@click.command()
@click.option("--network", "network_pkl", required=True)
@click.option("--noise-mode", type=click.Choice(["const", "random", "none"]),
              default="const", show_default=True)
@click.option("--s_input", type=str, required=True)
@click.option("--outdir", type=str, required=True)
@click.option("--text_prompt", type=str, required=True,
              default="a photo of a face of a feminine woman with no makeup")
@click.option("--text_prompts", type=str, default=None,
              help="'|'-separated prompt sweep (not ported yet: ROADMAP A10)")
@click.option("--batch_prompts/--no-batch_prompts", default=False,
              show_default=True,
              help="With --text_prompts (not ported yet: ROADMAP A10)")
@click.option("--negative_text_prompt", type=str, required=False,
              default="a photo of a face of a masculine man")
@click.option("--negative_text_prompts", type=str, default=None,
              help="With --text_prompts (not ported yet: ROADMAP A10)")
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
              help="Backpropagate the landmarks loss (not ported yet: "
                   "ROADMAP A11)")
@click.option("--l2_reg_coef", type=float, default=0.1, show_default=True)
@click.option("--clip_loss_coef", type=float, default=1.0, show_default=True)
@click.option("--arcface_weights", type=str, default=None)
@click.option("--allow_random_init", is_flag=True, default=False,
              help="Random-init missing perception weights (smoke test only)")
@click.option("--data_parallel/--no-data_parallel", default=True,
              help="Accepted; training runs on one card (multi-GPU is "
                   "ROADMAP A17)")
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
    if text_prompts or negative_text_prompts or batch_prompts:
        raise click.BadParameter(
            "--text_prompts / --negative_text_prompts / --batch_prompts: the "
            "prompt-sweep engine is not ported yet (ROADMAP A10); run one "
            "--text_prompt per call")
    if landmarks_grad:
        raise click.BadParameter(
            "--landmarks_grad: the differentiable landmarks loss is not "
            "ported yet (ROADMAP A11)")
    if resume and os.path.isdir(resume):
        raise click.BadParameter(
            "--resume as a directory requires --text_prompts "
            "--batch_prompts (not ported yet: ROADMAP A10); pass a single "
            ".npz")
    if steps_per_dispatch != "epoch":
        try:
            steps_per_dispatch = int(steps_per_dispatch)
        except ValueError:
            raise click.BadParameter(
                "--steps_per_dispatch must be an integer or 'epoch'")

    from ..device import resolve_device
    from ..io import load_generator
    from ..train.find_direction import FindDirectionConfig, find_direction
    from ..utils.logging import RunLogger
    from ..utils.model_zoo import load_arcface, load_clip_models

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
    if resume:
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

    if landmarks_loss_coef != 0:
        # the landmarks stack is not ported (ROADMAP A11); its metric is
        # logging-only and carries no gradient, so Δs is the same
        print("landmark model weights unavailable — landmarks metric "
              "reported as 0 (it carries no gradient either way)")

    tracing = contextlib.nullcontext()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        tracing = profile(activities=activities)
    with tracing:
        direction, info = find_direction(
            params, cfg, styles_array, clip_models, arcface_params, fdc,
            tokenizer=tokenizer, resume_direction=resume_direction,
            callback=callback)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        tracing.export_chrome_trace(
            os.path.join(trace_dir, "find_direction_trace.json"))

    np.savez(f"{outdir}/direction_{prompt_tag}.npz",
             s=direction.cpu().numpy().astype(np.float32))
    steady = info.get("steady_ms_per_step")
    if steady:
        print(f"steady step time: {steady:.0f} ms/step "
              f"(first step {info['first_step_time']:.1f} s: kernel builds "
              "and library set-up)")
    print("time passed:", time.time() - t1)
    logger.finish()


if __name__ == "__main__":
    main()
