"""Train a latent mapper for a text prompt (counterpart of
`stylemc_tpu/cli/train_latent_mapper.py`).

Same flags, defaults, console lines and output files as the JAX CLI:
{outdir}/mapper_{prompt}.pth (a torch state dict of CPU tensors with the
reference's names; spaces in the prompt turned into underscores),
mapper_last.pth at iterations 990, 1990, ..., and the run log
wandb_log.jsonl. Runs on --device (cuda unless told otherwise);
--data_parallel (on by default) splits each step's batch over the
process's cards (`data_mesh(max_size=batch_size)`); on one card or the
CPU it trains as without it.

  python -m stylemc_torch.cli.train_latent_mapper --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face"
"""

from __future__ import annotations

import dataclasses
import os
import time

import click
import numpy as np


@click.command()
@click.option("--network", "network_pkl", required=True)
@click.option("--network2", "network2_pkl", required=False, default=None)
@click.option("--noise-mode", type=click.Choice(["const", "random", "none"]),
              default="const", show_default=True)
@click.option("--s_input", type=str, required=True)
@click.option("--outdir", type=str, required=True)
@click.option("--text_prompt", type=str, required=True,
              default="a photo of a face of a feminine woman with no makeup")
@click.option("--negative_text_prompt", type=str, required=False,
              default="a photo of a face of a masculine man")
@click.option("--clip_type", type=str, default="double", show_default=True)
@click.option("--clip_loss_type", type=str, default="default", show_default=True)
@click.option("--resolution", type=int, default=512, show_default=True)
@click.option("--batch_size", type=int, default=2, show_default=True)
@click.option("--learning_rate", type=float, default=0.0005, show_default=True)
@click.option("--n_epochs", type=int, default=10, show_default=True)
@click.option("--resume", type=str, default=None)
@click.option("--mapper_neg_slope", type=float, default=0.01, show_default=True)
@click.option("--identity_loss_coef", type=float, default=0.3, show_default=True)
@click.option("--landmarks_loss_coef", type=float, default=0.0, show_default=True)
@click.option("--l2_reg_coef", type=float, default=0.8, show_default=True)
@click.option("--clip_loss_coef", type=float, default=2.0, show_default=True)
@click.option("--arcface_weights", type=str, default=None)
@click.option("--allow_random_init", is_flag=True, default=False)
@click.option("--data_parallel/--no-data_parallel", default=True,
              help="Shard each step's batch over all local CUDA devices "
                   "(1-axis data mesh)")
@click.option("--bf16", is_flag=True, default=False,
              help="bfloat16 synthesis on the top num_fp16_res blocks")
@click.option("--remat", is_flag=True, default=False,
              help="Recompute synthesis blocks in the backward pass "
                   "(torch.utils.checkpoint); the mapper default renders "
                   "512 px, where activation memory dominates")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, network2_pkl, noise_mode, s_input, outdir, text_prompt,
         negative_text_prompt, clip_type, clip_loss_type, resolution,
         batch_size, learning_rate, n_epochs, resume, mapper_neg_slope,
         identity_loss_coef, landmarks_loss_coef, l2_reg_coef, clip_loss_coef,
         arcface_weights, allow_random_init, data_parallel, bf16, remat,
         device):
    from ..device import resolve_device
    from ..io import load_generator
    from ..models.mapper import load_mapper, save_mapper
    from ..parallel.mesh import cli_mesh
    from ..train.latent_mapper import MapperTrainConfig, train_latent_mapper
    from ..utils.logging import RunLogger
    from ..utils.model_zoo import load_arcface, load_clip_models

    dev = resolve_device(device)
    logger = RunLogger("stylegan2_latent_mapper", config=dict(
        text_prompt=text_prompt, negative_text_prompt=negative_text_prompt,
        resolution=resolution, batch_size=batch_size,
        learning_rate=learning_rate, n_epochs=n_epochs), outdir=outdir)

    def with_policy(cfg):
        if not (bf16 or remat):
            return cfg
        return dataclasses.replace(
            cfg, remat=remat,
            low_precision_dtype="bfloat16" if bf16 else cfg.low_precision_dtype)

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=dev)
    cfg = with_policy(cfg)
    gen2 = None
    if network2_pkl and network2_pkl != network_pkl:
        print("using 2 generators")
        cfg2, params2 = load_generator(network2_pkl, device=dev)
        gen2 = (params2, with_policy(cfg2))
    os.makedirs(outdir, exist_ok=True)

    mtc = MapperTrainConfig(
        text_prompt=text_prompt, negative_text_prompt=negative_text_prompt,
        resolution=resolution, batch_size=batch_size,
        learning_rate=learning_rate, n_epochs=n_epochs,
        identity_loss_coef=identity_loss_coef,
        landmarks_loss_coef=landmarks_loss_coef,
        l2_reg_coef=l2_reg_coef, clip_loss_coef=clip_loss_coef,
        clip_type=clip_type, clip_loss_type=clip_loss_type,
        noise_mode=noise_mode, mapper_neg_slope=mapper_neg_slope)

    clip_models, tokenizer = load_clip_models(
        mtc.clip_type, allow_random_init=allow_random_init, device=dev)
    arcface_params = load_arcface(arcface_weights,
                                  allow_random_init=allow_random_init,
                                  device=dev)

    styles_array = np.load(s_input)["s"].astype(np.float32)

    resume_params = None
    if resume:
        resume_params = load_mapper(resume, device=dev)
        print(f"Loaded mapper from {resume}")

    prompt_tag = text_prompt.replace(" ", "_")

    def callback(it, loss, aux, lr, grad_norm, mapper):
        logger.log({"loss": loss, "lr": lr, "grad_norm": grad_norm, **aux},
                   step=it)
        print(f"Iteration {it}, gradient norm: {grad_norm:.4f}, lr {lr:.4f}")
        print(f"Total loss: {loss:.4f}, clip loss: {aux['clip_loss']:.4f}, "
              f"identity loss: {aux['identity_loss']:.4f}, "
              f"l2 loss: {aux['l2_loss']:.4f}")
        if it % 1000 == 990:
            save_mapper(mapper, f"{outdir}/mapper_last.pth")

    mesh = cli_mesh(data_parallel, batch_size, dev)
    if mesh is not None:
        print(f"data-parallel training over {mesh.size} devices")
    t1 = time.time()
    mapper, info = train_latent_mapper(
        params, cfg, styles_array, clip_models, arcface_params, mtc,
        tokenizer=tokenizer, mesh=mesh, gen2=gen2,
        resume_params=resume_params, callback=callback)

    save_mapper(mapper, f"{outdir}/mapper_{prompt_tag}.pth")
    steady = info.get("steady_ms_per_step")
    if steady:
        print(f"steady step time: {steady:.0f} ms/step "
              f"(first step {info['first_step_time']:.1f} s: kernel builds "
              "and library set-up)")
    print("time passed:", time.time() - t1)
    logger.finish()


if __name__ == "__main__":
    main()
