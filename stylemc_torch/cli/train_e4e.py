"""Train the e4e inversion encoder (counterpart of
`stylemc_tpu/cli/train_e4e.py`): the same flags and defaults, plus
--device (cuda unless told otherwise). Checkpoints go to
<exp_dir>/checkpoints/iteration_<step>.pkl every --save_interval steps,
best_model.pkl when validation improves, and last.pkl at the end; the
losses print every --board_interval steps. --resume_training_from_ckpt
reads one of the port's checkpoints (a JAX-written .pkl holds optax
objects and is refused).

The decoder loads from an NVIDIA .pkl or a native .npz (--stylegan_weights)
or from a rosinality .pt; --checkpoint_path warm-starts from an e4e
checkpoint instead. The encoder's IR-SE-50 trunk warm-starts from
--arcface_weights or STYLEMC_ARCFACE. LPIPS loads from
STYLEMC_LPIPS_<TYPE> (a pickled tree of numpy arrays), MoCo (datasets that
are not faces) from STYLEMC_MOCO; --allow_random_init draws what is
missing from fixed seeds.

  python -m stylemc_torch.cli.train_e4e --exp_dir runs/e4e \\
      --source_root ffhq --test_root celeba_test --stylegan_weights ffhq.pkl \\
      --w_discriminator_lambda 0.1 --progressive_start 20000
"""

from __future__ import annotations

import os

import click
import torch

LPIPS_SEED = 1
MOCO_SEED = 2


@click.command()
@click.option("--exp_dir", type=str, required=True)
@click.option("--dataset_type", default="ffhq_encode", show_default=True)
@click.option("--encoder_type", default="Encoder4Editing", show_default=True)
@click.option("--source_root", type=str, required=True,
              help="train image dir")
@click.option("--test_root", type=str, default=None)
@click.option("--batch_size", default=4, show_default=True)
@click.option("--test_batch_size", default=2, show_default=True)
@click.option("--learning_rate", default=1e-4, show_default=True)
@click.option("--optim_name", default="ranger", show_default=True)
@click.option("--train_decoder", default=False, type=bool, show_default=True)
@click.option("--lpips_type", default="alex", show_default=True)
@click.option("--lpips_lambda", default=0.8, show_default=True)
@click.option("--id_lambda", default=0.1, show_default=True)
@click.option("--l2_lambda", default=1.0, show_default=True)
@click.option("--stylegan_weights", type=str, required=True,
              help="decoder weights: rosinality .pt or NVIDIA .pkl/.npz")
@click.option("--stylegan_size", default=1024, show_default=True)
@click.option("--checkpoint_path", type=str, default=None,
              help="warm-start e4e checkpoint")
@click.option("--max_steps", default=500000, show_default=True)
@click.option("--board_interval", default=50, show_default=True)
@click.option("--val_interval", default=1000, show_default=True)
@click.option("--save_interval", default=None, type=int)
@click.option("--w_discriminator_lambda", default=0.0, show_default=True)
@click.option("--w_discriminator_lr", default=2e-5, show_default=True)
@click.option("--r1", default=10.0, show_default=True)
@click.option("--d_reg_every", default=16, show_default=True)
@click.option("--use_w_pool", is_flag=True, default=False)
@click.option("--w_pool_size", default=50, show_default=True)
@click.option("--delta_norm", default=2, show_default=True)
@click.option("--delta_norm_lambda", default=2e-4, show_default=True)
@click.option("--data_parallel", is_flag=True, default=False,
              help="shard the batch over all local devices (1-axis data "
                   "mesh; one card or the CPU runs as without it)")
@click.option("--progressive_start", type=int, default=None)
@click.option("--progressive_step_every", default=2000, show_default=True)
@click.option("--resume_training_from_ckpt", type=str, default=None)
@click.option("--arcface_weights", type=str, default=None)
@click.option("--allow_random_init", is_flag=True, default=False)
@click.option("--bf16_full", is_flag=True, default=False,
              help="bf16 on every decoder block")
@click.option("--encoder_bf16", is_flag=True, default=False,
              help="the encoder's forward in bf16, fp32 master weights")
@click.option("--perception_bf16", is_flag=True, default=False,
              help="bf16 activations through the LPIPS and identity towers")
@click.option("--bf16", is_flag=True, default=False,
              help="bf16 activations in the decoder's upper blocks")
@click.option("--no_fuse_d_step", is_flag=True, default=False,
              help="the JAX package's three-dispatch discriminator step "
                   "(the same operations here)")
@click.option("--remat_min_res", default=0, show_default=True,
              help="with a remat decoder, checkpoint only blocks at >= this "
                   "resolution (0 = all)")
@click.option("--fetch_every", default=1, show_default=True,
              help="fetch losses to the host every N steps")
@click.option("--prefetch_batches", default=2, show_default=True,
              help="background-thread batch prefetch depth (0 = inline)")
@click.option("--device", default="cuda", show_default=True)
def main(exp_dir, dataset_type, encoder_type, source_root, test_root,
         batch_size, test_batch_size, learning_rate, optim_name,
         train_decoder, lpips_type, lpips_lambda, id_lambda, l2_lambda,
         stylegan_weights, stylegan_size, checkpoint_path, max_steps,
         board_interval, val_interval, save_interval,
         w_discriminator_lambda, w_discriminator_lr, r1, d_reg_every,
         use_w_pool, w_pool_size, delta_norm, delta_norm_lambda,
         data_parallel, progressive_start, progressive_step_every,
         resume_training_from_ckpt, arcface_weights, allow_random_init,
         bf16_full, encoder_bf16, perception_bf16, bf16, no_fuse_d_step,
         remat_min_res, fetch_every, prefetch_batches, device):
    from ..convert import as_float32, params_from_numpy
    from ..data.images import ImagesDataset, batch_iterator
    from ..device import disable_tf32, resolve_device
    from ..io.numpy_pickle import load_numpy_pickle
    from ..losses.lpips import init_lpips_params
    from ..models.e4e.encoders import init_encoder_params, style_count
    from ..models.e4e.psp import PSP, PSPConfig, load_psp_from_checkpoint
    from ..parallel.mesh import cli_mesh
    from ..train.coach import Coach, CoachOptions
    from ..utils.model_zoo import load_arcface

    dev = resolve_device(device)
    disable_tf32(dev)
    os.makedirs(exp_dir, exist_ok=True)
    opts = CoachOptions(
        dataset_type=dataset_type, encoder_type=encoder_type,
        batch_size=batch_size, test_batch_size=test_batch_size,
        learning_rate=learning_rate, optim_name=optim_name,
        train_decoder=train_decoder, lpips_type=lpips_type,
        lpips_lambda=lpips_lambda, id_lambda=id_lambda, l2_lambda=l2_lambda,
        stylegan_size=stylegan_size, max_steps=max_steps,
        board_interval=board_interval, val_interval=val_interval,
        save_interval=save_interval,
        w_discriminator_lambda=w_discriminator_lambda,
        w_discriminator_lr=w_discriminator_lr, r1=r1,
        d_reg_every=d_reg_every, use_w_pool=use_w_pool,
        w_pool_size=w_pool_size, delta_norm=delta_norm,
        delta_norm_lambda=delta_norm_lambda,
        progressive_start=progressive_start,
        progressive_step_every=progressive_step_every, exp_dir=exp_dir,
        bf16=bf16, bf16_full=bf16_full, perception_bf16=perception_bf16,
        encoder_bf16=encoder_bf16, fuse_d_step=not no_fuse_d_step,
        remat_min_res=remat_min_res, fetch_every=fetch_every,
        prefetch_batches=prefetch_batches)

    # --- decoder and encoder
    if checkpoint_path:
        psp = load_psp_from_checkpoint(checkpoint_path, stylegan_size,
                                       encoder_type, device=dev)
    else:
        if stylegan_weights.endswith((".pkl", ".npz")):
            from ..io import load_generator
            dec_cfg, dec_params = load_generator(stylegan_weights, device=dev)
        else:
            from ..io import load_state_dict_numpy
            from ..io.rosinality import generator_params_from_rosinality
            dec_cfg, dec_params = generator_params_from_rosinality(
                load_state_dict_numpy(stylegan_weights, key="g_ema"),
                stylegan_size)
            dec_params = params_from_numpy(dec_params, dev)
        enc_params = init_encoder_params(
            torch.Generator().manual_seed(opts.seed),
            stylegan_size, encoder_type, device=dev)
        if arcface_weights or os.environ.get("STYLEMC_ARCFACE"):
            # warm-start the encoder's trunk from IR-SE-50
            from ..io import load_state_dict_numpy
            from ..models import arcface
            path = arcface_weights or os.environ["STYLEMC_ARCFACE"]
            irse = params_from_numpy(arcface.params_from_torch_state(
                load_state_dict_numpy(path)), dev)
            enc_params.update({k: irse[k] for k in
                               ("input_conv_weight", "input_bn",
                                "input_prelu", "body")})
        latent_avg = as_float32(dec_params["mapping"]["w_avg"], dev)
        psp = PSP(cfg=PSPConfig(stylegan_size=stylegan_size,
                                encoder_type=encoder_type),
                  encoder_params=enc_params, decoder_cfg=dec_cfg,
                  decoder_params=dec_params,
                  latent_avg=latent_avg[None].repeat(
                      style_count(stylegan_size), 1))

    # --- perception
    perception = {}
    lpips_path = os.environ.get("STYLEMC_LPIPS_" + lpips_type.upper())
    if lpips_path and os.path.exists(lpips_path):
        perception["lpips"] = params_from_numpy(
            load_numpy_pickle(lpips_path), dev)
    elif allow_random_init:
        perception["lpips"] = init_lpips_params(
            torch.Generator().manual_seed(LPIPS_SEED), lpips_type, device=dev)
    else:
        raise FileNotFoundError(
            f"set STYLEMC_LPIPS_{lpips_type.upper()} or pass "
            "--allow_random_init")
    if "ffhq" in dataset_type or "celeb" in dataset_type:
        perception["arcface"] = load_arcface(
            arcface_weights, allow_random_init=allow_random_init, device=dev)
    else:
        from ..models.resnet import (init_resnet50_params,
                                     resnet50_from_torch_state)
        moco_path = os.environ.get("STYLEMC_MOCO")
        if moco_path and os.path.exists(moco_path):
            from ..io import load_state_dict_numpy
            state = load_state_dict_numpy(moco_path, key="state_dict")
            state = {k[len("module.encoder_q."):]: v for k, v in state.items()
                     if k.startswith("module.encoder_q")
                     and not k.startswith("module.encoder_q.fc")}
            perception["moco"] = params_from_numpy(
                resnet50_from_torch_state(state), dev)
        elif allow_random_init:
            perception["moco"] = init_resnet50_params(
                torch.Generator().manual_seed(MOCO_SEED), device=dev)
        else:
            raise FileNotFoundError(
                "set STYLEMC_MOCO or pass --allow_random_init")

    # --- data
    train_ds = ImagesDataset(source_root, size=256)
    train_iter = batch_iterator(train_ds, batch_size, shuffle=True, flip=True)
    test_iter = None
    if test_root:
        test_ds = ImagesDataset(test_root, size=256)
        test_iter = batch_iterator(test_ds, test_batch_size, shuffle=False)

    mesh = cli_mesh(data_parallel, batch_size, dev)
    if mesh is not None:
        print(f"data-parallel training over {mesh.size} devices")
    coach = Coach(opts, psp, perception, train_iter, test_iter, mesh=mesh,
                  device=dev)
    if resume_training_from_ckpt:
        coach.load_checkpoint(resume_training_from_ckpt)

    ckpt_dir = os.path.join(exp_dir, "checkpoints")

    def callback(step, loss_dict):
        if step % opts.board_interval == 0:
            print(f"step {step}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in loss_dict.items()))
        if step % opts.save_interval == 0 or step == opts.max_steps:
            coach.save_checkpoint(os.path.join(ckpt_dir,
                                               f"iteration_{step}.pkl"))

    coach.train(callback=callback,
                best_checkpoint_path=os.path.join(ckpt_dir, "best_model.pkl"))
    coach.save_checkpoint(os.path.join(ckpt_dir, "last.pkl"))
    print("OMG, finished training!")


if __name__ == "__main__":
    main()
