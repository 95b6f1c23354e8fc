"""Convert a generator checkpoint between formats. Inputs: an NVIDIA .pkl
(parsed without executing embedded code), a rosinality .pt/.pth or a native
.npz. The --dest extension picks the output: .npz is the native format
(config JSON + flattened params), .pt/.pth a rosinality-layout torch
checkpoint that rosinality/e4e torch tooling loads.

  python -m stylemc_torch.cli.legacy --source ffhq.pkl --dest ffhq.npz
  python -m stylemc_torch.cli.legacy --source ffhq.pkl --dest ffhq.pt
"""

from __future__ import annotations

import click


@click.command()
@click.option("--source", required=True, metavar="PATH",
              help="Input .pkl, .pt or .npz")
@click.option("--dest", required=True, metavar="PATH",
              help="Output .npz (native) or .pt (rosinality)")
@click.option("--key", default="G_ema", show_default=True)
@click.option("--force-fp16", is_flag=True, default=False, show_default=True,
              help="force num_fp16_res=4 + conv_clamp=256")
def main(source, dest, key, force_fp16):
    from ..io import load_generator, save_native
    from ..io.export import save_rosinality_pt

    if not dest.endswith((".npz", ".pt", ".pth")):
        raise click.BadParameter("expected a .npz, .pt or .pth output",
                                 param_hint="--dest")
    print(f'Loading "{source}"...')
    cfg, params = load_generator(source, key=key, force_fp16=force_fp16,
                                 device="cpu")
    print(f'Saving "{dest}"...')
    if dest.endswith(".npz"):
        save_native(dest, cfg, params)
    else:
        save_rosinality_pt(dest, cfg, params)
    print("Done.")


if __name__ == "__main__":
    main()
