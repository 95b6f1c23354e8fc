"""Convert an NVIDIA .pkl generator (parsed without executing embedded
code) into the native .npz format (config JSON + flattened params).

  python -m stylemc_torch.cli.legacy --source ffhq.pkl --dest ffhq.npz
"""

from __future__ import annotations

import click


@click.command()
@click.option("--source", required=True, metavar="PATH",
              help="Input .pkl or .npz")
@click.option("--dest", required=True, metavar="PATH", help="Output .npz")
@click.option("--key", default="G_ema", show_default=True)
@click.option("--force-fp16", is_flag=True, default=False, show_default=True,
              help="force num_fp16_res=4 + conv_clamp=256")
def main(source, dest, key, force_fp16):
    from ..io import load_generator, save_native

    if not dest.endswith(".npz"):
        raise click.BadParameter("only .npz output is supported",
                                 param_hint="--dest")
    print(f'Loading "{source}"...')
    cfg, params = load_generator(source, key=key, force_fp16=force_fp16,
                                 device="cpu")
    print(f'Saving "{dest}"...')
    save_native(dest, cfg, params)
    print("Done.")


if __name__ == "__main__":
    main()
