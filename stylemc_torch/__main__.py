"""`python -m stylemc_torch` lists the CLIs, or dispatches one
(`python -m stylemc_torch verify --network ...` is
`python -m stylemc_torch.cli.verify_weights --network ...`)."""

import sys

CLIS = [
    ("generate_w", "seeds → W latents npz"),
    ("w_s_converter", "W npz → packed S-space npz"),
    ("find_direction", "optimize a global S-space direction for a prompt"),
    ("train_latent_mapper", "train a per-image latent Mapper"),
    ("generate_fromS", "apply direction/mapper, render [orig|edited]"),
    ("run_deeplab", "batch face parsing to parsings/ masks"),
    ("align_faces", "FFHQ-align a directory of faces"),
    ("warp_images", "landmark overlays / piecewise warp on [orig|edited] pairs"),
    ("infer_e4e", "real images → W+ latents (e4e inversion)"),
    ("train_e4e", "train the e4e inversion encoder (Coach)"),
    ("legacy", "convert legacy .pkl → native .npz"),
    ("calc_metrics", "FID/KID/IS/PPL/P&R evaluation"),
    ("calc_losses_on_images", "LPIPS/L2 between image dirs"),
    ("clip_filter", "CLIP attribute filtering / dataset balancing"),
    ("compare_directions", "per-channel cosine between direction files"),
    ("serve", "HTTP edit serving over pre-compiled batch buckets"),
    ("verify", "real-weights verification harness → parity report"),
]

# subcommand → module name where it differs from the CLI name
_ALIASES = {"verify": "verify_weights"}


def main(argv=None) -> None:
    argv = sys.argv if argv is None else argv
    names = {name for name, _ in CLIS}
    if len(argv) > 1 and argv[1] in names:
        import importlib

        sub = argv.pop(1)
        mod = importlib.import_module(
            f"stylemc_torch.cli.{_ALIASES.get(sub, sub)}")
        argv[0] = f"stylemc_torch {sub}"
        mod.main(args=argv[1:], prog_name=argv[0])
    else:
        print("stylemc_torch CLIs (python -m stylemc_torch.cli.<name> "
              "--help, or python -m stylemc_torch <name> ...):\n")
        for name, desc in CLIS:
            print(f"  {name:22s} {desc}")


if __name__ == "__main__":
    main()
