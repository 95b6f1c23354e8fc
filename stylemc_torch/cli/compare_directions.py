"""Compare two S-space direction files channel by channel (cosine).

The acceptance metric for a direction: the per-channel cosine between this
port's direction and a reference run's, ≥ 0.99 on every active channel.
Works on any pair of direction_{prompt}.npz files; numpy only.

  python -m stylemc_torch.cli.compare_directions a.npz b.npz
"""

from __future__ import annotations

import json

import click
import numpy as np


@click.command()
@click.argument("direction_a")
@click.argument("direction_b")
@click.option("--threshold", type=float, default=0.99, show_default=True)
def main(direction_a, direction_b, threshold):
    a = np.load(direction_a)["s"].reshape(26, 512)
    b = np.load(direction_b)["s"].reshape(26, 512)
    rows = []
    for i in range(26):
        na, nb = np.linalg.norm(a[i]), np.linalg.norm(b[i])
        if na < 1e-8 and nb < 1e-8:
            cos = 1.0   # both channels empty
        elif na < 1e-8 or nb < 1e-8:
            cos = 0.0
        else:
            cos = float(a[i] @ b[i] / (na * nb))
        rows.append(cos)
    active = [c for i, c in enumerate(rows)
              if np.linalg.norm(a[i]) > 1e-8 or np.linalg.norm(b[i]) > 1e-8]
    result = {
        "per_channel_cosine": [round(c, 4) for c in rows],
        "min_active_cosine": round(min(active), 4) if active else 1.0,
        "mean_active_cosine": (round(float(np.mean(active)), 4)
                               if active else 1.0),
        "pass": bool(not active or min(active) >= threshold),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
