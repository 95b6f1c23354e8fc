"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference works out from the same inputs."""

from __future__ import annotations

import torch


def render_gap(levels: torch.Tensor, served: torch.Tensor) -> float:
    """Widest distance, in uint8 levels, between the reference's unrounded
    level (x·127.5 + 128 clipped to [0, 255]) and the bin [u, u + 1) of
    the served value u, which truncates that level: 0 where the served
    byte is the reference's own."""
    u = served.to(levels.device, torch.float32)
    below = (u - levels).clamp(min=0)
    above = (levels - (u + 1)).clamp(min=0)
    return float(torch.maximum(below, above).max())


def truncate_levels(levels: torch.Tensor) -> torch.Tensor:
    """What a served uint8 is: the level truncated toward zero."""
    return levels.to(torch.uint8)
