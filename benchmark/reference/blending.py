"""StyleMC's feature blending (thepowerfuldeez/stylemc `generate_fromS.py
--use_blending`, its `utils.py` `generate_image` with `masks_dict`) in
plain PyTorch: the original is rendered keeping each block's features,
the edit is rendered again with the features after conv1 of the 32² and
64² blocks blended toward the original's, m·x_orig + (1 − m)·x, under the
earring mask at 32² and the background, then the teeth mask at 64²; each
mask is the 512² parsing mask resized with cv2's INTER_AREA. Built from
`stylegan2.py`'s layers; nothing here imports the program.

Departures: float32 with TF32 off, one image a call; noise 'const', as the
benchmark serves.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .stylegan2 import _layer, _torgb, block_resolutions, channels, fir, \
    upsample2x

# where each mask blends, in the order the reference applies them
AT = (("earring", 32), ("background", 64), ("teeth", 64))


def synthesis(params, g, styles: torch.Tensor,
              masks: Optional[Dict[int, List[torch.Tensor]]] = None,
              original: Optional[Dict[int, torch.Tensor]] = None):
    """Packed styles [N, 26, 512] → (image [N, 3, R, R], {resolution: the
    block's features after conv1 and any blend}); `masks` {resolution:
    [mask [N or 1, 1, res, res], ...]} blends toward `original`."""
    f = fir(styles.device)
    clamp = g["conv_clamp"]
    n = styles.shape[0]
    row = 0
    x = img = None
    feats: Dict[int, torch.Tensor] = {}
    for res in block_resolutions(g):
        bp = params["synthesis"][f"b{res}"]
        c_out = channels(g, res)
        if res == 4:
            x = bp["const"][None].expand(n, -1, -1, -1)
            x = _layer(bp["conv1"], x, styles[:, row, :c_out], False, f,
                       clamp)
            img = _torgb(bp["torgb"], x, styles[:, row + 1, :c_out], clamp)
            row += 2
            feats[res] = x
            continue
        c_in = channels(g, res // 2)
        x = _layer(bp["conv0"], x, styles[:, row, :c_in], True, f, clamp)
        x = _layer(bp["conv1"], x, styles[:, row + 1, :c_out], False, f,
                   clamp)
        for m in (masks or {}).get(res, []):
            x = m * original[res] + (1 - m) * x
        img = upsample2x(img, f) + _torgb(bp["torgb"], x,
                                          styles[:, row + 2, :c_out], clamp)
        feats[res] = x
        row += 3
    return img, feats


def resized(masks: Dict[str, Optional[np.ndarray]], device
            ) -> Dict[int, List[torch.Tensor]]:
    """512² masks → {resolution: [mask [1, 1, res, res], ...]} in blending
    order, each resized with cv2's INTER_AREA."""
    import cv2

    out: Dict[int, List[torch.Tensor]] = {}
    for kind, res in AT:
        if masks.get(kind) is None:
            continue
        m = cv2.resize(masks[kind].astype(np.float64), (res, res),
                       interpolation=cv2.INTER_AREA)
        out.setdefault(res, []).append(torch.tensor(
            m, dtype=torch.float32, device=device)[None, None])
    return out


def blended_edit(params, g, styles: torch.Tensor, edited: torch.Tensor,
                 masks: Dict[str, Optional[np.ndarray]]) -> torch.Tensor:
    """One item: styles and edited styles [1, 26, 512] and its 512²
    masks → the blended edit [1, 3, R, R]."""
    with torch.no_grad():
        _, original = synthesis(params, g, styles)
        img, _ = synthesis(params, g, edited, resized(masks, styles.device),
                           original)
    return img
