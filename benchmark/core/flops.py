"""Operations and bytes of the measured work, from shapes, and the H100's
peaks they are held against.

Useful FLOPs count each multiply-add twice and each up-convolution at nine
taps per output pixel (the polyphase count), whatever the program runs: a
change of algorithm moves a share, and the count never goes stale.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from ..reference.stylegan2 import block_resolutions, channels

# 3xTF32 on the tensor cores: a third of the dense TF32 rate (495 TFLOP/s,
# NVIDIA's H100 SXM data sheet), the fastest any float32-exact program
# can run on the card
PEAK_FLOP_PER_S = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12


def _blocks(g, until_k=None):
    res = block_resolutions(g)
    return res if until_k is None else res[:until_k + 1]


def synthesis_flop(g: Dict, until_k=None) -> int:
    """Useful FLOPs of one image's synthesis: 3x3 convs, each up-conv at 9
    taps per output pixel, the 1x1 ToRGBs."""
    total = 0
    for res in _blocks(g, until_k):
        c_out = channels(g, res)
        c_in = channels(g, res // 2) if res > 4 else c_out
        if res > 4:
            total += 2 * 9 * c_in * c_out * res * res
        total += 2 * 9 * c_out * c_out * res * res
        total += 2 * c_out * g["img_channels"] * res * res
    return total


def w_to_s_flop(g: Dict) -> int:
    """One image's affines: w_dim → each layer's input width."""
    total = 0
    for res in _blocks(g):
        c_out = channels(g, res)
        c_in = channels(g, res // 2) if res > 4 else c_out
        widths = (c_out, c_out) if res == 4 else (c_in, c_out, c_out)
        total += sum(2 * g["w_dim"] * w for w in widths)
    return total


def vit_flop(c: Dict) -> int:
    """One image through a CLIP ViT image tower."""
    width, layers, patch = c["vision_width"], c["vision_layers"], \
        c["vision_patch_size"]
    res = c["image_resolution"]
    tokens = (res // patch) ** 2 + 1
    per_layer = 2 * tokens * 12 * width * width \
        + 2 * 2 * tokens * tokens * width
    return (layers * per_layer + 2 * (tokens - 1) * 3 * patch * patch * width
            + 2 * width * c["embed_dim"])


def irse_body_flop(layout: Sequence[Tuple[int, int, int]], size: int,
                   stem: int) -> Tuple[int, List[int]]:
    """FLOPs of the IR-SE trunk at input `size`² (stem, both 3x3 convs of
    each bottleneck, 1x1 shortcuts; SE gates' small FCs), and the plane
    side after each bottleneck."""
    total, s, sides = 2 * 9 * 3 * stem * size * size, size, []
    for in_c, depth, stride in layout:
        out = s // stride
        total += 2 * 9 * in_c * depth * s * s
        total += 2 * 9 * depth * depth * out * out
        if in_c != depth:
            total += 2 * in_c * depth * out * out
        total += 2 * 2 * depth * max(depth // 16, 1)
        s = out
        sides.append(s)
    return total, sides


def arcface_flop(a: Dict, layout) -> int:
    body, sides = irse_body_flop(layout, a["input_size"], a["stem"])
    final = layout[-1][1]
    return body + 2 * final * sides[-1] ** 2 * a["embed"]


def e4e_flop(e: Dict, layout, taps, n_styles: int, size: int = 256) -> int:
    """Encoder4Editing at `size`²: the trunk, the two 1x1 laterals, and
    each style head's stride-2 3x3 convs and EqualLinear."""
    body, sides = irse_body_flop(layout, size, e["stem"])
    c1, c2, c3 = (layout[t][1] for t in taps)
    s1, s2 = sides[taps[0]], sides[taps[1]]
    total = body + 2 * c2 * c3 * s2 * s2 + 2 * c1 * c3 * s1 * s1
    for i in range(n_styles):
        spatial = 16 if i < 3 else 32 if i < 7 else 64
        s = spatial
        for _ in range(int(math.log2(spatial))):
            s //= 2
            total += 2 * 9 * c3 * c3 * s * s
        total += 2 * c3 * e["style_dim"]
    return total


def train_flop(g: Dict, clip: Dict[str, Dict], arcface: Dict, layout,
               batch: int, until_k=None) -> int:
    """One prompt-step of find_direction: the forward and the input
    gradient (each weight frozen: the backward costs the forward) of the
    generator (useful count), the CLIP image towers and IR-SE-50 at 112,
    for `batch` images."""
    per_image = synthesis_flop(g, until_k) + sum(
        vit_flop(c) for c in clip.values()) + arcface_flop(arcface, layout)
    return 2 * batch * per_image


def upsample_bytes(shape) -> int:
    """B1's 2x upsample of `shape`: each input read once (4 B), each output
    written once (16 B per input element)."""
    return 20 * math.prod(shape)


def downsample_bytes(shape) -> int:
    """B2's 2x downsample of an input of `shape`: read once, a quarter
    written (5 B per input element)."""
    return 5 * math.prod(shape)


def resample_step_bytes(g: Dict, rows: int, until_k=None) -> int:
    """B1 and B2 bytes of one training step over `rows` images: B1 on the
    ToRGB chain of each upper block's input plane, B2 on each upsampled
    plane's gradient."""
    total = 0
    for res in _blocks(g, until_k)[1:]:
        total += upsample_bytes((rows, g["img_channels"], res // 2, res // 2))
        total += downsample_bytes((rows, g["img_channels"], res, res))
    return total


def inversion_flop(config: Dict) -> int:
    """One photo's inversion: Encoder4Editing at its input size and the
    generator's affines."""
    from .weights import e4e_taps, ir_se_layout

    e = config["e4e"]
    layout = ir_se_layout(e["units"], e["widths"], e["stem"])
    return e4e_flop(e, layout, e4e_taps(layout), e["n_styles"],
                    e["input_size"]) + w_to_s_flop(config["generator"])
