"""The face parser of StyleMC's blending flow in plain PyTorch, as
published: DeepLabV3 (arXiv:1706.05587) over ResNet-101 with
weight-standardised convolutions and GroupNorm (arXiv:1903.10520), as
chenxi116/DeepLabv3.pytorch builds it (`resnet101(num_groups=32,
weight_std=True)`, 19 CelebAMask-HQ classes), and the host steps of
thepowerfuldeez/stylemc's `run_deeplab.py` (`get_bg_mask`,
`get_earring_mouth_teeth_masks`) with PIL and cv2. It reads the weights in
the port's param layout (keys only); nothing here imports the program.

The network: a 7x7 stride-2 stem and a 3x3 stride-2 max pool; four stages
of bottlenecks (1x1, 3x3, 1x1; the shortcut a strided 1x1 where the shape
changes) at strides 1, 2, 2 and 1, the last dilated by 2 (its first block
by 1); ASPP with a 1x1 branch, three 3x3 branches at rates 6/12/18 and an
image-pooling branch, concatenated, a 1x1 and the 1x1 classifier with a
bias; the logits upsampled to the input size, bilinear with aligned
corners. Every convolution but the classifier standardises its weights
(each filter less its mean, over its unbiased standard deviation plus
1e-5); every norm is GroupNorm over 32 groups, eps 1e-5.

Departures, each for the benchmark's run and none in the arithmetic's
intent: float32 with TF32 off, one image a call (the loop is the
caller's); GroupNorm written out (mean and biased variance per group), so
that a group of one value, which `F.group_norm` refuses at batch 1,
normalises to 0 as the formula says; weights from the port's param
layout, so the stage depths and widths are read from the weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLASSES = ("background", "skin", "nose", "eye_g", "l_eye", "r_eye",
           "l_brow", "r_brow", "l_ear", "r_ear", "mouth", "u_lip", "l_lip",
           "hair", "hat", "ear_r", "neck_l", "neck", "cloth")
GROUPS = 32
INPUT = 513
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def ws_conv(x, weight, stride=1, padding=0, dilation=1):
    """chenxi116's `layers.Conv2d` with weight standardisation."""
    w = weight - weight.mean(dim=(1, 2, 3), keepdim=True)
    std = w.reshape(w.shape[0], -1).std(dim=1).reshape(-1, 1, 1, 1) + 1e-5
    return F.conv2d(x, w / std, None, stride, padding, dilation)


def group_norm(p, x, groups: int = GROUPS):
    n, c, h, w = x.shape
    g = x.reshape(n, groups, -1)
    mu = g.mean(dim=2, keepdim=True)
    var = g.var(dim=2, unbiased=False, keepdim=True)
    y = ((g - mu) / torch.sqrt(var + 1e-5)).reshape(n, c, h, w)
    return y * p["weight"].reshape(1, c, 1, 1) + p["bias"].reshape(1, c, 1, 1)


def bottleneck(p, x, stride: int, dilation: int):
    out = F.relu(group_norm(p["bn1"], ws_conv(x, p["conv1_weight"])))
    out = F.relu(group_norm(p["bn2"], ws_conv(out, p["conv2_weight"], stride,
                                              dilation, dilation)))
    out = group_norm(p["bn3"], ws_conv(out, p["conv3_weight"]))
    if "downsample" in p:
        x = group_norm(p["downsample"]["1"],
                       ws_conv(x, p["downsample"]["0_weight"], stride))
    return F.relu(out + x)


def aspp(p, x):
    size = x.shape[2:]
    branches = [F.relu(group_norm(p["aspp1_bn"],
                                  ws_conv(x, p["aspp1_weight"])))]
    for i, rate in ((2, 6), (3, 12), (4, 18)):
        branches.append(F.relu(group_norm(
            p[f"aspp{i}_bn"], ws_conv(x, p[f"aspp{i}_weight"], 1, rate,
                                      rate))))
    pooled = F.adaptive_avg_pool2d(x, 1)
    pooled = F.relu(group_norm(p["aspp5_bn"],
                               ws_conv(pooled, p["aspp5_weight"])))
    branches.append(F.interpolate(pooled, size=size, mode="bilinear",
                                  align_corners=True))
    h = F.relu(group_norm(p["bn2"], ws_conv(torch.cat(branches, 1),
                                            p["conv2_weight"])))
    return F.conv2d(h, p["conv3_weight"], p["conv3_bias"])


def logits(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [N, 3, H, W] (ImageNet-normalised) → logits [N, 19, H, W]."""
    size = x.shape[2:]
    h = F.relu(group_norm(params["bn1"], ws_conv(x, params["conv1_weight"],
                                                 2, 3)))
    h = F.max_pool2d(h, 3, 2, 1)
    for stage, (stride, dilation) in enumerate(((1, 1), (2, 1), (2, 1),
                                                (1, 2))):
        blocks = params[f"layer{stage + 1}"]
        for i in range(len(blocks)):
            h = bottleneck(blocks[str(i)], h, stride if i == 0 else 1,
                           max(1, dilation // 2) if i == 0 else dilation)
    return F.interpolate(aspp(params["aspp"], h), size=size, mode="bilinear",
                         align_corners=True)


# ------------------------------------------------------------ host steps


def network_input(img_u8: np.ndarray, device) -> torch.Tensor:
    """uint8 HWC → [1, 3, 513, 513]: PIL's bilinear resize to 513², /255,
    ImageNet's mean and std."""
    from PIL import Image

    img = Image.fromarray(img_u8).resize((INPUT, INPUT), Image.BILINEAR)
    x = torch.from_numpy(np.array(img)).to(device=device,
                                           dtype=torch.float32) / 255.0
    x = (x - torch.tensor(MEAN, device=device)) / torch.tensor(STD,
                                                               device=device)
    return x.permute(2, 0, 1)[None].contiguous()


def image_logits(params, img_u8: np.ndarray) -> torch.Tensor:
    """uint8 HWC → the logits [19, 513, 513] of its network input."""
    dev = params["conv1_weight"].device
    with torch.no_grad():
        return logits(params, network_input(img_u8, dev))[0]


def classes(image_logits_: torch.Tensor, resolution: int = 512
            ) -> np.ndarray:
    """Logits [19, 513, 513] → the class of each pixel, uint8
    [resolution, resolution]: the argmax, PIL's nearest resize."""
    from PIL import Image

    pred = Image.fromarray(image_logits_.argmax(0).to(torch.uint8).cpu()
                           .numpy())
    return np.array(pred.resize((resolution, resolution), Image.NEAREST))


def class_map(params, img_u8: np.ndarray, resolution: int = 512
              ) -> np.ndarray:
    """uint8 HWC → its classes at `resolution`²."""
    return classes(image_logits(params, img_u8), resolution)


def _is(cls: np.ndarray, *names: str) -> np.ndarray:
    return np.isin(cls, [CLASSES.index(n) for n in names]).astype(np.uint8)


def _erode(mask: np.ndarray, k: int) -> np.ndarray:
    import cv2

    return cv2.erode(mask, np.ones((k, k), np.uint8)).astype(bool)


def _dilate(mask: np.ndarray, k: int) -> np.ndarray:
    import cv2

    return cv2.dilate(mask, np.ones((k, k), np.uint8)).astype(bool)


def background(cls: np.ndarray) -> np.ndarray:
    """`get_bg_mask`: background or cloth eroded by 20², hair dilated by
    10² taken out."""
    return _erode(_is(cls, "background", "cloth"), 20) & \
        ~_dilate(_is(cls, "hair"), 10)


def earring_mouth_teeth(cls: np.ndarray, need_earring: bool = True
                        ) -> Tuple[Optional[np.ndarray], np.ndarray,
                                   np.ndarray]:
    """`get_earring_mouth_teeth_masks`: earrings dilated by 15² (None
    where not asked for), mouth or lips dilated by 7², the mouth's inside
    eroded by 3²."""
    earring = _dilate(_is(cls, "ear_r"), 15) if need_earring else None
    mouth = _dilate(_is(cls, "mouth", "u_lip", "l_lip"), 7)
    return earring, mouth, _erode(_is(cls, "mouth"), 3)


def blend_masks(params, orig_u8: np.ndarray, edit_u8: np.ndarray,
                need_earring: bool, resolution: int = 512
                ) -> Dict[str, Optional[np.ndarray]]:
    """What generate_fromS's blending reads: the background mask of the
    original render, the earring and teeth masks of the edited one."""
    return masks_of(class_map(params, orig_u8, resolution),
                    class_map(params, edit_u8, resolution), need_earring)


def masks_of(orig_classes: np.ndarray, edit_classes: np.ndarray,
             need_earring: bool) -> Dict[str, Optional[np.ndarray]]:
    earring, _, teeth = earring_mouth_teeth(edit_classes, need_earring)
    return {"background": background(orig_classes), "earring": earring,
            "teeth": teeth}
