"""DeepLabV3 ResNet-101 face parser (weight-standardised convs, GroupNorm)
and the CelebAMask mask extraction used for feature blending (counterpart
of `stylemc_tpu/models/deeplab.py`).

The network: WS-Conv (each filter's weights normalised by their mean and
unbiased std at run time), GroupNorm(32), ResNet-101 with layer4 at stride
1 and dilation 2, ASPP (rates 6/12/18 and image pooling), and a bilinear
(align_corners) upsample of the logits to the input size. Plain torch ops
(cuDNN convolutions on the card). The params tree is the JAX package's
layout (`conv1_weight`, `bn1`, `layer{1..4}.{i}`, `aspp`), so
`convert.params_from_numpy` carries it.

`Segmenter` runs the network on the card; the 513² bilinear resize before
it, the nearest resize of the class map after it and the mask morphology
(cv2) run on the host, as in the reference.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import params_from_numpy
from ..device import DeviceLike, resolve_device

CLASSES = ["background", "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow",
           "r_brow", "l_ear", "r_ear", "mouth", "u_lip", "l_lip", "hair",
           "hat", "ear_r", "neck_l", "neck", "cloth"]
RESNET101_LAYERS = (3, 4, 23, 3)
INPUT_SIZE = 513
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _ws_conv(x, w, stride=1, padding=0, dilation=1, eps=1e-5):
    """Weight-standardised conv: subtract each filter's mean and divide by
    its std (unbiased, n − 1, as torch's std), then convolve."""
    w = w - torch.mean(w, dim=(1, 2, 3), keepdim=True)
    n = w[0].numel()
    var = torch.sum(torch.square(w), dim=(1, 2, 3), keepdim=True) / (n - 1)
    w = w / (torch.sqrt(var) + eps)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding,
                    dilation=dilation)


def _group_norm(p, x, num_groups=32, eps=1e-5):
    c = x.shape[1]
    while c % num_groups != 0:  # reduced (test) widths: largest divisor ≤ 32
        num_groups -= 1
    if c // num_groups * x.shape[2] * x.shape[3] == 1:
        # one value a group (a reduced width's pooled branch), which
        # F.group_norm refuses: it normalises to 0
        return torch.zeros_like(x) + p["bias"].to(x.dtype)[:, None, None]
    return F.group_norm(x, num_groups, p["weight"].to(x.dtype),
                        p["bias"].to(x.dtype), eps=eps)


def _bilinear_ac(x, out_h, out_w):
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def _bottleneck(p, x, stride=1, dilation=1):
    out = F.relu(_group_norm(p["bn1"], _ws_conv(x, p["conv1_weight"])))
    out = F.relu(_group_norm(p["bn2"], _ws_conv(
        out, p["conv2_weight"], stride=stride, padding=dilation,
        dilation=dilation)))
    out = _group_norm(p["bn3"], _ws_conv(out, p["conv3_weight"]))
    residual = x
    if "downsample" in p:
        residual = _group_norm(p["downsample"]["1"],
                               _ws_conv(x, p["downsample"]["0_weight"],
                                        stride=stride))
    return F.relu(out + residual)


def _aspp(p, x):
    branches = [F.relu(_group_norm(p["aspp1_bn"],
                                   _ws_conv(x, p["aspp1_weight"])))]
    for i, rate in ((2, 6), (3, 12), (4, 18)):
        branches.append(F.relu(_group_norm(p[f"aspp{i}_bn"], _ws_conv(
            x, p[f"aspp{i}_weight"], padding=rate, dilation=rate))))
    pooled = torch.mean(x, dim=(2, 3), keepdim=True)
    pooled = F.relu(_group_norm(p["aspp5_bn"],
                                _ws_conv(pooled, p["aspp5_weight"])))
    branches.append(pooled.expand(-1, -1, *x.shape[2:]))
    h = torch.cat(branches, dim=1)
    h = F.relu(_group_norm(p["bn2"], _ws_conv(h, p["conv2_weight"])))
    # conv3 is a plain conv with a bias
    return F.conv2d(h, p["conv3_weight"].to(h.dtype),
                    p["conv3_bias"].to(h.dtype))


def deeplab_stages(params):
    """The network before its final upsample as [(name, fn)], each fn
    taking the previous stage's output: the stem (conv, GroupNorm, ReLU,
    max pool), each bottleneck ('layer{i}.{j}'; a stage's first block
    takes its stride and dilation max(1, d / 2)), and ASPP."""
    def stem(x):
        x = F.relu(_group_norm(params["bn1"], _ws_conv(
            x, params["conv1_weight"], stride=2, padding=3)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    stages = [("stem", stem)]
    strides = (1, 2, 2, 1)
    dilations = (1, 1, 1, 2)
    for li in range(4):
        layer = params[f"layer{li + 1}"]
        for bi in range(len(layer)):
            first = bi == 0
            stages.append((f"layer{li + 1}.{bi}", functools.partial(
                _bottleneck, layer[f"{bi}"],
                stride=strides[li] if first else 1,
                dilation=max(1, dilations[li] // 2) if first
                else dilations[li])))
    stages.append(("aspp", functools.partial(_aspp, params["aspp"])))
    return stages


def deeplab_apply(params, x):
    """x: [N, 3, H, W] ImageNet-normalised → logits [N, classes, H, W]."""
    size = x.shape[2:]
    for _, stage in deeplab_stages(params):
        x = stage(x)
    return _bilinear_ac(x, size[0], size[1])


# ----------------------------------------------------------------- weights


def params_from_torch_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's state dict ({name: array}; 'module.' prefixes
    stripped and GroupNorm-free 'num_batches_tracked' entries dropped, as
    the reference loader does) → the params tree of numpy arrays. Each
    layer's depth is read from the names, so reduced networks load too."""
    t = {(k[7:] if k.startswith("module.") else k): np.asarray(v, np.float32)
         for k, v in state.items() if "tracked" not in k}

    def gn(prefix):
        return {"weight": t[f"{prefix}.weight"], "bias": t[f"{prefix}.bias"]}

    params: Dict[str, Any] = {"conv1_weight": t["conv1.weight"],
                              "bn1": gn("bn1")}
    for li in range(4):
        depth = 1 + max(int(m.group(1)) for k in t
                        for m in [re.match(rf"layer{li + 1}\.(\d+)\.", k)]
                        if m)
        layer = {}
        for bi in range(depth):
            pfx = f"layer{li + 1}.{bi}"
            bp = {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}_weight"] = t[f"{pfx}.conv{ci}.weight"]
                bp[f"bn{ci}"] = gn(f"{pfx}.bn{ci}")
            if f"{pfx}.downsample.0.weight" in t:
                bp["downsample"] = {"0_weight": t[f"{pfx}.downsample.0.weight"],
                                    "1": gn(f"{pfx}.downsample.1")}
            layer[f"{bi}"] = bp
        params[f"layer{li + 1}"] = layer
    aspp = {}
    for i in range(1, 6):
        aspp[f"aspp{i}_weight"] = t[f"aspp.aspp{i}.weight"]
        aspp[f"aspp{i}_bn"] = gn(f"aspp.aspp{i}_bn")
    aspp["conv2_weight"] = t["aspp.conv2.weight"]
    aspp["bn2"] = gn("aspp.bn2")
    aspp["conv3_weight"] = t["aspp.conv3.weight"]
    aspp["conv3_bias"] = t["aspp.conv3.bias"]
    params["aspp"] = aspp
    return params


def params_to_torch_state(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The params tree → the reference's state dict names (no prefix), the
    inverse of `params_from_torch_state`."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v, np.float32)

    out: Dict[str, np.ndarray] = {}

    def gn(prefix, p):
        out[f"{prefix}.weight"] = arr(p["weight"])
        out[f"{prefix}.bias"] = arr(p["bias"])

    out["conv1.weight"] = arr(params["conv1_weight"])
    gn("bn1", params["bn1"])
    for li in range(4):
        for bi, bp in params[f"layer{li + 1}"].items():
            pfx = f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                out[f"{pfx}.conv{ci}.weight"] = arr(bp[f"conv{ci}_weight"])
                gn(f"{pfx}.bn{ci}", bp[f"bn{ci}"])
            if "downsample" in bp:
                out[f"{pfx}.downsample.0.weight"] = arr(
                    bp["downsample"]["0_weight"])
                gn(f"{pfx}.downsample.1", bp["downsample"]["1"])
    aspp = params["aspp"]
    for i in range(1, 6):
        out[f"aspp.aspp{i}.weight"] = arr(aspp[f"aspp{i}_weight"])
        gn(f"aspp.aspp{i}_bn", aspp[f"aspp{i}_bn"])
    out["aspp.conv2.weight"] = arr(aspp["conv2_weight"])
    gn("aspp.bn2", aspp["bn2"])
    out["aspp.conv3.weight"] = arr(aspp["conv3_weight"])
    out["aspp.conv3.bias"] = arr(aspp["conv3_bias"])
    return out


def save_deeplab_checkpoint(path: str, params: Dict[str, Any]) -> None:
    """Write params in the reference checkpoint's layout,
    {'state_dict': {'module.' + name: tensor}} (as a DataParallel model
    saves it): the file `default_segmenter` reads."""
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v.copy())
                               for k, v in params_to_torch_state(
                                   params).items()}}, path)


def init_deeplab_params(generator: torch.Generator,
                        num_classes: int = len(CLASSES),
                        layers=RESNET101_LAYERS, width: int = 64
                        ) -> Dict[str, Any]:
    """Random init from `generator` (a CPU generator): He-normal convs,
    GroupNorm weight 1 and bias 0, a zero classifier bias; the JAX
    initialiser's shapes. `layers` and `width` may be reduced. numpy
    leaves."""
    def he(shape):
        n = shape[0] * shape[2] * shape[3]
        return (torch.randn(shape, generator=generator)
                * np.sqrt(2.0 / n)).numpy()

    def gn_init(c):
        return {"weight": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32)}

    params: Dict[str, Any] = {"conv1_weight": he((width, 3, 7, 7)),
                              "bn1": gn_init(width)}
    cin = width
    for li, depth in enumerate(layers):
        cmid = width * (2 ** li)
        layer = {}
        for bi in range(depth):
            bp = {
                "conv1_weight": he((cmid, cin, 1, 1)), "bn1": gn_init(cmid),
                "conv2_weight": he((cmid, cmid, 3, 3)), "bn2": gn_init(cmid),
                "conv3_weight": he((cmid * 4, cmid, 1, 1)),
                "bn3": gn_init(cmid * 4),
            }
            if bi == 0:
                bp["downsample"] = {"0_weight": he((cmid * 4, cin, 1, 1)),
                                    "1": gn_init(cmid * 4)}
            layer[f"{bi}"] = bp
            cin = cmid * 4
        params[f"layer{li + 1}"] = layer
    depthc = 256 if width == 64 else width
    aspp = {}
    for i in (1, 5):
        aspp[f"aspp{i}_weight"] = he((depthc, cin, 1, 1))
    for i in (2, 3, 4):
        aspp[f"aspp{i}_weight"] = he((depthc, cin, 3, 3))
    for i in range(1, 6):
        aspp[f"aspp{i}_bn"] = gn_init(depthc)
    aspp["conv2_weight"] = he((depthc, depthc * 5, 1, 1))
    aspp["bn2"] = gn_init(depthc)
    aspp["conv3_weight"] = he((num_classes, depthc, 1, 1))
    aspp["conv3_bias"] = np.zeros((num_classes,), np.float32)
    params["aspp"] = aspp
    return params


# ----------------------------------------------------------- mask extraction


def preprocess(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC → the network's input [1, 3, 513, 513] float32: PIL
    bilinear resize, /255, ImageNet mean and std (on the host)."""
    from PIL import Image

    img = Image.fromarray(img_u8).resize((INPUT_SIZE, INPUT_SIZE),
                                         Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    return x.transpose(2, 0, 1)[None].astype(np.float32)


class Segmenter:
    """Face parser with the reference's mask morphology: the network on
    `device`, the resizes and the morphology on the host."""

    def __init__(self, params, resolution: int = 512,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device)
        self.resolution = resolution

    @torch.inference_mode()
    def logits(self, img_u8: np.ndarray) -> torch.Tensor:
        """uint8 HWC → logits [1, classes, 513, 513] on the device."""
        x = torch.from_numpy(preprocess(img_u8)).to(self.device)
        return deeplab_apply(self.params, x)

    @torch.inference_mode()
    def segment(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC → class-index map (uint8) at self.resolution
        (nearest)."""
        from PIL import Image

        pred = self.logits(img_u8)[0].argmax(dim=0).to(torch.uint8).cpu()
        mask = Image.fromarray(pred.numpy()).resize(
            (self.resolution, self.resolution), Image.NEAREST)
        return np.asarray(mask)

    def get_bg_mask(self, img_u8: np.ndarray) -> np.ndarray:
        import cv2

        mask = self.segment(img_u8)
        hair = (cv2.dilate((mask == CLASSES.index("hair")).astype("float"),
                           np.ones((10, 10))) > 0)
        bg = (mask == CLASSES.index("background")) | \
             (mask == CLASSES.index("cloth"))
        bg = (cv2.erode(bg.astype("float"), np.ones((20, 20))) > 0)
        bg[hair] = 0
        return bg

    def get_earring_mouth_teeth_masks(self, img_u8: np.ndarray,
                                      need_earring_mask: bool = True):
        import cv2

        mask = self.segment(img_u8)
        earring = (cv2.dilate((mask == CLASSES.index("ear_r")).astype("float"),
                              np.ones((15, 15))) > 0)
        mouth = mask == CLASSES.index("mouth")
        lips = (mask == CLASSES.index("u_lip")) | \
               (mask == CLASSES.index("l_lip"))
        teeth = (cv2.erode(mouth.astype("float"), np.ones((3, 3))) > 0)
        mouth = (cv2.dilate((mouth | lips).astype("float"),
                            np.ones((7, 7))) > 0)
        if need_earring_mask:
            return earring, mouth, teeth
        return None, mouth, teeth


def default_segmenter(ckpt_path: Optional[str] = None,
                      resolution: int = 512,
                      device: DeviceLike = None) -> Segmenter:
    """The Segmenter of `ckpt_path`, else of STYLEMC_DEEPLAB
    (deeplab_model.pth: {'state_dict': {'module.' + name: tensor}})."""
    ckpt_path = ckpt_path or os.environ.get("STYLEMC_DEEPLAB")
    if not ckpt_path or not os.path.exists(ckpt_path):
        raise FileNotFoundError("set STYLEMC_DEEPLAB to deeplab_model.pth")
    from ..io import load_state_dict_numpy

    state = load_state_dict_numpy(ckpt_path, key="state_dict")
    return Segmenter(params_from_torch_state(state), resolution=resolution,
                     device=device)


def read_image_mask(mask_path: str, mask_min_value: float = 0.0,
                    dilation: bool = True) -> np.ndarray:
    """A saved parsing mask, binarised for blending: background, hair, hat,
    ears, earrings, neck_l and cloth set to mask_min_value, the rest to 1,
    then dilated (20², three times)."""
    import cv2
    from PIL import Image

    segm = np.array(Image.open(mask_path))
    keep = ((segm == 0) | (segm == 13) | (segm == 14) | (segm == 8) |
            (segm == 9) | (segm == 15) | (segm == 16) | (segm == 18))
    out = segm.astype("float")
    out[keep] = mask_min_value
    out[~keep] = 1
    if dilation:
        out = cv2.dilate(out, np.ones((20, 20)), iterations=3)
    return out.astype(np.float32)
