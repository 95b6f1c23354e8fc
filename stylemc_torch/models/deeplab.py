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

`Segmenter` runs the network on the card, one call per batch of images;
the 513² bilinear resize before it, the nearest resize of the class maps
after it and the mask morphology (cv2) run on the host per image, as in
the reference.
"""

from __future__ import annotations

import functools
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import params_from_numpy
from ..device import DeviceLike, host_later, resolve_device
from ..utils.profiling import record_function, to_device

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


# each byte's normalised value per channel, [3, 256] float32, worked out
# as the reference does it (/255 in float32, then the mean and std in
# float64), so that a lookup gives its values bit for bit
_NORMALISED = ((np.arange(256, dtype=np.float32) / 255.0)[None]
               - np.asarray(IMAGENET_MEAN)[:, None]) \
    / np.asarray(IMAGENET_STD)[:, None]
_NORMALISED = _NORMALISED.astype(np.float32)


def _ready(images):
    """An array, or the function that returns one."""
    return images() if callable(images) else images


def _per_image(fn: Callable, items) -> list:
    """[fn(item) for item in items], the items spread over threads: PIL's
    resizes and cv2's morphology release the interpreter lock."""
    items = list(items)
    if len(items) < 2:
        return [fn(item) for item in items]
    with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def preprocess_batch(images_u8) -> np.ndarray:
    """uint8 NHWC → the network's input [N, 3, 513, 513] float32
    (contiguous): PIL bilinear resize, /255, ImageNet mean and std (on the
    host, per image)."""
    from PIL import Image

    out = np.empty((len(images_u8), 3, INPUT_SIZE, INPUT_SIZE), np.float32)

    def one(i):
        img = np.asarray(Image.fromarray(np.asarray(images_u8[i])).resize(
            (INPUT_SIZE, INPUT_SIZE), Image.BILINEAR))
        for c in range(3):
            np.take(_NORMALISED[c], img[..., c], out=out[i, c])

    _per_image(one, range(len(images_u8)))
    return out


def preprocess(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC → the network's input [1, 3, 513, 513] float32."""
    return preprocess_batch(img_u8[None])


def _morph(op, mask: np.ndarray, size: int) -> np.ndarray:
    """cv2's erode or dilate of a boolean mask by a size² square."""
    import cv2

    return getattr(cv2, op)(mask.astype("float"), np.ones((size, size))) > 0


def bg_mask(cls_map: np.ndarray) -> np.ndarray:
    """Background or cloth eroded by 20², less hair dilated by 10²."""
    hair = _morph("dilate", cls_map == CLASSES.index("hair"), 10)
    bg = (cls_map == CLASSES.index("background")) | \
        (cls_map == CLASSES.index("cloth"))
    bg = _morph("erode", bg, 20)
    bg[hair] = 0
    return bg


def earring_mask(cls_map: np.ndarray) -> np.ndarray:
    """Earrings (ear_r) dilated by 15²."""
    return _morph("dilate", cls_map == CLASSES.index("ear_r"), 15)


def teeth_mask(cls_map: np.ndarray) -> np.ndarray:
    """The mouth's inside eroded by 3²."""
    return _morph("erode", cls_map == CLASSES.index("mouth"), 3)


def mouth_mask(cls_map: np.ndarray) -> np.ndarray:
    """Mouth or lips dilated by 7²."""
    lips = (cls_map == CLASSES.index("u_lip")) | \
        (cls_map == CLASSES.index("l_lip"))
    return _morph("dilate", (cls_map == CLASSES.index("mouth")) | lips, 7)


# what feature blending reads, in the order it blends: the earring mask at
# 32², then the background and teeth masks at 64²
BLEND_MASKS = (("earring", 32), ("background", 64), ("teeth", 64))


class Segmenter:
    """Face parser with the reference's mask morphology: the network on
    `device`, one call per batch of images with the argmax on the device
    and one copy of the class maps to the host; the resizes and the
    morphology on the host, per image, as in the reference.

    Counters: `deeplab_calls` and `deeplab_rows`, the network's calls and
    the images they parsed; `masks_nonempty`, by kind (background,
    earring, teeth), the blend masks `blend_masks` made that are not
    empty."""

    def __init__(self, params, resolution: int = 512,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device)
        self.resolution = resolution
        self.deeplab_calls = 0
        self.deeplab_rows = 0
        self.masks_nonempty = {kind: 0 for kind, _ in BLEND_MASKS}

    def network_input(self, images_u8) -> torch.Tensor:
        """uint8 NHWC → the network's input [N, 3, 513, 513] on the
        device, in one copy."""
        with record_function("segmenter.preprocess", rows=len(images_u8)):
            return to_device(preprocess_batch(images_u8), self.device)

    @torch.inference_mode()
    def logits(self, images_u8) -> torch.Tensor:
        """uint8 NHWC, or one HWC image → logits [N, classes, 513, 513] on
        the device, in one network call."""
        images_u8 = np.asarray(images_u8)
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        return deeplab_apply(self.params, self.network_input(images_u8))

    @torch.inference_mode()
    def _launch(self, images_u8) -> Callable[[], np.ndarray]:
        """uint8 NHWC (or the function that returns them) → preprocessed on
        the host; the network, the argmax and the copy of the 513²
        class-index maps (uint8) to the host queued on the device; → a
        function that waits for the maps."""
        x = self.network_input(_ready(images_u8))
        n = x.shape[0]
        with record_function("segmenter.logits", rows=n, bucket=n):
            maps = host_later(deeplab_apply(self.params, x).argmax(dim=1).to(
                torch.uint8))
        self.deeplab_calls += 1
        self.deeplab_rows += n

        def wait() -> np.ndarray:
            with record_function("segmenter.logits", rows=n, bucket=n):
                return maps()

        return wait

    def _resized(self, maps: np.ndarray) -> List[np.ndarray]:
        from PIL import Image

        return _per_image(lambda m: np.asarray(Image.fromarray(m).resize(
            (self.resolution, self.resolution), Image.NEAREST)), maps)

    def segment(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC → class-index map (uint8) at self.resolution
        (nearest)."""
        maps = self._launch(img_u8[None])()
        with record_function("segmenter.masks", rows=1):
            return self._resized(maps)[0]

    def blend_masks(self, originals_u8, edits_u8,
                    need_earring: Sequence[bool]
                    ) -> Dict[str, Optional[np.ndarray]]:
        """The masks feature blending reads, for N rows: {'background':
        the originals' [N, res, res] bool, 'earring': the edits' (all
        False in a row that needs none; None where no row needs one),
        'teeth': the edits'}; one network call for the originals and one
        for the edits. Either batch may be given as the function that
        returns it (`host_later`, a copy still on its way): the host's
        steps then overlap the device's work, the originals' preprocessing
        with what the device does before their copy completes, the
        edits' with the originals' network call, and the originals' masks
        with the edits'."""
        orig = self._launch(originals_u8)
        edit = self._launch(edits_u8)
        orig = orig()
        with record_function("segmenter.masks", rows=len(orig)):
            bg = np.stack(_per_image(bg_mask, self._resized(orig)))
        edit = edit()
        with record_function("segmenter.masks", rows=len(edit)):
            edit = self._resized(edit)
            teeth = np.stack(_per_image(teeth_mask, edit))
            earring = np.stack(_per_image(
                lambda i: earring_mask(edit[i]) if need_earring[i]
                else np.zeros(edit[i].shape, bool), range(len(edit)))) \
                if any(need_earring) else None
        masks = {"background": bg, "earring": earring, "teeth": teeth}
        for kind, m in masks.items():
            if m is not None:
                self.masks_nonempty[kind] += int(m.any(axis=(1, 2)).sum())
        return masks

    def get_bg_mask(self, img_u8: np.ndarray) -> np.ndarray:
        return bg_mask(self.segment(img_u8))

    def get_earring_mouth_teeth_masks(self, img_u8: np.ndarray,
                                      need_earring_mask: bool = True):
        mask = self.segment(img_u8)
        earring = earring_mask(mask) if need_earring_mask else None
        return earring, mouth_mask(mask), teeth_mask(mask)


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
