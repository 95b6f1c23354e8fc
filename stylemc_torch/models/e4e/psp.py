"""pSp wrapper: encoder + StyleGAN2 decoder + latent_avg offset
(counterpart of `stylemc_tpu/models/e4e/psp.py`).

Encode to W+ codes, add latent_avg when the model has one (and
start_from_latent_avg, the default), optionally
inject or zero rows (latent_mask), decode with per-row w (the mapping
network skipped) and adaptive-pool the output to 256².
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...convert import params_from_numpy
from ...device import DeviceLike, resolve_device
from ...utils.image import adaptive_avg_pool2d
from ..stylegan2.generator import GeneratorConfig, synthesis, w_to_s
from .encoders import (backbone_encoder_into_w, encoder4editing,
                       gradual_style_encoder, style_count)

ENCODERS = {"Encoder4Editing": encoder4editing,
            "GradualStyleEncoder": gradual_style_encoder,
            "SingleStyleCodeEncoder": backbone_encoder_into_w}


@dataclasses.dataclass
class PSPConfig:
    stylegan_size: int = 1024
    encoder_type: str = "Encoder4Editing"
    start_from_latent_avg: bool = True
    # encoder body [(in_c, depth, stride), ...]; None = IR-SE-50
    encoder_layout: Optional[Any] = None


@dataclasses.dataclass
class PSP:
    cfg: PSPConfig
    encoder_params: Dict[str, Any]
    decoder_cfg: GeneratorConfig
    decoder_params: Dict[str, Any]
    latent_avg: Optional[torch.Tensor] = None    # [S, 512] or None

    def encode(self, x: torch.Tensor, progressive_stage: int = 18
               ) -> torch.Tensor:
        """x: [N,3,256,256] in [-1,1] → W+ codes [N, S, 512]."""
        if self.cfg.encoder_type not in ENCODERS:
            raise ValueError(self.cfg.encoder_type)
        kw = {"layout": self.cfg.encoder_layout}
        if self.cfg.encoder_type == "Encoder4Editing":
            kw["progressive_stage"] = progressive_stage
        codes = ENCODERS[self.cfg.encoder_type](
            self.encoder_params, x, self.cfg.stylegan_size, **kw)
        if self.cfg.start_from_latent_avg and self.latent_avg is not None:
            codes = codes + self.latent_avg[None].to(codes.dtype)
        return codes

    def decode(self, codes: torch.Tensor, resize: bool = True,
               noise_mode: str = "const") -> torch.Tensor:
        """W+ codes [N, S, 512] → images [N,3,256,256] (resize=True) or at
        the decoder's resolution."""
        styles = w_to_s(self.decoder_params, self.decoder_cfg, codes)
        images = synthesis(self.decoder_params, self.decoder_cfg, styles,
                           noise_mode=noise_mode)
        if resize and images.shape[-1] != 256:
            images = adaptive_avg_pool2d(images, 256, 256)
        return images

    def __call__(self, x, resize: bool = True, return_latents: bool = False,
                 latent_mask: Optional[List[int]] = None,
                 inject_latent=None, alpha: Optional[float] = None,
                 noise_mode: str = "const", progressive_stage: int = 18):
        """Encode then decode. latent_mask rows take inject_latent's rows
        (blended by alpha when given), or zeros without inject_latent."""
        codes = self.encode(x, progressive_stage)
        if latent_mask is not None:
            codes = codes.clone()
            for i in latent_mask:
                if inject_latent is None:
                    codes[:, i] = 0.0
                elif alpha is None:
                    codes[:, i] = inject_latent[:, i]
                else:
                    codes[:, i] = alpha * inject_latent[:, i] + \
                        (1 - alpha) * codes[:, i]
        images = self.decode(codes, resize=resize, noise_mode=noise_mode)
        if return_latents:
            return images, codes
        return images


def load_psp_from_checkpoint(path: str, stylegan_size: int = 1024,
                             encoder_type: str = "Encoder4Editing",
                             device: DeviceLike = None) -> PSP:
    """Load an e4e checkpoint (the e4e_ffhq_encode.pt layout: encoder.* /
    decoder.* keys in "state_dict", and latent_avg) onto `device`."""
    from ...io.rosinality import generator_params_from_rosinality
    from ...io.torch_state import strip_prefix
    from .encoders import encoder_params_from_torch_state

    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()
             if isinstance(v, torch.Tensor)}
    encoder_params = encoder_params_from_torch_state(
        strip_prefix(state, "encoder."), stylegan_size)
    dec_cfg, dec_params = generator_params_from_rosinality(
        strip_prefix(state, "decoder."), stylegan_size)
    latent_avg = None
    if "latent_avg" in ckpt:
        latent_avg = ckpt["latent_avg"].float().numpy()
        if latent_avg.ndim == 1:
            latent_avg = np.repeat(latent_avg[None],
                                   style_count(stylegan_size), axis=0)
        latent_avg = torch.from_numpy(np.ascontiguousarray(latent_avg)).to(dev)
    return PSP(cfg=PSPConfig(stylegan_size=stylegan_size,
                             encoder_type=encoder_type),
               encoder_params=params_from_numpy(encoder_params, dev),
               decoder_cfg=dec_cfg,
               decoder_params=params_from_numpy(dec_params, dev),
               latent_avg=latent_avg)
