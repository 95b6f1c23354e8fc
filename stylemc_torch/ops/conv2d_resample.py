"""2D convolution with fused FIR up/downsampling (counterpart of
`stylemc_tpu/ops/conv2d_resample.py`).

Padding is applied once with respect to the upsampled image; up > 1 applies
the FIR with gain up²; flip_weight=True means correlation (F.conv2d), False a
true convolution. Where the FIR follows a convolution it is composed into the
conv kernel (valid correlations compose as the full convolution of their
kernels), so a fused up-conv is one convolution. Two forms of that up-conv,
selected per call by `up_impl`:

* "polyphase": one low-resolution convolution with up²·O output channels
  whose phases interleave into the output;
* "pad_dilate": convolve the materialised zero-upsampled input at full
  resolution.

They are the same function. Every caller of the port runs polyphase, training
and forward-only rendering alike: on an H100 in fp32 it takes 0.13–0.48 of
pad_dilate's time at every conv0 that serving runs. pad_dilate stays for
`GeneratorConfig.up_conv_impl`, which native `.npz` configs share with the JAX
package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .upfirdn2d import (_get_filter_size, _pad_dilate, _parse_padding,
                        filter_like, upfirdn2d)

UP_CONV_IMPLS = ("polyphase", "pad_dilate")
DEFAULT_UP_CONV_IMPL = "polyphase"


def _compose_kernel_with_fir(wk, f, gain: float, flip_filter: bool):
    """The conv kernel composed with the FIR that would follow it.

    C(C(u, a), b) == C(u, a ⊛ b) for valid correlations, where a ⊛ b is the
    full 2D convolution of the kernels and `b` is the FIR as upfirdn2d
    applies it: scaled by gain**(ndim/2), flipped unless flip_filter.
    """
    f = filter_like(f, wk)
    if f.ndim == 1:
        f = torch.outer(f, f)
    b = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        b = b.flip((0, 1))
    o, i, kh, kw = wk.shape
    fh, fw = b.shape
    # full convolution of each (o, i) plane with b == correlation of the
    # (fh-1, fw-1)-padded plane with flip(b)
    a = wk.reshape(o * i, 1, kh, kw)
    rhs = b.flip((0, 1))[None, None].to(wk.dtype)
    m = F.conv2d(a, rhs, padding=(fh - 1, fw - 1))
    return m.reshape(o, i, kh + fh - 1, kw + fw - 1)


def _polyphase_up_conv(x, wk, up: int, pads):
    """VALID-corr(pad(zero_interleave(x, up), pads), wk) as ONE low-res conv.

    Output row r = up·m + a reads input rows m - s_a + t with kernel taps
    wk[up·t + c_a], where c_a = (py0 - a) mod up and s_a = ⌊(py0 - a)/up⌋:
    each output phase is a plain correlation of x. The up² phases come from
    one conv with (phase_r, phase_c, O)-blocked output channels, then are
    sliced and interleaved.
    """
    n, _, h, w_sp = x.shape
    o, i, kh, kw = wk.shape
    px0, px1, py0, py1 = pads
    th, tw = -(-kh // up), -(-kw // up)  # taps per phase (ceil)
    ho = up * h + py0 + py1 - kh + 1
    wo = up * w_sp + px0 + px1 - kw + 1
    assert ho > 0 and wo > 0, (ho, wo)

    c_r = [(py0 - a) % up for a in range(up)]
    s_r = [(py0 - a - c_r[a]) // up for a in range(up)]
    c_c = [(px0 - b) % up for b in range(up)]
    s_c = [(px0 - b - c_c[b]) // up for b in range(up)]
    big_sr, big_sc = max(s_r), max(s_c)
    mr = -(-ho // up)   # uniform per-phase slice length (final crop trims)
    mc = -(-wo // up)
    rr = mr + big_sr - min(s_r)   # conv output rows needed
    cc = mc + big_sc - min(s_c)

    lo_r, hi_r = big_sr, (rr + th - 1) - big_sr - h
    lo_c, hi_c = big_sc, (cc + tw - 1) - big_sc - w_sp
    xp = F.pad(x, (lo_c, hi_c, lo_r, hi_r))

    # polyphase kernel [up²·O, I, th, tw], output channels blocked (a, b, o)
    wk_pad = F.pad(wk, (0, tw * up - kw, 0, th * up - kh))
    wkr = wk_pad.reshape(o, i, th, up, tw, up)
    ph = torch.stack([wkr[:, :, :, c_r[a], :, :] for a in range(up)], dim=0)
    ph = torch.stack([ph[..., c_c[b]] for b in range(up)], dim=1)
    wk_poly = ph.reshape(up * up * o, i, th, tw)

    out = F.conv2d(xp, wk_poly).reshape(n, up, up, o, rr, cc)
    rows = []
    for a in range(up):
        r0 = big_sr - s_r[a]
        cols = [out[:, a, b, :, r0:r0 + mr,
                    big_sc - s_c[b]:big_sc - s_c[b] + mc] for b in range(up)]
        rows.append(torch.stack(cols, dim=-1))     # [n, o, mr, mc, up_b]
    y = torch.stack(rows, dim=3)                   # [n, o, mr, up_a, mc, up_b]
    return y.reshape(n, o, up * mr, up * mc)[:, :, :ho, :wo]


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding=0,
                    groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False, up_impl=None):
    """Convolve NCHW `x` with OIHW `w`, with optional FIR up/downsampling.

    `f` comes from `setup_filter`. `up_impl` picks the fused up-conv form
    ("polyphase" | "pad_dilate"; None → polyphase);
    `conv2d_resample.up_convs` counts the fused up-convs run, by form.
    """
    assert x.ndim == 4 and w.ndim == 4
    impl = up_impl or DEFAULT_UP_CONV_IMPL
    assert impl in UP_CONV_IMPLS, up_impl
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # fold the resampling geometry into the edge padding
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    pads = (px0, px1, py0, py1)

    wk = w if flip_weight else w.flip((2, 3))
    wk = wk.to(x.dtype)

    if up > 1:
        fuse = f is not None and down == 1 and groups == 1
        if fuse:
            conv2d_resample.up_convs[impl] += 1
            wk = _compose_kernel_with_fir(wk, f, gain=up ** 2,
                                          flip_filter=flip_filter)
            if impl == "polyphase":
                return _polyphase_up_conv(x, wk, up, pads)
        x = F.conv2d(_pad_dilate(x, (up, up), pads), wk, groups=groups)
        if fuse:
            return x
        x = upfirdn2d(x, f, gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    if down > 1:
        x = _pad_dilate(x, (1, 1), pads)
        if f is not None and groups == 1:
            # S_d(C(C(u, w), f)) == S_d(C(u, w ⊛ f)): one strided conv
            wk = _compose_kernel_with_fir(wk, f, gain=1.0,
                                          flip_filter=flip_filter)
            return F.conv2d(x, wk, stride=down, groups=groups)
        x = F.conv2d(x, wk, groups=groups)
        return upfirdn2d(x, f, down=down, flip_filter=flip_filter)

    return F.conv2d(_pad_dilate(x, (1, 1), pads), wk, groups=groups)


conv2d_resample.up_convs = dict.fromkeys(UP_CONV_IMPLS, 0)
