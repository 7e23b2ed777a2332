"""Edge-avoiding à-trous wavelet denoiser for path-traced radiance.

Counterpart of ``tpu_raytracer/render/denoise.py`` (Dammertz et al.,
"Edge-Avoiding À-Trous Wavelet Transform for fast Global Illumination
Filtering", HPG 2010): a 5x5 B3-spline kernel applied ``iterations``
times with dilation 1, 2, 4, ..., each tap down-weighted by its colour,
normal and depth difference so that smoothing stops at geometric edges.
Every tap is a shifted slice of an edge-replicated pad, summed in the
JAX package's tap order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 5-tap B3 spline, outer-producted into the 5x5 kernel per axis.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

# Miss pixels carry +inf depth; one large finite sentinel makes sky-sky
# taps weigh 1 and sky-surface taps ~0, with no inf - inf = NaN.
_MISS_DEPTH = 1e8


def _pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate ``[H, W, C]`` by ``r`` pixels on each side."""
    return F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode="replicate")[0].permute(1, 2, 0)


def atrous_denoise(radiance: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
                   iterations: int = 3, sigma_color: float = 0.25,
                   sigma_normal: float = 0.35, sigma_depth: float = 0.5) -> torch.Tensor:
    """Filter HDR ``radiance [H, W, 3]`` guided by the first hit's
    ``normal [H, W, 3]`` and ``depth [H, W]`` (+inf on a miss); returns
    the filtered ``[H, W, 3]`` f32. ``iterations`` doubles the footprint
    each pass (0 is the identity); colour weights follow the current
    estimate, the guides stay fixed."""
    img = torch.as_tensor(radiance, dtype=torch.float32)
    if iterations <= 0:
        return img
    n = torch.as_tensor(normal, dtype=torch.float32)
    z = torch.as_tensor(depth, dtype=torch.float32)
    z = torch.where(torch.isfinite(z), z, torch.full_like(z, _MISS_DEPTH))

    inv_sc = 1.0 / (2.0 * sigma_color * sigma_color)
    inv_sn = 1.0 / (2.0 * sigma_normal * sigma_normal)
    inv_sz = 1.0 / (2.0 * sigma_depth * sigma_depth)
    h, w = img.shape[0], img.shape[1]
    offs = (-2, -1, 0, 1, 2)
    for it in range(iterations):
        step = 1 << it
        r = 2 * step
        pimg, pn = _pad(img, r), _pad(n, r)
        pz = _pad(z[..., None], r)[..., 0]
        acc = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2], dtype=torch.float32, device=img.device)
        for iy, dy in enumerate(offs):
            for ix, dx in enumerate(offs):
                ky = _B3[iy] * _B3[ix]
                y0 = r + dy * step
                x0 = r + dx * step
                c_q = pimg[y0:y0 + h, x0:x0 + w]
                dc = c_q - img
                dn = pn[y0:y0 + h, x0:x0 + w] - n
                dz = pz[y0:y0 + h, x0:x0 + w] - z
                wt = ky * torch.exp(-(dc * dc).sum(-1) * inv_sc - (dn * dn).sum(-1) * inv_sn
                                    - dz * dz * inv_sz)
                acc = acc + c_q * wt[..., None]
                wsum = wsum + wt
        img = acc / torch.clamp(wsum, min=1e-12)[..., None]
    return img
