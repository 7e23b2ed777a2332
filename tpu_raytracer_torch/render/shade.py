"""Primary-hit shading in flat mode.

Counterpart of ``tpu_raytracer/render/shade.py`` for the reference's
active path: misses take the sky colour (255, 204, 153); textured
materials sample nearest-neighbour with v flipped and a C-style
truncating modulo wrap clamped at 0, scaled by the literal 0.0039215;
untextured ones take their albedo; flat illumination is 1 clamped to
[0.4, 1]; the u8 cast truncates. Lit modes (and so a light direction),
filtered textures and sky maps are not ported yet (ROADMAP items 8 and
9).
"""

from __future__ import annotations

import torch

SKY_COLOR = (255, 204, 153)


def _c_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C-style truncating integer modulo (a negative stays negative)."""
    b = torch.clamp(b, min=1)
    return torch.where(a >= 0, a % b, -((-a) % b))


def _fetch_texel(scene, idx: torch.Tensor) -> torch.Tensor:
    """Unpack ``r | g << 8 | b << 16`` atlas words to [..., 3] f32."""
    word = scene.tex_atlas[torch.clamp(idx, 0, scene.tex_atlas.shape[0] - 1)]
    return torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF],
                       dim=-1).to(torch.float32)


def _sample_texture_nearest(scene, start, w, h, uv) -> torch.Tensor:
    tex_x = (uv[..., 0] * w.to(torch.float32)).to(torch.int32)
    tex_y = ((1.0 - uv[..., 1]) * h.to(torch.float32)).to(torch.int32)
    tex_x = torch.clamp(_c_mod(tex_x, w), min=0)
    tex_y = torch.clamp(_c_mod(tex_y, h), min=0)
    idx = torch.clamp(start, min=0) + tex_y * w + tex_x
    return _fetch_texel(scene, idx.long()) * 0.0039215


def surface_color(scene, attrs) -> torch.Tensor:
    """Nearest texture sample where the material is textured, else its
    albedo."""
    alb = scene.mat_albedo[attrs.material]
    if not scene.has_textures:
        return alb
    start = scene.mat_tex_start[attrs.material]
    w = scene.mat_tex_w[attrs.material]
    h = scene.mat_tex_h[attrs.material]
    tex = _sample_texture_nearest(scene, start, w, h, attrs.uv)
    return torch.where((start >= 0)[..., None], tex, alb)


def compute_illumination(attrs) -> torch.Tensor:
    """Scalar illumination per ray in the reference's flat mode: 1
    clamped to [0.4, 1]."""
    illum = torch.ones(attrs.t.shape, dtype=torch.float32, device=attrs.t.device)
    illum = torch.clamp(illum, max=1.0)
    return torch.clamp(illum, min=0.4)


def shade_primary(scene, attrs) -> torch.Tensor:
    """Flat primary-hit shade -> uint8 [..., 3] in the reference's
    channel order."""
    if scene.has_sky:
        raise NotImplementedError("environment-map skies are not ported yet "
                                  "(ROADMAP item 9)")
    color = surface_color(scene, attrs)
    illum = compute_illumination(attrs)
    rgb = illum[..., None] * color * 255.0
    shaded = rgb.to(torch.uint8)  # truncates like the C cast
    sky = torch.tensor(SKY_COLOR, dtype=torch.uint8, device=shaded.device)
    return torch.where(attrs.hit[..., None], shaded, sky)
