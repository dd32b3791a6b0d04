"""Density-field rasterization for rendering — the counterpart of
``water_sandbox_tpu/viz/raster.py``: a density (or speed) raster splatted
onto a regular image grid on the particles' own device, with no
per-particle host work. 2-D scenes raster the plane; 3-D scenes raster an
axis-aligned slab or a column-sum projection.
"""

from __future__ import annotations

import torch


def raster2d(pos: torch.Tensor, values: torch.Tensor, bounds, width: int,
             height: int) -> torch.Tensor:
    """Splat per-particle ``values`` (n,) onto a (height, width) image on
    ``pos``'s device.

    bounds = (min_xy, max_xy) tensors of shape (2,). Bilinear splat: each
    particle feeds its 4 surrounding pixels, indices clipped to the image."""
    lo, hi = bounds
    extent = hi - lo
    uv = (pos[:, :2] - lo) / extent * torch.tensor(
        [width - 1, height - 1], dtype=pos.dtype, device=pos.device)
    x0 = torch.floor(uv[:, 0]).to(torch.int64)
    y0 = torch.floor(uv[:, 1]).to(torch.int64)
    fx = uv[:, 0] - x0
    fy = uv[:, 1] - y0

    img = torch.zeros(height * width, dtype=pos.dtype, device=pos.device)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi = torch.clamp(x0 + dx, 0, width - 1)
        yi = torch.clamp(y0 + dy, 0, height - 1)
        img.index_add_(0, yi * width + xi, values * w)
    return img.view(height, width)


def density_image(state, params, width: int = 256, height: int = 144,
                  values=None, z_slab: float | None = None) -> torch.Tensor:
    """Raster the particle density field over the container footprint.

    3-D: restrict to a slab |z - center_z| < z_slab (default: full
    projection)."""
    c = params.container
    lo = (c.center - c.half_size)[:2]
    hi = (c.center + c.half_size)[:2]
    pos = state.pos
    vals = state.density if values is None else values
    if pos.shape[1] == 3 and z_slab is not None:
        vals = vals * ((pos[:, 2] - c.center[2]).abs() < z_slab).to(
            vals.dtype)
    return raster2d(pos, vals, (lo, hi), width, height)


def speed_image(state, params, width: int = 256,
                height: int = 144) -> torch.Tensor:
    """The velocity-magnitude field the reference's commented-out color
    system wanted (fluid_compute.rs:489-502)."""
    speed = (state.vel ** 2).sum(dim=1).sqrt()
    return density_image(state, params, width, height, values=speed)


def ascii_preview(img: torch.Tensor, levels: str = " .:-=+*#%@") -> str:
    """Terminal heat map — the zero-dependency HUD. Fetches the image to
    the host."""
    a = img.cpu().numpy()
    if a.max() > 0:
        a = a / a.max()
    idx = (a * (len(levels) - 1)).astype(int)
    return "\n".join("".join(levels[v] for v in row) for row in idx[::-1])
