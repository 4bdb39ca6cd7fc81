"""Color space conversions (CIE XYZ -> sRGB) and film tonemapping.

Port of volume_path_tracer_tpu/utils/color.py: the reference renderer's
XYZ -> linear sRGB matrix, the sRGB gamma curve, and the film (XYZ sum,
sample weight) -> u8 image mapping. Tensors on any device; the last axis is
the color axis.
"""
from __future__ import annotations

import numpy as np
import torch

# Standard CIE XYZ -> linear sRGB matrix (D65), the reference's constants.
XYZ_TO_LINSRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)


def xyz_to_linsrgb(xyz: torch.Tensor) -> torch.Tensor:
    """Convert CIE XYZ to linear sRGB. Last axis is the color axis."""
    m = torch.as_tensor(XYZ_TO_LINSRGB, device=xyz.device)
    return torch.einsum("ij,...j->...i", m, xyz)


def linsrgb_to_srgb(linsrgb: torch.Tensor) -> torch.Tensor:
    """Gamma-encode linear sRGB (IEC 61966-2-1 piecewise curve)."""
    x = linsrgb
    safe = torch.clamp(x, min=1e-12)
    return torch.where(
        x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055
    )


def film_to_srgb_u8(film: torch.Tensor) -> torch.Tensor:
    """Tonemap a film [H, W, 4] (XYZ sum, sample count) to u8 [H, W, 3].

    Divide by the weight (floored at 1e-30 so unrendered pixels are black,
    not NaN), convert to linear sRGB, gamma encode, clamp to [0, 1], scale
    to 255 and truncate (C-style float -> u8 cast).
    """
    xyz = film[..., :3] / torch.clamp(film[..., 3:4], min=1e-30)
    srgb = linsrgb_to_srgb(xyz_to_linsrgb(xyz))
    return (torch.clamp(srgb, 0.0, 1.0) * 255.0).to(torch.uint8)

