"""Henyey-Greenstein phase function: evaluation and direction sampling.

Port of volume_path_tracer_tpu/ops/phase.py (the reference renderer's
utils.hpp:39-66 and random.hpp:56-84, both PBRT-derived). Vectorized over a
leading ray axis. The expressions keep the JAX package's operation order, so
the float32 results agree with it to the last ulp of the transcendentals.
"""
from __future__ import annotations

import math

import torch

INV_4PI = 1.0 / (4.0 * math.pi)


def henyey_greenstein(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    """HG phase function value for scattering angle cosine cos_theta."""
    den = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (den * torch.sqrt(torch.clamp(den, min=1e-12)))


def coordinate_system(v1: torch.Tensor):
    """Branchless ONB (Duff et al.) with v1 ([..., 3]) as the z axis."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    v2 = torch.stack([1.0 + sign * a * x * x, sign * b, -sign * x], dim=-1)
    v3 = torch.stack([b, sign + a * y * y, -y], dim=-1)
    return v2, v3


def sample_henyey_greenstein(w: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, g: float) -> torch.Tensor:
    """Sample a new direction around w ([..., 3]) from the HG distribution:
    inversion sampling of cos_theta (isotropic for |g| < 1e-3), uniform phi,
    the local direction normalized, then the branchless ONB frame."""
    g = torch.tensor(g, dtype=w.dtype, device=w.device)
    g2 = g * g
    denom = 1.0 + g - 2.0 * g * u1
    sqr = (1.0 - g2) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    aniso = (1.0 + g2 - sqr * sqr) / (2.0 * torch.where(torch.abs(g) < 1e-12, 1e-12, g))
    iso = 1.0 - 2.0 * u1
    cos_theta = torch.where(torch.abs(g) < 1e-3, iso, aniso)

    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2

    sin_c = torch.clamp(sin_theta, -1.0, 1.0)
    local = torch.stack(
        [sin_c * torch.cos(phi), sin_c * torch.sin(phi), torch.clamp(cos_theta, -1.0, 1.0)],
        dim=-1,
    )
    local = local / torch.linalg.vector_norm(local, dim=-1, keepdim=True)

    vx, vy = coordinate_system(w)
    return local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * w
