"""Spectral subsystem: Planck blackbody emission pre-integrated to CIE XYZ.

Port of volume_path_tracer_tpu/utils/spectral.py. The LUT is built once on
the host with numpy, with the same float32 math as the JAX package (so the
tables are bitwise equal), and shipped to the device as a small [n, 3] table.
Breakpoint i holds temperature (i-1)*100 K: the reference renderer's
deliberate one-slot shift (its src/precompute_blackbody.cpp:7-52), so slot 0
holds T=-100 K, which the Planck T<=0 guard zeroes.

The table is sized to cover the scene's hottest temperature
(breakpoints_for_max_temp) instead of falling back to exact spectral
integration above 49,900 K; temperatures beyond the table continue the last
segment linearly.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .cie_data import CIE_X, CIE_Y, CIE_Z, CIE_Y_INTEGRAL, LAMBDA_MIN, NUM_WAVELENGTHS

N_BREAKPOINTS = 500
RESOLUTION = 50000.0 / N_BREAKPOINTS  # 100 K


def planck_law(lambda_m: np.ndarray, temperature_k: float) -> np.ndarray:
    """Spectral radiance of a blackbody (W.sr^-1.m^-3), float32 math."""
    lambda_m = np.asarray(lambda_m, dtype=np.float32)
    if temperature_k <= 0.0:
        return np.zeros_like(lambda_m)
    c = np.float32(299792458.0)
    h = np.float32(6.62606957e-34)
    kb = np.float32(1.3806488e-23)
    num = np.float32(2.0) * h * c * c
    lambda5 = lambda_m**5
    with np.errstate(over="ignore"):  # exp overflow -> inf -> radiance 0, as in f32 C++
        ex = np.exp((h * c) / (lambda_m * kb * np.float32(temperature_k)))
        return num / (lambda5 * (ex - np.float32(1.0)))


def blackbody_spectrum_to_xyz(temperature_k: float) -> np.ndarray:
    """Integrate the Planck spectrum at T against the CIE XYZ curves: plain
    1 nm Riemann sums over 360..830 nm, normalized by the CIE Y integral."""
    lambdas_nm = np.arange(LAMBDA_MIN, LAMBDA_MIN + NUM_WAVELENGTHS, dtype=np.float32)
    s = planck_law(lambdas_nm * np.float32(1e-9), temperature_k)
    return (
        np.array([np.dot(CIE_X, s), np.dot(CIE_Y, s), np.dot(CIE_Z, s)])
        / CIE_Y_INTEGRAL
    ).astype(np.float32)


def _idx_to_temp(idx: int) -> float:
    return (idx - 1) * RESOLUTION


@functools.lru_cache(maxsize=8)
def _xyz_table_np(n_breakpoints: int) -> np.ndarray:
    table = np.zeros((n_breakpoints, 3), dtype=np.float32)
    for i in range(n_breakpoints):
        table[i] = blackbody_spectrum_to_xyz(_idx_to_temp(i))
    table.setflags(write=False)
    return table


def blackbody_xyz_table(n_breakpoints: int = N_BREAKPOINTS) -> np.ndarray:
    """The [n, 3] float32 blackbody XYZ LUT, breakpoint i at (i-1)*100 K."""
    return _xyz_table_np(int(n_breakpoints)).copy()


def breakpoints_for_max_temp(t_max_k: float) -> int:
    """Table length covering temperatures up to t_max_k (>= the default 500)."""
    need = int(math.ceil(max(0.0, float(t_max_k)) / RESOLUTION)) + 2
    return max(N_BREAKPOINTS, need)


def blackbody_pairs(table: torch.Tensor) -> torch.Tensor:
    """Pair-packed LUT [n-1, 6]: row i = (table[i], table[i+1] - table[i]).

    One row gather per lookup; lo + slope * frac is bitwise the two-gather
    lerp (the stored difference is the same float32 subtraction).
    """
    t = torch.as_tensor(table, dtype=torch.float32)
    return torch.cat([t[:-1], t[1:] - t[:-1]], dim=-1)


def blackbody_radiation_xyz_from_pairs(pairs: torch.Tensor, temperature_k: torch.Tensor) -> torch.Tensor:
    """XYZ radiance [..., 3] of a blackbody at temperature_k via the pair LUT.

    T <= 0 -> 0; otherwise the lerp between the two straddling breakpoints of
    the shifted table. The index is clipped to the table, the fraction is not.
    """
    t = temperature_k
    n = pairs.shape[0] + 1
    t_max = (n - 1) * RESOLUTION
    tc = torch.clamp(t, 0.0, t_max - 1e-3)
    idx = torch.floor(tc / RESOLUTION).to(torch.int64) + 1
    idx = torch.clamp(idx, 0, n - 2)
    frac = tc / RESOLUTION - (idx - 1).to(tc.dtype)
    row = pairs[idx]
    out = row[..., :3] + row[..., 3:] * frac[..., None]
    return torch.where(t[..., None] <= 0.0, 0.0, out)


def blackbody_radiation_xyz_value_grad(table: torch.Tensor, temperature_k: torch.Tensor):
    """(xyz, d xyz / dT) [..., 3] each of the LUT lookup: the closed-form
    derivative the replay backward pass uses (diff/prb.py).

    The value is bitwise blackbody_radiation_xyz_from_pairs(blackbody_pairs(
    table), T): hi - lo is the pair's stored slope. The derivative is that
    slope / RESOLUTION inside the lerp's range and 0 where the T <= 0 guard
    or the clamp is in effect, as reverse-mode AD of the lookup gives.
    """
    t = temperature_k
    table = torch.as_tensor(table, dtype=torch.float32, device=t.device)
    n = table.shape[0]
    t_max = (n - 1) * RESOLUTION
    tc = torch.clamp(t, 0.0, t_max - 1e-3)
    idx = torch.floor(tc / RESOLUTION).to(torch.int64) + 1
    idx = torch.clamp(idx, 0, n - 2)
    frac = tc / RESOLUTION - (idx - 1).to(tc.dtype)
    lo = table[idx]
    slope = table[idx + 1] - lo
    out = lo + slope * frac[..., None]
    in_range = (t > 0.0) & (t < t_max - 1e-3)
    grad = torch.where(in_range[..., None], slope / RESOLUTION, 0.0)
    return torch.where(t[..., None] <= 0.0, 0.0, out), grad
