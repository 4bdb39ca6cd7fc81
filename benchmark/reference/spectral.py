"""Blackbody emission pre-integrated to CIE XYZ, from the public CIE tables.

The reference renderer's scheme: Planck's law on a 1 nm grid from 360 to
830 nm, summed against the CIE 1931 curves and divided by the Y curve's
integral, tabulated every 100 K with its deliberate one-slot shift (slot i
holds (i - 1) * 100 K), and read by linear interpolation between slots.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

RESOLUTION_K = 100.0
MIN_SLOTS = 500

_CIE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cie1931.json")


def _cie():
    with open(_CIE) as f:
        c = json.load(f)
    xyz = np.array([c["x"], c["y"], c["z"]], dtype=np.float32)
    return c["lambda_min_nm"], xyz, c["y_integral"]


def planck(lambda_m: np.ndarray, kelvin: float) -> np.ndarray:
    """Spectral radiance of a blackbody (W sr^-1 m^-3), in float32."""
    lam = np.asarray(lambda_m, dtype=np.float32)
    if kelvin <= 0.0:
        return np.zeros_like(lam)
    c = np.float32(299792458.0)
    h = np.float32(6.62606957e-34)
    kb = np.float32(1.3806488e-23)
    with np.errstate(over="ignore"):
        return (np.float32(2.0) * h * c * c) / (lam ** 5 * (np.exp((h * c) / (lam * kb * np.float32(kelvin)))
                                                           - np.float32(1.0)))


def slots_for(max_kelvin: float) -> int:
    """Table length that covers max_kelvin (never under MIN_SLOTS)."""
    return max(MIN_SLOTS, int(math.ceil(max(0.0, max_kelvin) / RESOLUTION_K)) + 2)


def xyz_table(n_slots: int) -> np.ndarray:
    """[n_slots, 3] float32: slot i is the XYZ of a blackbody at (i - 1) * 100 K."""
    lam0, cmf, y_int = _cie()
    lam = (np.arange(cmf.shape[1], dtype=np.float32) + np.float32(lam0)) * np.float32(1e-9)
    out = np.zeros((n_slots, 3), dtype=np.float32)
    for i in range(n_slots):
        s = planck(lam, (i - 1) * RESOLUTION_K)
        out[i] = (np.array([np.dot(cmf[0], s), np.dot(cmf[1], s), np.dot(cmf[2], s)]) / y_int).astype(np.float32)
    return out


class Blackbody:
    """The table on a device, read as the reference renderer reads it."""

    def __init__(self, max_kelvin: float, device, dtype=torch.float32):
        table = torch.from_numpy(xyz_table(slots_for(max_kelvin))).to(device)
        self.n = table.shape[0]
        self.lo = table[:-1].to(dtype)
        self.slope = (table[1:] - table[:-1]).to(dtype)
        self.t_cap = float(np.float32((self.n - 1) * RESOLUTION_K - 1e-3))
        self.dtype = dtype

    def __call__(self, kelvin: torch.Tensor) -> torch.Tensor:
        tc = torch.clamp(kelvin, 0.0, self.t_cap)
        slot = torch.clamp(torch.floor(tc / RESOLUTION_K).long() + 1, 0, self.n - 2)
        frac = tc / RESOLUTION_K - (slot - 1).to(tc.dtype)
        out = self.lo[slot] + self.slope[slot] * frac[:, None]
        return torch.where((kelvin <= 0.0)[:, None], torch.zeros_like(out), out)
