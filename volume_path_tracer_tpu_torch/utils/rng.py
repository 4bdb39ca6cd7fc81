"""Counter-based, stateless RNG: PCG4D on (pixel id, stream, counter, salt).

Port of volume_path_tracer_tpu/utils/rng.py (pcg4d, counter_uniforms,
mix_stream, sample_exponential, sample_discrete3). Every draw is a pure
function of global coordinates, so renders are deterministic and independent
of lane order; the port draws the SAME bits as the JAX package.

uint32 arithmetic: torch on the CPU has no `add` or `>>` on torch.uint32, and
int32 `>>` sign-extends. Words are therefore held in int64 in [0, 2^32) and
masked after every operation. Products are split into 16-bit halves so that
no int64 product overflows (the low 32 bits are exact either way, but signed
overflow is left undefined by C++). The CUDA kernel (csrc/trace_lanes.cu)
uses uint32_t directly.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_LCG_MUL = 1664525
_LCG_ADD = 1013904223

# Largest float32 strictly below 1.0: the reference's uniform<float> clamp.
_ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))


def _u32(x) -> torch.Tensor:
    """Any integer tensor -> its uint32 bit pattern, held in int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for words in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg4d(a, b, c, d):
    """PCG4D hash (Jarzynski & Olano, JCGT 2020): 4 x uint32 -> 4 x uint32.

    Inputs are integer tensors (any dtype; their low 32 bits are used).
    Returns four int64 tensors holding uint32 values.
    """
    v0 = (_u32(a) * _LCG_MUL + _LCG_ADD) & _M32
    v1 = (_u32(b) * _LCG_MUL + _LCG_ADD) & _M32
    v2 = (_u32(c) * _LCG_MUL + _LCG_ADD) & _M32
    v3 = (_u32(d) * _LCG_MUL + _LCG_ADD) & _M32
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    return v0, v1, v2, v3


def _u32_to_uniform(v: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1): round to nearest, scale by 2^-32,
    clamp to 1 - 2^-24 (values within 2^7 of 2^32 round up to 2^32)."""
    f = v.to(torch.float32) * (2.0 ** -32)
    return torch.clamp(f, max=_ONE_MINUS_EPS)


def counter_uniforms(pixel_ids: torch.Tensor, stream, iteration, n: int) -> torch.Tensor:
    """n uniforms in [0, 1) per lane, shape [N, n], from pure counters.

    pixel_ids: [N] integer global pixel ids. stream: uint32 stream word
    (python int or [N] tensor). iteration: python int or per-lane [N]
    integer counter (cast to uint32, as the JAX package does).
    """
    pid = _u32(pixel_ids)
    shape = pid.shape
    dev = pid.device
    s = _u32(torch.as_tensor(stream, device=dev)).expand(shape)
    it = _u32(torch.as_tensor(iteration, device=dev)).expand(shape)
    outs = []
    for salt in range((n + 3) // 4):
        outs.extend(pcg4d(pid, s, it, torch.full(shape, salt, dtype=torch.int64, device=dev)))
    return torch.stack([_u32_to_uniform(o) for o in outs[:n]], dim=-1)


def mix_stream(seed: int, wave: int) -> int:
    """Mix (seed, wave) into the uint32 stream word for counter_uniforms."""
    return (
        (int(seed) & _M32) * 0x9E3779B9 + (int(wave) & _M32) * 0x85EBCA6B
    ) & _M32


def sample_exponential(u: torch.Tensor, a) -> torch.Tensor:
    """Sample from pdf a*exp(-a*x): -log(1-u)/a."""
    return -torch.log1p(-u) / a


def sample_discrete3(w0, w1, w2, u) -> torch.Tensor:
    """3-way discrete sample by CDF inversion: int32 index 0/1/2 among
    weights (w0, w1, w2), picking the first prefix sum >= u * total."""
    total = w0 + w1 + w2
    x = u * total
    idx = torch.where(x <= w0, 0, torch.where(x <= w0 + w1, 1, 2))
    return idx.to(torch.int32)
