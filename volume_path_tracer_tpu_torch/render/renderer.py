"""Scene assembly and per-wave rendering.

Port of volume_path_tracer_tpu/render/renderer.py. A wave is one sample per
pixel over the whole image, rendered as one (optionally chunked) batch of
rays; the film keeps the (XYZ sum, sample count) layout, so every wave
boundary is a valid snapshot. Draws are keyed on (seed, wave, global pixel
id), so renders are deterministic and independent of chunking.

Path choice (the port's replacement for use_fused_path): every wave of
render and render_wave_image is one call of megakernel.render_wave per pixel
chunk, whose wrapper makes the one device switch: a film on a CUDA device
launches the wave kernel (camera rays, tracing and the film add in one
launch), a film on the CPU runs its plain version. render_rays_wave, for
callers that want a batch's contribution and not a film, goes through
megakernel.trace_rays_fused.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.camera import Camera
from ..models.medium import Medium
from ..utils import logging as vlog
from ..utils import rng as vrng
from ..utils.config import Configuration
from ..utils.device import DeviceLike, resolve_device, same_device
from ..utils.spans import span
from ..utils.spectral import blackbody_xyz_table, breakpoints_for_max_temp
from .integrator import IntegratorParams, emission_enabled, trace_rays_diff
from .megakernel import JITTER_COUNTER, render_wave, trace_rays_fused


@dataclasses.dataclass(frozen=True)
class Scene:
    """Everything needed to render: medium, camera and transport parameters."""

    medium: Medium
    camera: Camera
    params: IntegratorParams
    width: int
    height: int
    seed: int
    num_waves: int
    use_jitter: bool
    single_pixel: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.medium.device

    @functools.cached_property
    def bb_table(self) -> Optional[torch.Tensor]:
        """The blackbody LUT on the scene's device, sized to the hottest
        temperature (None for a non-emissive medium); built once."""
        return _bb_table_for(self.medium, self.params)

    @staticmethod
    def from_config(
        cfg: Configuration, medium: Medium, max_iters: int = 8192, device: DeviceLike = None
    ) -> "Scene":
        """A Scene on `device` (CUDA unless device="cpu"); `medium` must
        already live there."""
        dev = resolve_device(device)
        if not same_device(medium.device, dev):
            raise ValueError(f"the medium lives on {medium.device}, the scene on {dev}")
        wp = cfg.worker_parameters
        return Scene(
            medium=medium,
            camera=Camera.from_parameters(cfg.camera_parameters, cfg.output_size, device=dev),
            params=IntegratorParams.from_config(cfg.volume_parameters, wp, max_iters=max_iters),
            width=cfg.output_size[0],
            height=cfg.output_size[1],
            seed=cfg.seed,
            num_waves=cfg.num_waves,
            use_jitter=wp.use_jitter,
            single_pixel=tuple(wp.single_pixel.coord) if wp.single_pixel.enabled else None,
        )


def pixel_coords(width: int, height: int) -> np.ndarray:
    """Row-major [H*W, 2] (x, y) integer pixel coordinates."""
    ys, xs = np.mgrid[0:height, 0:width]
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.int32)


def _bb_table_for(medium: Medium, params: IntegratorParams) -> Optional[torch.Tensor]:
    if not emission_enabled(medium, params):
        return None
    # Size the LUT to the scene's hottest reachable temperature (trilinear
    # interpolation never exceeds the largest corner value).
    t_max = (
        float(medium.temperature.data.max()) * params.temperature_scale
        + params.temperature_offset
    )
    table = blackbody_xyz_table(breakpoints_for_max_temp(t_max))
    return torch.from_numpy(table).to(medium.device)


def render_rays_wave(
    medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table: Optional[torch.Tensor],
    raster_xy: torch.Tensor,
    pixel_ids: torch.Tensor,
    seed: int,
    wave: int,
    use_jitter: bool,
    imaging_ratio: float,
):
    """Render one wave for a batch of pixels.

    Returns ([N, 4] film contribution (imaging_ratio * XYZ, weight 1),
    iterations, n_capped), the last two as 0-d tensors.
    """
    stream = vrng.mix_stream(seed, wave)
    u_jit = vrng.counter_uniforms(pixel_ids, stream, JITTER_COUNTER, 2)
    jitter = u_jit * (0.5 if use_jitter else 0.0)  # half-pixel jitter quirk
    o_w, d_w = camera.generate_rays(raster_xy, jitter)
    L, iters, n_capped = trace_rays_fused(medium, params, bb_table, o_w, d_w, pixel_ids, stream)
    contrib = torch.cat(
        [imaging_ratio * L, torch.ones((L.shape[0], 1), dtype=torch.float32, device=L.device)],
        dim=-1,
    )
    return contrib, iters, n_capped


def render_wave_image(
    scene: Scene,
    wave: int,
    film: Optional[torch.Tensor] = None,
    chunk_pixels: Optional[int] = None,
    chunk_callback=None,
    return_ncap: bool = False,
):
    """Accumulate one full wave into the film [H, W, 4]; returns the new film.

    return_ncap=True returns (film, n_capped 0-d tensor) and skips the
    truncation warning, so a caller can accumulate the count on the device
    and read it once. chunk_callback(pixels_done, pixels_total, film) runs
    after each pixel chunk but the last when the wave is chunked.
    """
    with span("render.wave"):
        return _render_wave_image(scene, wave, film, chunk_pixels, chunk_callback, return_ncap)


def _render_wave_image(scene, wave, film, chunk_pixels, chunk_callback, return_ncap):
    H, W = scene.height, scene.width
    dev = scene.device
    # A new film: the caller's stays as it was (render_wave adds in place).
    with span("render.film"):
        out = (torch.zeros((H, W, 4), dtype=torch.float32, device=dev) if film is None
               else film.clone(memory_format=torch.contiguous_format))
    stream = vrng.mix_stream(scene.seed, wave)

    def wave_of(pixels):
        _, n_capped = render_wave(
            scene.medium, scene.params, scene.camera, scene.bb_table, out, pixels, stream,
            scene.use_jitter, scene.camera.imaging_ratio,
        )
        return n_capped

    if scene.single_pixel is not None:
        x, y = scene.single_pixel
        sp_ncap = wave_of(range(y * W + x, y * W + x + 1))
        return (out, sp_ncap) if return_ncap else out

    n = W * H
    chunk = chunk_pixels or n
    ncap_dev = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        ncap_dev = ncap_dev + wave_of(range(start, end))
        if chunk_callback is not None and end < n:
            chunk_callback(end, n, out)
    if return_ncap:
        return out, ncap_dev
    ncap = int(ncap_dev)
    if ncap:
        vlog.warn(
            f"wave {wave}: {ncap} rays truncated at the iteration cap "
            f"(max_iters={scene.params.max_iters}) - raise --max-iters to "
            f"eliminate the bias"
        )
    return out


def render(
    scene: Scene,
    num_waves: Optional[int] = None,
    chunk_pixels: Optional[int] = None,
    wave_callback=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Render `num_waves` (default: the scene's) waves; returns film [H, W, 4].

    Runs on `device` (CUDA unless device="cpu"), which must be the scene's.
    wave_callback(wave_index, film) runs after each wave; returning False
    stops after that wave. num_waves=0 returns the zero film (the JAX
    package raises there).
    """
    dev = resolve_device(device)
    if not same_device(scene.device, dev):
        raise ValueError(f"the scene lives on {scene.device}; pass device={str(scene.device)!r}")
    waves = num_waves if num_waves is not None else scene.num_waves
    film = torch.zeros((scene.height, scene.width, 4), dtype=torch.float32, device=dev)
    ncap_total = torch.zeros((), dtype=torch.int64, device=dev)
    for w in range(1, waves + 1):  # waves are 1-indexed
        film, ncap_w = render_wave_image(scene, w, film, chunk_pixels, return_ncap=True)
        ncap_total = ncap_total + ncap_w
        if wave_callback is not None and wave_callback(w, film) is False:
            break
    ncap = int(ncap_total)
    if ncap:
        vlog.warn(
            f"{ncap} rays (all waves) truncated at the iteration cap "
            f"(max_iters={scene.params.max_iters}) - raise max_iters to "
            f"eliminate the bias"
        )
    return film


def render_radiance_diff(
    scene: Scene,
    wave: int,
    n_iters: int,
    raster_xy: torch.Tensor,
    pixel_ids: torch.Tensor,
    medium: Optional[Medium] = None,
) -> torch.Tensor:
    """Differentiable per-ray radiance [N, 3] for a pixel batch: the bounded
    loop of integrator.trace_rays_diff under torch autograd.

    `medium` overrides the scene's, so a caller can hand in grids that
    require gradients (inverse rendering).
    """
    med = medium if medium is not None else scene.medium
    bb = _bb_table_for(med, scene.params)
    stream = vrng.mix_stream(scene.seed, wave)
    u_jit = vrng.counter_uniforms(pixel_ids, stream, JITTER_COUNTER, 2)
    jitter = u_jit * (0.5 if scene.use_jitter else 0.0)
    o_w, d_w = scene.camera.generate_rays(raster_xy, jitter)
    return trace_rays_diff(med, scene.params, bb, o_w, d_w, pixel_ids, stream, n_iters)
