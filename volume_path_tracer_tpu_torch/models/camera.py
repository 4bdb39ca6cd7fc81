"""Pinhole camera with the reference renderer's exact raster->world mapping.

Port of volume_path_tracer_tpu/models/camera.py: the look-at basis, the
raster -> screen -> camera maps precomposed on the host (float64 numpy) into
one 3x3 matrix plus translation, and batch ray generation as one product plus
a normalize. Ray generation adds the +0.5 pixel-center offset and the
caller's jitter (half a pixel when enabled: a preserved quirk of the
reference's worker.cpp:121-122).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.config import CameraParameters
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomposed camera: world ray = (position, normalize(M @ raster + t))."""

    position: torch.Tensor  # [3] float32
    raster_to_world_dir: torch.Tensor  # [3, 3] float32 (acts on (x, y, 0))
    raster_to_world_trans: torch.Tensor  # [3] float32
    imaging_ratio: float

    @staticmethod
    def from_numpy(
        position, raster_to_world_dir, raster_to_world_trans, imaging_ratio,
        device: DeviceLike = None,
    ) -> "Camera":
        """Camera from the JAX package's arrays (as numpy), on `device`."""
        dev = resolve_device(device)

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

        return Camera(
            position=f32(position),
            raster_to_world_dir=f32(raster_to_world_dir),
            raster_to_world_trans=f32(raster_to_world_trans),
            imaging_ratio=float(imaging_ratio),
        )

    @staticmethod
    def from_parameters(p: CameraParameters, output_size, device: DeviceLike = None) -> "Camera":
        width, height = int(output_size[0]), int(output_size[1])
        pos = np.asarray(p.position, dtype=np.float64)
        look = np.asarray(p.look, dtype=np.float64)
        up = np.asarray(p.up, dtype=np.float64)

        # camera_to_world look-at basis (camera.cpp:5-18)
        d = look - pos
        d = d / np.linalg.norm(d)
        un = up / np.linalg.norm(up)
        left = np.cross(un, d)
        new_up = np.cross(d, left)
        c2w = np.stack([left, new_up, d], axis=1)  # columns

        # screen_to_camera (camera.cpp:33-43): film plane at z=1
        ar = width / height
        vfov = np.pi * p.vfov_deg / 180.0
        tanv = np.tan(vfov / 2.0)
        s2c_lin = np.diag([ar * tanv, tanv, 0.0])
        s2c_t = np.array([0.0, 0.0, 1.0])

        # raster_to_screen (camera.cpp:21-31): (0,0)->(1,1), (W,H)->(-1,-1)
        r2s_lin = np.diag([-2.0 / width, -2.0 / height, 0.0])
        r2s_t = np.array([1.0, 1.0, 0.0])

        lin = c2w @ s2c_lin @ r2s_lin
        trans = c2w @ (s2c_lin @ r2s_t + s2c_t)
        return Camera.from_numpy(pos, lin, trans, p.imaging_ratio, device=device)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        """The camera with its tensors on `device`."""
        return dataclasses.replace(
            self, position=self.position.to(device),
            raster_to_world_dir=self.raster_to_world_dir.to(device),
            raster_to_world_trans=self.raster_to_world_trans.to(device),
        )

    def generate_rays(self, raster_xy: torch.Tensor, jitter: torch.Tensor):
        """Batch ray generation.

        raster_xy: [N, 2] integer pixel coordinates (x, y).
        jitter: [N, 2] offsets already scaled by the caller (0 or uniform*0.5).
        Returns (origins [N, 3], directions [N, 3]) in world space, unit dirs.
        """
        pt = raster_xy.to(torch.float32) + 0.5 + jitter
        m = self.raster_to_world_dir
        d = pt @ m[:, :2].T + self.raster_to_world_trans
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = self.position.expand(d.shape)
        return o, d
