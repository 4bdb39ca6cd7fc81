"""volume_path_tracer_tpu_torch: the PyTorch/CUDA port of volume_path_tracer_tpu.

The same volumetric path tracer (delta tracking through dense voxel grids
with brick/superbrick majorants, blackbody emission, Henyey-Greenstein
scattering, next-event estimation with ratio-tracking shadow rays, wave
rendering into an (XYZ, weight) film) written as plain PyTorch, with the one
hot loop as a CUDA kernel for Hopper (csrc/trace_lanes.cu, bound in
render/megakernel.py).

The subpackages mirror the JAX package's layout module by module. This
package imports torch and numpy only: never jax, never volume_path_tracer_tpu.
Entry points run on the `cuda` device unless the caller passes device="cpu".

The names below are those the JAX package exports at its top level, in the
same places (file I/O is grids.nvdb: read_nvdb, read_nvdb_grids,
read_nvdb_medium, write_nvdb; the tools are tools.trace and
tools.visualize_ray). Importing the package builds no kernel and touches no
device.
"""

__version__ = "0.1.0"

from .grids.grid import DenseGrid, dense_grid_from_array
from .grids.majorant import MajorantPyramid, build_majorants
from .models.camera import Camera
from .models.medium import Medium
from . import render  # callable subpackage: render(scene) forwards to renderer.render
from .render.integrator import IntegratorParams
from .render.renderer import Scene, render_wave_image
from .utils.config import Configuration, read_configuration

__all__ = [
    "DenseGrid",
    "dense_grid_from_array",
    "MajorantPyramid",
    "build_majorants",
    "Camera",
    "Medium",
    "IntegratorParams",
    "Scene",
    "render",
    "render_wave_image",
    "Configuration",
    "read_configuration",
]
