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
"""

__version__ = "0.1.0"
