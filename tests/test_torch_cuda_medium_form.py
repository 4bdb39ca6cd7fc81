"""choose_pack's count of a packed build against the card's allocator.

Runs only where CUDA is; elsewhere every test skips (on the card:
`python -m pytest --noconftest tests/test_torch_cuda_*.py`). This file
imports neither JAX nor the JAX package.

models.medium.packed_bytes says what Medium.from_grids(pack=True) holds on
the device once built (`held`) and at most at once while it builds (`peak`:
the padded copy the packer makes of a grid and a fused temperature's
[X+2, Y+2, Z+2] array beside the finished table). choose_pack packs only
where the device's free memory holds `peak`, so `peak` must not fall short
of torch.cuda.max_memory_allocated over the build, and `held` must be what
stays allocated. Three media: density alone, a fused (alignment-compatible)
temperature, and a temperature on its own transform with its own rows, for
which `peak` is an upper bound. The allocator rounds each block up (to 512 B,
and a large block by less than 1 MB where it is not split), hence SLACK.
"""
import pytest
import torch

from volume_path_tracer_tpu_torch.grids.grid import dense_grid_from_array
from volume_path_tracer_tpu_torch.models.medium import Medium, packed_bytes

pytestmark = pytest.mark.cuda

SHAPE = (160, 144, 136)
SLACK = 4 * 2 ** 20


def _grids(temperature):
    g = torch.Generator().manual_seed(5)
    density = dense_grid_from_array(torch.rand(SHAPE, generator=g), (-80, -72, -68))
    if temperature is None:
        return density, None
    offset = (0.0, 0.0, 0.0) if temperature == "fused" else (0.3, 0.0, 0.0)
    t = dense_grid_from_array(torch.rand((96, 100, 88), generator=g), (-48, -50, -44), 1.0, offset)
    return density, t


@pytest.mark.parametrize("temperature", [None, "fused", "own rows"])
def test_packed_bytes_covers_the_builds_peak(temperature):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    density, t = _grids(temperature)
    _, held, peak = packed_bytes(density, t)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    medium = Medium.from_grids(density, t, device=dev)
    torch.cuda.synchronize(dev)
    built = torch.cuda.max_memory_allocated(dev) - base
    kept = torch.cuda.memory_allocated(dev) - base
    assert medium.form == "packed"
    assert (medium.temperature_rows is None) == (temperature != "own rows")
    assert medium.resident_bytes == held
    assert abs(kept - held) <= SLACK, (kept, held)
    assert built <= peak + SLACK, (built, peak)
    # and the count is the build's, not a loose bound: within the slack where
    # it is exact, above what stays where the temperature has its own rows
    if temperature == "own rows":
        assert built > held, (built, held)
    else:
        assert built >= peak - SLACK, (built, peak)
    del medium
    torch.cuda.empty_cache()
