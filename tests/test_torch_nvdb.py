"""The port's .nvdb file I/O (grids/nvdb.py, grids/native.py) against the JAX package's.

The file's bytes are a contract with the reference renderer, so everything
here is exact: no tolerance anywhere in this file.

- the round trips of tests/test_io.py::TestNvdb (simple, negative origin with
  several leaves, spanning two upper nodes, medium from file, missing
  density) for the port, with the C++ core and with the numpy path;
- the port's write_nvdb gives the same bytes as the JAX write_nvdb for the
  same grids, with the C++ core and without it;
- each package reads the other's file to bitwise equal arrays and equal
  transforms;
- a ZIP-codec file (a written blob deflated by hand, u64 size prefix) reads;
- the C++ core against the numpy path, bitwise, for fill_leaves and
  extract_leaves (negative origins, clipped leaves);
- read_nvdb_medium(device="cpu") equals medium_from_numpy of the JAX medium
  read from the same file, table for table;
- the loader: which path runs without g++, what a failing build raises, and
  that the library is built into the port's own _build/ directory.

The native cases are skipped only when g++ is absent.
"""
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from volume_path_tracer_tpu.grids import nvdb as jnvdb
from volume_path_tracer_tpu_torch.grids import native as tnative
from volume_path_tracer_tpu_torch.grids import nvdb as tnvdb
from volume_path_tracer_tpu_torch.models.medium import medium_from_numpy

torch.set_num_threads(2)

PATHS = ["native", "numpy"]


@pytest.fixture
def core(request):
    """Run the test body on the C++ core ("native") or the numpy path."""
    if request.param == "native":
        if shutil.which("g++") is None:
            pytest.skip("no g++ on PATH: the C++ core cannot be built here")
        assert tnative.available()
        yield "native"
    else:
        with tnative.numpy_only():
            yield "numpy"


def _grids(case):
    """name -> (data, origin_ijk, voxel_size, world_offset), from a seed."""
    rs = np.random.default_rng({"simple": 2, "negative": 3, "upper": 0, "two": 4, "sparse": 5}[case])
    if case == "simple":
        data = (rs.random((20, 12, 9)) * (rs.random((20, 12, 9)) > 0.5)).astype(np.float32)
        return {"density": (data, (0, 0, 0), 0.5, (1.0, -2.0, 3.0))}
    if case == "negative":
        return {"density": (rs.random((40, 33, 21)).astype(np.float32), (-17, -8, -3), 1.0, (0.0, 0.0, 0.0))}
    if case == "upper":
        data = np.zeros((16, 8, 8), np.float32)
        data[2, 3, 4] = 1.5
        data[13, 2, 1] = 2.5
        return {"density": (data, (-8, 0, 0), 1.0, (0.0, 0.0, 0.0))}
    if case == "two":
        d = rs.random((10, 10, 10)).astype(np.float32)
        t = (rs.random((11, 9, 12)) * 20).astype(np.float32)
        return {"density": (d, (0, 0, 0), 1.0, (0.0, 0.0, 0.0)),
                "temperature": (t, (-1, 2, 0), 1.0, (0.5, 0.5, 0.5))}
    data = np.zeros((150, 20, 9), np.float32)  # spans two lower nodes along x
    for c in [(0, 0, 0), (7, 7, 7), (8, 3, 2), (149, 19, 8), (131, 0, 4)]:
        data[c] = float(rs.uniform(0.1, 2.0))
    return {"density": (data, (-4, 3, 17), 0.25, (1.0, -2.0, 3.0))}


CASES = ["simple", "negative", "upper", "two", "sparse"]


def _embed(g, data, origin):
    """The reader's active-bbox array laid back into the written extent."""
    full = np.zeros(data.shape, np.float32)
    s = np.array(g.origin_ijk) - np.array(origin)
    e = s + np.array(g.data.shape)
    full[s[0]:e[0], s[1]:e[1], s[2]:e[2]] = g.data
    return full


@pytest.mark.parametrize("core", PATHS, indirect=True)
@pytest.mark.parametrize("case", ["simple", "negative", "upper"])
def test_roundtrip(tmp_path, case, core):
    grids = _grids(case)
    data, origin, voxel, offset = grids["density"]
    p = str(tmp_path / "g.nvdb")
    tnvdb.write_nvdb(p, grids)
    g = tnvdb.read_nvdb(p)["density"]
    assert g.voxel_size == voxel and g.world_offset == offset
    if case == "negative":  # all voxels nonzero: the bbox is the full extent
        assert g.origin_ijk == origin
    np.testing.assert_array_equal(_embed(g, data, origin), data)


@pytest.mark.parametrize("core", PATHS, indirect=True)
def test_medium_from_nvdb(tmp_path, core):
    grids = _grids("two")
    p = str(tmp_path / "m.nvdb")
    tnvdb.write_nvdb(p, grids)
    med = tnvdb.read_nvdb_medium(p, device="cpu")
    assert med.has_temperature and med.device.type == "cpu"
    np.testing.assert_array_equal(med.density.data.numpy(), grids["density"][0])
    np.testing.assert_array_equal(med.temperature.data.numpy(), grids["temperature"][0])
    assert med.temperature.origin_ijk == (-1, 2, 0) and med.temperature.world_offset == (0.5, 0.5, 0.5)
    unpacked = tnvdb.read_nvdb_medium(p, pack=False, device="cpu")
    assert unpacked.density_rows is None and med.density_rows is not None


def test_read_nvdb_medium_defaults_to_the_cuda_device(tmp_path):
    p = str(tmp_path / "m.nvdb")
    tnvdb.write_nvdb(p, _grids("simple"))
    if torch.cuda.is_available():
        assert tnvdb.read_nvdb_medium(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnvdb.read_nvdb_medium(p)


def test_missing_density_fatal_and_missing_temperature_warns(tmp_path, capsys):
    p = str(tmp_path / "x.nvdb")
    tnvdb.write_nvdb(p, {"foo": (np.ones((4, 4, 4), np.float32), (0, 0, 0), 1.0, (0, 0, 0))})
    with pytest.raises(tnvdb.NvdbError, match="density"):
        tnvdb.read_nvdb_medium(p, device="cpu")
    tnvdb.write_nvdb(p, _grids("simple"))
    med = tnvdb.read_nvdb_medium(p, device="cpu")
    assert not med.has_temperature
    assert 'no "temperature" grid' in capsys.readouterr().err


@pytest.mark.parametrize("core", PATHS, indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_writer_bytes_equal_the_jax_writer(tmp_path, case, core):
    grids = _grids(case)
    pt, pj = str(tmp_path / "t.nvdb"), str(tmp_path / "j.nvdb")
    tnvdb.write_nvdb(pt, grids)
    jnvdb.write_nvdb(pj, grids)
    with open(pt, "rb") as f, open(pj, "rb") as h:
        assert f.read() == h.read()


@pytest.mark.parametrize("core", PATHS, indirect=True)
@pytest.mark.parametrize("case", ["negative", "two", "sparse"])
def test_each_package_reads_the_others_file(tmp_path, case, core):
    grids = _grids(case)
    pt, pj = str(tmp_path / "t.nvdb"), str(tmp_path / "j.nvdb")
    tnvdb.write_nvdb(pt, grids)
    jnvdb.write_nvdb(pj, grids)
    for a, b in ((tnvdb.read_nvdb(pj), jnvdb.read_nvdb(pj)), (tnvdb.read_nvdb(pt), jnvdb.read_nvdb(pt))):
        assert list(a) == list(b) == list(grids)
        for name in grids:
            np.testing.assert_array_equal(a[name].data, b[name].data)
            assert a[name].data.dtype == b[name].data.dtype == np.float32
            assert a[name].origin_ijk == b[name].origin_ijk
            assert a[name].voxel_size == b[name].voxel_size
            assert a[name].world_offset == b[name].world_offset
            assert a[name].meta["voxel_count"] == b[name].meta["voxel_count"]


def _deflate(raw: bytes) -> bytes:
    """A one-grid codec-NONE file rewritten with the ZIP codec: the blob
    deflated, prefixed by its u64 uncompressed size, fileSize adjusted."""
    magic, version, count, codec = struct.unpack_from("<QIHH", raw, 0)
    assert (count, codec) == (1, 0)
    meta = bytearray(raw[16:16 + 176])
    grid_size, file_size = struct.unpack_from("<QQ", meta, 0)
    name_size = struct.unpack_from("<I", meta, 136)[0]
    name = raw[16 + 176:16 + 176 + name_size]
    blob = raw[16 + 176 + name_size:]
    assert len(blob) == grid_size == file_size - name_size
    packed = struct.pack("<Q", len(blob)) + zlib.compress(blob)
    struct.pack_into("<Q", meta, 8, name_size + len(packed))
    return struct.pack("<QIHH", magic, version, 1, 1) + bytes(meta) + name + packed


@pytest.mark.parametrize("core", PATHS, indirect=True)
def test_zip_codec_file_reads(tmp_path, core):
    grids = _grids("sparse")
    data, origin, voxel, offset = grids["density"]
    p = str(tmp_path / "plain.nvdb")
    tnvdb.write_nvdb(p, grids)
    with open(p, "rb") as f:
        zipped = _deflate(f.read())
    pz = str(tmp_path / "zip.nvdb")
    with open(pz, "wb") as f:
        f.write(zipped)
    g = tnvdb.read_nvdb(pz)["density"]
    np.testing.assert_array_equal(_embed(g, data, origin), data)
    assert (g.voxel_size, g.world_offset) == (voxel, offset)
    np.testing.assert_array_equal(g.data, jnvdb.read_nvdb(pz)["density"].data)
    # a size prefix that does not match is refused
    bad = bytearray(zipped)
    struct.pack_into("<Q", bad, 16 + 176 + len(b"density\x00"), 7)
    with open(pz, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(tnvdb.NvdbError, match="ZIP size"):
        tnvdb.read_nvdb(pz)


def test_not_a_nanovdb_file(tmp_path):
    p = str(tmp_path / "junk.nvdb")
    with open(p, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(tnvdb.NvdbError, match="not a NanoVDB file"):
        tnvdb.read_nvdb(p)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the C++ core cannot be built here")


def _numpy_leaves(data, lo):
    """The writer's numpy enumeration of nonzero 8^3 blocks (nvdb.py)."""
    with tnative.numpy_only():
        assert tnative.extract_leaves(data, lo) is None
    lo = np.asarray(lo, np.int64)
    hi = lo + np.array(data.shape) - 1
    leaf_lo, leaf_hi = (lo // 8) * 8, ((hi // 8) + 1) * 8
    ext = (leaf_hi - leaf_lo).astype(int)
    padded = np.zeros(tuple(ext), np.float32)
    s = (lo - leaf_lo).astype(int)
    padded[s[0]:s[0] + data.shape[0], s[1]:s[1] + data.shape[1], s[2]:s[2] + data.shape[2]] = data
    blocks = padded.reshape(ext[0] // 8, 8, ext[1] // 8, 8, ext[2] // 8, 8).transpose(0, 2, 4, 1, 3, 5)
    nz = np.argwhere(blocks.reshape(blocks.shape[:3] + (512,)).any(axis=-1))
    return leaf_lo + 8 * nz, np.stack([blocks[tuple(i)] for i in nz]) if len(nz) else np.zeros((0, 8, 8, 8))


@pytest.mark.parametrize("lo", [(0, 0, 0), (-17, -8, -3), (5, -1, 9), (-8, -16, 24)])
def test_extract_leaves_native_equals_numpy(lo, gxx):
    rs = np.random.default_rng(7)
    data = (rs.random((29, 17, 10)) * (rs.random((29, 17, 10)) > 0.9)).astype(np.float32)
    data[8:16, :, :] = 0.0  # an empty slab: whole blocks drop out
    origins, values = tnative.extract_leaves(data, lo)
    ref_origins, ref_values = _numpy_leaves(data, lo)
    np.testing.assert_array_equal(origins, ref_origins)
    np.testing.assert_array_equal(values, ref_values)
    assert origins.dtype == np.int32 and values.dtype == np.float32


@pytest.mark.parametrize("case", ["negative", "sparse", "two"])
def test_fill_leaves_native_equals_numpy(tmp_path, case, gxx):
    """The same file parsed with the core and with the numpy scatter; also a
    dense array smaller than the leaves' cover, so that leaves are clipped."""
    p = str(tmp_path / "g.nvdb")
    tnvdb.write_nvdb(p, _grids(case))
    a = tnvdb.read_nvdb(p)
    with tnative.numpy_only():
        b = tnvdb.read_nvdb(p)
    for name in a:
        np.testing.assert_array_equal(a[name].data, b[name].data)
        assert a[name].origin_ijk == b[name].origin_ijk
    # clipped scatter: leaves at 8-aligned origins into a window that cuts them
    rs = np.random.default_rng(9)
    n_leaf = 6
    raw = np.zeros((n_leaf, 96 + 2048), np.uint8)
    origins = np.array([[-8, 0, 0], [0, 0, 0], [8, 8, 0], [0, -8, 8], [16, 0, 8], [40, 40, 40]], np.int32)
    vals = rs.random((n_leaf, 512)).astype(np.float32)
    raw[:, :12] = (origins + np.array([1, 2, 3], np.int32)).view(np.uint8).reshape(n_leaf, 12)  # mBBoxMin
    raw[:, 96:] = vals.view(np.uint8).reshape(n_leaf, 2048)
    dense = np.zeros((21, 13, 12), np.float32)
    assert tnative.fill_leaves(raw, raw.shape[1], dense, (-3, -2, 1))
    ref = np.zeros_like(dense)
    for o, v in zip(origins, vals.reshape(n_leaf, 8, 8, 8)):
        l0 = o.astype(np.int64) - np.array([-3, -2, 1])
        a0, b0 = np.maximum(l0, 0), np.minimum(l0 + 8, dense.shape)
        if (b0 > a0).all():
            ref[a0[0]:b0[0], a0[1]:b0[1], a0[2]:b0[2]] = v[a0[0] - l0[0]:b0[0] - l0[0], a0[1] - l0[1]:b0[1] - l0[1],
                                                          a0[2] - l0[2]:b0[2] - l0[2]]
    np.testing.assert_array_equal(dense, ref)
    assert ref.any()


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_read_nvdb_medium_equals_medium_from_numpy_of_the_jax_medium(tmp_path, pack):
    from volume_path_tracer_tpu_torch.grids.procedural import fire_plume

    d, t = fire_plume(height=24, radius=6.0)
    p = str(tmp_path / "plume.nvdb")
    tnvdb.write_nvdb(p, {
        "density": (d.data.numpy(), d.origin_ijk, d.voxel_size, d.world_offset),
        "temperature": (t.data.numpy(), t.origin_ijk, t.voxel_size, t.world_offset),
    })
    med = tnvdb.read_nvdb_medium(p, pack=pack, device="cpu")
    jmed = jnvdb.read_nvdb_medium(p, pack=pack)
    ref = medium_from_numpy(jmed.density, jmed.temperature, device="cpu", pack=pack)
    for grid, jgrid, rgrid in ((med.density, jmed.density, ref.density),
                               (med.temperature, jmed.temperature, ref.temperature)):
        np.testing.assert_array_equal(grid.data.numpy(), np.asarray(jgrid.data))
        assert torch.equal(grid.data, rgrid.data)
        assert grid.origin_ijk == tuple(jgrid.origin_ijk) == rgrid.origin_ijk
        assert grid.voxel_size == jgrid.voxel_size and grid.world_offset == tuple(jgrid.world_offset)
    np.testing.assert_array_equal(med.majorants.rows.numpy(), np.asarray(jmed.majorants.rows))
    np.testing.assert_array_equal(med.majorants.brick_maj.numpy(), np.asarray(jmed.majorants.brick_maj))
    np.testing.assert_array_equal(med.majorants.super_maj.numpy(), np.asarray(jmed.majorants.super_maj))
    for mine, theirs in ((med.density_rows, jmed.density_rows), (med.temperature_rows, jmed.temperature_rows)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert (med.density_rows is None) == (not pack)


def test_loader_without_gxx_says_so_once_and_takes_numpy(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_decided", False)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    grids = _grids("negative")
    p = str(tmp_path / "g.nvdb")
    tnvdb.write_nvdb(p, grids)
    np.testing.assert_array_equal(tnvdb.read_nvdb(p)["density"].data, grids["density"][0])
    assert capsys.readouterr().err.count("no g++ on PATH") == 1


def test_loader_raises_with_the_compilers_output_when_the_build_fails(tmp_path, monkeypatch, gxx):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_decided", False)
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        tnative.available()


def test_library_is_built_in_the_ports_own_directory():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    assert tnative.SOURCE == os.path.join(pkg, "csrc", "nvdb_core.cpp") and os.path.isfile(tnative.SOURCE)
    assert tnative.BUILD_DIR == os.path.join(pkg, "_build")
    with open(tnative.SOURCE) as f:
        source = f.read()
    assert "vpt_fill_leaves(" in source and "vpt_extract_leaves(" in source
    if shutil.which("g++") is not None and tnative.available():
        built = [f for f in os.listdir(tnative.BUILD_DIR) if f.startswith("libnvdb_core-")]
        assert built
