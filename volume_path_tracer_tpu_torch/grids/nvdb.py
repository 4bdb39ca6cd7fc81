"""NanoVDB (.nvdb) file I/O: pure-Python parser + writer for float grids.

Port of volume_path_tracer_tpu/grids/nvdb.py (numpy, struct and zlib only;
the port keeps its own copy). Replaces the reference renderer's dependency on
the NanoVDB C++ library for file ingestion (nanovdb::io::readGrid, its
volume_grids.cpp:39-56): the VDB tree is parsed on the host and repacked into
the dense [X, Y, Z] layout the tracer uses; read_nvdb_medium then builds the
Medium on the render device. A writer for the same format is included so
procedural and optimized volumes can be exported back to .nvdb for use with
the reference renderer, and so the round trip is testable without binary
assets. The writer's bytes are a contract: the same grids give the same file
as the JAX package's writer, with the C++ core (grids/native.py) and without.

Implemented from the public NanoVDB memory-layout specification (ABI version
32.3+: position-independent offsets). Scope: FLOAT grids, uniform-scale maps,
codecs NONE and ZIP (zlib). The tree is the fixed NanoVDB topology
root -> upper internal (32^3 children, 4096^3 extent) -> lower internal
(16^3 children, 128^3 extent) -> leaf (8^3 voxels).

Layout summary (float grid, little-endian):
  FileHeader   16 B: u64 magic "NanoVDB0", u32 version, u16 gridCount, u16 codec
  per grid: FileMetaData 176 B + gridName + (compressed) grid blob
  GridData    672 B: magic, checksum, version, flags, gridIndex/Count,
               gridSize, name[256], Map (264 B: 9d+9d+3d+d / 9f+9f+3f+f),
               worldBBox (6d), voxelSize (3d), gridClass, gridType,
               blind-metadata offset/count, data0..2
  TreeData     64 B: u64 nodeOffset[4] (leaf/lower/upper/root, relative to
               tree start), u32 nodeCount[3], u32 tileCount[3], u64 voxelCount
  RootData     64 B (alignas 32): CoordBBox, tableSize, background, min, max,
               avg, stddev; then tableSize x Tile{u64 key, i64 child (rel. to
               root), u32 state, f32 value} (24 B each)
  Upper node   8256 B header (bbox, flags, value/child masks 4096 B each,
               stats) + 32768 x 8 B table (union{f32 value, i64 child(rel. to
               this node)})
  Lower node   1088 B header (masks 512 B each) + 4096 x 8 B table
  Leaf         96 B header (bboxMin, bboxDif, flags, valueMask 64 B, stats)
               + 512 x f32 values
  Node coord->offset: x-major, ((i&M)>>T << 2L) | ((j&M)>>T << L) | (k&M)>>T
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

MAGIC_FILE = 0x304244566F6E614E  # "NanoVDB0"
MAGIC_GRID = 0x314244566F6E614E  # "NanoVDB1" (ABI >= 32.4 per-grid magic)
GRID_TYPE_FLOAT = 1
GRID_CLASS_FOG = 2

_FILE_HEADER = struct.Struct("<QIHH")
_FILE_META = struct.Struct("<4Q2I6d6i3dI4I3I2HI")  # 176 bytes
assert _FILE_META.size == 176, _FILE_META.size

_GRIDDATA_SIZE = 672
_TREEDATA_SIZE = 64
_ROOTDATA_SIZE = 64
_ROOT_TILE_SIZE = 24
_UPPER_HEADER = 8256
_UPPER_TABLE = 32768
_LOWER_HEADER = 1088
_LOWER_TABLE = 4096
_LEAF_HEADER = 96
_LEAF_SIZE = 96 + 512 * 4


def _version(major=32, minor=3, patch=0) -> int:
    return (major << 21) | (minor << 10) | patch


def _decode_version(v: int) -> Tuple[int, int, int]:
    return (v >> 21, (v >> 10) & ((1 << 11) - 1), v & ((1 << 10) - 1))


class NvdbError(ValueError):
    pass


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------
def _root_key_to_origin(key: int) -> Tuple[int, int, int]:
    """Decode the single-u64 root key to the upper node's origin coords."""
    def dec(bits21):
        # 21-bit field holds (uint32(coord) >> 12); recover int32 coord.
        u = (bits21 << 12) & 0xFFFFFFFF
        return u - (1 << 32) if u >= (1 << 31) else u

    k = dec(key & 0x1FFFFF)
    j = dec((key >> 21) & 0x1FFFFF)
    i = dec((key >> 42) & 0x1FFFFF)
    return (i, j, k)


def _mask_bits(buf: bytes) -> np.ndarray:
    """Bitmask bytes -> bool array indexed by node-local offset."""
    words = np.frombuffer(buf, dtype="<u8")
    return (
        (words[:, None] >> np.arange(64, dtype=np.uint64)[None, :]) & 1
    ).astype(bool).reshape(-1)


class NvdbGrid:
    """A parsed float grid: dense array over the active index bbox."""

    def __init__(self, name, data, origin_ijk, voxel_size, world_offset, meta):
        self.name = name
        self.data = data  # np.float32 [X, Y, Z]
        self.origin_ijk = origin_ijk
        self.voxel_size = voxel_size
        self.world_offset = world_offset
        self.meta = meta  # dict with background, class, bboxes, counts...


def _parse_grid_blob(blob: bytes, expect_name: str) -> NvdbGrid:
    if len(blob) < _GRIDDATA_SIZE + _TREEDATA_SIZE:
        raise NvdbError("grid blob too small")
    magic, checksum = struct.unpack_from("<QQ", blob, 0)
    if magic not in (MAGIC_FILE, MAGIC_GRID):
        raise NvdbError(f"bad grid magic 0x{magic:x}")
    (version,) = struct.unpack_from("<I", blob, 16)
    major, minor, patch = _decode_version(version)
    if major != 32:
        raise NvdbError(f"unsupported NanoVDB ABI major version {major}")
    name = blob[40 : 40 + 256].split(b"\x00", 1)[0].decode("utf-8", "replace")
    # Map: doubles at 296 (matD 9), 368 (invMatD 9), 440 (vecD 3)
    matd = np.frombuffer(blob, "<f8", 9, 296).reshape(3, 3)
    vecd = np.frombuffer(blob, "<f8", 3, 440)
    world_bbox = np.frombuffer(blob, "<f8", 6, 560)
    voxel_size3 = np.frombuffer(blob, "<f8", 3, 608)
    grid_class, grid_type = struct.unpack_from("<II", blob, 632)
    if grid_type != GRID_TYPE_FLOAT:
        raise NvdbError(f"grid {name!r}: only float grids supported (type={grid_type})")
    diag = np.diag(matd)
    if not (np.allclose(matd, np.diag(diag)) and np.allclose(diag, diag[0])):
        raise NvdbError(f"grid {name!r}: only uniform-scale maps supported")
    voxel_size = float(diag[0])

    tree = _GRIDDATA_SIZE
    node_off = struct.unpack_from("<4Q", blob, tree)
    node_count = struct.unpack_from("<3I", blob, tree + 32)
    voxel_count = struct.unpack_from("<Q", blob, tree + 56)[0]

    root = tree + node_off[3]
    bbox = struct.unpack_from("<6i", blob, root)
    table_size, background, vmin, vmax = struct.unpack_from("<I3f", blob, root + 24)
    bb_lo = np.array(bbox[:3], np.int64)
    bb_hi = np.array(bbox[3:], np.int64)  # inclusive max
    if table_size == 0 or np.any(bb_hi < bb_lo):
        data = np.zeros((0, 0, 0), np.float32)
        return NvdbGrid(name, data, (0, 0, 0), voxel_size, tuple(vecd), dict(
            background=background, vmin=vmin, vmax=vmax, grid_class=grid_class,
            voxel_count=voxel_count, node_count=node_count))
    extent = bb_hi - bb_lo + 1
    nbytes = int(np.prod(extent)) * 4
    if nbytes > 8 << 30:
        raise NvdbError(
            f"grid {name!r}: dense extent {tuple(extent)} needs {nbytes>>30} GiB"
        )
    data = np.zeros(tuple(extent), np.float32)

    def fill_box(lo, hi_excl, value):
        """Fill a constant tile region, clipped to the active bbox."""
        a = np.maximum(lo - bb_lo, 0)
        b = np.minimum(hi_excl - bb_lo, extent)
        if np.all(b > a):
            data[a[0] : b[0], a[1] : b[1], a[2] : b[2]] = value

    def bulk_fill_leaves():
        """Fill all leaves in one pass: NanoVDB stores each node level as a
        contiguous array (that is what TreeData::mNodeOffset/nodeCount index),
        and every leaf holds its own origin (mBBoxMin) — no tree walk needed.
        """
        n_leaf = node_count[0]
        if n_leaf == 0:
            return
        base = tree + node_off[0]
        raw = np.frombuffer(
            blob, np.uint8, n_leaf * _LEAF_SIZE, base
        ).reshape(n_leaf, _LEAF_SIZE)
        # The C++ core where it runs; else the numpy path below (the same
        # array either way).
        from . import native as _native

        if _native.fill_leaves(raw, _LEAF_SIZE, data, bb_lo):
            return
        # mBBoxMin is the leaf's *active* bbox min; the node origin is its
        # 8-aligned floor (LeafNode::origin() = mBBoxMin & ~MASK).
        origins = (
            raw[:, :12].copy().view("<i4").reshape(n_leaf, 3).astype(np.int64) & ~7
        )
        values = raw[:, _LEAF_HEADER : _LEAF_HEADER + 2048].copy().view("<f4")
        values = values.reshape(n_leaf, 8, 8, 8)
        # Scatter leaf blocks with vectorized fancy indexing, chunked to
        # bound index-array memory. Leaves are 8-aligned and the active bbox
        # contains every active voxel, but clip defensively.
        chunk = 4096
        offs = np.arange(8)
        for s in range(0, n_leaf, chunk):
            e = min(s + chunk, n_leaf)
            lo = origins[s:e] - bb_lo  # [M,3] local leaf origins
            ix = lo[:, 0, None] + offs  # [M,8]
            iy = lo[:, 1, None] + offs
            iz = lo[:, 2, None] + offs
            ok = (
                (ix[:, 0] >= 0) & (ix[:, -1] < extent[0])
                & (iy[:, 0] >= 0) & (iy[:, -1] < extent[1])
                & (iz[:, 0] >= 0) & (iz[:, -1] < extent[2])
            )
            idx = np.nonzero(ok)[0]
            if idx.size:
                data[
                    ix[idx][:, :, None, None],
                    iy[idx][:, None, :, None],
                    iz[idx][:, None, None, :],
                ] = values[s:e][idx]
            # partially-clipped leaves (bbox-edge): slow path, rare
            for m in np.nonzero(~ok)[0]:
                l0 = origins[s + m] - bb_lo
                a = np.maximum(l0, 0)
                b = np.minimum(l0 + 8, extent)
                if np.all(b > a):
                    sl = a - l0
                    el = b - l0
                    data[a[0] : b[0], a[1] : b[1], a[2] : b[2]] = values[s + m][
                        sl[0] : el[0], sl[1] : el[1], sl[2] : el[2]
                    ]

    def parse_internal(off, origin, log2dim, child_total, header, parse_child):
        dim = 1 << log2dim  # children per axis
        child_extent = 1 << child_total  # voxels per child per axis
        mask_bytes = (dim**3) // 8
        vmask = _mask_bits(blob[off + 32 : off + 32 + mask_bytes])
        cmask = _mask_bits(blob[off + 32 + mask_bytes : off + 32 + 2 * mask_bytes])
        # Table entries are union{float value; int64 child}: read both views.
        table_child = np.frombuffer(blob, "<i8", dim**3, off + header)
        table_value = np.frombuffer(blob, "<f4", 2 * dim**3, off + header)[0::2]
        child_idx = np.nonzero(cmask)[0]
        tile_idx = np.nonzero(vmask & ~cmask)[0]
        ox, oy, oz = origin
        # constant active tiles
        for n in tile_idx:
            v = float(table_value[n])
            i = (int(n) >> (2 * log2dim)) & (dim - 1)
            j = (int(n) >> log2dim) & (dim - 1)
            k = int(n) & (dim - 1)
            lo = np.array(
                [ox + i * child_extent, oy + j * child_extent, oz + k * child_extent],
                np.int64,
            )
            fill_box(lo, lo + child_extent, v)
        for n in child_idx:
            child_off = off + int(table_child[n])
            i = (int(n) >> (2 * log2dim)) & (dim - 1)
            j = (int(n) >> log2dim) & (dim - 1)
            k = int(n) & (dim - 1)
            corigin = (
                ox + i * child_extent,
                oy + j * child_extent,
                oz + k * child_extent,
            )
            parse_child(child_off, corigin)

    def parse_lower(off, origin):
        # Leaves are bulk-filled; the walk only extracts constant tiles.
        parse_internal(off, origin, 4, 3, _LOWER_HEADER, lambda o, org: None)

    def parse_upper(off, origin):
        parse_internal(off, origin, 5, 7, _UPPER_HEADER, parse_lower)

    bulk_fill_leaves()
    for t in range(table_size):
        toff = root + _ROOTDATA_SIZE + t * _ROOT_TILE_SIZE
        key, child, state, value = struct.unpack_from("<qqIf", blob, toff)
        origin = _root_key_to_origin(key & 0xFFFFFFFFFFFFFFFF)
        if child > 0:
            parse_upper(root + child, origin)
        elif state:  # active root tile: constant 4096^3 region
            lo = np.array(origin, np.int64)
            fill_box(lo, lo + 4096, value)

    return NvdbGrid(
        name, data, tuple(int(v) for v in bb_lo), voxel_size, tuple(vecd),
        dict(background=background, vmin=vmin, vmax=vmax,
             grid_class=grid_class, voxel_count=voxel_count,
             node_count=node_count, world_bbox=world_bbox),
    )


def read_nvdb(path: str) -> Dict[str, NvdbGrid]:
    """Parse all float grids from a .nvdb file."""
    with open(path, "rb") as f:
        buf = f.read()
    grids: Dict[str, NvdbGrid] = {}
    pos = 0
    while pos + _FILE_HEADER.size <= len(buf):
        magic, version, grid_count, codec = _FILE_HEADER.unpack_from(buf, pos)
        if magic != MAGIC_FILE:
            if not grids:
                raise NvdbError(f"{path}: not a NanoVDB file (magic 0x{magic:x})")
            break
        pos += _FILE_HEADER.size
        for _ in range(grid_count):
            meta = _FILE_META.unpack_from(buf, pos)
            grid_size, file_size = meta[0], meta[1]
            name_size = meta[21]  # field order: 4Q 2I 6d 6i 3d -> nameSize
            pos += _FILE_META.size
            name = buf[pos : pos + name_size].split(b"\x00", 1)[0].decode()
            pos += name_size
            # fileSize = nameSize + compressed blob size
            blob_size = file_size - name_size
            blob = buf[pos : pos + blob_size]
            pos += blob_size
            if codec == 1:  # ZIP
                # NanoVDB ZIP codec prefixes the compressed blob with its
                # uncompressed size (uint64).
                (usize,) = struct.unpack_from("<Q", blob, 0)
                blob = zlib.decompress(blob[8:])
                if len(blob) != usize:
                    raise NvdbError("ZIP size mismatch")
            elif codec == 2:
                raise NvdbError("BLOSC codec not supported (use NONE or ZIP)")
            try:
                g = _parse_grid_blob(blob, name)
                grids[g.name or name] = g
            except NvdbError:
                raise
    return grids


def read_nvdb_medium(path: str, pack: bool = True, device=None):
    """Load density (+ optional temperature) from .nvdb into a Medium on
    `device` (CUDA unless device="cpu"): read_nvdb_grids, then
    Medium.from_grids(pack=pack)."""
    from ..models.medium import Medium

    density, temperature = read_nvdb_grids(path)
    return Medium.from_grids(density, temperature, pack=pack, device=device)


def read_nvdb_grids(path: str):
    """(density, temperature or None) DenseGrids of a .nvdb file, on the CPU.

    Mirrors VolumeGrids::read_from_file (volume_grids.cpp:58-67): a missing
    'density' grid is fatal, a missing 'temperature' grid only warns and
    yields a non-emissive medium.
    """
    from .grid import dense_grid_from_array

    grids = read_nvdb(path)
    if "density" not in grids:
        raise NvdbError(f'{path}: does not contain the "density" grid')
    d = grids["density"]
    density = dense_grid_from_array(
        d.data, origin_ijk=d.origin_ijk, voxel_size=d.voxel_size,
        world_offset=d.world_offset,
    )
    temperature = None
    if "temperature" in grids:
        t = grids["temperature"]
        temperature = dense_grid_from_array(
            t.data, origin_ijk=t.origin_ijk, voxel_size=t.voxel_size,
            world_offset=t.world_offset,
        )
    else:
        from ..utils import logging as vlog

        vlog.warn(f'{path} has no "temperature" grid; medium is non-emissive')
    return density, temperature


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------
def _root_key_from_origin(i: int, j: int, k: int) -> int:
    def enc(c):
        return ((c & 0xFFFFFFFF) >> 12) & 0x1FFFFF

    return enc(k) | (enc(j) << 21) | (enc(i) << 42)


def _pack_mask(bits: np.ndarray) -> bytes:
    # Inverse of _mask_bits: little-endian u64 words, bit n = offset n.
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def write_nvdb(
    path: str,
    grids: Dict[str, Tuple[np.ndarray, Tuple[int, int, int], float, Tuple[float, float, float]]],
) -> None:
    """Write float grids as an uncompressed .nvdb file.

    grids: name -> (data [X,Y,Z] float32, origin_ijk, voxel_size, world_offset).
    Voxels equal to 0 are written but the value masks mark only nonzero voxels
    active (fog-volume convention, background 0).
    """
    segments = []
    for name, (data, origin, voxel_size, world_offset) in grids.items():
        segments.append(_build_grid_blob(name, np.asarray(data, np.float32),
                                         tuple(int(v) for v in origin),
                                         float(voxel_size),
                                         tuple(float(v) for v in world_offset),
                                         len(grids)))
    out = [_FILE_HEADER.pack(MAGIC_FILE, _version(), len(grids), 0)]
    for idx, (name, blob) in enumerate(zip(grids.keys(), segments)):
        nm = name.encode() + b"\x00"
        data, origin, voxel_size, world_offset = grids[name]
        data = np.asarray(data)
        bb_lo = np.array(origin, np.int64)
        bb_hi = bb_lo + np.array(data.shape) - 1
        wlo = bb_lo * voxel_size + np.array(world_offset)
        whi = (bb_hi + 1) * voxel_size + np.array(world_offset)
        meta = _FILE_META.pack(
            len(blob), len(nm) + len(blob), 0, int((data != 0).sum()),
            GRID_TYPE_FLOAT, GRID_CLASS_FOG,
            *wlo, *whi, *bb_lo, *bb_hi, voxel_size, voxel_size, voxel_size,
            len(nm),
            0, 0, 0, 0,  # nodeCount[4] (informational; filled 0)
            0, 0, 0,  # tileCount
            0, 0, _version(),
        )
        out.append(meta)
        out.append(nm)
        out.append(blob)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _align32(n: int) -> int:
    return (n + 31) & ~31


def _build_grid_blob(name, data, origin, voxel_size, world_offset, grid_count):
    X, Y, Z = data.shape
    bb_lo = np.array(origin, np.int64)
    bb_hi = bb_lo + [X - 1, Y - 1, Z - 1]

    # Enumerate leaves (nonzero 8-aligned blocks): the C++ core where it
    # runs, else vectorized numpy (pad to the 8-aligned bbox, blocked reshape).
    from . import native as _native

    leaves = {}
    nat = _native.extract_leaves(np.ascontiguousarray(data, np.float32), bb_lo)
    if nat is not None:
        origins_arr, values_arr = nat
        for o, v in zip(origins_arr, values_arr):
            leaves[(int(o[0]), int(o[1]), int(o[2]))] = v
    else:
        leaf_lo = (bb_lo // 8) * 8
        leaf_hi = ((bb_hi // 8) + 1) * 8  # exclusive, 8-aligned
        ext = (leaf_hi - leaf_lo).astype(int)
        padded = np.zeros(tuple(ext), np.float32)
        s = (bb_lo - leaf_lo).astype(int)
        padded[s[0] : s[0] + X, s[1] : s[1] + Y, s[2] : s[2] + Z] = data
        blocks = padded.reshape(
            ext[0] // 8, 8, ext[1] // 8, 8, ext[2] // 8, 8
        ).transpose(0, 2, 4, 1, 3, 5)
        nonzero = blocks.reshape(blocks.shape[:3] + (512,)).any(axis=-1)
        for bxi, byi, bzi in np.argwhere(nonzero):
            origin = (
                int(leaf_lo[0] + 8 * bxi),
                int(leaf_lo[1] + 8 * byi),
                int(leaf_lo[2] + 8 * bzi),
            )
            leaves[origin] = blocks[bxi, byi, bzi]

    lowers = {}
    for (ix, iy, iz) in leaves:
        lowers.setdefault((ix // 128 * 128, iy // 128 * 128, iz // 128 * 128), []).append((ix, iy, iz))
    uppers = {}
    for lo in lowers:
        uppers.setdefault((lo[0] // 4096 * 4096, lo[1] // 4096 * 4096, lo[2] // 4096 * 4096), []).append(lo)

    n_leaf, n_lower, n_upper = len(leaves), len(lowers), len(uppers)
    vmax = float(data.max()) if data.size else 0.0
    vmin = float(data.min()) if data.size else 0.0

    # Layout: GridData | TreeData | root | root tiles | uppers | lowers | leaves
    tree0 = _GRIDDATA_SIZE
    root0 = tree0 + _TREEDATA_SIZE
    tiles0 = root0 + _ROOTDATA_SIZE
    upper0 = _align32(tiles0 + n_upper * _ROOT_TILE_SIZE)
    lower0 = upper0 + n_upper * (_UPPER_HEADER + 8 * _UPPER_TABLE)
    leaf0 = lower0 + n_lower * (_LOWER_HEADER + 8 * _LOWER_TABLE)
    total = leaf0 + n_leaf * _LEAF_SIZE

    blob = bytearray(total)

    upper_keys = sorted(uppers)
    lower_keys = sorted(lowers)
    leaf_keys = sorted(leaves)
    upper_off = {k: upper0 + i * (_UPPER_HEADER + 8 * _UPPER_TABLE) for i, k in enumerate(upper_keys)}
    lower_off = {k: lower0 + i * (_LOWER_HEADER + 8 * _LOWER_TABLE) for i, k in enumerate(lower_keys)}
    leaf_off = {k: leaf0 + i * _LEAF_SIZE for i, k in enumerate(leaf_keys)}

    # ---- leaves ----
    for k in leaf_keys:
        off = leaf_off[k]
        block = leaves[k]
        active = block != 0
        struct.pack_into("<3i", blob, off, *k)
        # mBBoxDif + flags: whole-leaf bbox (approximation: full extent)
        blob[off + 12 : off + 16] = bytes([7, 7, 7, 0])
        blob[off + 16 : off + 80] = _pack_mask(active.reshape(-1))
        struct.pack_into(
            "<4f", blob, off + 80,
            float(block[active].min()) if active.any() else 0.0,
            float(block[active].max()) if active.any() else 0.0,
            float(block[active].mean()) if active.any() else 0.0, 0.0,
        )
        blob[off + 96 : off + 96 + 2048] = block.astype("<f4").tobytes()

    # ---- lower internals ----
    for k in lower_keys:
        off = lower_off[k]
        cmask = np.zeros(4096, bool)
        table = np.zeros(4096, "<i8")
        for lk in lowers[k]:
            i = (lk[0] - k[0]) // 8
            j = (lk[1] - k[1]) // 8
            kk = (lk[2] - k[2]) // 8
            n = (i << 8) | (j << 4) | kk
            cmask[n] = True
            table[n] = leaf_off[lk] - off
        struct.pack_into("<6i", blob, off, k[0], k[1], k[2], k[0] + 127, k[1] + 127, k[2] + 127)
        struct.pack_into("<Q", blob, off + 24, 0)
        blob[off + 32 : off + 32 + 512] = b"\x00" * 512  # value mask (no tiles)
        blob[off + 544 : off + 544 + 512] = _pack_mask(cmask)
        struct.pack_into("<4f", blob, off + 1056, vmin, vmax, 0.0, 0.0)
        blob[off + _LOWER_HEADER : off + _LOWER_HEADER + 8 * 4096] = table.tobytes()

    # ---- upper internals ----
    for k in upper_keys:
        off = upper_off[k]
        cmask = np.zeros(32768, bool)
        table = np.zeros(32768, "<i8")
        for lk in uppers[k]:
            i = (lk[0] - k[0]) // 128
            j = (lk[1] - k[1]) // 128
            kk = (lk[2] - k[2]) // 128
            n = (i << 10) | (j << 5) | kk
            cmask[n] = True
            table[n] = lower_off[lk] - off
        struct.pack_into("<6i", blob, off, k[0], k[1], k[2], k[0] + 4095, k[1] + 4095, k[2] + 4095)
        struct.pack_into("<Q", blob, off + 24, 0)
        blob[off + 32 : off + 32 + 4096] = b"\x00" * 4096
        blob[off + 4128 : off + 4128 + 4096] = _pack_mask(cmask)
        struct.pack_into("<4f", blob, off + 8224, vmin, vmax, 0.0, 0.0)
        blob[off + _UPPER_HEADER : off + _UPPER_HEADER + 8 * 32768] = table.tobytes()

    # ---- root + tiles ----
    struct.pack_into("<6i", blob, root0, *bb_lo, *bb_hi)
    struct.pack_into("<I5f", blob, root0 + 24, n_upper, 0.0, vmin, vmax, 0.0, 0.0)
    for t, k in enumerate(upper_keys):
        toff = tiles0 + t * _ROOT_TILE_SIZE
        struct.pack_into(
            "<QqIf", blob, toff,
            _root_key_from_origin(*k), upper_off[k] - root0, 0, 0.0,
        )

    # ---- tree ----
    struct.pack_into(
        "<4Q3I3IQ", blob, tree0,
        leaf0 - tree0, lower0 - tree0, upper0 - tree0, root0 - tree0,
        n_leaf, n_lower, n_upper,
        0, 0, 0,
        int((data != 0).sum()),
    )

    # ---- grid data ----
    struct.pack_into("<QQ", blob, 0, MAGIC_FILE, 0xFFFFFFFFFFFFFFFF)
    struct.pack_into("<IIII", blob, 16, _version(), 0, 0, grid_count)
    struct.pack_into("<Q", blob, 32, total)
    nm = name.encode()[:255]
    blob[40 : 40 + len(nm)] = nm
    # Map: uniform scale + translation
    s = voxel_size
    matd = np.diag([s, s, s]).astype("<f8")
    inv = np.diag([1 / s, 1 / s, 1 / s]).astype("<f8")
    blob[296:368] = matd.tobytes()
    blob[368:440] = inv.tobytes()
    blob[440:464] = np.asarray(world_offset, "<f8").tobytes()
    struct.pack_into("<d", blob, 464, 0.0)  # taper
    blob[472:508] = matd.astype("<f4").tobytes()
    blob[508:544] = inv.astype("<f4").tobytes()
    blob[544:556] = np.asarray(world_offset, "<f4").tobytes()
    struct.pack_into("<f", blob, 556, 0.0)
    wlo = bb_lo * s + np.asarray(world_offset)
    whi = (bb_hi + 1) * s + np.asarray(world_offset)
    struct.pack_into("<6d", blob, 560, *wlo, *whi)
    struct.pack_into("<3d", blob, 608, s, s, s)
    struct.pack_into("<II", blob, 632, GRID_CLASS_FOG, GRID_TYPE_FLOAT)
    struct.pack_into("<qII", blob, 640, 0, 0, 0)

    return bytes(blob)
