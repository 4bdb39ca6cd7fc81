// Host-side core for NanoVDB file I/O: bulk leaf scatter into dense arrays
// and leaf extraction from them.
//
// The hot loops of .nvdb <-> dense repacking (grids/nvdb.py) are scattering
// every 8^3 leaf block into the dense [X,Y,Z] volume (reading) and gathering
// the nonzero 8^3 blocks out of it (writing). grids/nvdb.py does both with
// numpy; this core does them as straight row copies, which matters for
// production-scale grids (a 512^3 cloud is 262,144 leaf positions). Both
// give the same arrays, bit for bit (tests/test_torch_nvdb.py).
//
// The port's own copy of the JAX package's native/nvdb_core.cpp. Compiled at
// first use by volume_path_tracer_tpu_torch.grids.native (g++ -O3 -shared,
// into the package's _build/ directory), loaded via ctypes. Where there is
// no g++ the numpy path runs instead.
//
// Layout contract (NanoVDB ABI 32.3, float leaf = 2144 bytes):
//   offset 0:  int32 mBBoxMin[3]  (leaf origin = mBBoxMin & ~7)
//   offset 96: float mValues[512] (x-major: v[((x&7)<<6)|((y&7)<<3)|(z&7)])

#include <cstdint>
#include <cstring>

extern "C" {

// Scatter n_leaf leaves into dense[X][Y][Z] whose [0,0,0] voxel is at
// absolute index coords (lo_x, lo_y, lo_z). Returns number of leaves
// scattered (clipped leaves handled; fully-outside leaves skipped).
int64_t vpt_fill_leaves(
    const uint8_t* leaf_array, int64_t leaf_stride, int64_t n_leaf,
    float* dense, int64_t X, int64_t Y, int64_t Z,
    int64_t lo_x, int64_t lo_y, int64_t lo_z)
{
    int64_t filled = 0;
    for (int64_t n = 0; n < n_leaf; ++n) {
        const uint8_t* leaf = leaf_array + n * leaf_stride;
        int32_t bb[3];
        std::memcpy(bb, leaf, 12);
        const int64_t ox = (int64_t)(bb[0] & ~7) - lo_x;
        const int64_t oy = (int64_t)(bb[1] & ~7) - lo_y;
        const int64_t oz = (int64_t)(bb[2] & ~7) - lo_z;
        const float* vals = reinterpret_cast<const float*>(leaf + 96);

        // fast path: fully inside
        if (ox >= 0 && oy >= 0 && oz >= 0 &&
            ox + 8 <= X && oy + 8 <= Y && oz + 8 <= Z) {
            for (int64_t i = 0; i < 8; ++i) {
                for (int64_t j = 0; j < 8; ++j) {
                    std::memcpy(
                        dense + ((ox + i) * Y + (oy + j)) * Z + oz,
                        vals + (i << 6) + (j << 3),
                        8 * sizeof(float));
                }
            }
            ++filled;
            continue;
        }
        // clipped path
        const int64_t x0 = ox < 0 ? -ox : 0, x1 = (ox + 8 > X) ? X - ox : 8;
        const int64_t y0 = oy < 0 ? -oy : 0, y1 = (oy + 8 > Y) ? Y - oy : 8;
        const int64_t z0 = oz < 0 ? -oz : 0, z1 = (oz + 8 > Z) ? Z - oz : 8;
        if (x0 >= x1 || y0 >= y1 || z0 >= z1)
            continue;
        for (int64_t i = x0; i < x1; ++i)
            for (int64_t j = y0; j < y1; ++j)
                std::memcpy(
                    dense + ((ox + i) * Y + (oy + j)) * Z + (oz + z0),
                    vals + (i << 6) + (j << 3) + z0,
                    (z1 - z0) * sizeof(float));
        ++filled;
    }
    return filled;
}

// Gather nonzero 8^3 blocks of dense[X][Y][Z] into a leaf-value array
// (the writer's hot loop). block_origins: int32 [max_blocks][3] out,
// block_values: float [max_blocks][512] out. Returns block count
// (or -1 if max_blocks was too small). Origins are absolute (+lo).
int64_t vpt_extract_leaves(
    const float* dense, int64_t X, int64_t Y, int64_t Z,
    int64_t lo_x, int64_t lo_y, int64_t lo_z,
    int32_t* block_origins, float* block_values, int64_t max_blocks)
{
    // 8-aligned block cover of the bbox [lo, lo+shape)
    const int64_t bx0 = (lo_x >= 0 ? lo_x : lo_x - 7) / 8 * 8;
    const int64_t by0 = (lo_y >= 0 ? lo_y : lo_y - 7) / 8 * 8;
    const int64_t bz0 = (lo_z >= 0 ? lo_z : lo_z - 7) / 8 * 8;
    int64_t count = 0;
    float block[512];
    for (int64_t bx = bx0; bx < lo_x + X; bx += 8)
        for (int64_t by = by0; by < lo_y + Y; by += 8)
            for (int64_t bz = bz0; bz < lo_z + Z; bz += 8) {
                bool nonzero = false;
                std::memset(block, 0, sizeof(block));
                const int64_t x0 = bx < lo_x ? lo_x : bx;
                const int64_t x1 = bx + 8 > lo_x + X ? lo_x + X : bx + 8;
                const int64_t y0 = by < lo_y ? lo_y : by;
                const int64_t y1 = by + 8 > lo_y + Y ? lo_y + Y : by + 8;
                const int64_t z0 = bz < lo_z ? lo_z : bz;
                const int64_t z1 = bz + 8 > lo_z + Z ? lo_z + Z : bz + 8;
                for (int64_t x = x0; x < x1; ++x)
                    for (int64_t y = y0; y < y1; ++y) {
                        const float* src =
                            dense + ((x - lo_x) * Y + (y - lo_y)) * Z + (z0 - lo_z);
                        float* dst =
                            block + ((x - bx) << 6) + ((y - by) << 3) + (z0 - bz);
                        for (int64_t z = 0; z < z1 - z0; ++z) {
                            dst[z] = src[z];
                            nonzero |= src[z] != 0.0f;
                        }
                    }
                if (!nonzero)
                    continue;
                if (count >= max_blocks)
                    return -1;
                block_origins[count * 3 + 0] = (int32_t)bx;
                block_origins[count * 3 + 1] = (int32_t)by;
                block_origins[count * 3 + 2] = (int32_t)bz;
                std::memcpy(block_values + count * 512, block, sizeof(block));
                ++count;
            }
    return count;
}

}  // extern "C"
