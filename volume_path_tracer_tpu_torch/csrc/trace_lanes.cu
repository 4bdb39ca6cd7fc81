// trace_lanes.cu: the forward tracer's lane loop as CUDA kernels for Hopper.
//
// Replaces the JAX package's Pallas megakernel (volume_path_tracer_tpu/
// render/megakernel.py: the event step `kernel` built by make_kernel,
// launched by _pallas_step_call through trace_rays_fused) TOGETHER WITH its
// XLA prestep (make_prestep / fetch_rows). On the TPU those were two
// programs per wavefront iteration because Mosaic cannot gather from a large
// table inside a kernel; a CUDA thread reads the table in device memory
// directly, so one thread carries one lane through a whole step:
//
//   PCG4D draws on (pixel id, stream, ctr, 0) -> free flight in the carried
//   segment -> ONE row read from the fused table (the corner row at a
//   collision, the brick's majorant row at a crossing) -> trilinear dot ->
//   [emissive: temperature (16-wide row, or the temperature grid's own
//   corner row through its own transform) and the blackbody pair-LUT lerp]
//   -> the event step (null/absorb/scatter with p_n clamped at 0, HG
//   redirect, NEE ratio tracking with Russian roulette, resume/retire, the
//   next brick/superbrick segment) -> ctr += 1.
//
// A medium without the fused table (Medium.from_grids(pack=False): a density
// that changes every step cannot pay for a re-pack, and a large grid's table
// is eight times the grid) goes through the same step with another fetch,
// chosen by the template parameter kDense: at a collision the 8 corners of
// the base voxel from the dense density array, each 0 outside it; at a
// crossing the brick's 8-byte (brick, superbrick) majorant pair; at an
// emissive collision the 8 corners of the dense temperature array through
// its own transform. A lane reads only what its event needs. The corners and
// weights are those of the packed row, summed in the same order, so dense
// and packed media give the same bits. The arrays are the grids' own
// ([X, Y, Z], no copy): each corner is tested and read only if inside, and
// the launch refuses an array of another length.
//
// The step is written once (lane_step) and follows render/integrator.py
// make_step operation by operation. The compiler contracts multiply-adds to
// FMA and log1pf/sinf/cosf differ in the last ulp from the host's, so lanes
// agree with the plain version to rounding, except where rounding flips a
// knife-edge branch; draws and table reads agree exactly.
//
// One warp loop (warp_loop), three kernels around it:
//
//   render_wave_kernel  the renderer's wave. A lane is born from its pixel
//                       id alone (jitter draw, camera ray, world -> index,
//                       box clip) and ends as one 16-byte read-add-write of
//                       the film: no per-lane state crosses device memory.
//                       Its kCount instantiation also sums the lanes'
//                       lane-iterations (a work count, the same on any mesh).
//   trace_lanes_kernel  state in, state out (SoA sf/si), for arbitrary ray
//                       batches and for max_steps = 1, the one-step check.
//                       Its kRecord instantiation is the forward of the
//                       gradient path (diff/prb.py _trace_rays_record): a
//                       lane is born from its world ray (init_lane, as a
//                       camera lane is), runs the same lane_step, writes at
//                       each shadow walk's end the walk's residual into tf
//                       [n, K], and ends as its radiance, its last counter
//                       and zeros in the slots it never filled: no state
//                       crosses device memory.
//   replay_lanes_kernel the gradient path's backward, the counterpart of the
//                       JAX package's XLA loop diff/prb.py replay_grads /
//                       _make_replay_step (there is no Pallas kernel for it):
//                       one thread replays one lane's path from its world
//                       ray and its draw counters and adds each event's
//                       derivative straight into the dense gradient grids
//                       with float atomics (scatter_grid). Lanes
//                       are taken in the order the wrapper gives: groups of
//                       neighbouring lanes, the group with the longest lane
//                       (by the record's counters) first, so long lanes do
//                       not start last.
//
// Beside them, loss_rays_kernel makes a train step's ray batch (below).
//
// Path replay is right only if the replay takes the forward's branches on
// the forward's draws, lane by lane. Both steps therefore call one inlined
// traverse() (draws, free flight, the row read, the next segment) and the
// same helpers for the event, the HG redirect and ratio tracking; the
// record kernel runs lane_step itself, so its radiance is trace_lanes's bit
// for bit. The replay is bound as the forward is (the chain's latency, the
// longest lane), not by its atomics: a collision adds its 8 weighted corners
// straight into the [X, Y, Z] gradient grids (scatter_grid), more atomic
// instructions than a corner row's two 16-byte adds but no table: the JAX
// package's corner-row tables [(X+1)(Y+1)(Z+1), 8] suit the TPU's scatter
// engine, and on the card they are eight times the grid, to zero and fold
// every step, which cost more device time than the replay itself (PERF.md,
// Findings). Atomics add in another order on every run, so its gradients
// equal the plain replay's to rounding only.
//
// What bounds it on this card, as measured (PERF.md, Findings): not bytes
// and not the gather's bandwidth. A wave moves a few MB against 3.35 TB/s. A step is about 1,300 SASS instructions, most of them
// one dependent chain (draws, log1pf, an IEEE reciprocal, the row address,
// the gather, the trilinear dot, the event), and a warp walks every branch
// that any of its 32 lanes takes, one after the other. One warp alone on a
// scheduler takes about as long for a step as four do together, so the
// card is bound by that chain's latency, and by the skew of path lengths:
// most lanes retire within tens of steps, a few run hundreds. With one
// thread per lane and no refill a warp runs as long as its longest lane
// (two thirds of the issued thread-steps are idle threads), and no launch
// ends before its longest lane has walked its chain: more than half of a
// launch runs with under half of the warps at work.
//
// What the design does about it: blocks are persistent (the grid is at most
// what the card holds resident, asked of the runtime) and every warp pulls
// lanes from a queue. At the top of its loop, at a convergent point, the
// warp counts its idle threads by ballot; when enough are idle one thread
// takes that many queue entries with one atomicAdd and each idle thread
// starts the lane at base + its rank. A retired lane's thread is refilled
// while its neighbours go on, so the warp's threads stay busy while the
// queue lasts. A 256x256 wave fits the resident threads at once and would
// never refill, so a launch starts no more threads than leave each of them
// QUEUE_PER_THREAD lanes to expect (2: measured best of 1, 2, 3, 4, 8 on
// that wave; larger images exceed the card and refill by themselves). No
// thread leaves the loop before the whole warp does, so every *_sync names
// the full mask. Draws are keyed on (pixel id, stream, lane counter): a
// lane takes the same path whichever thread carries it, and refill order
// shows in no result. The record has just counted how long each lane is, so
// the replay's queue starts the groups of neighbouring lanes that hold the
// longest lanes first. It keeps the groups whole: neighbouring lanes are
// neighbouring pixels whose rays read neighbouring rows, and a warp of them
// gathers and adds coherently; sorting the lanes themselves put lanes of a
// like length in each warp (SIMT efficiency 0.39 -> 0.89) but scattered every
// warp over the image and made the replay 1.45x slower (PERF.md, Findings).
// The scene's constants ride in the kernel's arguments
// (the constant bank): no registers and no loads for them. The chain is cut where that changes no
// result, or the same last bits in the plain step: the reciprocal of the
// direction is carried with the lane and recomputed only when the
// direction changes; the step's quotients by the majorant share one
// reciprocal, as in integrator.make_step; the brick and superbrick cell
// sizes are powers of two, so their quotients are exact products; row
// indices are 32-bit and only the address is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAM = 0;
constexpr int SHADOW = 1;
constexpr int DONE = 2;
// Replay modes (diff/prb.py): camera walk, shadow walk reproducing the
// forward (PRE), shadow walk scattering gradients (GRAD), retired.
constexpr int RCAM = 0;
constexpr int RPRE = 1;
constexpr int RGRAD = 2;
constexpr int RDONE = 3;
constexpr int THREADS = 128;
// __launch_bounds__ of all three kernels: at most 128 registers a thread.
// Measured on the gradient kernels (chip_smoke.py --variants replay_blocks=5
// record_blocks=6): 5 blocks take the dense replay from 102 to 96 registers
// with 40 B of spills, and are slower; 6 take the record from 85 to 80
// registers and 6 blocks an SM, and are no faster.
constexpr int MIN_BLOCKS = 4;
// Idle threads a warp waits for before it takes new lanes from the queue.
constexpr int REFILL_MIN = 8;
// A launch starts at most n / QUEUE_PER_THREAD threads (and at most what the
// card holds resident).
constexpr int QUEUE_PER_THREAD = 2;
constexpr unsigned FULL = 0xffffffffu;
// The jitter draw's counter: one no tracing step reaches (render/renderer.py).
constexpr uint32_t JITTER_CTR = 0x7fffffffu;
constexpr int MAX_DEVICES = 16;
// Ints of a launch's scratch (Args::scratch); render/megakernel.py SCRATCH_INTS.
constexpr int SCRATCH_INTS = 6;

// Float parameters (render/megakernel.py names this layout).
enum FParam {
  P_VOXEL, P_INV_VOXEL, P_SIGMA_A, P_SIGMA_S, P_SIGMA_T, P_G, P_SUPER_TAU, P_LE_SCALE,
  P_T_SCALE, P_T_OFFSET, P_HG_DEN0, P_HG_C1, P_HG_NUM,
  P_WI, P_WI_INV = P_WI + 3, P_LI = P_WI_INV + 3, P_LINF = P_LI + 3, P_DOFF = P_LINF + 3,
  P_TOFF = P_DOFF + 3, P_TVOXEL = P_TOFF + 3, P_TC_MAX, P_ORIGIN,
  P_TORIGIN = P_ORIGIN + 3, P_BB_RES = P_TORIGIN + 3,
  P_CAM_POS, P_CAM_MX = P_CAM_POS + 3, P_CAM_MY = P_CAM_MX + 3, P_CAM_T = P_CAM_MY + 3,
  P_IMG_RATIO = P_CAM_T + 3, P_JITTER, NUM_FPARAMS
};
// Integer parameters.
enum IParam {
  I_X, I_Y, I_Z, I_BX, I_BY, I_BZ, I_MAX_DEPTH, I_NEE, I_EMISSION,
  I_TX, I_TY, I_TZ, I_NPAIRS, I_WIDTH, NUM_IPARAMS
};
// I_EMISSION: 0 none, 1 temperature in columns 8..15 of 16-wide rows,
// 2 temperature from its own corner table through its own transform,
// 3 (dense instantiations) temperature from its dense array through its own
// transform.

struct Params {
  float f[NUM_FPARAMS];
  int i[NUM_IPARAMS];
};

// Everything a launch needs, passed by value.
struct Args {
  // trace_lanes_kernel: SoA state sf [21, n] / si [3, n] in the field order
  // of render/megakernel.py STATE_F32 / STATE_I32, per-lane pixel ids and
  // streams. render_wave_kernel: pids [n], or null for the range
  // [start, start + n); one stream word; the film [H * W] float4.
  float* sf;
  int* si;
  const int* pids;
  const int* streams;
  float4* film;
  int n, max_steps, start;
  uint32_t stream;
  // [0] the queue's head, [1] n_capped, [2] largest lane counter, [3]
  // unused, [4..5] the wave's lane-iterations as one unsigned 64-bit word
  int* scratch;
  const float* rows;
  int n_rows, row_w;
  const float* trows;
  int n_trows;
  const float* bb_pairs;
  // Dense instantiations (dens not null; rows and trows are then unused):
  // the density array [X, Y, Z], the majorant pairs [n_maj, 2] and, for an
  // emissive medium, the temperature array [TX, TY, TZ]. An array may hold
  // 2^31 voxels or more: its length and offsets are 64-bit.
  const float* dens;
  long long n_dens;
  const float* maj;
  int n_maj;
  const float* tdata;
  long long n_tdata;
  // Measuring instantiation only (tap not null): tap [n_rows + n_trows]
  // bytes set to 1 for every row read; in the dense instantiations tap
  // [sectors(n_dens) + n_maj + sectors(n_tdata)], one byte for each 32-byte
  // sector (8 floats) of the density array, each majorant pair and each
  // sector of the temperature array; stat, or null: [2 + 2 * warps]:
  // warp-steps, thread-steps that did a lane's step, then each warp's first
  // and last %globaltimer reading.
  unsigned char* tap;
  unsigned long long* stat;
  // The record and replay kernels: world rays o_world (row stride o_stride
  // floats: 3, or 0 for one origin shared by every ray) and d_world [n, 3];
  // order [n] or null: the queue's lane order (replay: megakernel.py
  // longest_first). The record kernel
  // writes tf [n, k_walks] walk residuals (every slot), L_out [n, 3] and
  // ctr_out [n], each lane's last counter. The replay kernel: tf read, the
  // cotangent g [n, 3] and the forward radiance Lf [n, 3], the gradient
  // grids gd [X, Y, Z] and gt [TX, TY, TZ] (temperature, or null), and, or
  // null, gacc [n] (<g, L> replayed) and nsteps [n] (steps taken).
  const float* o_world;
  const float* d_world;
  int o_stride;
  const int* order;
  float* L_out;
  int* ctr_out;
  float* tf;
  int k_walks, max_iters;
  const float* g;
  const float* Lf;
  float* gd;
  float* gt;
  float* gacc;
  int* nsteps;
  Params p;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // safe_inv(d): carried, not state
  float t, t_exit, sig_seg, t_seg, Lx, Ly, Lz;
  float pox, poy, poz, pdx, pdy, pdz, T_ray, phase_val;
  int depth, mode, ctr;
  uint32_t pid, strm;
  // The record kernel: shadow walks started so far (the residual slot).
  int wc;
  // The replay kernel (which leaves Lx, Ly, Lz unused): <g, L accumulated>,
  // <g, L_fwd>, the cotangent g, the walk's final transmittance, the shadow
  // ray's first counter and clip, and the steps taken.
  float gL_acc, gL_tot, gx, gy, gz, T_fin, sh_t0, sh_t1;
  int sh_ctr0, nsteps;
};

__device__ __forceinline__ void pcg4d(uint32_t& v0, uint32_t& v1, uint32_t& v2, uint32_t& v3) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v3 = v3 * 1664525u + 1013904223u;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
}

// u32 -> f32 rounded to nearest, times 2^-32, clamped to 1 - 2^-24.
__device__ __forceinline__ float u32_to_uniform(uint32_t v) {
  return fminf(__uint2float_rn(v) * 0x1p-32f, 0x1.fffffep-1f);
}

// sign(d) * (1 / max(|d|, 1e-12)) + (d == 0 ? 1e12 : 0); sign(+-0) = 0.
__device__ __forceinline__ float safe_inv(float d) {
  const float mag = fmaxf(fabsf(d), 1e-12f);
  const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  return sgn * (1.0f / mag) + (d == 0.f ? 1e12f : 0.f);
}

// Slab clip of the ray with origin o and direction reciprocals inv against
// [lo, hi]; t0 floored at 1e-4 (integrator.clip_ray).
__device__ __forceinline__ void clip_box(float ox, float oy, float oz, float ix, float iy, float iz,
                                         const float* lo, const float* hi,
                                         float& t0, float& t1, bool& hit) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  float t_lo = 0.f, t_hi = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ta = (lo[a] - o[a]) * inv[a];
    const float tb = (hi[a] - o[a]) * inv[a];
    const float mn = fminf(ta, tb), mx = fmaxf(ta, tb);
    t_lo = a == 0 ? mn : fmaxf(t_lo, mn);
    t_hi = a == 0 ? mx : fminf(t_hi, mx);
  }
  t0 = fmaxf(t_lo, 1e-4f);
  t1 = t_hi;
  hit = t0 < t_hi;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The 8 trilinear weights in corner order (z fastest), products left to right.
__device__ __forceinline__ void tri_weights(float fx, float fy, float fz, float* w) {
  const float gx = 1.f - fx, gy = 1.f - fy, gz = 1.f - fz;
  w[0] = gx * gy * gz; w[1] = gx * gy * fz; w[2] = gx * fy * gz; w[3] = gx * fy * fz;
  w[4] = fx * gy * gz; w[5] = fx * gy * fz; w[6] = fx * fy * gz; w[7] = fx * fy * fz;
}

// Left-to-right sum of v[c] * w[c] (grids/grid.py dot8) with the
// multiply-adds fused as nvcc fuses `v0 * w0 + v1 * w1 + ...` (the first
// product into the first sum, each later one into the sum so far), written
// out with intrinsics: the compiler's choice can differ from one call site
// to another, and the packed row's sample must give the bits of the dense
// corners' (dense_trilinear, whose sum nvcc fuses in this order).
__device__ __forceinline__ float dot8(float4 a, float4 b, const float* w) {
  float s = __fmaf_rn(a.x, w[0], __fmul_rn(a.y, w[1]));
  s = __fmaf_rn(a.z, w[2], s);
  s = __fmaf_rn(a.w, w[3], s);
  s = __fmaf_rn(b.x, w[4], s);
  s = __fmaf_rn(b.y, w[5], s);
  s = __fmaf_rn(b.z, w[6], s);
  s = __fmaf_rn(b.w, w[7], s);
  return s;
}

// 32-byte sectors (8 floats) of an array of n_floats.
__device__ __forceinline__ size_t sectors(long long n_floats) { return ((size_t)n_floats + 7) >> 3; }

// Trilinear sample of a dense [X, Y, Z] grid at base voxel (ix, iy, iz) with
// weights w, bitwise the packed row's: the 8 corners in corner order, each 0
// outside the grid (grids/grid.py gather_voxels), summed as dot8 sums a
// packed row. `data` is the grid's own array; each corner is tested and read
// only if inside. kWide (the forward launches): the base voxel's flat
// offset is made once, in 64 bits (an array may hold 2^31 voxels or more),
// and each corner adds its strides (Y * Z, Z, 1) to it; else (the gradient
// launches, whose arrays the wrapper keeps under 2^31 voxels) each corner's
// offset is an int. kTap: mark the sector of each corner read at tap + its
// index.
template <bool kTap, bool kWide>
__device__ __forceinline__ float dense_trilinear(const float* data, int X, int Y, int Z,
                                                 int ix, int iy, int iz, const float* w,
                                                 unsigned char* tap) {
  const long long yz = (long long)Y * Z;
  const long long base = kWide ? ((long long)ix * Y + iy) * Z + iz : 0;
  float v[8];
  // An invalid base voxel has no corner inside: the sum is 0 as well. The
  // sum is left to nvcc, which fuses it here as dot8 spells it out (the
  // bitwise gates against the packed kernels hold this); spelled out, it
  // took 1-2 more registers (PERF.md, Findings).
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = ix + (c >> 2), cy = iy + ((c >> 1) & 1), cz = iz + (c & 1);
    const bool inside = cx >= 0 && cx < X && cy >= 0 && cy < Y && cz >= 0 && cz < Z;
    v[c] = 0.f;
    if (inside) {
      if constexpr (kWide) {
        const long long flat = base + ((c >> 2) ? yz : 0) + (((c >> 1) & 1) ? Z : 0) + (c & 1);
        v[c] = __ldg(data + flat);
        if (kTap) tap[flat >> 3] = 1;
      } else {
        const int flat = (cx * Y + cy) * Z + cz;
        v[c] = __ldg(data + flat);
        if (kTap) tap[flat >> 3] = 1;
      }
    }
  }
  float s = v[0] * w[0];
  s = s + v[1] * w[1];
  s = s + v[2] * w[2];
  s = s + v[3] * w[3];
  s = s + v[4] * w[4];
  s = s + v[5] * w[5];
  s = s + v[6] * w[6];
  s = s + v[7] * w[7];
  return s;
}

// A density-index-space point in the temperature grid's local coordinates,
// through the temperature grid's own transform (sample_temperature_kelvin).
__device__ __forceinline__ void temperature_local(const float* fp, float pcx, float pcy, float pcz,
                                                  float& tlx, float& tly, float& tlz) {
  const float voxel = fp[P_VOXEL];
  const float tvox = fp[P_TVOXEL];
  tlx = ((pcx * voxel + fp[P_DOFF]) - fp[P_TOFF]) / tvox - fp[P_TORIGIN];
  tly = ((pcy * voxel + fp[P_DOFF + 1]) - fp[P_TOFF + 1]) / tvox - fp[P_TORIGIN + 1];
  tlz = ((pcz * voxel + fp[P_DOFF + 2]) - fp[P_TOFF + 2]) / tvox - fp[P_TORIGIN + 2];
}

__device__ __forceinline__ void set_direction(Lane& L, float dx, float dy, float dz) {
  L.dx = dx; L.dy = dy; L.dz = dz;
  L.ix = safe_inv(dx); L.iy = safe_inv(dy); L.iz = safe_inv(dz);
}

// Corner-row index of base voxel (ix, iy, iz) in a table over [X, Y, Z]
// (grids/grid.py corner_row_index, clamped; the caller masks with validity).
__device__ __forceinline__ int corner_row(int ix, int iy, int iz, int X, int Y, int Z) {
  return (clampi(ix + 1, 0, X) * (Y + 1) + clampi(iy + 1, 0, Y)) * (Z + 1) + clampi(iz + 1, 0, Z);
}

// What one tracking event gives a lane (integrator.make_traversal): the
// draws, free flight in the carried segment, THE row read, the trilinear
// sample and the next segment. lane_step and replay_step both call it, so a
// replayed path takes the forward's branches on the forward's draws.
struct Trav {
  float u1, u2, u3;
  float rsig, t_cand, t_next, pcx, pcy, pcz, rho, t_seg_f, sig_seg_f;
  float w[8];
  int ix, iy, iz;
  bool collide, exited, fetch, valid, real_col, zero_col;
  const float4* rp;  // the row read (packed media), for its temperature columns
};

// kTap: also mark in a.tap what the lane reads (see Args), so a measurement
// can count the distinct bytes a run needs. kDense: 0 reads the fused table,
// 1 the grids' dense arrays (an int, not a bool, so that the kernels keep
// the names <., 0|1, .> that register reports and PERF.md use). kWide: the
// dense fetch's offsets in 64 bits (dense_trilinear; warp_loop sets it for
// the forward kinds).
template <bool kTap, int kDense, bool kWide>
__device__ __forceinline__ void traverse(const Lane& L, const Args& a, Trav& tr) {
  const float* fp = a.p.f;
  const int* ip = a.p.i;
  const float voxel = fp[P_VOXEL];
  const float sigma_t = fp[P_SIGMA_T];
  const float Ox = fp[P_ORIGIN], Oy = fp[P_ORIGIN + 1], Oz = fp[P_ORIGIN + 2];
  const int X = ip[I_X], Y = ip[I_Y], Z = ip[I_Z];
  const int BX = ip[I_BX], BY = ip[I_BY], BZ = ip[I_BZ];

  // ---- draws ----
  uint32_t r0 = L.pid, r1 = L.strm, r2 = (uint32_t)L.ctr, r3 = 0u;
  pcg4d(r0, r1, r2, r3);
  const float u0 = u32_to_uniform(r0);
  tr.u1 = u32_to_uniform(r1);
  tr.u2 = u32_to_uniform(r2);
  tr.u3 = u32_to_uniform(r3);

  // ---- free flight in the carried segment ----
  const bool has_seg = L.t_seg > L.t;
  const float sig = fmaxf(L.sig_seg, 1e-20f);
  // One reciprocal serves every quotient by sig in this step, and 1 / voxel
  // comes with the parameters: IEEE divisions are the longest links of the
  // chain (integrator.make_traversal and make_step compute the same way).
  const float rsig = __frcp_rn(sig);
  tr.rsig = rsig;
  const float dt_w = -log1pf(-u0) * rsig;
  const float t_cand = L.t + dt_w * fp[P_INV_VOXEL];
  const bool collide = has_seg && (L.sig_seg > 0.f) && (t_cand < L.t_seg);
  const float t_next = has_seg ? L.t_seg : L.t;
  const bool exited = !collide && (t_next >= L.t_exit - 1e-6f);
  const bool fetch = !collide && !exited;
  tr.t_cand = t_cand; tr.t_next = t_next;
  tr.collide = collide; tr.exited = exited; tr.fetch = fetch;

  // ---- THE gather: corner row at a collision, majorant row otherwise ----
  // Row indices fit 32 bits (the wrapper refuses a larger table); the
  // address does not: the 16-wide 512^3 table passes 2^31 floats.
  const float t_gather = collide ? t_cand : t_next + 1e-3f;
  const float pcx = L.ox + L.dx * t_gather, pcy = L.oy + L.dy * t_gather, pcz = L.oz + L.dz * t_gather;
  tr.pcx = pcx; tr.pcy = pcy; tr.pcz = pcz;
  const float lpx = pcx - Ox, lpy = pcy - Oy, lpz = pcz - Oz;
  const int bi = (int)floorf(lpx / 8.f), bj = (int)floorf(lpy / 8.f), bk = (int)floorf(lpz / 8.f);
  const bool b_valid = bi >= 0 && bi < BX && bj >= 0 && bj < BY && bk >= 0 && bk < BZ;
  const int b_flat = (clampi(bi, 0, BX - 1) * BY + clampi(bj, 0, BY - 1)) * BZ + clampi(bk, 0, BZ - 1);
  const int ix = (int)floorf(lpx), iy = (int)floorf(lpy), iz = (int)floorf(lpz);
  tr.ix = ix; tr.iy = iy; tr.iz = iz;
  const float fx = lpx - (float)ix, fy = lpy - (float)iy, fz = lpz - (float)iz;
  const bool valid = ix >= -1 && ix <= X - 1 && iy >= -1 && iy <= Y - 1 && iz >= -1 && iz <= Z - 1;
  tr.valid = valid;
  float* w = tr.w;
  float rho, bmaj, smaj;
  tr.rp = nullptr;
  if constexpr (kDense != 0) {
    // The packed row's validity test and its corners, zero-padded as a
    // packed row's are: the same values. A crossing lane reads no corner and
    // a colliding lane no majorant: these loads are the longest link of the
    // step's chain.
    tri_weights(fx, fy, fz, w);
    rho = 0.f; bmaj = 0.f; smaj = 0.f;
    if (collide) {
      rho = dense_trilinear<kTap, kWide>(a.dens, X, Y, Z, ix, iy, iz, w, a.tap);
    } else if (fetch && b_valid) {
      const float2 m = __ldg(reinterpret_cast<const float2*>(a.maj) + b_flat);
      bmaj = m.x; smaj = m.y;
      if (kTap) a.tap[sectors(a.n_dens) + b_flat] = 1;
    }
  } else {
    const int n_corner = (X + 1) * (Y + 1) * (Z + 1);
    const int base = corner_row(ix, iy, iz, X, Y, Z);
    const int idx = clampi(collide ? base : n_corner + b_flat, 0, a.n_rows - 1);
    const float4* rp = reinterpret_cast<const float4*>(a.rows + (size_t)idx * a.row_w);
    tr.rp = rp;
    if (kTap) a.tap[idx] = 1;
    const float4 ra = __ldg(rp), rb = __ldg(rp + 1);
    tri_weights(fx, fy, fz, w);
    rho = valid ? dot8(ra, rb, w) : 0.f;
    bmaj = b_valid ? ra.x : 0.f;
    smaj = b_valid ? ra.y : 0.f;
  }
  tr.rho = rho;

  // ---- next segment (crossing lanes): brick or superbrick ----
  const float extra = (smaj - bmaj) * sigma_t * 64.f * voxel;
  const bool use_super = extra <= fp[P_SUPER_TAU];
  const float cs = use_super ? 64.f : 8.f;
  // lp / cs as a product: exact, the cell size is a power of two.
  const float inv_cs = use_super ? 0.015625f : 0.125f;
  const float clx = floorf(lpx * inv_cs) * cs + Ox;
  const float cly = floorf(lpy * inv_cs) * cs + Oy;
  const float clz = floorf(lpz * inv_cs) * cs + Oz;
  float t_cell = fmaxf((clx - L.ox) * L.ix, ((clx + cs) - L.ox) * L.ix);
  t_cell = fminf(t_cell, fmaxf((cly - L.oy) * L.iy, ((cly + cs) - L.oy) * L.iy));
  t_cell = fminf(t_cell, fmaxf((clz - L.oz) * L.iz, ((clz + cs) - L.oz) * L.iz));
  tr.t_seg_f = fmaxf(fminf(t_cell, L.t_exit), t_next + 2e-3f);
  tr.sig_seg_f = (use_super ? smaj : bmaj) * sigma_t;
  tr.real_col = collide && (rho > 0.f);
  tr.zero_col = collide && !(rho > 0.f);
}

// The adimensional temperature at a camera collision, by the medium's
// emission arm (see I_EMISSION); (tlx, tly, tlz): the point in the
// temperature grid's local coordinates, set by arms 2 and 3 only.
template <bool kTap, int kDense, bool kWide>
__device__ __forceinline__ float sample_temperature(const Args& a, const Trav& tr,
                                                    float& tlx, float& tly, float& tlz) {
  const float* fp = a.p.f;
  const int* ip = a.p.i;
  float temp_adim;
  if (!kDense && ip[I_EMISSION] == 1) {
    const float4 ta = __ldg(tr.rp + 2), tb = __ldg(tr.rp + 3);
    temp_adim = tr.valid ? dot8(ta, tb, tr.w) : 0.f;
  } else {
    temperature_local(fp, tr.pcx, tr.pcy, tr.pcz, tlx, tly, tlz);
    const int TX = ip[I_TX], TY = ip[I_TY], TZ = ip[I_TZ];
    const int jx = (int)floorf(tlx), jy = (int)floorf(tly), jz = (int)floorf(tlz);
    float tw[8];
    tri_weights(tlx - (float)jx, tly - (float)jy, tlz - (float)jz, tw);
    if constexpr (kDense != 0) {
      temp_adim = dense_trilinear<kTap, kWide>(a.tdata, TX, TY, TZ, jx, jy, jz, tw,
                                        kTap ? a.tap + sectors(a.n_dens) + a.n_maj : nullptr);
    } else {
      const bool tvalid = jx >= -1 && jx <= TX - 1 && jy >= -1 && jy <= TY - 1 && jz >= -1 && jz <= TZ - 1;
      const int tbase = clampi(corner_row(jx, jy, jz, TX, TY, TZ), 0, a.n_trows - 1);
      const float4* tp = reinterpret_cast<const float4*>(a.trows + (size_t)tbase * 8);
      if (kTap) a.tap[(size_t)a.n_rows + tbase] = 1;
      temp_adim = tvalid ? dot8(__ldg(tp), __ldg(tp + 1), tw) : 0.f;
    }
  }
  return temp_adim;
}

// The blackbody XYZ at temp_k from the pair LUT (utils/spectral.py
// blackbody_radiation_xyz_from_pairs): lo + slope * frac, 0 for T <= 0.
// slope_out, if given, gets the stored slopes (the derivative's numerators).
__device__ __forceinline__ void blackbody(const Args& a, float temp_k, float* bb, float* slope_out) {
  const float* fp = a.p.f;
  const float tc = fminf(fmaxf(temp_k, 0.f), fp[P_TC_MAX]);
  const float bb_res = fp[P_BB_RES];
  const int ti = clampi((int)floorf(tc / bb_res) + 1, 0, a.p.i[I_NPAIRS] - 1);
  const float frac = tc / bb_res - (float)(ti - 1);
  const float* pr = a.bb_pairs + ti * 6;
  const bool hot = !(temp_k <= 0.f);
  bb[0] = hot ? __ldg(pr + 0) + __ldg(pr + 3) * frac : 0.f;
  bb[1] = hot ? __ldg(pr + 1) + __ldg(pr + 4) * frac : 0.f;
  bb[2] = hot ? __ldg(pr + 2) + __ldg(pr + 5) * frac : 0.f;
  if (slope_out != nullptr) {
    slope_out[0] = __ldg(pr + 3); slope_out[1] = __ldg(pr + 4); slope_out[2] = __ldg(pr + 5);
  }
}

// The event of a camera collision (utils/rng.py sample_discrete3): 0 null,
// 1 absorb, 2 scatter.
__device__ __forceinline__ int pick_event(float p_n, float p_a, float p_s, float u1) {
  const float total = p_n + p_a + p_s;
  const float xv = u1 * total;
  return xv <= p_n ? 0 : (xv <= p_n + p_a ? 1 : 2);
}

// A scatter at (pcx, pcy, pcz): the pending camera ray (HG redirect of d),
// the phase toward the distant light, depth + 2.
__device__ __forceinline__ void hg_scatter(Lane& L, const float* fp, float u2, float u3,
                                           float pcx, float pcy, float pcz) {
  // HG redirect around d (ops/phase.sample_henyey_greenstein)
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  const float g = fp[P_G];
  const float g2 = g * g;
  const float denom = 1.f + g - 2.f * g * u2;
  const float sqr = (1.f - g2) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
  const float aniso = (1.f + g2 - sqr * sqr) / (2.f * (fabsf(g) < 1e-12f ? 1e-12f : g));
  const float iso = 1.f - 2.f * u2;
  const float cos_t = fabsf(g) < 1e-3f ? iso : aniso;
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  const float phi = 6.28318548f * u3;
  const float sin_c = fminf(fmaxf(sin_t, -1.f), 1.f);
  float sin_p, cos_p;
  sincosf(phi, &sin_p, &cos_p);
  float lx = sin_c * cos_p, ly = sin_c * sin_p, lz = fminf(fmaxf(cos_t, -1.f), 1.f);
  const float nrm = sqrtf(lx * lx + ly * ly + lz * lz);
  lx = lx / nrm; ly = ly / nrm; lz = lz / nrm;
  const float sgn = dz >= 0.f ? 1.f : -1.f;
  const float aa = -1.f / (sgn + dz);
  const float b = dx * dy * aa;
  const float v2x = 1.f + sgn * aa * dx * dx, v2y = sgn * b, v2z = -sgn * dx;
  const float v3x = b, v3y = sgn + aa * dy * dy, v3z = -dy;
  L.pdx = lx * v2x + ly * v3x + lz * dx;
  L.pdy = lx * v2y + ly * v3y + lz * dy;
  L.pdz = lx * v2z + ly * v3z + lz * dz;
  L.pox = pcx; L.poy = pcy; L.poz = pcz;
  // HG phase toward the distant light (ops/phase.henyey_greenstein)
  const float cw = dx * fp[P_WI] + dy * fp[P_WI + 1] + dz * fp[P_WI + 2];
  const float den = fp[P_HG_DEN0] + fp[P_HG_C1] * cw;
  L.phase_val = fp[P_HG_NUM] / (den * sqrtf(fmaxf(den, 1e-12f)));
  L.depth = L.depth + 2;
}

// Ratio tracking at a shadow collision: T * sigma_n / sigma_maj with Russian
// roulette below 0.05 (q = 0.75). Returns the new T (0: killed).
__device__ __forceinline__ float ratio_track(float T_ray, float sigma_n, float rsig, float u1) {
  float T_after = T_ray * (sigma_n * rsig);
  const bool rr = T_after <= 0.05f;
  const bool rr_kill = rr && (u1 < 0.75f);
  T_after = rr_kill ? 0.f : (rr ? T_after / 0.25f : T_after);
  return T_after;
}

// One step of one lane that is not DONE (integrator.make_step).
template <bool kTap, int kDense, bool kWide>
__device__ __forceinline__ void lane_step(Lane& L, const Args& a) {
  const float* fp = a.p.f;
  const int* ip = a.p.i;
  const float sigma_t = fp[P_SIGMA_T];
  const float Ox = fp[P_ORIGIN], Oy = fp[P_ORIGIN + 1], Oz = fp[P_ORIGIN + 2];
  const int X = ip[I_X], Y = ip[I_Y], Z = ip[I_Z];
  const bool nee_on = ip[I_NEE] != 0;
  const int emission = ip[I_EMISSION];
  const float box_lo[3] = {Ox, Oy, Oz};
  const float box_hi[3] = {Ox + (float)X, Oy + (float)Y, Oz + (float)Z};
  const float wix = fp[P_WI], wiy = fp[P_WI + 1], wiz = fp[P_WI + 2];

  const bool in_cam = L.mode == CAM;
  const bool in_shw = L.mode == SHADOW;

  Trav tr;
  traverse<kTap, kDense, kWide>(L, a, tr);
  const bool exited = tr.exited, fetch = tr.fetch;
  const float rho = tr.rho, rsig = tr.rsig;
  const float pcx = tr.pcx, pcy = tr.pcy, pcz = tr.pcz;
  const bool real_col = tr.real_col, zero_col = tr.zero_col;

  // ---- camera-mode collision: emission, then the event ----
  const bool cam_col = in_cam && real_col;
  const float p_a = fp[P_SIGMA_A] * rho * rsig;
  const float p_s = fp[P_SIGMA_S] * rho * rsig;
  const float p_n = fmaxf(1.f - p_a - p_s, 0.f);
  if (emission != 0 && cam_col) {
    float tlx, tly, tlz;
    const float temp_adim = sample_temperature<kTap, kDense, kWide>(a, tr, tlx, tly, tlz);
    const float temp_k = temp_adim * fp[P_T_SCALE] + fp[P_T_OFFSET];
    float bb[3];
    blackbody(a, temp_k, bb, nullptr);
    const float pal = p_a * fp[P_LE_SCALE];
    L.Lx = L.Lx + pal * bb[0];
    L.Ly = L.Ly + pal * bb[1];
    L.Lz = L.Lz + pal * bb[2];
  }
  const int event = pick_event(p_n, p_a, p_s, tr.u1);
  const bool cam_null = cam_col && event == 0;
  const bool cam_abs = cam_col && event == 1;
  const bool cam_scat = cam_col && event == 2;

  const float phase_old = L.phase_val;
  if (cam_scat) hg_scatter(L, fp, tr.u2, tr.u3, pcx, pcy, pcz);

  // ---- shadow-mode collision: ratio tracking + Russian roulette ----
  const bool shw_col = in_shw && real_col;
  const float sigma_n = fmaxf(L.sig_seg - sigma_t * rho, 0.f);
  const float T_after = ratio_track(L.T_ray, sigma_n, rsig, tr.u1);
  const float T_new = shw_col ? T_after : L.T_ray;
  const bool shw_dead = shw_col && (T_new <= 0.f);
  const bool shadow_finish = (in_shw && exited) || shw_dead;
  if (shadow_finish) {
    const float c = phase_old * T_new;
    L.Lx = L.Lx + c * fp[P_LI];
    L.Ly = L.Ly + c * fp[P_LI + 1];
    L.Lz = L.Lz + c * fp[P_LI + 2];
  }

  // ---- resume / retire ----
  const bool start_shadow = nee_on && cam_scat;
  const bool resume = nee_on ? shadow_finish : (shadow_finish || cam_scat);
  // The pending ray's reciprocals: needed only where a lane resumes.
  float pix = 0.f, piy = 0.f, piz = 0.f;
  float t0n = 0.f, t1n = 0.f;
  bool hitn = false;
  if (start_shadow) {
    clip_box(pcx, pcy, pcz, fp[P_WI_INV], fp[P_WI_INV + 1], fp[P_WI_INV + 2], box_lo, box_hi, t0n, t1n, hitn);
  } else if (resume) {
    pix = safe_inv(L.pdx); piy = safe_inv(L.pdy); piz = safe_inv(L.pdz);
    clip_box(L.pox, L.poy, L.poz, pix, piy, piz, box_lo, box_hi, t0n, t1n, hitn);
  }
  const bool depth_ok = L.depth < ip[I_MAX_DEPTH];
  const bool resume_ok = resume && hitn && depth_ok;
  const bool resume_escape = resume && (!hitn || !depth_ok);
  const bool start_shadow_ok = start_shadow && hitn;
  const bool shadow_miss = start_shadow && !hitn;
  float t0p = 0.f, t1p = 0.f;
  bool hitp = false;
  if (shadow_miss) {
    // A shadow ray that misses the box keeps T = 1.
    L.Lx = L.Lx + L.phase_val * fp[P_LI];
    L.Ly = L.Ly + L.phase_val * fp[P_LI + 1];
    L.Lz = L.Lz + L.phase_val * fp[P_LI + 2];
    pix = safe_inv(L.pdx); piy = safe_inv(L.pdy); piz = safe_inv(L.pdz);
    clip_box(L.pox, L.poy, L.poz, pix, piy, piz, box_lo, box_hi, t0p, t1p, hitp);
  }
  const bool miss_resume_ok = shadow_miss && hitp && depth_ok;
  const bool miss_resume_escape = shadow_miss && (!hitp || !depth_ok);
  const bool done_inf = (in_cam && exited) || resume_escape || miss_resume_escape;
  if (done_inf) {
    L.Lx = L.Lx + fp[P_LINF];
    L.Ly = L.Ly + fp[P_LINF + 1];
    L.Lz = L.Lz + fp[P_LINF + 2];
  }

  if (done_inf || cam_abs) L.mode = DONE;
  if (start_shadow_ok) L.mode = SHADOW;
  if (resume_ok || miss_resume_ok) L.mode = CAM;

  float t_new = L.t;
  if (start_shadow_ok) {
    L.ox = pcx; L.oy = pcy; L.oz = pcz;
    L.dx = wix; L.dy = wiy; L.dz = wiz;
    L.ix = fp[P_WI_INV]; L.iy = fp[P_WI_INV + 1]; L.iz = fp[P_WI_INV + 2];
    t_new = t0n; L.t_exit = t1n;
  }
  if (resume_ok || miss_resume_ok) {
    L.ox = L.pox; L.oy = L.poy; L.oz = L.poz;
    L.dx = L.pdx; L.dy = L.pdy; L.dz = L.pdz;
    L.ix = pix; L.iy = piy; L.iz = piz;
    t_new = resume_ok ? t0n : t0p;
    L.t_exit = resume_ok ? t1n : t1p;
  }
  const bool plain_adv = cam_null || zero_col || (in_shw && real_col && !shadow_finish);
  if (plain_adv) t_new = tr.t_cand;
  if (fetch) t_new = tr.t_next;

  const bool new_ray = start_shadow_ok || resume_ok || miss_resume_ok;
  if (fetch) { L.sig_seg = tr.sig_seg_f; L.t_seg = tr.t_seg_f; }
  if (new_ray) { L.sig_seg = 0.f; L.t_seg = t_new; }
  L.t = t_new;
  L.T_ray = start_shadow_ok ? 1.f : T_new;
  L.ctr = L.ctr + 1;
}

// The record kernel's look at one step from outside (diff/prb.py
// _trace_rays_record): a shadow walk that ended writes its residual into
// slot wc - 1 of the lane's row of tf (T_final > 0, or -(the counter after
// it) for a walk that died), and a walk that started takes the next slot.
__device__ __forceinline__ void record_walks(Lane& L, int mode0, int q, const Args& a) {
  if (mode0 == SHADOW && L.mode != SHADOW) {
    const int slot = L.wc - 1;
    if (slot < a.k_walks) a.tf[(size_t)q * a.k_walks + slot] = L.T_ray > 0.f ? L.T_ray : -(float)L.ctr;
  }
  if (mode0 == CAM && L.mode == SHADOW) L.wc = L.wc + 1;
}

// Add w[c] * wgt to corner c of base voxel (ix, iy, iz) of a dense [X, Y, Z]
// grid (corner order as tri_weights); a corner outside the grid is dropped,
// as the plain version's fold never reads one. Corners 2p and 2p + 1 are
// z-neighbours: where both are inside and the first is 8-byte aligned they
// take one float2 atomic, else one float atomic each; no result is used (a
// RED). The pairs measured 0.7-1.7% faster end to end than 8 float atomics
// (PERF.md, Findings). The caller has tested the base voxel (every axis in
// [-1, N-1]), so no index overflows.
__device__ __forceinline__ void scatter_grid(float* grid, int ix, int iy, int iz, int X, int Y, int Z,
                                             const float* w, float wgt) {
  const bool z0 = iz >= 0, z1 = iz + 1 < Z;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int cx = ix + (p >> 1), cy = iy + (p & 1);
    if (!(cx >= 0 && cx < X && cy >= 0 && cy < Y)) continue;
    float* q = grid + (((ptrdiff_t)cx * Y + cy) * Z + iz);
    const float a0 = w[2 * p] * wgt, a1 = w[2 * p + 1] * wgt;
    if (z0 && z1 && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
      atomicAdd(reinterpret_cast<float2*>(q), make_float2(a0, a1));
    } else {
      if (z0) atomicAdd(q, a0);
      if (z1) atomicAdd(q + 1, a1);
    }
  }
}

// One replay step of one lane that is not RDONE (diff/prb.py
// _make_replay_step): the forward's tracking event by traverse(), then the
// camera collision's emission and score-function weights, the PRE / GRAD
// shadow walks, the recorded residual at a shadow start, resume / retire,
// and the gradient scatter into the gradient grids a.gd and a.gt. kTap:
// as in traverse.
template <bool kTap, int kDense>
__device__ __forceinline__ void replay_step(Lane& L, int q, const Args& a) {
  const float* fp = a.p.f;
  const int* ip = a.p.i;
  // Truncation parity: a forward lane stops drawing at max_iters.
  if (L.ctr >= a.max_iters) { L.mode = RDONE; return; }
  const float sigma_a = fp[P_SIGMA_A], sigma_s = fp[P_SIGMA_S], sigma_t = fp[P_SIGMA_T];
  const float Ox = fp[P_ORIGIN], Oy = fp[P_ORIGIN + 1], Oz = fp[P_ORIGIN + 2];
  const int X = ip[I_X], Y = ip[I_Y], Z = ip[I_Z];
  const bool nee_on = ip[I_NEE] != 0;
  const int emission = ip[I_EMISSION];
  const float box_lo[3] = {Ox, Oy, Oz};
  const float box_hi[3] = {Ox + (float)X, Oy + (float)Y, Oz + (float)Z};
  const float wix = fp[P_WI], wiy = fp[P_WI + 1], wiz = fp[P_WI + 2];
  const bool in_cam = L.mode == RCAM;
  const bool in_pre = L.mode == RPRE;
  const bool in_grad = L.mode == RGRAD;
  const float gLi = L.gx * fp[P_LI] + L.gy * fp[P_LI + 1] + L.gz * fp[P_LI + 2];
  const float gLinf = L.gx * fp[P_LINF] + L.gy * fp[P_LINF + 1] + L.gz * fp[P_LINF + 2];

  Trav tr;
  traverse<kTap, kDense, false>(L, a, tr);
  const float rho = tr.rho, rsig = tr.rsig;
  const float pcx = tr.pcx, pcy = tr.pcy, pcz = tr.pcz;

  // ---- camera collision: emission, then the event's score factor ----
  const bool cam_col = in_cam && tr.real_col;
  const float p_a = sigma_a * rho * rsig;
  const float p_s = sigma_s * rho * rsig;
  const float p_n = fmaxf(1.f - p_a - p_s, 0.f);
  float demis = 0.f, tw = 0.f;
  float tlx = 0.f, tly = 0.f, tlz = 0.f;
  if (emission != 0 && cam_col) {
    const float temp_adim = sample_temperature<kTap, kDense, false>(a, tr, tlx, tly, tlz);
    if (!kDense && emission == 1) temperature_local(fp, pcx, pcy, pcz, tlx, tly, tlz);
    const float temp_k = temp_adim * fp[P_T_SCALE] + fp[P_T_OFFSET];
    float bb[3], slope[3];
    blackbody(a, temp_k, bb, slope);
    // d bb / dT: the slope over the LUT's resolution inside the lerp's range.
    const bool in_range = temp_k > 0.f && temp_k < fp[P_TC_MAX];
    const float bb_res = fp[P_BB_RES];
    const float gbb = L.gx * bb[0] + L.gy * bb[1] + L.gz * bb[2];
    const float gbbg = in_range ? L.gx * (slope[0] / bb_res) + L.gy * (slope[1] / bb_res) + L.gz * (slope[2] / bb_res)
                                : 0.f;
    const float le = fp[P_LE_SCALE];
    L.gL_acc = L.gL_acc + p_a * le * gbb;
    demis = (sigma_a * rsig) * le * gbb;
    tw = p_a * le * gbbg * fp[P_T_SCALE];
  }
  const int event = pick_event(p_n, p_a, p_s, tr.u1);
  const bool cam_null = cam_col && event == 0;
  const bool cam_abs = cam_col && event == 1;
  const bool cam_scat = cam_col && event == 2;
  float score_w = 0.f;
  if (cam_col) {
    // autograd of p_e / detach(p_e): (d p_e / p_e) * the suffix from here on.
    const float dpn = (1.f - p_a - p_s > 0.f) ? -sigma_t : 0.f;
    const float coef = event == 0 ? dpn : (event == 1 ? sigma_a : sigma_s);
    const float p_e = event == 0 ? p_n : (event == 1 ? p_a : p_s);
    const float gsuffix = L.gL_tot - L.gL_acc;
    if (p_e > 1e-20f) score_w = (coef * rsig) / fmaxf(p_e, 1e-20f) * gsuffix;
  }
  if (cam_scat) hg_scatter(L, fp, tr.u2, tr.u3, pcx, pcy, pcz);

  // ---- shadow walks: PRE reproduces the forward, GRAD scatters ----
  const bool shw_col = (in_pre || in_grad) && tr.real_col;
  const float sigma_n = fmaxf(L.sig_seg - sigma_t * rho, 0.f);
  const float T_after = ratio_track(L.T_ray, sigma_n, rsig, tr.u1);
  const float T_new = shw_col ? T_after : L.T_ray;
  const bool shw_dead = shw_col && (T_new <= 0.f);
  const bool pre_finish = in_pre && (tr.exited || shw_dead);
  const bool grad_finish = in_grad && (tr.exited || shw_dead);
  float shadow_w = 0.f;
  if (in_grad && shw_col && sigma_n > 0.f)
    shadow_w = -L.phase_val * gLi * sigma_t * L.T_fin / fmaxf(sigma_n, 1e-20f);
  if (pre_finish) {
    L.gL_acc = L.gL_acc + L.phase_val * T_new * gLi;
    L.T_fin = T_new;
  }
  const bool go_grad = pre_finish && (L.T_fin > 0.f);
  const bool pre_resume = pre_finish && !go_grad;

  // ---- resume / retire ----
  const bool shadow_done = grad_finish || pre_resume;
  const bool start_shadow = nee_on && cam_scat;
  const bool resume = nee_on ? shadow_done : (shadow_done || cam_scat);
  float pix = 0.f, piy = 0.f, piz = 0.f;
  float t0n = 0.f, t1n = 0.f;
  bool hitn = false;
  if (start_shadow) {
    clip_box(pcx, pcy, pcz, fp[P_WI_INV], fp[P_WI_INV + 1], fp[P_WI_INV + 2], box_lo, box_hi, t0n, t1n, hitn);
  } else if (resume) {
    pix = safe_inv(L.pdx); piy = safe_inv(L.pdy); piz = safe_inv(L.pdz);
    clip_box(L.pox, L.poy, L.poz, pix, piy, piz, box_lo, box_hi, t0n, t1n, hitn);
  }
  const bool depth_ok = L.depth < ip[I_MAX_DEPTH];
  const bool resume_ok = resume && hitn && depth_ok;
  const bool resume_escape = resume && (!hitn || !depth_ok);
  const bool start_shadow_ok = start_shadow && hitn;
  const bool shadow_miss = start_shadow && !hitn;
  if (shadow_miss) L.gL_acc = L.gL_acc + L.phase_val * gLi;

  // A recorded walk: its residual instead of a PRE walk.
  bool slot_ok = false, sv_unfinished = false, sv_live = false, sv_killed = false;
  float tf_val = 0.f;
  if (start_shadow_ok && a.k_walks > 0) {
    slot_ok = L.wc < a.k_walks;
    if (slot_ok) tf_val = a.tf[(size_t)q * a.k_walks + L.wc];
    sv_unfinished = slot_ok && tf_val == 0.f;
    sv_live = slot_ok && tf_val > 0.f;
    sv_killed = slot_ok && tf_val < 0.f;
  }
  // The forward added the walk's contribution at its end; no camera event
  // comes before the GRAD walk ends.
  if (sv_live) L.gL_acc = L.gL_acc + L.phase_val * tf_val * gLi;
  const bool start_pre_ok = start_shadow_ok && !slot_ok;
  float t0p = 0.f, t1p = 0.f;
  bool hitp = false;
  if (shadow_miss || sv_killed) {
    pix = safe_inv(L.pdx); piy = safe_inv(L.pdy); piz = safe_inv(L.pdz);
    clip_box(L.pox, L.poy, L.poz, pix, piy, piz, box_lo, box_hi, t0p, t1p, hitp);
  }
  const bool miss_resume_ok = shadow_miss && hitp && depth_ok;
  const bool miss_resume_escape = shadow_miss && (!hitp || !depth_ok);
  const bool sv_skip_ok = sv_killed && hitp && depth_ok;
  const bool sv_skip_escape = sv_killed && (!hitp || !depth_ok);
  if (start_shadow_ok) L.wc = L.wc + 1;

  const bool done_inf = (in_cam && tr.exited) || resume_escape || miss_resume_escape || sv_skip_escape;
  if (done_inf) L.gL_acc = L.gL_acc + gLinf;
  if (done_inf || cam_abs || sv_unfinished) L.mode = RDONE;
  if (start_pre_ok) L.mode = RPRE;
  if (resume_ok || miss_resume_ok || sv_skip_ok) L.mode = RCAM;
  if (go_grad || sv_live) L.mode = RGRAD;

  // ---- the next walk's ray ----
  float t_new = L.t;
  if (start_shadow_ok) {
    L.ox = pcx; L.oy = pcy; L.oz = pcz;
    L.dx = wix; L.dy = wiy; L.dz = wiz;
    L.ix = fp[P_WI_INV]; L.iy = fp[P_WI_INV + 1]; L.iz = fp[P_WI_INV + 2];
    t_new = t0n; L.t_exit = t1n;
  }
  if (resume_ok || miss_resume_ok || sv_skip_ok) {
    L.ox = L.pox; L.oy = L.poy; L.oz = L.poz;
    L.dx = L.pdx; L.dy = L.pdy; L.dz = L.pdz;
    L.ix = pix; L.iy = piy; L.iz = piz;
    t_new = resume_ok ? t0n : t0p;
    L.t_exit = resume_ok ? t1n : t1p;
  }
  if (go_grad) {
    // PRE -> GRAD: the saved shadow ray again, from its first counter.
    L.ox = L.pox; L.oy = L.poy; L.oz = L.poz;
    L.dx = wix; L.dy = wiy; L.dz = wiz;
    L.ix = fp[P_WI_INV]; L.iy = fp[P_WI_INV + 1]; L.iz = fp[P_WI_INV + 2];
    t_new = L.sh_t0; L.t_exit = L.sh_t1;
  }
  const bool plain_adv = cam_null || tr.zero_col || (shw_col && !(pre_finish || grad_finish));
  if (plain_adv) t_new = tr.t_cand;
  if (tr.fetch) t_new = tr.t_next;
  const bool new_ray = start_shadow_ok || resume_ok || miss_resume_ok || go_grad || sv_skip_ok;
  if (tr.fetch) { L.sig_seg = tr.sig_seg_f; L.t_seg = tr.t_seg_f; }
  if (new_ray) { L.sig_seg = 0.f; L.t_seg = t_new; }
  L.t = t_new;
  L.T_ray = (start_shadow_ok || go_grad) ? 1.f : T_new;
  if (sv_live) L.T_fin = tf_val;
  const int ctr_next = (go_grad ? L.sh_ctr0 : L.ctr) + 1;
  if (start_shadow_ok) { L.sh_ctr0 = L.ctr; L.sh_t0 = t0n; L.sh_t1 = t1n; }
  L.ctr = sv_killed ? (int)(-tf_val) : ctr_next;  // a killed walk: past its draws
  L.nsteps = L.nsteps + 1;

  // ---- the gradient scatter ----
  // Emission + score weights on camera collisions, shadow_w on GRAD
  // collisions: disjoint lanes, added in the plain version's order.
  const float dweight = (demis + score_w) + shadow_w;
  if (dweight != 0.f && tr.valid) scatter_grid(a.gd, tr.ix, tr.iy, tr.iz, X, Y, Z, tr.w, dweight);
  if (tw != 0.f) {
    const int TX = ip[I_TX], TY = ip[I_TY], TZ = ip[I_TZ];
    const int jx = (int)floorf(tlx), jy = (int)floorf(tly), jz = (int)floorf(tlz);
    if (jx >= -1 && jx <= TX - 1 && jy >= -1 && jy <= TY - 1 && jz >= -1 && jz <= TZ - 1) {
      float w8t[8];
      tri_weights(tlx - (float)jx, tly - (float)jy, tlz - (float)jz, w8t);
      scatter_grid(a.gt, jx, jy, jz, TX, TY, TZ, w8t, tw);
    }
  }
}

// integrator.init_state for one world ray: world -> index (grids/grid.py
// world_to_index: the offset subtracted, then a true division by the voxel
// size), the direction's reciprocals, the box clip from t_min 1e-4
// (integrator.clip_ray); a ray that misses the box is DONE with L = L_inf.
// Camera, record and replay lanes are all born here, so the replay starts
// each lane where the record started it. No product meets a sum here, so no
// multiply-add is contracted and the lane is torch's init_state bit for bit
// (grids/grid.py divides by a tensor on the card, not by a host scalar;
// chip_smoke.py phase 9 (a) holds this bitwise at a voxel size of 0.1).
__device__ __forceinline__ void init_lane(Lane& L, float owx, float owy, float owz,
                                          float dx, float dy, float dz, const Args& a) {
  const float* fp = a.p.f;
  set_direction(L, dx, dy, dz);
  const float voxel = fp[P_VOXEL];
  L.ox = (owx - fp[P_DOFF]) / voxel;
  L.oy = (owy - fp[P_DOFF + 1]) / voxel;
  L.oz = (owz - fp[P_DOFF + 2]) / voxel;
  const float Ox = fp[P_ORIGIN], Oy = fp[P_ORIGIN + 1], Oz = fp[P_ORIGIN + 2];
  const float lo[3] = {Ox, Oy, Oz};
  const float hi[3] = {Ox + (float)a.p.i[I_X], Oy + (float)a.p.i[I_Y], Oz + (float)a.p.i[I_Z]};
  float t0, t1;
  bool hit;
  clip_box(L.ox, L.oy, L.oz, L.ix, L.iy, L.iz, lo, hi, t0, t1, hit);
  L.t = hit ? t0 : 0.f;
  L.t_exit = hit ? t1 : 0.f;
  L.sig_seg = 0.f;
  L.t_seg = L.t;
  L.Lx = hit ? 0.f : fp[P_LINF];
  L.Ly = hit ? 0.f : fp[P_LINF + 1];
  L.Lz = hit ? 0.f : fp[P_LINF + 2];
  L.pox = L.ox; L.poy = L.oy; L.poz = L.oz;
  L.pdx = L.dx; L.pdy = L.dy; L.pdz = L.dz;
  L.T_ray = 1.f;
  L.phase_val = 0.f;
  L.depth = 0;
  L.mode = hit ? CAM : DONE;
  L.ctr = 0;
}

// A new lane from its pixel id alone: the jitter draw (renderer.py
// render_rays_wave), the camera ray (models/camera.py generate_rays), then
// init_lane.
__device__ __forceinline__ void camera_lane(Lane& L, uint32_t pid, const Args& a) {
  const float* fp = a.p.f;
  L.pid = pid;
  L.strm = a.stream;
  uint32_t r0 = pid, r1 = a.stream, r2 = JITTER_CTR, r3 = 0u;
  pcg4d(r0, r1, r2, r3);
  const float jx = u32_to_uniform(r0) * fp[P_JITTER], jy = u32_to_uniform(r1) * fp[P_JITTER];
  const uint32_t width = (uint32_t)a.p.i[I_WIDTH];
  const uint32_t py = pid / width, px = pid - py * width;
  const float ptx = ((float)px + 0.5f) + jx, pty = ((float)py + 0.5f) + jy;
  const float dx = ptx * fp[P_CAM_MX] + pty * fp[P_CAM_MY] + fp[P_CAM_T];
  const float dy = ptx * fp[P_CAM_MX + 1] + pty * fp[P_CAM_MY + 1] + fp[P_CAM_T + 1];
  const float dz = ptx * fp[P_CAM_MX + 2] + pty * fp[P_CAM_MY + 2] + fp[P_CAM_T + 2];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  init_lane(L, fp[P_CAM_POS], fp[P_CAM_POS + 1], fp[P_CAM_POS + 2], dx / nrm, dy / nrm, dz / nrm, a);
}

// A record or replay lane from queue entry q: its world ray, pixel id and
// stream, no walk started.
__device__ __forceinline__ void ray_lane(Lane& L, int q, const Args& a) {
  const float* o = a.o_world + (size_t)q * a.o_stride;
  const float* d = a.d_world + 3 * (size_t)q;
  init_lane(L, __ldg(o), __ldg(o + 1), __ldg(o + 2), __ldg(d), __ldg(d + 1), __ldg(d + 2), a);
  L.pid = (uint32_t)a.pids[q];
  L.strm = (uint32_t)a.streams[q];
  L.wc = 0;
}

// The record kernel's end of a lane: its radiance, its last counter (the
// replay's queue order), and zero in every residual slot it did not fill (a
// walk still in flight at the cap fills none), so the caller need not zero tf.
__device__ __forceinline__ void finish_record(const Lane& L, int q, const Args& a) {
  a.L_out[3 * (size_t)q] = L.Lx;
  a.L_out[3 * (size_t)q + 1] = L.Ly;
  a.L_out[3 * (size_t)q + 2] = L.Lz;
  a.ctr_out[q] = L.ctr;
  const int ended = L.wc - (L.mode == SHADOW ? 1 : 0);
  for (int s = ended; s < a.k_walks; ++s) a.tf[(size_t)q * a.k_walks + s] = 0.f;
}

// film[pid] += (imaging_ratio * L, 1). A pixel id occurs once in a launch,
// so no atomics. The product and the sum are rounded separately, as the
// plain version's two tensor operations are.
__device__ __forceinline__ void add_to_film(const Lane& L, const Args& a) {
  const float ratio = a.p.f[P_IMG_RATIO];
  float4 f = a.film[L.pid];
  f.x = __fadd_rn(f.x, __fmul_rn(ratio, L.Lx));
  f.y = __fadd_rn(f.y, __fmul_rn(ratio, L.Ly));
  f.z = __fadd_rn(f.z, __fmul_rn(ratio, L.Lz));
  f.w = f.w + 1.f;
  a.film[L.pid] = f;
}

__device__ __forceinline__ void load_lane(Lane& L, int q, const Args& a) {
  const float* sf = a.sf;
  const int* si = a.si;
  const size_t n = (size_t)a.n;
  L.ox = sf[0 * n + q]; L.oy = sf[1 * n + q]; L.oz = sf[2 * n + q];
  set_direction(L, sf[3 * n + q], sf[4 * n + q], sf[5 * n + q]);
  L.t = sf[6 * n + q]; L.t_exit = sf[7 * n + q];
  L.sig_seg = sf[8 * n + q]; L.t_seg = sf[9 * n + q];
  L.Lx = sf[10 * n + q]; L.Ly = sf[11 * n + q]; L.Lz = sf[12 * n + q];
  L.pox = sf[13 * n + q]; L.poy = sf[14 * n + q]; L.poz = sf[15 * n + q];
  L.pdx = sf[16 * n + q]; L.pdy = sf[17 * n + q]; L.pdz = sf[18 * n + q];
  L.T_ray = sf[19 * n + q]; L.phase_val = sf[20 * n + q];
  L.depth = si[0 * n + q]; L.mode = si[1 * n + q]; L.ctr = si[2 * n + q];
  L.pid = (uint32_t)a.pids[q];
  L.strm = (uint32_t)a.streams[q];
}

__device__ __forceinline__ void store_lane(const Lane& L, int q, const Args& a) {
  float* sf = a.sf;
  int* si = a.si;
  const size_t n = (size_t)a.n;
  sf[0 * n + q] = L.ox; sf[1 * n + q] = L.oy; sf[2 * n + q] = L.oz;
  sf[3 * n + q] = L.dx; sf[4 * n + q] = L.dy; sf[5 * n + q] = L.dz;
  sf[6 * n + q] = L.t; sf[7 * n + q] = L.t_exit;
  sf[8 * n + q] = L.sig_seg; sf[9 * n + q] = L.t_seg;
  sf[10 * n + q] = L.Lx; sf[11 * n + q] = L.Ly; sf[12 * n + q] = L.Lz;
  sf[13 * n + q] = L.pox; sf[14 * n + q] = L.poy; sf[15 * n + q] = L.poz;
  sf[16 * n + q] = L.pdx; sf[17 * n + q] = L.pdy; sf[18 * n + q] = L.pdz;
  sf[19 * n + q] = L.T_ray; sf[20 * n + q] = L.phase_val;
  si[0 * n + q] = L.depth; si[1 * n + q] = L.mode; si[2 * n + q] = L.ctr;
}

// A replay lane from its world ray, as the record kernel started it, and its
// cotangent (diff/prb.py _replay_init): a lane whose ray misses the box is
// RDONE with <g, L_inf> accumulated.
__device__ __forceinline__ void replay_lane(Lane& L, int q, const Args& a) {
  const float* fp = a.p.f;
  ray_lane(L, q, a);
  L.gx = a.g[3 * (size_t)q]; L.gy = a.g[3 * (size_t)q + 1]; L.gz = a.g[3 * (size_t)q + 2];
  L.gL_tot = L.gx * a.Lf[3 * (size_t)q] + L.gy * a.Lf[3 * (size_t)q + 1] + L.gz * a.Lf[3 * (size_t)q + 2];
  const bool hit = L.mode == CAM;
  L.mode = hit ? RCAM : RDONE;
  L.gL_acc = hit ? 0.f : L.gx * fp[P_LINF] + L.gy * fp[P_LINF + 1] + L.gz * fp[P_LINF + 2];
  L.T_fin = 0.f; L.sh_t0 = 0.f; L.sh_t1 = 0.f;
  L.sh_ctr0 = 0; L.nsteps = 0;
}

__device__ __forceinline__ void finish_replay(const Lane& L, int q, const Args& a) {
  if (a.gacc != nullptr) {
    a.gacc[q] = L.gL_acc;
    a.nsteps[q] = L.nsteps;
  }
}

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What a warp loop carries its lanes through.
enum Kind {
  kWaveKind,    // render_wave_kernel: born from pixel ids, ends in the film
  kTraceKind,   // trace_lanes_kernel: SoA state in, state out
  kRecordKind,  // trace_lanes_kernel<., ., true>: born from world rays, recording NEE walks
  kReplayKind,  // replay_lanes_kernel: the backward replay, born from world rays
  kWaveCountKind,  // render_wave_kernel<., ., true>: the wave, counting lane-iterations
  kNumKinds,
};

// The warp loop of every kernel. A lane runs until it is done or has taken
// a.max_steps steps in this launch.
template <int kKind, bool kTap, int kDense>
__device__ __forceinline__ void warp_loop(const Args& a) {
  constexpr bool kWave = kKind == kWaveKind || kKind == kWaveCountKind;
  // Only the counting wave carries the lane-iterations: the others keep
  // the code and registers they have without it.
  constexpr bool kCount = kKind == kWaveCountKind;
  constexpr int kDoneMode = kKind == kReplayKind ? RDONE : DONE;
  // 64-bit dense offsets for the forward kinds only: the gradient launches
  // take arrays of fewer than 2^31 voxels and keep the int fetch's registers.
  constexpr bool kWide = kKind != kRecordKind && kKind != kReplayKind;
  const unsigned lane_id = threadIdx.x & 31u;
  const unsigned below = (1u << lane_id) - 1u;
  Lane L;
  L.mode = kDoneMode;
  int q = 0, steps_left = 0;
  bool idle = true, drained = false;
  int capped = 0, max_ctr = 0;
  unsigned lane_iters = 0;
  unsigned long long warp_steps = 0, t_first = 0;
  unsigned busy_steps = 0;
  if (kTap) t_first = global_timer();

  for (;;) {
    // ---- refill, at a convergent point ----
    const unsigned idle_mask = __ballot_sync(FULL, idle);
    const int n_idle = __popc(idle_mask);
    if (!drained && n_idle >= REFILL_MIN) {
      int base = 0;
      if (lane_id == 0) base = atomicAdd(a.scratch, n_idle);
      base = __shfl_sync(FULL, base, 0);
      drained = base >= a.n - n_idle;
      const int mine = base + __popc(idle_mask & below);
      if (idle && mine < a.n) {
        q = (!kWave && a.order != nullptr) ? a.order[mine] : mine;
        steps_left = a.max_steps;
        if constexpr (kWave) {
          camera_lane(L, (uint32_t)(a.pids != nullptr ? a.pids[q] : a.start + q), a);
        } else if constexpr (kKind == kReplayKind) {
          replay_lane(L, q, a);
        } else if constexpr (kKind == kRecordKind) {
          ray_lane(L, q, a);
        } else {
          load_lane(L, q, a);
        }
        idle = L.mode == kDoneMode || steps_left <= 0;
        // A lane that is DONE at birth (its ray misses the box) still owes
        // its result (the film's sample, the record's outputs); a loaded
        // state that takes no step is left as it is.
        if (kWave && idle) {
          add_to_film(L, a);
          capped += L.mode != DONE;
        }
        if (kKind == kRecordKind && idle) finish_record(L, q, a);
        if (kKind == kReplayKind && idle) finish_replay(L, q, a);
      }
    }
    if (__all_sync(FULL, idle)) {
      if (drained) break;
      continue;
    }

    // ---- one step of every lane the warp carries ----
    if (!idle) {
      if constexpr (kKind == kReplayKind) {
        replay_step<kTap, kDense>(L, q, a);
      } else if constexpr (kKind == kRecordKind) {
        const int mode0 = L.mode;
        lane_step<kTap, kDense, kWide>(L, a);
        record_walks(L, mode0, q, a);
      } else {
        lane_step<kTap, kDense, kWide>(L, a);
      }
      --steps_left;
      if (L.mode == kDoneMode || steps_left == 0) {
        if constexpr (kWave) {
          // A lane stopped by the cap adds what it gathered and no infinite
          // light (integrator.finalize_radiance).
          add_to_film(L, a);
          capped += L.mode != DONE;
          max_ctr = max(max_ctr, L.ctr);
          // The lane was alive after each of its steps but a last one that
          // retired it: integrator.lane_iterations, summed over the wave.
          if (kCount) lane_iters += (unsigned)L.ctr - (L.mode == DONE);
        } else if constexpr (kKind == kReplayKind) {
          finish_replay(L, q, a);
        } else if constexpr (kKind == kRecordKind) {
          finish_record(L, q, a);
        } else {
          store_lane(L, q, a);
        }
        idle = true;
      }
      if (kTap) ++busy_steps;
    }
    if (kTap) ++warp_steps;
  }

  if (kWave) {
    capped = __reduce_add_sync(FULL, capped);
    max_ctr = __reduce_max_sync(FULL, max_ctr);
    if (kCount) lane_iters = __reduce_add_sync(FULL, lane_iters);
    if (lane_id == 0) {
      if (capped) atomicAdd(a.scratch + 1, capped);
      if (max_ctr) atomicMax(a.scratch + 2, max_ctr);
      if (kCount && lane_iters)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.scratch + 4), (unsigned long long)lane_iters);
    }
  }
  if (kTap) {
    busy_steps = __reduce_add_sync(FULL, busy_steps);
    if (lane_id == 0 && a.stat != nullptr) {
      atomicAdd(a.stat, warp_steps);
      atomicAdd(a.stat + 1, (unsigned long long)busy_steps);
      const size_t warp = ((size_t)blockIdx.x * THREADS + threadIdx.x) / 32;
      a.stat[2 + 2 * warp] = t_first;
      a.stat[3 + 2 * warp] = global_timer();
    }
  }
}

// kCount: the counting instantiation (vpt_render_wave_counted).
template <bool kTap, int kDense, bool kCount>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) render_wave_kernel(const Args a) {
  warp_loop<kCount ? kWaveCountKind : kWaveKind, kTap, kDense>(a);
}

// kRecord: the record instantiation, the forward of the gradient path.
template <bool kTap, int kDense, bool kRecord>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) trace_lanes_kernel(const Args a) {
  warp_loop<kRecord ? kRecordKind : kTraceKind, kTap, kDense>(a);
}

template <bool kTap, int kDense>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) replay_lanes_kernel(const Args a) {
  warp_loop<kReplayKind, kTap, kDense>(a);
}

// The ray batch of one loss evaluation (diff/inverse.py loss_rays; in the
// JAX package XLA ops inside make_render_loss's loss_fn, no Pallas kernel).
// Lane q < k * n is sample i = q / n of pixel j = q % n: its stream word
// mix_stream(seed, wave0 * k + i) in uint32 arithmetic (the host's (wave0 *
// k + i) mod 2^32 gives the same word), the render wave's jitter draw and
// camera ray (camera_lane), its pixel id and its word written out. It
// replaces some 127 torch launches over 64-bit words and two copies from
// host memory, each of which waited for the card, so the train step's host
// never ran ahead of it. One thread a lane; bound by bytes (12-20 B read a
// pixel, 20-24 B written a lane): 4.5 us a 262,144-lane launch on the H100,
// 40% of that bound (PERF.md, Findings).
constexpr int LOSS_RAYS_THREADS = 256;

template <typename R, typename P>
__global__ void __launch_bounds__(LOSS_RAYS_THREADS) loss_rays_kernel(
    const R* __restrict__ raster, const P* __restrict__ pids, const float* __restrict__ m,
    const float* __restrict__ t, uint32_t seed, uint32_t wave0, const int* __restrict__ sw, int k, int n,
    float jitter, float* __restrict__ d_w, P* __restrict__ pids_k, int* __restrict__ stream_k,
    float* __restrict__ jit) {
  const long long q = (long long)blockIdx.x * LOSS_RAYS_THREADS + threadIdx.x;
  if (q >= (long long)k * n) return;
  if (sw != nullptr) {
    seed = (uint32_t)sw[0];
    wave0 = (uint32_t)sw[1];
  }
  const int i = (int)(q / n), j = (int)(q - (long long)i * n);
  const uint32_t strm = seed * 0x9E3779B9u + (wave0 * (uint32_t)k + (uint32_t)i) * 0x85EBCA6Bu;
  const P pid = pids[j];
  uint32_t r0 = (uint32_t)pid, r1 = strm, r2 = JITTER_CTR, r3 = 0u;
  pcg4d(r0, r1, r2, r3);
  const float u0 = u32_to_uniform(r0), u1 = u32_to_uniform(r1);
  const float ptx = ((float)raster[2 * (size_t)j] + 0.5f) + u0 * jitter;
  const float pty = ((float)raster[2 * (size_t)j + 1] + 0.5f) + u1 * jitter;
  // m: [3, 3] row-major, acting on (x, y, 0).
  const float dx = ptx * m[0] + pty * m[1] + t[0];
  const float dy = ptx * m[3] + pty * m[4] + t[1];
  const float dz = ptx * m[6] + pty * m[7] + t[2];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  d_w[3 * q] = dx / nrm;
  d_w[3 * q + 1] = dy / nrm;
  d_w[3 * q + 2] = dz / nrm;
  pids_k[q] = pid;
  stream_k[q] = (int)strm;
  if (jit != nullptr) {
    jit[2 * q] = u0;
    jit[2 * q + 1] = u1;
  }
}

template <typename R, typename P>
int launch_loss_rays(void* stream, const void* raster, const void* pids, const float* m, const float* t,
                     uint32_t seed, uint32_t wave0, const int* sw, int k, int n, float jitter, float* d_w,
                     void* pids_k, int* stream_k, float* jit) {
  const long long lanes = (long long)k * n;
  const int blocks = (int)((lanes + LOSS_RAYS_THREADS - 1) / LOSS_RAYS_THREADS);
  loss_rays_kernel<R, P><<<blocks, LOSS_RAYS_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const R*>(raster), static_cast<const P*>(pids), m, t, seed, wave0, sw, k, n, jitter, d_w,
      static_cast<P*>(pids_k), stream_k, jit);
  return (int)cudaGetLastError();
}

using Kernel = void (*)(const Args);

template <int kDense>
Kernel pick_kernel(int kind, bool tap) {
  switch (kind) {
    case kWaveKind: return tap ? render_wave_kernel<true, kDense, false> : render_wave_kernel<false, kDense, false>;
    // No measuring twin counts: a measuring launch of the counting wave is refused.
    case kWaveCountKind:
      if (tap) return nullptr;
      return render_wave_kernel<false, kDense, true>;
    case kTraceKind: return tap ? trace_lanes_kernel<true, kDense, false> : trace_lanes_kernel<false, kDense, false>;
    case kRecordKind: return tap ? trace_lanes_kernel<true, kDense, true> : trace_lanes_kernel<false, kDense, true>;
    default: return tap ? replay_lanes_kernel<true, kDense> : replay_lanes_kernel<false, kDense>;
  }
}

// dense: 1 for the dense instantiations, 0 for the fused table's.
Kernel pick_kernel(int kind, bool tap, int dense) {
  return dense ? pick_kernel<1>(kind, tap) : pick_kernel<0>(kind, tap);
}

// Blocks the device holds resident for `kernel` (resident blocks per SM
// times the SM count, both asked of the runtime and kept per device).
cudaError_t resident_blocks(int kind, bool tap, int dense, int device, int* blocks) {
  static int resident[MAX_DEVICES][kNumKinds][2][2];
  if (device < 0 || device >= MAX_DEVICES || kind < 0 || kind >= kNumKinds || dense < 0 || dense > 1 ||
      pick_kernel(kind, tap, dense) == nullptr)
    return cudaErrorInvalidValue;
  int& kept = resident[device][kind][tap][dense];
  if (kept == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick_kernel(kind, tap, dense), THREADS, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm * sms <= 0) return cudaErrorLaunchOutOfResources;
    kept = per_sm * sms;
  }
  *blocks = kept;
  return cudaSuccess;
}

int launch(int kind, int device, void* stream, const Args& a) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(a.scratch, 0, SCRATCH_INTS * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0) return 0;
  const bool tap = a.tap != nullptr;
  const int dense = a.dens != nullptr;
  if (dense) {
    // The kernels index the grids' own arrays by the grids' shapes: an array
    // of another length is refused, never read out of its bounds.
    const int* ip = a.p.i;
    if (a.n_dens != (long long)ip[I_X] * ip[I_Y] * ip[I_Z]) return (int)cudaErrorInvalidValue;
    if (ip[I_EMISSION] == 3 && a.n_tdata != (long long)ip[I_TX] * ip[I_TY] * ip[I_TZ])
      return (int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  err = resident_blocks(kind, tap, dense, device, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int per_block = THREADS * QUEUE_PER_THREAD;
  const int wanted = (int)(((long long)a.n + per_block - 1) / per_block);
  if (wanted < blocks) blocks = wanted;
  pick_kernel(kind, tap, dense)<<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

void set_tables(Args& a, const float* rows, int n_rows, int row_w, const float* trows, int n_trows,
                const float* bb_pairs, const float* dens, long long n_dens, const float* maj, int n_maj,
                const float* tdata, long long n_tdata, const float* fp, const int* ip, int* scratch,
                unsigned char* tap, unsigned long long* stat) {
  a.rows = rows; a.n_rows = n_rows; a.row_w = row_w;
  a.trows = trows; a.n_trows = n_trows; a.bb_pairs = bb_pairs;
  a.dens = dens; a.n_dens = n_dens; a.maj = maj; a.n_maj = n_maj;
  a.tdata = tdata; a.n_tdata = n_tdata;
  a.scratch = scratch; a.tap = tap; a.stat = stat;
  for (int k = 0; k < NUM_FPARAMS; ++k) a.p.f[k] = fp[k];
  for (int k = 0; k < NUM_IPARAMS; ++k) a.p.i[k] = ip[k];
}

// The wave launches of the C interface (vpt_render_wave).
int launch_wave(int kind, int device, void* stream, float* film, const int* pids, int start, int n,
                unsigned int stream_word, int max_steps,
                const float* rows, int n_rows, int row_w,
                const float* trows, int n_trows, const float* bb_pairs,
                const float* dens, long long n_dens, const float* maj, int n_maj,
                const float* tdata, long long n_tdata,
                const float* fp, const int* ip, int* scratch,
                unsigned char* tap, unsigned long long* stat) {
  Args a{};
  a.film = reinterpret_cast<float4*>(film); a.pids = pids; a.start = start;
  a.n = n; a.max_steps = max_steps; a.stream = stream_word;
  set_tables(a, rows, n_rows, row_w, trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata,
             fp, ip, scratch, tap, stat);
  return launch(kind, device, stream, a);
}

}  // namespace

extern "C" {

int vpt_num_fparams() { return NUM_FPARAMS; }
int vpt_num_iparams() { return NUM_IPARAMS; }

// The four launches below run on `stream`, do not synchronise, and return a
// cudaError_t (0 on success). fp / ip are HOST arrays in the FParam / IParam
// layout; they travel in the kernel's arguments. rows: [n_rows, row_w]
// float32 (row_w 8 or 16), trows: [n_trows, 8] or null, bb_pairs:
// [npairs, 6] or null. A medium without the fused table passes rows null
// and instead dens: [n_dens] float32 (the grid's own density array, flat,
// n_dens = X * Y * Z), maj: [n_maj, 2] (brick, superbrick) majorant pairs,
// tdata: [n_tdata] (the temperature grid's own array, flat, n_tdata = TX *
// TY * TZ) or null. An array of another length is refused.
// scratch: SCRATCH_INTS (6) ints on the device, 8-byte aligned, zeroed here on the stream. tap: null, or given for the measuring instantiation, and then
// stat may be given too (see Args).

// Advance every lane of (sf [21, n] float32, si [3, n] int32, SoA) until
// DONE or max_steps steps, in place. pids / streams: [n] int32 (uint32 bits).
int vpt_trace_lanes(int device, void* stream, float* sf, int* si, const int* pids, const int* streams,
                    int n, int max_steps, const float* rows, int n_rows, int row_w,
                    const float* trows, int n_trows, const float* bb_pairs,
                    const float* dens, long long n_dens, const float* maj, int n_maj,
                    const float* tdata, long long n_tdata,
                    const float* fp, const int* ip, int* scratch,
                    unsigned char* tap, unsigned long long* stat) {
  Args a{};
  a.sf = sf; a.si = si; a.pids = pids; a.streams = streams;
  a.n = n; a.max_steps = max_steps;
  set_tables(a, rows, n_rows, row_w, trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata,
             fp, ip, scratch, tap, stat);
  return launch(kTraceKind, device, stream, a);
}

// One sample for each of n pixels, added to film [H * W, 4] float32 in
// place: pixel ids pids[0..n), or start .. start + n - 1 where pids is null.
// A pixel id may occur once. After the launch scratch[1] holds the lanes
// stopped by the max_steps cap and scratch[2] the largest lane counter.
int vpt_render_wave(int device, void* stream, float* film, const int* pids, int start, int n,
                    unsigned int stream_word, int max_steps,
                    const float* rows, int n_rows, int row_w,
                    const float* trows, int n_trows, const float* bb_pairs,
                    const float* dens, long long n_dens, const float* maj, int n_maj,
                    const float* tdata, long long n_tdata,
                    const float* fp, const int* ip, int* scratch,
                    unsigned char* tap, unsigned long long* stat) {
  return launch_wave(kWaveKind, device, stream, film, pids, start, n, stream_word, max_steps, rows, n_rows, row_w,
                     trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata, fp, ip, scratch, tap, stat);
}

// vpt_render_wave, and scratch[4..5] gets the wave's lane-iterations (a
// uint64: each retired lane's counter, less one where an event retired it;
// integrator.lane_iterations). tap must be null.
int vpt_render_wave_counted(int device, void* stream, float* film, const int* pids, int start, int n,
                            unsigned int stream_word, int max_steps,
                            const float* rows, int n_rows, int row_w,
                            const float* trows, int n_trows, const float* bb_pairs,
                            const float* dens, long long n_dens, const float* maj, int n_maj,
                            const float* tdata, long long n_tdata,
                            const float* fp, const int* ip, int* scratch,
                            unsigned char* tap, unsigned long long* stat) {
  return launch_wave(kWaveCountKind, device, stream, film, pids, start, n, stream_word, max_steps, rows, n_rows, row_w,
                     trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata, fp, ip, scratch, tap, stat);
}

// The record instantiation of trace_lanes_kernel, the forward of the
// gradient path (diff/prb.py _trace_rays_record): each of n world rays
// (o_world with row stride o_stride floats, 3 or 0; d_world [n, 3]; pids /
// streams [n] int32, uint32 bits) is born in the kernel as init_state makes
// it and runs until DONE or max_steps steps. Writes L_out [n, 3] (the
// radiance), ctr_out [n] (each lane's last counter) and tf [n, k_walks] (the
// walk residuals in _trace_rays_record's encoding, 0 in every slot a lane
// did not fill).
int vpt_record_lanes(int device, void* stream, const float* o_world, int o_stride, const float* d_world,
                     const int* pids, const int* streams, int n, int max_steps,
                     float* L_out, int* ctr_out, float* tf, int k_walks,
                     const float* rows, int n_rows, int row_w,
                     const float* trows, int n_trows, const float* bb_pairs,
                     const float* dens, long long n_dens, const float* maj, int n_maj,
                     const float* tdata, long long n_tdata,
                     const float* fp, const int* ip, int* scratch,
                     unsigned char* tap, unsigned long long* stat) {
  Args a{};
  a.o_world = o_world; a.o_stride = o_stride; a.d_world = d_world; a.pids = pids; a.streams = streams;
  a.n = n; a.max_steps = max_steps; a.L_out = L_out; a.ctr_out = ctr_out; a.tf = tf; a.k_walks = k_walks;
  set_tables(a, rows, n_rows, row_w, trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata,
             fp, ip, scratch, tap, stat);
  return launch(kRecordKind, device, stream, a);
}

// The backward replay of n lanes (diff/prb.py replay_grads): the record's
// world rays, pids and streams (as vpt_record_lanes), taken in the queue
// order `order` [n] (a permutation of 0..n-1; null: index order), tf [n,
// k_walks] the recorded residuals (k_walks 0: none, PRE+GRAD for every
// walk), g [n, 3] the cotangent, Lf [n, 3] the forward radiance; a lane
// retires at counter max_iters (truncation parity) or after max_steps steps.
// Adds into the gradient grids gd [X, Y, Z] and gt [TX, TY, TZ] (null
// without emission), zeroed by the caller, with float atomics; gacc /
// nsteps [n], or null, get each lane's replayed <g, L> and its steps.
int vpt_replay_lanes(int device, void* stream, const float* o_world, int o_stride, const float* d_world,
                     const int* pids, const int* streams, const int* order, int n, int max_steps,
                     int max_iters, const float* tf, int k_walks,
                     const float* g, const float* Lf, float* gd, float* gt, float* gacc, int* nsteps,
                     const float* rows, int n_rows, int row_w,
                     const float* trows, int n_trows, const float* bb_pairs,
                     const float* dens, long long n_dens, const float* maj, int n_maj,
                     const float* tdata, long long n_tdata,
                     const float* fp, const int* ip, int* scratch,
                     unsigned char* tap, unsigned long long* stat) {
  Args a{};
  a.o_world = o_world; a.o_stride = o_stride; a.d_world = d_world; a.pids = pids; a.streams = streams;
  a.order = order;
  a.n = n; a.max_steps = max_steps; a.max_iters = max_iters;
  a.tf = const_cast<float*>(tf); a.k_walks = k_walks;
  a.g = g; a.Lf = Lf; a.gd = gd; a.gt = gt; a.gacc = gacc; a.nsteps = nsteps;
  set_tables(a, rows, n_rows, row_w, trows, n_trows, bb_pairs, dens, n_dens, maj, n_maj, tdata, n_tdata,
             fp, ip, scratch, tap, stat);
  return launch(kReplayKind, device, stream, a);
}

// The ray batch of one loss evaluation (diff/inverse.py loss_rays), one
// launch: for lane q < k * n, sample i = q / n of pixel j = q % n, d_w
// [k * n, 3] gets the unit world direction, pids_k [k * n] pids[j],
// stream_k [k * n] int32 (uint32 bits) mix_stream(seed, wave0 * k + i), and
// jit [k * n, 2] (or null) the two jitter uniforms. raster [n, 2] and pids
// [n] are int32, or int64 where raster_i64 / pids_i64, and pids_k takes
// pids' type; m [3, 3] and t [3] are the camera's raster_to_world_dir and
// raster_to_world_trans, float32 on the device; jitter 1 moves each ray by
// half a pixel times its uniforms, 0 not at all. sw: null, or two int32
// words on the device (uint32 bits) that the kernel reads in place of seed
// and wave0 when it runs, so that a CUDA graph which captured the launch
// takes each replay's seed and wave from them.
int vpt_loss_rays(int device, void* stream, const void* raster, int raster_i64, const void* pids, int pids_i64,
                  const float* m, const float* t, unsigned int seed, unsigned int wave0, const int* sw, int k,
                  int n, int jitter, float* d_w, void* pids_k, int* stream_k, float* jit) {
  if (k < 0 || n < 0 || (long long)k * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)k * n == 0) return 0;
  const float scale = jitter ? 0.5f : 0.f;
  if (raster_i64) {
    return pids_i64 ? launch_loss_rays<long long, long long>(stream, raster, pids, m, t, seed, wave0, sw, k, n,
                                                             scale, d_w, pids_k, stream_k, jit)
                    : launch_loss_rays<long long, int>(stream, raster, pids, m, t, seed, wave0, sw, k, n, scale,
                                                       d_w, pids_k, stream_k, jit);
  }
  return pids_i64 ? launch_loss_rays<int, long long>(stream, raster, pids, m, t, seed, wave0, sw, k, n, scale,
                                                     d_w, pids_k, stream_k, jit)
                  : launch_loss_rays<int, int>(stream, raster, pids, m, t, seed, wave0, sw, k, n, scale, d_w,
                                               pids_k, stream_k, jit);
}

// Resident blocks of the production kernels on `device` (see
// resident_blocks), dense (1) or reading the fused table (0):
// render_wave_kernel, trace_lanes_kernel,
// THREADS, the device's SM count, then the record instantiation and
// replay_lanes_kernel (after the first four, so that a caller of the
// six-argument form of earlier sources reads the same first four).
int vpt_occupancy(int device, int dense, int* wave_blocks, int* trace_blocks, int* threads, int* sms,
                  int* record_blocks, int* replay_blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  *threads = THREADS;
  err = resident_blocks(kWaveKind, false, dense, device, wave_blocks);
  if (err != cudaSuccess) return (int)err;
  err = resident_blocks(kTraceKind, false, dense, device, trace_blocks);
  if (err != cudaSuccess) return (int)err;
  err = resident_blocks(kRecordKind, false, dense, device, record_blocks);
  if (err != cudaSuccess) return (int)err;
  err = resident_blocks(kReplayKind, false, dense, device, replay_blocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

const char* vpt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
