// trace_lanes.cu: the forward tracer's lane loop as one CUDA kernel for Hopper.
//
// Replaces the JAX package's Pallas megakernel (volume_path_tracer_tpu/
// render/megakernel.py: the event step `kernel` built by make_kernel,
// launched by _pallas_step_call through trace_rays_fused) TOGETHER WITH its
// XLA prestep (make_prestep / fetch_rows). On the TPU those were two
// programs per wavefront iteration because Mosaic cannot gather from a large
// table inside a kernel; a CUDA thread reads the table in device memory
// directly, so one thread here carries one lane through everything:
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
// A lane loops until it is DONE or has taken max_steps steps. max_steps = 1
// is exactly one wavefront iteration of the plain step (render/integrator.py
// make_step); max_steps = max_iters in one launch is the production tracer.
// Every lane's draws are keyed on its own counter, so a lane looping on its
// own takes the same path as in the wavefront with compaction: no
// compaction, no per-iteration launch and no device->host read of the alive
// count. State is read once and written once (SoA, neighbouring threads on
// neighbouring lanes) and lives in registers in between.
//
// The arithmetic follows make_step operation by operation. The compiler
// contracts multiply-adds to FMA and log1pf/sinf/cosf differ in the last ulp
// from the host's, so lanes agree with the plain version to rounding, except
// where rounding flips a knife-edge branch; draws and table reads agree
// exactly.
//
// What bounds it on this card: one gathered row per lane-step (32 B for
// 8-wide rows, 64 B for 16-wide), plus 24 B per blackbody pair read at an
// emissive collision and one 32 B temperature row on 8-wide emissive media.
// The flagship 77^3 table is about 15 MB and stays in the 50 MB L2, so the
// dependent-load latency of that gather, not HBM bandwidth, is the likely
// limit. What the persistent-lane design costs: warp divergence on the
// long-path tail. Most lanes retire within tens of steps while a few run
// hundreds; a warp runs as long as its longest lane. Wavefront with
// compaction against persistent lanes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAM = 0;
constexpr int SHADOW = 1;
constexpr int DONE = 2;
constexpr int THREADS = 128;

// State: sf [21, n] float32 and si [3, n] int32, SoA, in the field order of
// render/megakernel.py STATE_F32 / STATE_I32.
// Float parameters (render/megakernel.py _kernel_params builds this array).
enum FParam {
  P_VOXEL, P_SIGMA_A, P_SIGMA_S, P_SIGMA_T, P_G, P_SUPER_TAU, P_LE_SCALE,
  P_T_SCALE, P_T_OFFSET, P_HG_DEN0, P_HG_C1, P_HG_NUM,
  P_WI, P_LI = P_WI + 3, P_LINF = P_LI + 3, P_DOFF = P_LINF + 3,
  P_TOFF = P_DOFF + 3, P_TVOXEL = P_TOFF + 3, P_TC_MAX, P_ORIGIN,
  P_TORIGIN = P_ORIGIN + 3, P_BB_RES = P_TORIGIN + 3, NUM_FPARAMS
};
// Integer parameters.
enum IParam {
  I_X, I_Y, I_Z, I_BX, I_BY, I_BZ, I_MAX_DEPTH, I_NEE, I_EMISSION,
  I_TX, I_TY, I_TZ, I_NPAIRS, NUM_IPARAMS
};
// I_EMISSION: 0 none, 1 temperature in columns 8..15 of 16-wide rows,
// 2 temperature from its own corner table through its own transform.

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

// Slab clip against [lo, hi]; t0 floored at 1e-4 (clip_ray).
__device__ __forceinline__ void clip_box(float ox, float oy, float oz, float dx, float dy, float dz,
                                         const float* lo, const float* hi,
                                         float& t0, float& t1, bool& hit) {
  const float o[3] = {ox, oy, oz};
  const float d[3] = {dx, dy, dz};
  float t_lo = 0.f, t_hi = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = safe_inv(d[a]);
    const float ta = (lo[a] - o[a]) * inv;
    const float tb = (hi[a] - o[a]) * inv;
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

// Left-to-right sum of v[c] * w[c] (grids/grid.py dot8).
__device__ __forceinline__ float dot8(float4 a, float4 b, const float* w) {
  float s = a.x * w[0];
  s = s + a.y * w[1];
  s = s + a.z * w[2];
  s = s + a.w * w[3];
  s = s + b.x * w[4];
  s = s + b.y * w[5];
  s = s + b.z * w[6];
  s = s + b.w * w[7];
  return s;
}

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// kTap: also mark each table row the lane reads in `tap` (rows of the fused
// table at [0, n_rows), temperature rows after them), so a measurement can
// count the distinct bytes a run needs. The production launch has kTap false.
template <bool kTap>
__global__ void __launch_bounds__(THREADS)
trace_lanes_kernel(float* __restrict__ sf, int* __restrict__ si,
                   const int* __restrict__ pids, const int* __restrict__ streams,
                   int n, int max_steps,
                   const float* __restrict__ rows, long long n_rows, int row_w,
                   const float* __restrict__ trows, long long n_trows,
                   const float* __restrict__ bb_pairs,
                   const float* __restrict__ fp, const int* __restrict__ ip,
                   unsigned char* __restrict__ tap) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  // ---- lane state: one load per field ----
  float ox = sf[0 * n + lane], oy = sf[1 * n + lane], oz = sf[2 * n + lane];
  float dx = sf[3 * n + lane], dy = sf[4 * n + lane], dz = sf[5 * n + lane];
  float t = sf[6 * n + lane], t_exit = sf[7 * n + lane];
  float sig_seg = sf[8 * n + lane], t_seg = sf[9 * n + lane];
  float Lx = sf[10 * n + lane], Ly = sf[11 * n + lane], Lz = sf[12 * n + lane];
  float pox = sf[13 * n + lane], poy = sf[14 * n + lane], poz = sf[15 * n + lane];
  float pdx = sf[16 * n + lane], pdy = sf[17 * n + lane], pdz = sf[18 * n + lane];
  float T_ray = sf[19 * n + lane], phase_val = sf[20 * n + lane];
  int depth = si[0 * n + lane], mode = si[1 * n + lane], ctr = si[2 * n + lane];
  const uint32_t pid = (uint32_t)pids[lane];
  const uint32_t strm = (uint32_t)streams[lane];

  if (mode != DONE && max_steps > 0) {
    // ---- scene constants ----
    const float voxel = fp[P_VOXEL];
    const float sigma_a = fp[P_SIGMA_A], sigma_s = fp[P_SIGMA_S], sigma_t = fp[P_SIGMA_T];
    const float super_tau = fp[P_SUPER_TAU];
    const float Ox = fp[P_ORIGIN], Oy = fp[P_ORIGIN + 1], Oz = fp[P_ORIGIN + 2];
    const int X = ip[I_X], Y = ip[I_Y], Z = ip[I_Z];
    const int BX = ip[I_BX], BY = ip[I_BY], BZ = ip[I_BZ];
    const int max_depth = ip[I_MAX_DEPTH];
    const bool nee_on = ip[I_NEE] != 0;
    const int emission = ip[I_EMISSION];
    const long long n_corner = (long long)(X + 1) * (Y + 1) * (Z + 1);
    const float box_lo[3] = {Ox, Oy, Oz};
    const float box_hi[3] = {Ox + (float)X, Oy + (float)Y, Oz + (float)Z};
    const float wix = fp[P_WI], wiy = fp[P_WI + 1], wiz = fp[P_WI + 2];

    for (int s = 0; s < max_steps && mode != DONE; ++s) {
      const bool in_cam = mode == CAM;
      const bool in_shw = mode == SHADOW;

      // ---- draws ----
      uint32_t r0 = pid, r1 = strm, r2 = (uint32_t)ctr, r3 = 0u;
      pcg4d(r0, r1, r2, r3);
      const float u0 = u32_to_uniform(r0), u1 = u32_to_uniform(r1);
      const float u2 = u32_to_uniform(r2), u3 = u32_to_uniform(r3);

      // ---- free flight in the carried segment ----
      const bool has_seg = t_seg > t;
      const float sig = fmaxf(sig_seg, 1e-20f);
      const float dt_w = -log1pf(-u0) / sig;
      const float t_cand = t + dt_w / voxel;
      const bool collide = has_seg && (sig_seg > 0.f) && (t_cand < t_seg);
      const float t_next = has_seg ? t_seg : t;
      const bool exited = !collide && (t_next >= t_exit - 1e-6f);
      const bool fetch = !collide && !exited;

      // ---- THE gather: corner row at a collision, majorant row otherwise ----
      const float t_gather = collide ? t_cand : t_next + 1e-3f;
      const float pcx = ox + dx * t_gather, pcy = oy + dy * t_gather, pcz = oz + dz * t_gather;
      const float lpx = pcx - Ox, lpy = pcy - Oy, lpz = pcz - Oz;
      const int bi = (int)floorf(lpx / 8.f), bj = (int)floorf(lpy / 8.f), bk = (int)floorf(lpz / 8.f);
      const bool b_valid = bi >= 0 && bi < BX && bj >= 0 && bj < BY && bk >= 0 && bk < BZ;
      const long long b_flat =
          ((long long)clampi(bi, 0, BX - 1) * BY + clampi(bj, 0, BY - 1)) * BZ + clampi(bk, 0, BZ - 1);
      const int ix = (int)floorf(lpx), iy = (int)floorf(lpy), iz = (int)floorf(lpz);
      const float fx = lpx - (float)ix, fy = lpy - (float)iy, fz = lpz - (float)iz;
      const bool valid = ix >= -1 && ix <= X - 1 && iy >= -1 && iy <= Y - 1 && iz >= -1 && iz <= Z - 1;
      const long long base =
          ((long long)clampi(ix + 1, 0, X) * (Y + 1) + clampi(iy + 1, 0, Y)) * (Z + 1) + clampi(iz + 1, 0, Z);
      const long long idx = clampll(collide ? base : n_corner + b_flat, 0, n_rows - 1);
      const float4* rp = reinterpret_cast<const float4*>(rows + idx * row_w);
      if (kTap) tap[idx] = 1;
      const float4 ra = __ldg(rp), rb = __ldg(rp + 1);
      float w[8];
      tri_weights(fx, fy, fz, w);
      const float rho = valid ? dot8(ra, rb, w) : 0.f;
      const float bmaj = b_valid ? ra.x : 0.f;
      const float smaj = b_valid ? ra.y : 0.f;

      // ---- next segment (crossing lanes): brick or superbrick ----
      const float extra = (smaj - bmaj) * sigma_t * 64.f * voxel;
      const bool use_super = extra <= super_tau;
      const float cs = use_super ? 64.f : 8.f;
      float t_cell = 0.f;
      {
        const float clx = floorf(lpx / cs) * cs + Ox;
        const float cly = floorf(lpy / cs) * cs + Oy;
        const float clz = floorf(lpz / cs) * cs + Oz;
        const float lo[3] = {clx, cly, clz};
        const float hi[3] = {clx + cs, cly + cs, clz + cs};
        const float o[3] = {ox, oy, oz};
        const float d[3] = {dx, dy, dz};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float inv = safe_inv(d[a]);
          const float mx = fmaxf((lo[a] - o[a]) * inv, (hi[a] - o[a]) * inv);
          t_cell = a == 0 ? mx : fminf(t_cell, mx);
        }
      }
      const float t_seg_f = fmaxf(fminf(t_cell, t_exit), t_next + 2e-3f);
      const float sig_seg_f = (use_super ? smaj : bmaj) * sigma_t;
      const bool real_col = collide && (rho > 0.f);
      const bool zero_col = collide && !(rho > 0.f);

      // ---- camera-mode collision: emission, then the event ----
      const bool cam_col = in_cam && real_col;
      const float p_a = sigma_a * rho / sig;
      const float p_s = sigma_s * rho / sig;
      const float p_n = fmaxf(1.f - p_a - p_s, 0.f);
      if (emission != 0 && cam_col) {
        float temp_adim;
        if (emission == 1) {
          const float4 ta = __ldg(rp + 2), tb = __ldg(rp + 3);
          temp_adim = valid ? dot8(ta, tb, w) : 0.f;
        } else {
          // The temperature grid's own transform (sample_temperature_kelvin).
          const float tvox = fp[P_TVOXEL];
          const float tlx = ((pcx * voxel + fp[P_DOFF]) - fp[P_TOFF]) / tvox - fp[P_TORIGIN];
          const float tly = ((pcy * voxel + fp[P_DOFF + 1]) - fp[P_TOFF + 1]) / tvox - fp[P_TORIGIN + 1];
          const float tlz = ((pcz * voxel + fp[P_DOFF + 2]) - fp[P_TOFF + 2]) / tvox - fp[P_TORIGIN + 2];
          const int TX = ip[I_TX], TY = ip[I_TY], TZ = ip[I_TZ];
          const int jx = (int)floorf(tlx), jy = (int)floorf(tly), jz = (int)floorf(tlz);
          float tw[8];
          tri_weights(tlx - (float)jx, tly - (float)jy, tlz - (float)jz, tw);
          const bool tvalid = jx >= -1 && jx <= TX - 1 && jy >= -1 && jy <= TY - 1 && jz >= -1 && jz <= TZ - 1;
          const long long tbase = clampll(
              ((long long)clampi(jx + 1, 0, TX) * (TY + 1) + clampi(jy + 1, 0, TY)) * (TZ + 1) + clampi(jz + 1, 0, TZ),
              0, n_trows - 1);
          const float4* tp = reinterpret_cast<const float4*>(trows + tbase * 8);
          if (kTap) tap[n_rows + tbase] = 1;
          temp_adim = tvalid ? dot8(__ldg(tp), __ldg(tp + 1), tw) : 0.f;
        }
        const float temp_k = temp_adim * fp[P_T_SCALE] + fp[P_T_OFFSET];
        const float tc = fminf(fmaxf(temp_k, 0.f), fp[P_TC_MAX]);
        const float bb_res = fp[P_BB_RES];
        const int ti = clampi((int)floorf(tc / bb_res) + 1, 0, ip[I_NPAIRS] - 1);
        const float frac = tc / bb_res - (float)(ti - 1);
        const float* pr = bb_pairs + ti * 6;
        const bool hot = !(temp_k <= 0.f);
        const float bx = hot ? __ldg(pr + 0) + __ldg(pr + 3) * frac : 0.f;
        const float by = hot ? __ldg(pr + 1) + __ldg(pr + 4) * frac : 0.f;
        const float bz = hot ? __ldg(pr + 2) + __ldg(pr + 5) * frac : 0.f;
        const float pal = p_a * fp[P_LE_SCALE];
        Lx = Lx + pal * bx;
        Ly = Ly + pal * by;
        Lz = Lz + pal * bz;
      }
      const float total = p_n + p_a + p_s;
      const float xv = u1 * total;
      const int event = xv <= p_n ? 0 : (xv <= p_n + p_a ? 1 : 2);
      const bool cam_null = cam_col && event == 0;
      const bool cam_abs = cam_col && event == 1;
      const bool cam_scat = cam_col && event == 2;

      const float phase_old = phase_val;
      if (cam_scat) {
        // HG redirect around d (ops/phase.sample_henyey_greenstein)
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
        float lx = sin_c * cosf(phi), ly = sin_c * sinf(phi), lz = fminf(fmaxf(cos_t, -1.f), 1.f);
        const float nrm = sqrtf(lx * lx + ly * ly + lz * lz);
        lx = lx / nrm; ly = ly / nrm; lz = lz / nrm;
        const float sgn = dz >= 0.f ? 1.f : -1.f;
        const float a = -1.f / (sgn + dz);
        const float b = dx * dy * a;
        const float v2x = 1.f + sgn * a * dx * dx, v2y = sgn * b, v2z = -sgn * dx;
        const float v3x = b, v3y = sgn + a * dy * dy, v3z = -dy;
        pdx = lx * v2x + ly * v3x + lz * dx;
        pdy = lx * v2y + ly * v3y + lz * dy;
        pdz = lx * v2z + ly * v3z + lz * dz;
        pox = pcx; poy = pcy; poz = pcz;
        // HG phase toward the distant light (ops/phase.henyey_greenstein)
        const float cw = dx * wix + dy * wiy + dz * wiz;
        const float den = fp[P_HG_DEN0] + fp[P_HG_C1] * cw;
        phase_val = fp[P_HG_NUM] / (den * sqrtf(fmaxf(den, 1e-12f)));
        depth = depth + 2;
      }

      // ---- shadow-mode collision: ratio tracking + Russian roulette ----
      const bool shw_col = in_shw && real_col;
      const float sigma_n = fmaxf(sig_seg - sigma_t * rho, 0.f);
      float T_after = T_ray * (sigma_n / sig);
      const bool rr = T_after <= 0.05f;
      const bool rr_kill = rr && (u1 < 0.75f);
      T_after = rr_kill ? 0.f : (rr ? T_after / 0.25f : T_after);
      const float T_new = shw_col ? T_after : T_ray;
      const bool shw_dead = shw_col && (T_new <= 0.f);
      const bool shadow_finish = (in_shw && exited) || shw_dead;
      if (shadow_finish) {
        const float c = phase_old * T_new;
        Lx = Lx + c * fp[P_LI];
        Ly = Ly + c * fp[P_LI + 1];
        Lz = Lz + c * fp[P_LI + 2];
      }

      // ---- resume / retire ----
      const bool start_shadow = nee_on && cam_scat;
      const bool resume = nee_on ? shadow_finish : (shadow_finish || cam_scat);
      float t0n = 0.f, t1n = 0.f;
      bool hitn = false;
      if (start_shadow || resume) {
        if (start_shadow)
          clip_box(pcx, pcy, pcz, wix, wiy, wiz, box_lo, box_hi, t0n, t1n, hitn);
        else
          clip_box(pox, poy, poz, pdx, pdy, pdz, box_lo, box_hi, t0n, t1n, hitn);
      }
      const bool depth_ok = depth < max_depth;
      const bool resume_ok = resume && hitn && depth_ok;
      const bool resume_escape = resume && (!hitn || !depth_ok);
      const bool start_shadow_ok = start_shadow && hitn;
      const bool shadow_miss = start_shadow && !hitn;
      float t0p = 0.f, t1p = 0.f;
      bool hitp = false;
      if (shadow_miss) {
        // A shadow ray that misses the box keeps T = 1.
        Lx = Lx + phase_val * fp[P_LI];
        Ly = Ly + phase_val * fp[P_LI + 1];
        Lz = Lz + phase_val * fp[P_LI + 2];
        clip_box(pox, poy, poz, pdx, pdy, pdz, box_lo, box_hi, t0p, t1p, hitp);
      }
      const bool miss_resume_ok = shadow_miss && hitp && depth_ok;
      const bool miss_resume_escape = shadow_miss && (!hitp || !depth_ok);
      const bool done_inf = (in_cam && exited) || resume_escape || miss_resume_escape;
      if (done_inf) {
        Lx = Lx + fp[P_LINF];
        Ly = Ly + fp[P_LINF + 1];
        Lz = Lz + fp[P_LINF + 2];
      }

      if (done_inf || cam_abs) mode = DONE;
      if (start_shadow_ok) mode = SHADOW;
      if (resume_ok || miss_resume_ok) mode = CAM;

      float t_new = t;
      if (start_shadow_ok) {
        ox = pcx; oy = pcy; oz = pcz;
        dx = wix; dy = wiy; dz = wiz;
        t_new = t0n; t_exit = t1n;
      }
      if (resume_ok || miss_resume_ok) {
        ox = pox; oy = poy; oz = poz;
        dx = pdx; dy = pdy; dz = pdz;
        t_new = resume_ok ? t0n : t0p;
        t_exit = resume_ok ? t1n : t1p;
      }
      const bool plain_adv = cam_null || zero_col || (in_shw && real_col && !shadow_finish);
      if (plain_adv) t_new = t_cand;
      if (fetch) t_new = t_next;

      const bool new_ray = start_shadow_ok || resume_ok || miss_resume_ok;
      if (fetch) { sig_seg = sig_seg_f; t_seg = t_seg_f; }
      if (new_ray) { sig_seg = 0.f; t_seg = t_new; }
      t = t_new;
      T_ray = start_shadow_ok ? 1.f : T_new;
      ctr = ctr + 1;
    }
  }

  // ---- write back ----
  sf[0 * n + lane] = ox; sf[1 * n + lane] = oy; sf[2 * n + lane] = oz;
  sf[3 * n + lane] = dx; sf[4 * n + lane] = dy; sf[5 * n + lane] = dz;
  sf[6 * n + lane] = t; sf[7 * n + lane] = t_exit;
  sf[8 * n + lane] = sig_seg; sf[9 * n + lane] = t_seg;
  sf[10 * n + lane] = Lx; sf[11 * n + lane] = Ly; sf[12 * n + lane] = Lz;
  sf[13 * n + lane] = pox; sf[14 * n + lane] = poy; sf[15 * n + lane] = poz;
  sf[16 * n + lane] = pdx; sf[17 * n + lane] = pdy; sf[18 * n + lane] = pdz;
  sf[19 * n + lane] = T_ray; sf[20 * n + lane] = phase_val;
  si[0 * n + lane] = depth; si[1 * n + lane] = mode; si[2 * n + lane] = ctr;
}

}  // namespace

extern "C" {

int vpt_num_fparams() { return NUM_FPARAMS; }
int vpt_num_iparams() { return NUM_IPARAMS; }

// Advance every lane until DONE or max_steps steps, in place on (sf, si).
// sf: [21, n] float32, si: [3, n] int32 (SoA), pids / streams: [n] int32
// (uint32 bits). rows: [n_rows, row_w] float32 (row_w 8 or 16), trows:
// [n_trows, 8] or null, bb_pairs: [npairs, 6] or null, tap: null, or
// [n_rows + n_trows] bytes that the launch sets to 1 for every row it reads.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
int vpt_trace_lanes(int device, void* stream, float* sf, int* si, const int* pids, const int* streams,
                    int n, int max_steps, const float* rows, long long n_rows, int row_w,
                    const float* trows, long long n_trows, const float* bb_pairs,
                    const float* fp, const int* ip, unsigned char* tap) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (tap != nullptr) {
    trace_lanes_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        sf, si, pids, streams, n, max_steps, rows, n_rows, row_w, trows, n_trows, bb_pairs, fp, ip, tap);
  } else {
    trace_lanes_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        sf, si, pids, streams, n, max_steps, rows, n_rows, row_w, trows, n_trows, bb_pairs, fp, ip, tap);
  }
  return (int)cudaGetLastError();
}

const char* vpt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
