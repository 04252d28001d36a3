// SPH forces kernel for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces gpusph_tpu/ops/forces_pallas.py:_forces_kernel (l. 855) and its
// body _pair_chunk (l. 643), the Pallas TPU kernel launched by
// compute_forces_pallas at forces_pallas.py:916.  It computes the SPH
// right-hand side of every central particle over its rebuild-time neighbor
// groups (the block plan of gpusph_tpu_torch/ops/block_plan.py) and
// reduces it per particle: DrDt, DvDt xyz, XSPH xyz, DEDt.
//
// What bounds it on an H100: instruction issue on the CUDA cores.  A pass
// reads only the property table (64 B a row) and writes 32 B a particle,
// but every candidate pair (a central against a slot of a kept neighbor
// group) needs its offset, r^2 and range test, and the one pair in ten
// that is in range needs some 65 more f32 operations (kernel gradient,
// continuity, pressure gradient, artificial viscosity, density diffusion,
// moving-body feedback).  Tensor cores (wgmma) and TMA do not fit the pair
// math, a masked elementwise chain, not a matrix product.  So the design
// spends issue slots only where a pair needs them:
//
//  1. Per-thread compaction in summation order.  One CUDA block per central
//     block b of the plan loops over its own tiles [tile_off[b],
//     tile_off[b+1]) (no atomics; tile_off is clamped by the plan).  256
//     threads = 64 centrals x 4 slot lanes: thread 4i + lane holds central
//     i and owns the slots lane + 4j, j = 0..31, of each tile, so a warp
//     holds 8 centrals with all 4 lanes.  Per tile a thread first runs the
//     cheap part (offset, minimum image, r^2, range test) over its 32 slots
//     and sets bit j of a mask for each slot in range; then it walks only
//     those bits in ascending order (__ffs).  A warp issues the expensive
//     body max-popcount times per tile instead of once for each slot where
//     any of its threads is in range.  Each thread still sums its slots in
//     ascending order and the 4 lanes are reduced in a fixed order at the
//     end: the summation order, and so every bit of the result, is the same
//     from run to run.  Periodic and non-periodic grids get their own
//     instantiation, so the minimum image costs nothing where there is none.
//  2. A bank-safe window.  Once the threads of a warp read different slots,
//     64-byte rows would put one column of every row in the same 2 banks.
//     So after a tile lands, the block copies the 14 columns the body reads
//     into a column-major window s_col[14][128].  Lane l's 32 slots fill
//     positions 32l .. 32l+31, slot l + 4j at position 32l + ((j + 8l) & 31):
//     threads of one lane that read distinct slots hit distinct banks, and
//     the skew of 8 banks per lane keeps the 4 lanes apart while they walk
//     the same group.  The cheap part, where the 4 lanes of a warp read 4
//     slots, keeps reading the row-major stage as 16-byte loads of
//     (x, y, z, vx), one wavefront each.
//  3. Double-buffered window loads.  Two row-major stages of 8 KB (8 groups
//     x 16 rows x 64 B) take the tiles in turn: tile t+1's groups are
//     requested with 16-byte cp.async.cg right after the barrier that opens
//     tile t, and land while tile t is transposed and computed.  A stage's
//     16-byte chunk k of slot s sits at chunk k ^ f(s) of its row,
//     f(s) = ((s >> 2) ^ (s & 2)) & 3: the cheap part's 4 lanes and the
//     cp.async writes are conflict-free, the transpose's reads 2-way.  Pad
//     groups (id n_groups) are neither loaded nor tested: a warp-uniform
//     8-bit mask of kept groups gates the copy, the transpose and the cheap
//     part.
//  4. No work for sentinel centrals.  Real centrals fill the leading slots
//     of a block, so a block of n centrals holds sentinels only in its warps
//     past n / 8; a warp whose 8 centrals are all sentinels (cen_idx ==
//     cen_sentinel) skips the pair work of every tile (a warp-uniform
//     branch) and only takes its share of the block's copies and barriers.
//     It still writes zeros, as does a block with no tile.
//  5. Options fixed where they are common.  Each grid instantiation (1.)
//     comes in a general and a lean form, and the launch picks the lean one
//     when the options are the Wendland kernel, SPH_F1 and none of the
//     viscous term, boundary repulsion, XSPH or internal energy (DamBreak3D
//     and the other inviscid problems with artificial viscosity).  It pins
//     those options to their values as constants, so the compiler drops
//     their code from the pair body and schedules the rest in fewer
//     registers; it computes the same bits as the general form.
//
// The model options are run-time values in a POD struct, so one build
// serves every configuration of kernel_supported; all threads of a launch
// take the same branches on them.  __launch_bounds__(256, 4) sets the
// register budget: 64 registers, 32 warps per SM; of k = 2 .. 6 blocks per
// SM, 4 was the fastest on the H100 (scripts/sweep_forces_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 64;        // centrals per block
constexpr int GROUP = 16;    // particles per neighbor group
constexpr int GPT = 8;       // groups per tile
constexpr int TS = GROUP * GPT;  // window slots per tile
constexpr int NCOLS = 16;    // property-table columns
constexpr int NOUT = 8;      // DrDt, DvDt xyz, XSPH xyz, DEDt
constexpr int LANES = 4;     // slot lanes per central
constexpr int THREADS = B * LANES;
constexpr int SPL = TS / LANES;  // slots per lane in a tile: bits of a mask
constexpr int CHUNKS = NCOLS / 4;         // 16-byte chunks per table row
constexpr int TILE_CHUNKS = TS * CHUNKS;  // 16-byte chunks per tile (8 KB)
constexpr int GROUP_CHUNKS = GROUP * CHUNKS;
constexpr int NBODY = 14;    // columns the pair body reads: 0 .. C_DVISC
constexpr int SKEW = 8;      // bank skew between the lanes of the window
constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_BLOCKS = 4;  // blocks per SM that the register budget allows

// property-table columns (ops/forces_kernel.py C_*)
constexpr int C_POSX = 0, C_POSY = 1, C_POSZ = 2;
constexpr int C_VELX = 3, C_VELY = 4, C_VELZ = 5;
constexpr int C_MASS = 6, C_RHO = 7, C_PPRE = 8, C_SSPEED = 9;
constexpr int C_PRESS = 10, C_FLUID = 11, C_BOUND = 12, C_DVISC = 13;

// Run-time model options; filled from the two arrays that
// ops/forces_kernel.py:kernel_params builds, in the same order.
struct ForcesParams {
  // ints
  int kerneltype;     // 1 cubic spline, 2 quadratic, 3 Wendland, 4 Gaussian
  int sph_f2;         // SPH_F2 formulation (else SPH_F1)
  int dyn;            // DYN boundaries
  int ddt;            // density diffusion: 0 none, 1 Ferrari, 2 Colagrossi
  int artvisc;        // artificial viscosity
  int visc;           // 0 inviscid, 1 Morris, 2 Monaghan
  int avgop;          // viscosity average: 0 arithmetic, 1 harmonic, 2 geometric
  int repulsion;      // 0 none, 1 Lennard-Jones, 2 Monaghan-Kajtar
  int moving_bodies;  // boundary centrals take fluid feedback
  int xsph;
  int energy;
  int periodic;       // bit a set: axis a periodic
  int lj_p1_int;      // LJ exponents as small ints, or -1 for powf
  int lj_p2_int;
  // floats
  float h, rad2;
  float Lx, Ly, Lz, invLx, invLy, invLz;
  float kw, kf, gauss_wsub;  // kernel W / F coefficients, Gaussian offset
  float gx, gy, gz;
  float c0, rho0, sq_c0;
  float colagrossi_coeff;    // densityDiffCoeff * 2 h
  float ferrari_coeff;       // densityDiffCoeff
  float ferrari_safe2;       // (1e-4 h)^2
  float eps_art;             // epsartvisc
  float artvisc_h;           // h * artvisccoeff
  float monaghan_coeff;
  float r0, dcoeff, p1, p2, lj_rmin;
  float mk_k, mk_d, mk_beta;
};

constexpr int N_INT_PARAMS = 14;
constexpr int N_FLOAT_PARAMS = 31;

__device__ __forceinline__ float powi(float x, int n) {
  // repeated squaring, the same product order as ops/forces.py:_powf
  float out = 1.0f, base = x;
  while (n) {
    if (n & 1) out *= base;
    n >>= 1;
    if (n) base *= base;
  }
  return out;
}

__device__ __forceinline__ float kern_F(const ForcesParams& p, float r) {
  const float h = p.h;
  switch (p.kerneltype) {
    case 1: {  // cubic spline
      const float R = r / h;
      const float inner = (-4.0f + 3.0f * R) / h;
      const float t = -2.0f + R;
      const float outer = -(t * t) / (r > 0.0f ? r : 1.0f);
      return p.kf * (R < 1.0f ? inner : outer);
    }
    case 2: {  // quadratic
      const float R = r / h;
      return p.kf * (-2.0f + R) / r;  // r > 0 inside the pair mask
    }
    case 4: {  // Gaussian
      const float R = r / h;
      return -expf(-R * R) * p.kf;
    }
    default: {  // Wendland
      const float qm2 = r / h - 2.0f;
      return p.kf * qm2 * qm2 * qm2;
    }
  }
}

__device__ __forceinline__ float kern_W(const ForcesParams& p, float r) {
  const float R = r / p.h;
  switch (p.kerneltype) {
    case 1: {
      const float inner = 1.0f - 1.5f * R * R + 0.75f * R * R * R;
      const float t = 2.0f - R;
      const float outer = 0.25f * (t * t * t);
      return p.kw * (R < 1.0f ? inner : outer);
    }
    case 2:
      return p.kw * (0.25f * R * R - R + 1.0f);
    case 4:
      return p.kw * (expf(-R * R) - p.gauss_wsub);
    default: {
      float v = 1.0f - 0.5f * R;
      v = v * v;
      v = v * v;
      return p.kw * v * (1.0f + 2.0f * R);
    }
  }
}

__device__ __forceinline__ float avg_op(int op, float a, float b) {
  if (op == 0) return 0.5f * (a + b);
  if (op == 1) return 2.0f * a * b / (a + b + 1e-30f);
  return sqrtf(a * b);
}

__device__ __forceinline__ float min_image(float rl, int periodic, float L,
                                           float invL) {
  return periodic ? rl - L * rintf(rl * invL) : rl;
}

// r^2 with a fixed rounding, so that the cheap part and the body agree on
// which pairs are in range
__device__ __forceinline__ float dist2(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// stage position of 16-byte chunk k of window slot s (see the header, 3.)
__device__ __forceinline__ int stage_chunk(int s, int k) {
  return s * CHUNKS + (k ^ (((s >> 2) ^ (s & 2)) & 3));
}

// window position of slot lane + 4j in s_col (see the header, 2.)
__device__ __forceinline__ int col_pos(int lane, int j) {
  return lane * SPL + ((j + SKEW * lane) & (SPL - 1));
}

// offset of a window slot from the central, minimum image on the periodic
// axes
template <bool PERIODIC>
__device__ __forceinline__ void offset(const ForcesParams& p, float cx, float cy,
                                       float cz, float wx, float wy, float wz,
                                       float& rx, float& ry, float& rz) {
  rx = cx - wx;
  ry = cy - wy;
  rz = cz - wz;
  if (PERIODIC) {
    rx = min_image(rx, p.periodic & 1, p.Lx, p.invLx);
    ry = min_image(ry, p.periodic & 2, p.Ly, p.invLy);
    rz = min_image(rz, p.periodic & 4, p.Lz, p.invLz);
  }
}

// Requests tile t's kept groups into `stage` with cp.async and returns the
// warp-uniform mask of its kept groups (bit j: group j is not the pad).
__device__ __forceinline__ unsigned load_tile(float4* stage, const float4* prop,
                                              const int* flat_groups, int t,
                                              int n_groups, int tid) {
  const int wl = tid & 31;
  const int gid = flat_groups[(long long)t * GPT + (wl & (GPT - 1))];
  const unsigned kept = __ballot_sync(FULL, gid < n_groups) & ((1u << GPT) - 1);
#pragma unroll
  for (int r = 0; r < TILE_CHUNKS / THREADS; ++r) {
    const int q = tid + r * THREADS;
    const int j = q / GROUP_CHUNKS;  // group of the tile
    const int within = q % GROUP_CHUNKS;
    const int g = __shfl_sync(FULL, gid, j);
    if (kept >> j & 1) {
      cp_async16(stage + stage_chunk(j * GROUP + within / CHUNKS, within % CHUNKS),
                 prop + (long long)g * GROUP_CHUNKS + within);
    }
  }
  return kept;
}

// The cheap part over one thread's 32 slots of a tile: bit j of the result
// is set iff slot lane+4j is in range (0 < r^2 < rad^2).  Self-pairs fail
// r^2 > 0; a sentinel central sits at PAD_POS, far from every real slot;
// the slots of pad groups are not tested.
template <bool PERIODIC>
__device__ __forceinline__ unsigned range_mask(const ForcesParams& p,
                                               const float4* stage, int lane,
                                               unsigned kept, float cx,
                                               float cy, float cz) {
  unsigned m = 0;
#pragma unroll
  for (int g = 0; g < GPT; ++g) {
    if (!(kept >> g & 1)) continue;  // warp-uniform
#pragma unroll
    for (int jj = 0; jj < GROUP / LANES; ++jj) {
      const int j = g * (GROUP / LANES) + jj;  // slot lane + 4j lies in group g
      const float4 w = stage[stage_chunk(lane + LANES * j, 0)];  // x, y, z, vx
      float rx, ry, rz;
      offset<PERIODIC>(p, cx, cy, cz, w.x, w.y, w.z, rx, ry, rz);
      const float r2 = dist2(rx, ry, rz);
      if (r2 < p.rad2 && r2 > 0.0f) m |= 1u << j;
    }
  }
  return m;
}

// The options of the lean instantiation (header, 5.)
__host__ __device__ inline bool lean_options(const ForcesParams& p) {
  return p.kerneltype == 3 && !p.sph_f2 && p.visc == 0 && p.repulsion == 0 &&
         !p.xsph && !p.energy;
}

template <bool PERIODIC, bool LEAN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
forces_kernel(const ForcesParams p_in, const float4* __restrict__ prop,
              const int* __restrict__ flat_groups,
              const int* __restrict__ tile_off,
              const int* __restrict__ cen_idx, float* __restrict__ out,
              int n_slots, int n_groups, int cen_sentinel) {
  // two row-major stages; reused for the lane reduction at the end
  __shared__ float4 s_stage[2][TILE_CHUNKS];
  __shared__ float s_col[NBODY][TS];  // column-major, slots lane-major
  __shared__ float4 s_cen[B * CHUNKS];

  ForcesParams p = p_in;
  if (LEAN) {  // the values lean_options(p_in) holds, as constants
    p.kerneltype = 3;
    p.sph_f2 = p.visc = p.repulsion = p.xsph = p.energy = 0;
  }

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ci = tid / LANES;  // central of this thread
  const int lane = tid % LANES;  // slot lane: owns slots lane + 4j

  const int t0 = tile_off[b];
  const int t1 = tile_off[b + 1];
  // tile t0 is in flight while the centrals load
  unsigned kept_next = 0;
  if (t0 < t1) kept_next = load_tile(s_stage[0], prop, flat_groups, t0, n_groups, tid);
  cp_async_commit();

  // centrals: row cen_idx[b*B + i] of the table (sentinel = pad row)
  for (int q = tid; q < B * CHUNKS; q += THREADS) {
    const int row = q / CHUNKS;
    const long long src = (long long)cen_idx[b * B + row] * CHUNKS + q % CHUNKS;
    s_cen[q] = prop[src];
  }
  // sentinel warps skip the pair work (header, 4.)
  const bool live = __any_sync(FULL, cen_idx[b * B + ci] != cen_sentinel);
  __syncthreads();

  const float* cen = reinterpret_cast<const float*>(s_cen) + ci * NCOLS;
  const float cx = cen[C_POSX], cy = cen[C_POSY], cz = cen[C_POSZ];
  const float cvx = cen[C_VELX], cvy = cen[C_VELY], cvz = cen[C_VELZ];
  const float m_c = cen[C_MASS], rho_c = cen[C_RHO], ppre_c = cen[C_PPRE];
  const float ss_c = cen[C_SSPEED], press_c = cen[C_PRESS];
  const float c_fluid = cen[C_FLUID], c_bound = cen[C_BOUND];
  const float dvisc_c = cen[C_DVISC];
  const float c_any = c_fluid + c_bound - c_fluid * c_bound;

  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;

  // column c of this thread's slot lane + 4j is col[c * TS + col_pos(lane, j)]
  const float* col = &s_col[0][0];
  // transpose role: window position q_pos, i.e. slot lane_q + 4 j_q, and
  // chunks q_chunk, q_chunk + 1
  const int q_pos = tid % TS;
  const int q_lane = q_pos / SPL;
  const int q_slot = q_lane + LANES * ((q_pos - SKEW * q_lane) & (SPL - 1));
  const int q_chunk = (tid / TS) * 2;

  for (int t = t0; t < t1; ++t) {
    const float4* stage = s_stage[(t - t0) & 1];
    const unsigned kept = kept_next;
    cp_async_wait_all();
    // tile t has landed in `stage`; every warp is done with tile t-1, so
    // the other stage and s_col are free
    __syncthreads();
    if (t + 1 < t1)
      kept_next = load_tile(s_stage[(t + 1 - t0) & 1], prop, flat_groups, t + 1,
                            n_groups, tid);
    cp_async_commit();

    if (kept >> (q_slot / GROUP) & 1) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k = q_chunk + kk;
        const float4 v = stage[stage_chunk(q_slot, k)];
        s_col[4 * k][q_pos] = v.x;
        s_col[4 * k + 1][q_pos] = v.y;
        if (4 * k + 2 < NBODY) s_col[4 * k + 2][q_pos] = v.z;
        if (4 * k + 3 < NBODY) s_col[4 * k + 3][q_pos] = v.w;
      }
    }
    unsigned m = 0;
    if (live) m = range_mask<PERIODIC>(p, stage, lane, kept, cx, cy, cz);
    __syncthreads();  // s_col holds tile t

    while (m) {  // in-range slots, ascending
      const float* w = col + col_pos(lane, __ffs(m) - 1);
      m &= m - 1;
      float relx, rely, relz;
      offset<PERIODIC>(p, cx, cy, cz, w[C_POSX * TS], w[C_POSY * TS], w[C_POSZ * TS],
                       relx, rely, relz);
      const float r2 = dist2(relx, rely, relz);
      const float r = sqrtf(r2);
      const float fK = kern_F(p, r);

      const float relvx = cvx - w[C_VELX * TS];
      const float relvy = cvy - w[C_VELY * TS];
      const float relvz = cvz - w[C_VELZ * TS];
      const float vdp = relvx * relx + relvy * rely + relvz * relz;

      const float n_fluid = w[C_FLUID * TS], n_bound = w[C_BOUND * TS];
      const float m_n = w[C_MASS * TS], rho_n = w[C_RHO * TS];
      const float mfK = m_n * fK;
      const float n_any = n_fluid + n_bound - n_fluid * n_bound;

      // continuity (forces_kernel.def:2139-2155)
      const float cont = p.dyn ? c_any * n_any : c_fluid * n_fluid;
      float drdt_term = vdp * mfK;
      if (p.sph_f2) drdt_term = drdt_term * rho_c / rho_n;
      float drdt = cont * drdt_term;

      const float ff = c_fluid * n_fluid;

      // density diffusion
      if (p.ddt != 0) {
        const float g_dot_rel = p.gx * relx + p.gy * rely + p.gz * relz;
        if (p.ddt == 2) {  // Molteni & Colagrossi
          const float press_n = w[C_PRESS * TS];
          const float gate =
              fabsf(press_c - press_n) >= fabsf(g_dot_rel * rho_c) ? 1.0f : 0.0f;
          drdt -= ff * gate * p.colagrossi_coeff * p.c0 *
                  (rho_n / rho_c - 1.0f) * mfK;
        } else {  // Ferrari
          const float grav_corr = -g_dot_rel * p.rho0 / p.sq_c0;
          const float max_ss = fmaxf(ss_c, w[C_SSPEED * TS]);
          const float safe = r2 > p.ferrari_safe2 ? 1.0f : 0.0f;
          drdt += ff * safe * p.ferrari_coeff * max_ss *
                  (rho_c - rho_n + grav_corr) / rho_c * r * mfK;
        }
      }

      // momentum: pressure gradient
      float mom = p.dyn ? c_fluid * n_any : ff;
      if (p.moving_bodies) mom += c_bound * n_fluid;  // body force feedback
      const float pgrad = p.sph_f2 ? (press_c + w[C_PRESS * TS]) / (rho_c * rho_n)
                                   : ppre_c + w[C_PPRE * TS];
      float s_fac = -mom * pgrad * mfK;

      if (p.artvisc && vdp < 0.0f) {
        const float art = vdp * p.artvisc_h * (ss_c + w[C_SSPEED * TS]) /
                          ((r2 + p.eps_art) * (rho_c + rho_n));
        s_fac += mom * art * mfK;
      }

      float sv = 0.0f;
      if (p.visc != 0) {
        const float mu_avg = avg_op(p.avgop, dvisc_c, w[C_DVISC * TS]);
        const float visc_coeff = 2.0f * mu_avg * m_n / (rho_c * rho_n);
        if (p.visc == 2) {  // Monaghan
          const float mon = vdp < 0.0f ? vdp / (r2 + p.eps_art) : 0.0f;
          s_fac += mom * p.monaghan_coeff * visc_coeff * fK * mon;
        } else {  // Morris
          sv = mom * visc_coeff * fK;
        }
      }

      if (p.repulsion != 0) {
        const float rep_mask = c_fluid * n_bound;
        float rep;
        if (p.repulsion == 1) {  // Lennard-Jones
          const float inv_r = 1.0f / fmaxf(r, p.lj_rmin);
          const float ratio = p.r0 * inv_r;
          const float a = p.lj_p1_int >= 0 ? powi(ratio, p.lj_p1_int) : powf(ratio, p.p1);
          const float c = p.lj_p2_int >= 0 ? powi(ratio, p.lj_p2_int) : powf(ratio, p.p2);
          const float lj = fminf(p.dcoeff * (a - c) * inv_r * inv_r, 1e30f);
          rep = r < p.r0 ? lj : 0.0f;
        } else {  // Monaghan-Kajtar
          const float q = r / p.h;
          float t = 1.0f - 0.5f * q;
          t = t * t;
          const float wmk = 1.8f * (t * t) * (2.0f * q + 1.0f);
          const float dist = fmaxf(p.eps_art, r - p.mk_d);
          const float safe_r = fmaxf(r, 1e-12f);
          rep = p.mk_k * wmk * 2.0f * m_n /
                (p.mk_beta * dist * safe_r * (m_c + m_n));
        }
        s_fac += rep_mask * rep;
      }

      acc[0] += drdt;
      acc[1] += s_fac * relx + sv * relvx;
      acc[2] += s_fac * rely + sv * relvy;
      acc[3] += s_fac * relz + sv * relvz;
      if (p.xsph) {  // XSPH, reference factor 2 (forces_kernel.def:3368)
        const float xw = ff * (-2.0f * m_n) * kern_W(p, r) / (rho_c + rho_n);
        acc[4] += xw * relvx;
        acc[5] += xw * relvy;
        acc[6] += xw * relvz;
      }
      if (p.energy) {  // dU/dt -= (a_pair . v_ij)/2 (forces_kernel.def:3306-3316)
        const float dedt =
            s_fac * vdp + sv * (relvx * relvx + relvy * relvy + relvz * relvz);
        acc[7] += -0.5f * dedt;
      }
    }
  }

  // reduce the 4 slot lanes in a fixed order; write every output slot.  No
  // copy is in flight: the last tile waited for its own and requested none.
  __syncthreads();
  float* red = reinterpret_cast<float*>(s_stage);  // [LANES][NOUT][B]
#pragma unroll
  for (int k = 0; k < NOUT; ++k) red[(lane * NOUT + k) * B + ci] = acc[k];
  __syncthreads();
  for (int o = tid; o < NOUT * B; o += THREADS) {
    const int k = o / B;
    const int c = o % B;
    float v = red[(0 * NOUT + k) * B + c];
#pragma unroll
    for (int l = 1; l < LANES; ++l) v += red[(l * NOUT + k) * B + c];
    out[(long long)k * n_slots + (long long)b * B + c] = v;
  }
}

}  // namespace

extern "C" {

// Launches the forces kernel on `stream`.  prop: f32[(nG+1)*16, 16] with
// n_groups = nG (group nG is the pad group); flat_groups: i32[T_total*8];
// tile_off: i32[n_blocks+1]; cen_idx: i32[(n_blocks+1)*64], whose sentinel
// is cen_sentinel (the state's capacity, a pad row); out: f32[8, n_blocks*64].
// Returns cudaGetLastError() after the launch (0 on success).
int gpusph_forces_launch(const int* iparams, const float* fparams,
                         const float* prop, const int* flat_groups,
                         const int* tile_off, const int* cen_idx, float* out,
                         int n_blocks, int n_groups, int cen_sentinel,
                         void* stream) {
  ForcesParams p;
  int* pi = &p.kerneltype;
  for (int i = 0; i < N_INT_PARAMS; ++i) pi[i] = iparams[i];
  float* pf = &p.h;
  for (int i = 0; i < N_FLOAT_PARAMS; ++i) pf[i] = fparams[i];
  if (n_blocks > 0) {
    const bool lean = lean_options(p);
    auto kernel = p.periodic ? (lean ? forces_kernel<true, true> : forces_kernel<true, false>)
                             : (lean ? forces_kernel<false, true> : forces_kernel<false, false>);
    kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        p, reinterpret_cast<const float4*>(prop), flat_groups, tile_off,
        cen_idx, out, n_blocks * B, n_groups, cen_sentinel);
  }
  return static_cast<int>(cudaGetLastError());
}

int gpusph_forces_abi(int* n_int, int* n_float) {
  *n_int = N_INT_PARAMS;
  *n_float = N_FLOAT_PARAMS;
  return static_cast<int>(sizeof(ForcesParams));
}

const char* gpusph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
