// SPH forces kernel for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces gpusph_tpu/ops/forces_pallas.py:_forces_kernel (l. 855) and its
// body _pair_chunk (l. 643), the Pallas TPU kernel launched by
// compute_forces_pallas at forces_pallas.py:916.  It computes the SPH
// right-hand side of every central particle over its rebuild-time neighbor
// groups (the block plan of gpusph_tpu_torch/ops/block_plan.py) and
// reduces it per particle: DrDt, DvDt xyz, XSPH xyz, DEDt.
//
// What bounds it on an H100: the arithmetic.  Every candidate pair costs
// some 100+ f32 operations on the CUDA cores (offset, mask, kernel gradient,
// continuity, pressure gradient, artificial viscosity, density diffusion,
// moving-body feedback), and one pass of DamBreak3D at dp 0.012 covers
// about 1.9e8 candidate pairs, while it reads only the ~8 MB property table
// (129k rows of 64 B) and writes 8 floats per particle.  So it is bound by
// operations, not bytes.  Tensor cores (wgmma) and TMA do not fit the pair
// math, which is a masked elementwise chain, not a matrix product.
//
// Design (simple and right first):
//  * one CUDA block per central block b of the plan (n_blocks blocks, not
//    one per flat tile).  Blocks run in any order on Hopper, so instead of
//    the TPU's accumulation across consecutive grid steps, each block loops
//    over its own tiles [tile_off[b], tile_off[b+1]).  No atomics; the
//    summation order is fixed, so a pass is deterministic;
//  * the block's 64 central rows (16 f32 each, 4 KB) are loaded into shared
//    memory once, then into registers;
//  * per tile, the 8 window groups are loaded straight from the padded
//    property table by group id (8 x 16 rows x 64 B = 8 KB), as coalesced
//    16-byte loads.  Group id nG is the pad sentinel at PAD_POS;
//  * 256 threads = 64 centrals x 4 slot lanes.  Each thread keeps its 8 sums
//    in registers over the slots it owns; the 4 lanes are reduced in a fixed
//    order at the end.  Pairs outside 0 < r^2 < rad^2 are skipped;
//  * every output slot is written, including blocks that no tile visits,
//    which get zeros;
//  * the model options are run-time values in a POD struct, so one build
//    serves every configuration of kernel_supported.  All threads of a
//    launch take the same branches.
//
// What later work will do about the bound: cp.async double-buffering of the
// window groups, skipping culled slots inside partly filled tiles, and
// occupancy and register tuning guided by -Xptxas -v.

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

__global__ void __launch_bounds__(THREADS)
forces_kernel(const ForcesParams p, const float4* __restrict__ prop,
              const int* __restrict__ flat_groups,
              const int* __restrict__ tile_off,
              const int* __restrict__ cen_idx, float* __restrict__ out,
              int n_slots) {
  __shared__ float4 s_cen[B * NCOLS / 4];
  __shared__ float4 s_win[TS * NCOLS / 4];  // reused for the lane reduction

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ci = tid % B;     // central of this thread
  const int lane = tid / B;   // slot lane: owns slots lane, lane+4, ...

  // centrals: row cen_idx[b*B + i] of the table (sentinel = pad row)
  for (int q = tid; q < B * NCOLS / 4; q += THREADS) {
    const int row = q / (NCOLS / 4);
    const int c4 = q % (NCOLS / 4);
    const long long src = (long long)cen_idx[b * B + row] * (NCOLS / 4) + c4;
    s_cen[q] = prop[src];
  }
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

  const int t0 = tile_off[b];
  const int t1 = tile_off[b + 1];
  const float* win = reinterpret_cast<const float*>(s_win);

  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // previous tile fully consumed
    // 8 groups x 16 rows x 4 float4: 512 coalesced 16-byte loads
    for (int q = tid; q < TS * NCOLS / 4; q += THREADS) {
      const int j = q / (GROUP * NCOLS / 4);
      const int within = q % (GROUP * NCOLS / 4);
      const long long g = flat_groups[(long long)t * GPT + j];
      s_win[q] = prop[g * (GROUP * NCOLS / 4) + within];
    }
    __syncthreads();

    for (int s = lane; s < TS; s += LANES) {
      const float* w = win + s * NCOLS;
      const float relx = min_image(cx - w[C_POSX], p.periodic & 1, p.Lx, p.invLx);
      const float rely = min_image(cy - w[C_POSY], p.periodic & 2, p.Ly, p.invLy);
      const float relz = min_image(cz - w[C_POSZ], p.periodic & 4, p.Lz, p.invLz);
      const float r2 = relx * relx + rely * rely + relz * relz;
      // self-pairs fail r2 > 0; pad slots sit at PAD_POS and fail r2 < rad2
      if (!(r2 < p.rad2 && r2 > 0.0f)) continue;
      const float r = sqrtf(r2);
      const float fK = kern_F(p, r);

      const float relvx = cvx - w[C_VELX];
      const float relvy = cvy - w[C_VELY];
      const float relvz = cvz - w[C_VELZ];
      const float vdp = relvx * relx + relvy * rely + relvz * relz;

      const float n_fluid = w[C_FLUID], n_bound = w[C_BOUND];
      const float m_n = w[C_MASS], rho_n = w[C_RHO];
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
          const float press_n = w[C_PRESS];
          const float gate =
              fabsf(press_c - press_n) >= fabsf(g_dot_rel * rho_c) ? 1.0f : 0.0f;
          drdt -= ff * gate * p.colagrossi_coeff * p.c0 *
                  (rho_n / rho_c - 1.0f) * mfK;
        } else {  // Ferrari
          const float grav_corr = -g_dot_rel * p.rho0 / p.sq_c0;
          const float max_ss = fmaxf(ss_c, w[C_SSPEED]);
          const float safe = r2 > p.ferrari_safe2 ? 1.0f : 0.0f;
          drdt += ff * safe * p.ferrari_coeff * max_ss *
                  (rho_c - rho_n + grav_corr) / rho_c * r * mfK;
        }
      }

      // momentum: pressure gradient
      float mom = p.dyn ? c_fluid * n_any : ff;
      if (p.moving_bodies) mom += c_bound * n_fluid;  // body force feedback
      const float pgrad = p.sph_f2 ? (press_c + w[C_PRESS]) / (rho_c * rho_n)
                                   : ppre_c + w[C_PPRE];
      float s_fac = -mom * pgrad * mfK;

      if (p.artvisc && vdp < 0.0f) {
        const float art = vdp * p.artvisc_h * (ss_c + w[C_SSPEED]) /
                          ((r2 + p.eps_art) * (rho_c + rho_n));
        s_fac += mom * art * mfK;
      }

      float sv = 0.0f;
      if (p.visc != 0) {
        const float mu_avg = avg_op(p.avgop, dvisc_c, w[C_DVISC]);
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

  // reduce the 4 slot lanes in a fixed order; write every output slot
  __syncthreads();
  float* red = reinterpret_cast<float*>(s_win);  // [LANES][NOUT][B]
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

// Launches the forces kernel on `stream`.  prop: f32[(nG+1)*16, 16];
// flat_groups: i32[T_total*8]; tile_off: i32[n_blocks+1];
// cen_idx: i32[(n_blocks+1)*64]; out: f32[8, n_blocks*64].
// Returns cudaGetLastError() after the launch (0 on success).
int gpusph_forces_launch(const int* iparams, const float* fparams,
                         const float* prop, const int* flat_groups,
                         const int* tile_off, const int* cen_idx, float* out,
                         int n_blocks, void* stream) {
  ForcesParams p;
  int* pi = &p.kerneltype;
  for (int i = 0; i < N_INT_PARAMS; ++i) pi[i] = iparams[i];
  float* pf = &p.h;
  for (int i = 0; i < N_FLOAT_PARAMS; ++i) pf[i] = fparams[i];
  if (n_blocks > 0) {
    forces_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        p, reinterpret_cast<const float4*>(prop), flat_groups, tile_off,
        cen_idx, out, n_blocks * B);
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
