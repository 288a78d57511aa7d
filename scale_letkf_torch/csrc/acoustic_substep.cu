// One acoustic substep of the split-explicit core for a batch of members:
// model/dycore_si.py acoustic_substeps' loop body — p'' = c²·ρθ'', the
// explicit horizontal momenta, the horizontal mass and θ flux divergence of
// the new momenta, the explicit ρ'' and ρθ'', the implicit vertical solve
// for ρw'' at the interior faces (Thomas algorithm) and the implicit
// corrections of ρ'' and ρθ'' — in one launch.
//
// Replaces no TPU kernel: scale_letkf_tpu/model/dycore_si.py's substeps are
// plain XLA (acoustic_substeps, and _thomas_solve as two lax.scans). Added
// because the plain PyTorch substep, ~40 full-field passes and 2·(nz−1)
// launches of the solve's levels, took 58% of the 100-m radar cycle
// (PERF.md §5).
//
// What bounds it: device memory. A substep reads the five deviations
// (ρ'', ρu'', ρv'', ρw'', ρθ''), the five slow tendencies, c² and θ of the
// stage, and writes the five new deviations: 17 float32 fields, 68 bytes a
// point (5.35 GB at 100 × 48 × 128 × 128, 1.60 ms at 3.35 TB/s), against
// ~150 flops and 5 divisions a point. The first substep of a stage reads
// the start and the stage state in place of the deviations (s_start −
// s_stage formed on the fly), the last reads the stage state again and
// writes the full state (s_stage + deviation), so a stage makes no pass of
// its own to form or apply the deviations. θ is read a second time on the
// way down (18 fields).
//
// Design: one thread a column (member b, row j, column i), 32 threads along
// x so each level's loads are whole 128-byte rows; the x and y neighbours
// come from L1 and L2. The thread marches up its column — the horizontal
// part, ρ'' and ρθ'' explicit, the right-hand side and the forward sweep at
// each interior face — with the next levels' loads in flight while the
// current level computes, then down: back substitution and the implicit
// corrections. What the way down needs (the explicit ρ'', ρθ'' and the
// sweep's c′, d′) waits in a per-thread stack in shared memory, 4·nz − 2
// floats, so only the final fields go back to device memory. The new
// momenta at i−1 and j−1, which the divergence needs, are recomputed by the
// thread from the old values there (the same expression, so the same
// number) rather than read back after a second pass; so neighbours read
// old values only, and the deviations ping-pong between two buffer sets
// (the wrapper's). The tridiagonal coefficients, θ at the z-faces and the
// face θ along x and y come from c², θ and the level tables (dzc, dzf and
// their products with dτ·β, computed by the wrapper as acoustic_coeffs
// computes them), never from full fields.
//
// Lateral modes as the plain path's rolls: periodic wraps x and y; open
// clamps them to the edge cell, and a derived field's value beyond the edge
// is its value at the edge cell (model/dycore.py, csrc/stencil.cuh), so the
// neighbour's momentum at i−1 is the one at the clamped index.
//
// Arithmetic: the plain PyTorch path's on the card, operation for operation
// and in its order — a Python-float scalar rounded to float32 as PyTorch
// rounds it, division by dx and dy as a product with the float32 reciprocal
// (PyTorch's CUDA division by a scalar), every other division IEEE. The
// library is built with -fmad=false (utils/kernels.py), so no product is
// fused into a sum: each operation rounds as PyTorch's separate passes do.
//
// C entry point (ctypes): acoustic_substep_launch(a_rho, a_rhou, a_rhov,
// a_rhow, a_rhot, s_rho, s_rhou, s_rhov, s_rhow, s_rhot, f_rho, f_rhou,
// f_rhov, f_rhow, f_rhot, c2, theta, dzc, dzf, abf, abc, ga, gd, o_rho,
// o_rhou, o_rhov, o_rhow, o_rhot, B, nz, ny, nx, dtau, dt1b, g_half, grav,
// inv_dx, inv_dy, open, first, last, stream). a_*: the old deviations, or
// with first ≠ 0 the start state; s_*: the stage state (read when first or
// last ≠ 0); f_*: the slow tendencies; o_*: the new deviations, or with
// last ≠ 0 the new state. Centered fields (B, nz, ny, nx), ρw (B, nz+1, ny,
// nx); c2 and theta (B, nz, ny, nx); dzc, abc, ga = g_half·abc (nz,); dzf,
// abf, gd = g_half·(abc[1:] − abc[:-1]) (nz−1,); float32, contiguous, on
// the device; no output may alias an input. dt1b = dτ·(1−β); inv_dx,
// inv_dy the float32 reciprocals of dx, dy. open ≠ 0: the lateral mode
// 'open', else periodic. Launches on `stream`, does not synchronise, and
// returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes it does not take (nz outside
// [2, NZ_MAX], or a grid it cannot hold).

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace {

using stencil::quot;

constexpr int TX = 32;             // threads along x: one warp a row
constexpr int TY = 2;              // rows of a CTA
constexpr int NT = TX * TY;
constexpr int NZ_MAX = 128;        // the stack of a CTA fits shared memory
constexpr int AHEAD = 2;           // levels loaded ahead on the way up
constexpr int CHUNK = 8;           // levels whose loads the way down hoists

enum { RHO, RU, RV, RW, RT, NF };
// in-plane points of the thread's stencil: itself, its x neighbours and the
// east neighbour of the west one, its y neighbours and the north neighbour
// of the south one (the last of each is the point itself but at an open
// edge)
enum { C, XP, XM, XMP, YP, YM, YMP, NP };

struct Args {
  const float* __restrict__ a[NF];
  const float* __restrict__ s[NF];
  const float* __restrict__ f[NF];
  const float* __restrict__ c2;
  const float* __restrict__ th;
  const float* __restrict__ dzc;
  const float* __restrict__ dzf;
  const float* __restrict__ abf;
  const float* __restrict__ abc;
  const float* __restrict__ ga;
  const float* __restrict__ gd;
  float* __restrict__ o[NF];
  int nz, ny, nx;
  float dtau, dt1b, g_half, grav, inv_dx, inv_dy;
};

template <bool OPEN>
__device__ __forceinline__ int nbr(int r, int n) {
  return OPEN ? stencil::clamp_idx(r, n) : stencil::wrap_mod(r, n);
}

// The CTA's member: each field's pointer moved to the member's first level
// (or face), so a load adds a 32-bit offset within the member to it.
struct Member {
  const float* a[NF];
  const float* s[NF];
  const float* f[NF];
  const float* c2;
  const float* th;
  __device__ __forceinline__ Member(const Args& p, int64_t cen, int64_t fac) {
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const int64_t o = q == RW ? fac : cen;
      a[q] = p.a[q] + o;
      s[q] = p.s[q] + o;
      f[q] = p.f[q] + o;
    }
    c2 = p.c2 + cen;
    th = p.th + cen;
  }
};

// One level's loads for the thread's column, issued AHEAD levels before
// their use. FIRST: the deviations are start − stage, both loaded; LAST: the
// stage's momenta are loaded for the new state.
template <bool FIRST, bool LAST>
struct Level {
  float rt[NP], rt_s[NP], c2[NP], th[NP];
  float u[2], u_s[2], su[2];  // ρu'' at the point and at its west neighbour
  float v[2], v_s[2], sv[2];  // ρv'' at the point and its south neighbour
  float r, r_s, sr, srt, srw;  // ρ'', slow ρ, ρθ at the point, ρw at face k
  float w, w_s;                // ρw'' at face k+1
  float th_up;                 // θ of the point at level k+1

  // level k at ko = k·plane (face k+1 at ko + plane)
  __device__ __forceinline__ void load(const Member& m, const int* off,
                                       int ko, int plane, bool up) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      rt[q] = __ldg(m.a[RT] + ko + off[q]);
      if (FIRST) rt_s[q] = __ldg(m.s[RT] + ko + off[q]);
      c2[q] = __ldg(m.c2 + ko + off[q]);
      th[q] = __ldg(m.th + ko + off[q]);
    }
    const int o2[2] = {off[C], off[XM]}, o3[2] = {off[C], off[YM]};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      u[q] = __ldg(m.a[RU] + ko + o2[q]);
      v[q] = __ldg(m.a[RV] + ko + o3[q]);
      if (FIRST || (LAST && q == 0)) {
        u_s[q] = __ldg(m.s[RU] + ko + o2[q]);
        v_s[q] = __ldg(m.s[RV] + ko + o3[q]);
      }
      su[q] = __ldg(m.f[RU] + ko + o2[q]);
      sv[q] = __ldg(m.f[RV] + ko + o3[q]);
    }
    const int c = ko + off[C];
    r = __ldg(m.a[RHO] + c);
    if (FIRST) r_s = __ldg(m.s[RHO] + c);
    sr = __ldg(m.f[RHO] + c);
    srt = __ldg(m.f[RT] + c);
    srw = __ldg(m.f[RW] + c);
    w = __ldg(m.a[RW] + c + plane);
    if (FIRST) w_s = __ldg(m.s[RW] + c + plane);
    th_up = up ? __ldg(m.th + c + plane) : 0.f;
  }
  // the old deviations
  __device__ __forceinline__ float drt(int q) const {
    return FIRST ? rt[q] - rt_s[q] : rt[q];
  }
  __device__ __forceinline__ float du(int q) const {
    return FIRST ? u[q] - u_s[q] : u[q];
  }
  __device__ __forceinline__ float dv(int q) const {
    return FIRST ? v[q] - v_s[q] : v[q];
  }
  __device__ __forceinline__ float dr() const { return FIRST ? r - r_s : r; }
  __device__ __forceinline__ float dw() const { return FIRST ? w - w_s : w; }
};

template <bool OPEN, bool FIRST, bool LAST>
__global__ void __launch_bounds__(NT) acoustic_substep_kernel(const Args p) {
  extern __shared__ float smem[];
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  // the stacks are the thread's own: no barrier, so idle threads may leave
  if (i >= p.nx || j >= p.ny) return;
  const int nz = p.nz, nx = p.nx, ny = p.ny;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // the stacks, level-major ([k·NT + tid]: a warp's accesses fill 32 banks)
  float* const cps = smem + tid;          // c′ at the faces 1..nz−1
  float* const dps = cps + (nz - 1) * NT;  // d′ at the faces 1..nz−1
  float* const rex = dps + (nz - 1) * NT;  // explicit ρ'' at the centers
  float* const tex = rex + nz * NT;        // explicit ρθ'' at the centers

  const int xp = nbr<OPEN>(i + 1, nx), xm = nbr<OPEN>(i - 1, nx);
  const int yp = nbr<OPEN>(j + 1, ny), ym = nbr<OPEN>(j - 1, ny);
  const int xmp = nbr<OPEN>(xm + 1, nx), ymp = nbr<OPEN>(ym + 1, ny);
  const int off[NP] = {j * nx + i,  j * nx + xp, j * nx + xm, j * nx + xmp,
                       yp * nx + i, ym * nx + i, ymp * nx + i};
  const int plane = ny * nx;  // the launch holds (nz + 1)·plane to 32 bits
  const int64_t cen0 = static_cast<int64_t>(blockIdx.z) * nz * plane;
  const int64_t fac0 = static_cast<int64_t>(blockIdx.z) * (nz + 1) * plane;
  const Member mem(p, cen0, fac0);
  const int own = off[C];
  const float dtau = p.dtau, dt1b = p.dt1b, g_half = p.g_half;
  const float rdx = p.inv_dx, rdy = p.inv_dy;

  float* const o_u = p.o[RU] + cen0 + own;
  float* const o_v = p.o[RV] + cen0 + own;

  // ---- up the column --------------------------------------------------
  // levels k+1 … k+AHEAD load while level k computes: a ring of AHEAD+1
  // levels in registers, its slots fixed by unrolling the loop by AHEAD+1
  Level<FIRST, LAST> ring[AHEAD + 1];
#pragma unroll
  for (int q = 0; q < AHEAD; ++q)
    if (q < nz)
      ring[q].load(mem, off, q * plane, plane, q + 1 < nz);
  // ρw'' and θ at face k (θ of the lowest center at face 0); level k−1's
  // values that face k needs, and the sweep's last c′, d′
  float w_k = FIRST ? __ldg(mem.a[RW] + own) - __ldg(mem.s[RW] + own)
                    : __ldg(mem.a[RW] + own);
  float tf_k = ring[0].th[C];
  float dp_m = 0.f, dr_m = 0.f, rex_m = 0.f, tex_m = 0.f, c2_m = 0.f,
        tf_m = 0.f, cp_m = 0.f, dq_m = 0.f;
  for (int k0 = 0; k0 < nz; k0 += AHEAD + 1) {
#pragma unroll
    for (int r = 0; r <= AHEAD; ++r) {
      const int k = k0 + r;
      if (k >= nz) break;
      if (k + AHEAD < nz) {
        const int kl = k + AHEAD;
        ring[(r + AHEAD) % (AHEAD + 1)].load(mem, off, kl * plane, plane,
                                             kl + 1 < nz);
      }
      const Level<FIRST, LAST>& cur = ring[r];

      // pressure at the stencil's points, the new momenta at the point and
      // at its west / south neighbour, their flux divergences
      float dp[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) dp[q] = cur.c2[q] * cur.drt(q);
      const float un =
          cur.du(0) + dtau * (-((dp[XP] - dp[C]) * rdx) + cur.su[0]);
      const float un_m =
          cur.du(1) + dtau * (-((dp[XMP] - dp[XM]) * rdx) + cur.su[1]);
      const float vn =
          cur.dv(0) + dtau * (-((dp[YP] - dp[C]) * rdy) + cur.sv[0]);
      const float vn_m =
          cur.dv(1) + dtau * (-((dp[YMP] - dp[YM]) * rdy) + cur.sv[1]);
      const float div_h = (un - un_m) * rdx + (vn - vn_m) * rdy;
      const float uth = un * (0.5f * (cur.th[C] + cur.th[XP]));
      const float uth_m = un_m * (0.5f * (cur.th[XM] + cur.th[XMP]));
      const float vth = vn * (0.5f * (cur.th[C] + cur.th[YP]));
      const float vth_m = vn_m * (0.5f * (cur.th[YM] + cur.th[YMP]));
      const float div_th = (uth - uth_m) * rdx + (vth - vth_m) * rdy;
      o_u[k * plane] = LAST ? cur.u_s[0] + un : un;
      o_v[k * plane] = LAST ? cur.v_s[0] + vn : vn;

      // explicit ρ'' and ρθ'' with the (1−β) old vertical flux
      const float w_k1 = cur.dw();
      const float tf_k1 =
          k + 1 < nz ? 0.5f * (cur.th_up + cur.th[C]) : cur.th[C];
      const float dzc_k = __ldg(p.dzc + k);
      const float dflux_w = quot(w_k1 - w_k, dzc_k);
      const float dflux_wth = quot(w_k1 * tf_k1 - w_k * tf_k, dzc_k);
      const float dr_k = cur.dr(), c2_k = cur.c2[C];
      const float rex_k = dr_k + dtau * (cur.sr - div_h) - dt1b * dflux_w;
      const float tex_k =
          cur.drt(C) + dtau * (cur.srt - div_th) - dt1b * dflux_wth;
      rex[k * NT] = rex_k;
      tex[k * NT] = tex_k;

      if (k >= 1) {
        // face k: the right-hand side, the tridiagonal row, the sweep
        const int m = k - 1;
        const float abf = __ldg(p.abf + m);
        const float abc_up = __ldg(p.abc + k), abc_dn = __ldg(p.abc + m);
        const float dp_z = quot(dp[C] - dp_m, __ldg(p.dzf + m));
        const float rho_face_old = 0.5f * (dr_k + dr_m);
        const float d = w_k + dtau * cur.srw
                        - dt1b * (dp_z + p.grav * rho_face_old)
                        - abf * (c2_k * tex_k - c2_m * tex_m)
                        - g_half * (rex_k + rex_m);
        const float b = 1.0f + abf * tf_k * (c2_k * abc_up + c2_m * abc_dn)
                        + __ldg(p.gd + m);
        const float c = -abf * c2_k * abc_up * tf_k1 - __ldg(p.ga + k);
        const float a = -abf * c2_m * abc_dn * tf_m + __ldg(p.ga + m);
        const float denom = b - a * cp_m;
        cp_m = quot(c, denom);
        dq_m = quot(d - a * dq_m, denom);
        cps[m * NT] = cp_m;
        dps[m * NT] = dq_m;
      }
      dp_m = dp[C];
      dr_m = dr_k;
      rex_m = rex_k;
      tex_m = tex_k;
      c2_m = c2_k;
      tf_m = tf_k;
      tf_k = tf_k1;
      w_k = w_k1;
    }
  }

  // ---- down the column ------------------------------------------------
  // back substitution from the top interior face (x above it 0) and the
  // corrections at center k from ρw'' at faces k and k+1 (0 at the rigid
  // faces). θ at the faces comes again from θ, and the stage state of the
  // new state's points with it, CHUNK levels' loads at a time.
  float* const o_r = p.o[RHO] + cen0 + own;
  float* const o_t = p.o[RT] + cen0 + own;
  float* const o_w = p.o[RW] + fac0 + own;
  const float* const th = mem.th + own;
  float x = 0.f, wn_up = 0.f;
  float th_k = __ldg(th + (nz - 1) * plane);
  float tf_up = th_k;  // θ at face nz: the top center's
  for (int k0 = nz - 1; k0 >= 0; k0 -= CHUNK) {
    float th_dn[CHUNK], sr[CHUNK], st[CHUNK], sw[CHUNK];
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int k = k0 - q;
      th_dn[q] = k >= 1 ? __ldg(th + (k - 1) * plane) : 0.f;
      if (LAST && k >= 0) {
        sr[q] = __ldg(mem.s[RHO] + own + k * plane);
        st[q] = __ldg(mem.s[RT] + own + k * plane);
        sw[q] = __ldg(mem.s[RW] + own + (k + 1) * plane);
      }
    }
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int k = k0 - q;
      if (k < 0) break;
      float wn = 0.f;
      if (k >= 1) {
        wn = dps[(k - 1) * NT] - cps[(k - 1) * NT] * x;
        x = wn;
      }
      const float tf_k = k >= 1 ? 0.5f * (th_k + th_dn[q]) : th_k;
      const float abc = __ldg(p.abc + k);
      const float dr = rex[k * NT] - abc * (wn_up - wn);
      const float dt = tex[k * NT] - abc * (wn_up * tf_up - wn * tf_k);
      o_r[k * plane] = LAST ? sr[q] + dr : dr;
      o_t[k * plane] = LAST ? st[q] + dt : dt;
      o_w[(k + 1) * plane] = LAST ? sw[q] + wn_up : wn_up;
      wn_up = wn;
      tf_up = tf_k;
      th_k = th_dn[q];
    }
  }
  o_w[0] = LAST ? __ldg(mem.s[RW] + own) + 0.f : 0.f;
}

}  // namespace

extern "C" int acoustic_substep_launch(
    const void* a_rho, const void* a_rhou, const void* a_rhov,
    const void* a_rhow, const void* a_rhot, const void* s_rho,
    const void* s_rhou, const void* s_rhov, const void* s_rhow,
    const void* s_rhot, const void* f_rho, const void* f_rhou,
    const void* f_rhov, const void* f_rhow, const void* f_rhot,
    const void* c2, const void* theta, const void* dzc, const void* dzf,
    const void* abf, const void* abc, const void* ga, const void* gd,
    void* o_rho, void* o_rhou, void* o_rhov, void* o_rhow, void* o_rhot,
    int64_t B, int64_t nz, int64_t ny, int64_t nx, float dtau, float dt1b,
    float g_half, float grav, float inv_dx, float inv_dy, int open,
    int first, int last, void* stream) {
  if (B < 1 || B > 65535 || nz < 2 || nz > NZ_MAX || ny < 1 || nx < 1 ||
      (ny + TY - 1) / TY > 65535 || (nz + 1) * ny * nx > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  using K = void (*)(const Args);
  // [open][first][last]
  static const K kernels[2][2][2] = {
      {{acoustic_substep_kernel<false, false, false>,
        acoustic_substep_kernel<false, false, true>},
       {acoustic_substep_kernel<false, true, false>,
        acoustic_substep_kernel<false, true, true>}},
      {{acoustic_substep_kernel<true, false, false>,
        acoustic_substep_kernel<true, false, true>},
       {acoustic_substep_kernel<true, true, false>,
        acoustic_substep_kernel<true, true, true>}}};
  const K kernel = kernels[open != 0][first != 0][last != 0];
  const int smem = static_cast<int>((4 * nz - 2) * NT * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto g = [](void* q) { return static_cast<float*>(q); };
  Args a{{f(a_rho), f(a_rhou), f(a_rhov), f(a_rhow), f(a_rhot)},
         {f(s_rho), f(s_rhou), f(s_rhov), f(s_rhow), f(s_rhot)},
         {f(f_rho), f(f_rhou), f(f_rhov), f(f_rhow), f(f_rhot)},
         f(c2), f(theta), f(dzc), f(dzf), f(abf), f(abc), f(ga), f(gd),
         {g(o_rho), g(o_rhou), g(o_rhov), g(o_rhow), g(o_rhot)},
         static_cast<int>(nz), static_cast<int>(ny), static_cast<int>(nx),
         dtau, dt1b, g_half, grav, inv_dx, inv_dy};
  const dim3 grid(static_cast<unsigned>((nx + TX - 1) / TX),
                  static_cast<unsigned>((ny + TY - 1) / TY),
                  static_cast<unsigned>(B));
  kernel<<<grid, dim3(TX, TY), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
