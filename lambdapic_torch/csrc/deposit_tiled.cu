// Kernel B9: the charge-conserving (Esirkepov) deposit of a tile-binned 2D
// species (ntx, nty, cap_t) into per-tile current windows (4, ntx, nty,
// wx, wy) = (jx, jy, jz, rho).
//
// Replaces the TPU kernel lambdapic_tpu/ops/tiled2d_pallas.py::
// deposit_tiled_pallas (:282, kernel _deposit_kernel :219, pallas_call
// :301), velocity terms included (its wrapper computes them, :293-295).
// Plain PyTorch version: lambdapic_torch/ops/tiled2d.py::deposit_tiled;
// fold_windows (plain torch, as it is XLA in JAX) overlap-adds the
// windows into the padded current.
//
// The TPU kernel builds dense (w, cap) tap panels and contracts them in
// one matrix product a tile. Here one block takes one tile and keeps its
// four (wx, wy) windows in shared memory; each thread walks slots of the
// tile and adds each particle's nonzero stencil: S0 and S1 (the shapes at
// xw -/+ vx dt/2) are nonzero on the five nodes c0 .. c0+4 with c0 =
// min(floor(x0), floor(x1)) - 1 (|vx dt/dx| < 1), so
//   jx[cx, cy] += Fx[cx] b[cy],  Fx = -q w/(dy dt) cumsum(DSx) over the
//                                stencil, cx = c0 .. c0+3
//   jy[cx, cy] += a[cx] Gy[cy],  cy = c0y .. c0y+3
//   jz[cx, cy] += (a cvz)[cx] b[cy] + (DSx cvz/12)[cx] DSy[cy]
//   rho[cx, cy] += (S1x cd)[cx] S1y[cy]
// with DS = S1 - S0, a = S0x + DSx/2, b = S0y + DSy/2, cd = q w/(dx dy),
// cvz = cd vz. The dense form's cumsum beyond the stencil is a rounding
// residue of the telescoping sum (about eps |DS|), spread over the rest
// of the window; here those nodes get exact zeros. A node outside [0, w)
// is dropped, as the dense form has none. Slots with w = 0 (dead) add
// nothing and are skipped.
//
// The adds are shared-memory atomics (native for float and double on
// sm_90): the order of a node's sum changes from run to run, so B9's
// rounding is not deterministic. The windows are then written once.
//
// Bound on an H100 (3.35 TB/s): bytes: seven reals read a slot and the
// four windows written once.
#include "common.cuh"

namespace {

enum Ptr { P_X, P_Y, P_UX, P_UY, P_UZ, P_IG, P_W, P_OUT, P_COUNT };
enum Int { I_NTX, I_NTY, I_CAP, I_TX, I_TY, I_H, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY,           // c dt / dx, c dt / dy
            R_C,                    // c
            R_KCD, R_KFX, R_KFY };  // q / (dx dy), q / (dy dt), q / (dx dt)

constexpr int THREADS = 256;
constexpr int S = 5;                // stencil nodes an axis

template <typename T>
struct Args {
  const T *x, *y, *ux, *uy, *uz, *ig, *w;
  T* out;                           // (4, ntx, nty, wx, wy)
  int ntx, nty, cap, tx, ty, h, wx, wy;
  T cdx, cdy, c, kcd, kfx, kfy;
};

// S0, S1 and DS of one axis on the five nodes from c0
template <typename T>
__device__ __forceinline__ int shapes(T xw, T v, T* s0, T* s1, T* ds) {
  T x0 = xw - T(0.5) * v, x1 = xw + T(0.5) * v;
  T f = fmin(floor(x0), floor(x1));
  f = fmin(fmax(f, T(-16)), T(1 << 20));
  int c0 = (int)f - 1;
  for (int k = 0; k < S; ++k) {
    T c = T(c0 + k);
    s0[k] = m2(c - x0);
    s1[k] = m2(c - x1);
    ds[k] = s1[k] - s0[k];
  }
  return c0;
}

template <typename T>
__device__ __forceinline__ void add(T* acc, int wx, int wy, int cx, int cy,
                                    T v) {
  if (v != T(0) && cx >= 0 && cx < wx && cy >= 0 && cy < wy)
    atomicAdd(acc + cx * wy + cy, v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) deposit(Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);            // (4, wx, wy)
  const int tile = blockIdx.x;
  const int ti = tile / a.nty, tj = tile % a.nty;
  const int nw = a.wx * a.wy;
  for (int k = threadIdx.x; k < 4 * nw; k += blockDim.x) acc[k] = T(0);
  __syncthreads();
  const T ox = T(ti * a.tx), oy = T(tj * a.ty);
  const long long base = (long long)tile * a.cap;
  for (int s = threadIdx.x; s < a.cap; s += blockDim.x) {
    const long long i = base + s;
    const T w = a.w[i];
    if (w == T(0)) continue;
    const T ig = a.ig[i];
    const T vxc = (a.ux[i] * ig) * a.cdx;
    const T vyc = (a.uy[i] * ig) * a.cdy;
    const T vz = (a.uz[i] * ig) * a.c;
    const T xw = (a.x[i] - ox) + T(a.h);
    const T yw = (a.y[i] - oy) + T(a.h);
    T s0x[S], s1x[S], dsx[S], s0y[S], s1y[S], dsy[S];
    const int cx0 = shapes(xw, vxc, s0x, s1x, dsx);
    const int cy0 = shapes(yw, vyc, s0y, s1y, dsy);
    const T cd = a.kcd * w;
    const T fdx = a.kfx * w, fdy = a.kfy * w;
    const T cvz = cd * vz;
    const T cvz12 = cvz / T(12);
    T ax[S], by[S], fx[S], gy[S];
    T runx = T(0), runy = T(0);
    for (int k = 0; k < S; ++k) {
      ax[k] = s0x[k] + T(0.5) * dsx[k];
      by[k] = s0y[k] + T(0.5) * dsy[k];
      runx += dsx[k];
      runy += dsy[k];
      fx[k] = -fdx * runx;
      gy[k] = -fdy * runy;
    }
    T* jx = acc;
    T* jy = acc + nw;
    T* jz = acc + 2 * nw;
    T* rho = acc + 3 * nw;
    for (int p = 0; p < S; ++p) {
      const int cx = cx0 + p;
      const T az = ax[p] * cvz, dz = dsx[p] * cvz12, rx = s1x[p] * cd;
      for (int q = 0; q < S; ++q) {
        const int cy = cy0 + q;
        if (p < S - 1) add(jx, a.wx, a.wy, cx, cy, fx[p] * by[q]);
        if (q < S - 1) add(jy, a.wx, a.wy, cx, cy, ax[p] * gy[q]);
        add(jz, a.wx, a.wy, cx, cy, az * by[q] + dz * dsy[q]);
        add(rho, a.wx, a.wy, cx, cy, rx * s1y[q]);
      }
    }
  }
  __syncthreads();
  T* out = a.out;
  const long long ntile = (long long)a.ntx * a.nty;
  for (int k = threadIdx.x; k < 4 * nw; k += blockDim.x) {
    int ch = k / nw, r = k % nw;
    out[((long long)ch * ntile + tile) * nw + r] = acc[k];
  }
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY];
  a.uz = (const T*)p[P_UZ]; a.ig = (const T*)p[P_IG];
  a.w = (const T*)p[P_W];
  a.out = (T*)p[P_OUT];
  a.ntx = (int)n[I_NTX]; a.nty = (int)n[I_NTY]; a.cap = (int)n[I_CAP];
  a.tx = (int)n[I_TX]; a.ty = (int)n[I_TY]; a.h = (int)n[I_H];
  a.wx = a.tx + 2 * a.h; a.wy = a.ty + 2 * a.h;
  a.cdx = (T)r[R_CDX]; a.cdy = (T)r[R_CDY]; a.c = (T)r[R_C];
  a.kcd = (T)r[R_KCD]; a.kfx = (T)r[R_KFX]; a.kfy = (T)r[R_KFY];
  size_t smem = sizeof(T) * 4 * a.wx * a.wy;
  int err = (int)cudaFuncSetAttribute(
      deposit<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  deposit<T><<<a.ntx * a.nty, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_deposit_tiled(void** ptrs, const long long* ints,
                               const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
