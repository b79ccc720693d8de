// Kernel B8: the staggered quadratic gather of the six E/B components at
// every slot of a tile-binned 2D species (ntx, nty, cap_t).
//
// Replaces the TPU kernel lambdapic_tpu/ops/tiled2d_pallas.py::
// gather_tiled_pallas (:193, kernel _gather_kernel :153, pallas_call
// :203). Plain PyTorch version: lambdapic_torch/ops/tiled2d.py::
// extract_windows + gather_tiled (dense tap matrices over each tile's
// window).
//
// The TPU kernel evaluates all w taps of a window axis densely and
// contracts them on the matrix unit. Here each block takes one tile and a
// chunk of its slots: it loads the tile's six (wx, wy) windows straight
// from the padded stack eb_pad (6, nx+2h, ny+2h) into shared memory (the
// window cut fuses into the load), then each thread evaluates, per slot,
// only the taps that can be nonzero: with j = floor(xw), the integer taps
// M2(c - xw) at c = j-1 .. j+2 and the half taps M2(c + 0.5 - xw) at
// c = j-1 .. j+1 (every other tap of the dense form is exactly 0). A
// tap outside [0, w) is dropped, as the dense form has no node there.
// Dead slots (x = y = 0) lie outside every window but tile (0, 0)'s and
// gather exactly 0.
//
// Sums: per x tap, the y-tap sum of the window row, then the x-tap sum,
// as the dense form contracts y first; zero taps are left out, so the
// result equals the plain version's up to the order of its matrix
// product's sums.
//
// Bound on an H100 (3.35 TB/s): bytes: eb_pad read once, x and y read and
// six components written a slot.
#include "common.cuh"

namespace {

enum Ptr { P_EB, P_X, P_Y, P_OUT, P_COUNT = P_OUT + 6 };
enum Int { I_NTX, I_NTY, I_CAP, I_TX, I_TY, I_H, I_CHUNK, I_DOUBLE };

constexpr int THREADS = 256;

template <typename T>
struct Args {
  const T* eb;             // (6, nxp, nyp)
  const T *x, *y;          // (ntx, nty, cap)
  T* out[6];               // (ntx, nty, cap) each
  int ntx, nty, cap, tx, ty, h, chunk;
  int wx, wy, nxp, nyp;
};

// taps of one axis: integer taps at c0 .. c0+3, half taps at c0 .. c0+2
template <typename T>
struct Taps {
  int c0;
  T g[4], hf[3];
};

template <typename T>
__device__ __forceinline__ Taps<T> taps(T xw, int w) {
  Taps<T> t;
  // clamp before the int conversion: a position far outside the window
  // gives no tap in range either way
  T j = floor(xw);
  j = fmin(fmax(j, T(-8)), T(w + 8));
  t.c0 = (int)j - 1;
  for (int k = 0; k < 4; ++k) {
    int c = t.c0 + k;
    t.g[k] = (c >= 0 && c < w) ? m2(T(c) - xw) : T(0);
  }
  for (int k = 0; k < 3; ++k) {
    int c = t.c0 + k;
    t.hf[k] = (c >= 0 && c < w) ? m2((T(c) + T(0.5)) - xw) : T(0);
  }
  return t;
}

// sum_x Wx[x] sum_y F[x, y] Wy[y] over the candidate taps in range
template <typename T, int NX, int NY>
__device__ __forceinline__ T interp(const T* F, int wx, int wy, int cx0,
                                    const T* wxs, int cy0, const T* wys) {
  T acc = T(0);
  for (int a = 0; a < NX; ++a) {
    int cx = cx0 + a;
    if (cx < 0 || cx >= wx) continue;
    T row = T(0);
    for (int b = 0; b < NY; ++b) {
      int cy = cy0 + b;
      if (cy < 0 || cy >= wy) continue;
      row += F[cx * wy + cy] * wys[b];
    }
    acc += wxs[a] * row;
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gather(Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);            // (6, wx, wy)
  const int tile = blockIdx.x;
  const int ti = tile / a.nty, tj = tile % a.nty;
  const int nw = a.wx * a.wy;
  for (int k = threadIdx.x; k < 6 * nw; k += blockDim.x) {
    int comp = k / nw, r = k % nw;
    int u = r / a.wy, v = r % a.wy;
    win[k] = a.eb[((long long)comp * a.nxp + ti * a.tx + u) * a.nyp +
                  tj * a.ty + v];
  }
  __syncthreads();
  const T ox = T(ti * a.tx), oy = T(tj * a.ty);
  const long long base = (long long)tile * a.cap;
  const int s_end = min(a.cap, (blockIdx.y + 1) * a.chunk);
  for (int s = blockIdx.y * a.chunk + threadIdx.x; s < s_end;
       s += blockDim.x) {
    // window coordinates, as _tile_coords: x - origin + h
    T xw = (a.x[base + s] - ox) + T(a.h);
    T yw = (a.y[base + s] - oy) + T(a.h);
    Taps<T> tx = taps(xw, a.wx), ty = taps(yw, a.wy);
    const T* F = win;
    // ex (half x, integer y), ey (integer x, half y), ez (integer both),
    // bx (integer x, half y), by (half x, integer y), bz (half both)
    T ex = interp<T, 3, 4>(F, a.wx, a.wy, tx.c0, tx.hf, ty.c0, ty.g);
    T ey = interp<T, 4, 3>(F + nw, a.wx, a.wy, tx.c0, tx.g, ty.c0, ty.hf);
    T ez = interp<T, 4, 4>(F + 2 * nw, a.wx, a.wy, tx.c0, tx.g, ty.c0, ty.g);
    T bx = interp<T, 4, 3>(F + 3 * nw, a.wx, a.wy, tx.c0, tx.g, ty.c0, ty.hf);
    T by = interp<T, 3, 4>(F + 4 * nw, a.wx, a.wy, tx.c0, tx.hf, ty.c0, ty.g);
    T bz = interp<T, 3, 3>(F + 5 * nw, a.wx, a.wy, tx.c0, tx.hf, ty.c0, ty.hf);
    a.out[0][base + s] = ex;
    a.out[1][base + s] = ey;
    a.out[2][base + s] = ez;
    a.out[3][base + s] = bx;
    a.out[4][base + s] = by;
    a.out[5][base + s] = bz;
  }
}

template <typename T>
int launch(void** p, const long long* n, cudaStream_t st) {
  Args<T> a;
  a.eb = (const T*)p[P_EB];
  a.x = (const T*)p[P_X];
  a.y = (const T*)p[P_Y];
  for (int k = 0; k < 6; ++k) a.out[k] = (T*)p[P_OUT + k];
  a.ntx = (int)n[I_NTX]; a.nty = (int)n[I_NTY]; a.cap = (int)n[I_CAP];
  a.tx = (int)n[I_TX]; a.ty = (int)n[I_TY]; a.h = (int)n[I_H];
  a.chunk = (int)n[I_CHUNK];
  a.wx = a.tx + 2 * a.h; a.wy = a.ty + 2 * a.h;
  a.nxp = a.ntx * a.tx + 2 * a.h; a.nyp = a.nty * a.ty + 2 * a.h;
  if (a.chunk <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(T) * 6 * a.wx * a.wy;
  int err = (int)cudaFuncSetAttribute(
      gather<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  dim3 grid(a.ntx * a.nty, ceil_div(a.cap, a.chunk));
  gather<T><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int (see above); reals: none.
LP_EXPORT int lp_gather_tiled(void** ptrs, const long long* ints,
                              const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, st);
  return launch<float>(ptrs, ints, st);
}
