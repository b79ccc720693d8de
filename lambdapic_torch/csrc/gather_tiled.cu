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
// contracts them on the matrix unit. Here each thread evaluates, per slot
// and axis, only the taps that can be nonzero, from one floor j =
// floor(xw): the integer taps M2(c - xw) at the three nodes around the
// nearest one, r = j + (xw - j >= 1/2), and the half taps M2(c + 1/2 -
// xw) at c = j-1 .. j+1 (every other tap of the dense form is exactly 0):
// 3 x 3 taps a component. A tap outside [0, w) is 0 (the dense form has
// no node there) and reads a clamped node. Dead slots (x = y = 0) lie
// outside every window but tile (0, 0)'s, gather exactly 0 there and read
// no window; tile (0, 0)'s gather its field at (0, 0), as the dense form
// does.
//
// Design. One 256-thread block takes one tile and walks all its slots,
// one a thread a round, the next round's positions loaded ahead; five
// float blocks an SM hold bench.py's 576 tiles in one wave. The tile's
// six (wx, wy) windows go into shared memory once, by cp.async of
// eb_pad's rows (a warp a row; the window cut fuses into the load), at
// the first round that holds a slot whose taps reach the window
// (__syncthreads_or): a tile whose slots all lie outside its window (an
// empty tile) loads nothing and writes zeros. The windows that share
// their tap pattern are interleaved, (ex, by) and (ey, bx) as pairs, so
// a tap reads both in one 8-byte (float) or 16-byte (double) load: 36
// shared loads a slot where the parent's four integer taps an axis, each
// component apart, took 73. Every output is written once, a warp's 32
// slots in one coalesced store a component.
//
// Sums: per x tap, the y-tap sum of the window row, then the x-tap sum,
// as the dense form contracts y first; zero taps add exact zeros, so the
// result equals the plain version's up to the order of its matrix
// product's sums.
//
// Bound on an H100 (3.35 TB/s): bytes: eb_pad read once, x and y read and
// six components written a slot (the writes are three quarters of it).
// What holds it (kernel_ab.py tiled, PERF.md): the taps and sums of every
// warp that holds a slot in its window, beside the writes (a zero fill of
// the six outputs takes 45% of the kernel's time on the fill's order);
// the window load is 5% (ablation noload). Listing a warp's in-window
// slots by ballot, so that mixed warps gather densely, scattered the
// writes and was 10-25% slower. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py's [time B8], bench.py's --tiling 32,32 end state): 0.1876
// ms a launch against a 0.0945 ms bound (0.3578 before this design);
// kernel_ab.py tiled: 0.19-0.20 ms on the fill's order, 0.25 shuffled,
// 0.30 on tiled_state's random state.
#include "common.cuh"

namespace {

enum Ptr { P_EB, P_X, P_Y, P_OUT, P_COUNT = P_OUT + 6 };
enum Int { I_NTX, I_NTY, I_CAP, I_TX, I_TY, I_H, I_DOUBLE };

constexpr int THREADS = 256;
// blocks an SM: five float blocks (42 KB of windows each at bench's 32 x
// 32 tiles, 48 registers a thread) hold bench's 576 tiles in one wave of
// the 132 SMs
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 5 : 2; }

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

template <typename T>
struct Args {
  const T* eb;             // (6, nxp, nyp)
  const T *x, *y;          // (ntx, nty, cap)
  T* out[6];               // (ntx, nty, cap) each
  int ntx, nty, cap, tx, ty, h;
  int wx, wy, nxp, nyp;
};

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N));
}

// The tile's six windows from eb_pad into shared memory: pairs (ex, by)
// and (ey, bx), then ez and bz. A warp a window row, its lanes along y.
template <typename T>
__device__ void load_windows(const Args<T>& a, int ti, int tj, T* win) {
  const int nw = a.wx * a.wy;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < 6 * a.wx; row += THREADS / 32) {
    const int comp = row / a.wx, u = row % a.wx;
    const T* src = a.eb + ((long long)comp * a.nxp + ti * a.tx + u) * a.nyp +
                   tj * a.ty;
    // (ex, by) pairs at win, (ey, bx) pairs at win + 2 nw, ez at win +
    // 4 nw, bz at win + 5 nw
    const bool pair = comp != 2 && comp != 5;
    const int stride = pair ? 2 : 1;
    const int at = comp == 0 ? 0 : comp == 4 ? 1 : comp == 1 ? 2 * nw
                 : comp == 3 ? 2 * nw + 1 : comp == 2 ? 4 * nw : 5 * nw;
    T* d = win + at + u * a.wy * stride;
    for (int v = lane; v < a.wy; v += 32)
      cp_async<sizeof(T)>(d + v * stride, src + v);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one axis from its floor j: the integer taps M2(c - xw) at the three
// nodes around the nearest one, r = j + (xw - j >= 1/2), and the half taps
// M2(c + 1/2 - xw) at c = j-1 .. j+1 (every other tap of the dense form
// is 0), with their window nodes clamped into [0, w) as row offsets times
// ``scale``; a tap off the window is 0
template <typename T>
__device__ __forceinline__ void taps(T xw, T j, int w, int scale, int* ig,
                                     T* g, int* ih, T* hf) {
  const int c0 = (int)j - 1;
  const int r0 = c0 + (xw - j >= T(0.5) ? 1 : 0);
  for (int k = 0; k < 3; ++k) {
    const int c = r0 + k;
    const bool in = c >= 0 && c < w;
    ig[k] = (in ? c : (c < 0 ? 0 : w - 1)) * scale;
    g[k] = in ? m2(T(c) - xw) : T(0);
  }
  for (int k = 0; k < 3; ++k) {
    const int c = c0 + k;
    const bool in = c >= 0 && c < w;
    ih[k] = (in ? c : (c < 0 ? 0 : w - 1)) * scale;
    hf[k] = in ? m2((T(c) + T(0.5)) - xw) : T(0);
  }
}

// sum_x Wx[x] sum_y F[x, y] Wy[y] over three x taps and three y taps
template <typename T>
__device__ __forceinline__ T interp(const T* F, const int* ix, const T* wxs,
                                    const int* iy, const T* wys) {
  T acc = T(0);
  for (int a = 0; a < 3; ++a) {
    T row = T(0);
    for (int b = 0; b < 3; ++b) row += F[ix[a] + iy[b]] * wys[b];
    acc += wxs[a] * row;
  }
  return acc;
}

// the same for an interleaved pair of components
template <typename T>
__device__ __forceinline__ void interp2(const T* F, const int* ix,
                                        const T* wxs, const int* iy,
                                        const T* wys, T& o0, T& o1) {
  using P = typename Pair<T>::type;
  const P* Fp = reinterpret_cast<const P*>(F);
  T acc0 = T(0), acc1 = T(0);
  for (int a = 0; a < 3; ++a) {
    T row0 = T(0), row1 = T(0);
    for (int b = 0; b < 3; ++b) {
      const P v = Fp[ix[a] + iy[b]];
      row0 += v.x * wys[b];
      row1 += v.y * wys[b];
    }
    acc0 += wxs[a] * row0;
    acc1 += wxs[a] * row1;
  }
  o0 = acc0;
  o1 = acc1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, min_blocks<T>()) gather(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);     // see load_windows
  const int nw = a.wx * a.wy;
  const int tile = blockIdx.x;
  const int ti = tile / a.nty, tj = tile % a.nty;
  const T ox = T(ti * a.tx), oy = T(tj * a.ty);
  const long long base = (long long)tile * a.cap;
  const T* __restrict__ xs = a.x + base;
  const T* __restrict__ ys = a.y + base;
  bool loaded = false;                         // the same in every thread
  int s = threadIdx.x;
  T xn = T(0), yn = T(0);
  if (s < a.cap) { xn = __ldg(xs + s); yn = __ldg(ys + s); }
  for (int r0 = 0; r0 < a.cap; r0 += THREADS, s += THREADS) {
    const bool valid = s < a.cap;
    // window coordinates, as _tile_coords: x - origin + h
    const T xw = (xn - ox) + T(a.h);
    const T yw = (yn - oy) + T(a.h);
    if (s + THREADS < a.cap) {
      xn = __ldg(xs + s + THREADS);
      yn = __ldg(ys + s + THREADS);
    }
    const T jx = floor(xw), jy = floor(yw);
    // some tap of both axes on the window
    const bool in = valid && jx >= T(-2) && jx <= T(a.wx) && jy >= T(-2) &&
                    jy <= T(a.wy);
    if (!loaded && __syncthreads_or(in)) {
      load_windows(a, ti, tj, win);
      __syncthreads();
      loaded = true;
    }
    if (!valid) continue;
    const long long i = base + s;
    if (!in) {
      for (int k = 0; k < 6; ++k) a.out[k][i] = T(0);
      continue;
    }
    int igx[3], ihx[3], igy[3], ihy[3];
    T gx[3], hx[3], gy[3], hy[3];
    taps(xw, jx, a.wx, a.wy, igx, gx, ihx, hx);
    taps(yw, jy, a.wy, 1, igy, gy, ihy, hy);
    // ex (half x, integer y), ey (integer x, half y), ez (integer both),
    // bx (integer x, half y), by (half x, integer y), bz (half both),
    // each written once as it is done
    T o0, o1;
    interp2(win, ihx, hx, igy, gy, o0, o1);
    a.out[0][i] = o0;
    a.out[4][i] = o1;
    interp2(win + 2 * nw, igx, gx, ihy, hy, o0, o1);
    a.out[1][i] = o0;
    a.out[3][i] = o1;
    a.out[2][i] = interp(win + 4 * nw, igx, gx, igy, gy);
    a.out[5][i] = interp(win + 5 * nw, ihx, hx, ihy, hy);
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
  a.wx = a.tx + 2 * a.h; a.wy = a.ty + 2 * a.h;
  a.nxp = a.ntx * a.tx + 2 * a.h; a.nyp = a.nty * a.ty + 2 * a.h;
  size_t smem = sizeof(T) * 6 * a.wx * a.wy;
  int err = (int)cudaFuncSetAttribute(
      gather<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  gather<T><<<a.ntx * a.nty, THREADS, smem, st>>>(a);
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
