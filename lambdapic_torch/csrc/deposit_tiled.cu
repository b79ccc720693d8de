// Kernel B9: the charge-conserving (Esirkepov) deposit of a tile-binned 2D
// species (ntx, nty, cap_t) into per-tile current windows (4, ntx, nty,
// wx, wy) = (jx, jy, jz, rho).
//
// Replaces the TPU kernel lambdapic_tpu/ops/tiled2d_pallas.py::
// deposit_tiled_pallas (:282, kernel _deposit_kernel :219, pallas_call
// :301), velocity terms included (its wrapper computes them, :293-295).
// Plain PyTorch version: lambdapic_torch/ops/tiled2d_kernels.py::
// deposit_tiled_plain (the alive mask applied to w, then ops/tiled2d.py::
// deposit_tiled); fold_windows (plain torch, as it is XLA in JAX)
// overlap-adds the windows into the padded current.
//
// Stencil. S0 and S1 (the shapes at xw -/+ vx dt/2) are nonzero on the
// three nodes around n0 and n1, the nodes nearest x0 and x1; |vx dt/dx|
// < 1 keeps |n1 - n0| <= 1, so both lie on the four nodes c0 .. c0+3 with
// c0 = min(n0, n1) - 1, and
//   jx[cx, cy] += Fx[cx] b[cy],  Fx = -q w/(dy dt) cumsum(DSx) over the
//                                stencil, cx = c0 .. c0+2 (the last
//                                cumsum is the whole telescoping sum, 0)
//   jy[cx, cy] += a[cx] Gy[cy],  cy = c0y .. c0y+2
//   jz[cx, cy] += (a cvz)[cx] b[cy] + (DSx cvz/12)[cx] DSy[cy], 4 x 4
//   rho[cx, cy] += (S1x cd)[cx] S1y[cy], on S1's 3 x 3 nodes
// with DS = S1 - S0, a = S0x + DSx/2, b = S0y + DSy/2, cd = q w/(dx dy),
// cvz = cd vz: 49 adds a particle. The dense form's cumsum beyond the
// stencil is a rounding residue of the telescoping sum (about eps |DS|),
// spread over the rest of the window; here those nodes get exact zeros.
// A node outside [0, w) is dropped, as the dense form has none.
//
// Design. One 256-thread block takes one tile and keeps its four (wx, wy)
// windows in shared memory. It reads the tile's alive mask a round of
// 4096 slots at a time (16 bytes a thread), numbers the alive slots by a
// block scan and lists them in slot order; each thread then deposits a
// blocked run of consecutive list entries (run = ceil(alive / 256)), so
// the 32 lanes of a warp sit a run apart in the slot order. A warp stages
// its lanes' next four slots in shared memory, each load instruction
// reading eight runs of four entries (consecutive slots in the fill's
// order), so a slot's payload is read in whole sectors and once. A tile
// with no alive slot reads nothing but its mask and writes zero windows.
// The windows are written once, 16 bytes a thread where the window's
// size allows. No dead slot's payload is read.
//
// The adds. sm_90 has no native shared float add: atomicAdd on a shared
// float or double compiles to a compare-and-swap loop (ATOMS.CAST.SPIN,
// ATOMS.CAST.SPIN.64 in the SASS: a load, the add, the conditional store,
// a branch back), which lets one lane per address through a round. The
// fill lays particles out ten to a cell in consecutive slots, so lanes
// that took interleaved slots sat in about three cells and retried about
// ten rounds an add; a run of ten or more slots a lane puts the lanes of
// a warp in different cells, and an add of the warp hits 32 different
// nodes in one round. The order of a node's sum changes from run to run,
// so B9's rounding is not deterministic.
//
// What was tried and measured on an H100 (kernel_ab.py tiled, PERF.md):
// compare-and-swaps written out and issued in batches compile to
// ATOMS.CAS, not CAST.SPIN, and ran 10-20x slower; sums kept in registers
// while a lane's stencil origin stays (a cell's particles straddle the
// nearest-node boundary, so it changes every two or three particles)
// took 177 registers and flushed in nearly every step, 2x slower; a
// block-wide staging of a round's payloads, 1 block an SM, 2x slower;
// 64-bit fixed-point sums, 2.2x slower (only the 32-bit integer shared
// add is native, ATOMS.ADD; the 64-bit one is ATOMS.CAST.SPIN.64). The
// TPU's dense (w, cap) tap panels and one matrix product a tile multiply
// 42 taps an axis where 4 are nonzero, and in TF32 would miss the float32
// tolerance (1e-4 of each channel's peak).
//
// Bound on an H100 (3.35 TB/s): bytes: the mask read once, seven reals
// read an alive slot and the four windows written once. What holds it:
// the shared-memory compare-and-swap loops, about 12 cycles of an SM a
// warp's add (49 a particle): with the adds made plain stores the kernel
// takes a third of its time. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py's [time B9], bench.py's --tiling 32,32 end state, 3.92 M
// of 9.44 M slots alive): 0.2728 ms a launch against a 0.0405 ms bound
// (0.8372 before this design); kernel_ab.py tiled: 0.50 ms on the fill's
// order, 0.57 shuffled, 0.77 on tiled_state's random state.
#include "common.cuh"

namespace {

enum Ptr { P_X, P_Y, P_UX, P_UY, P_UZ, P_IG, P_W, P_ALIVE, P_OUT, P_COUNT };
enum Int { I_NTX, I_NTY, I_CAP, I_TX, I_TY, I_H, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY,           // c dt / dx, c dt / dy
            R_C,                    // c
            R_KCD, R_KFX, R_KFY };  // q / (dx dy), q / (dy dt), q / (dx dt)

constexpr int THREADS = 256;
constexpr int S = 4;                // stencil nodes an axis
constexpr int ROUND = 4096;         // slots whose alive bytes a round lists
constexpr int PER = ROUND / THREADS;  // alive bytes a thread reads a round
constexpr int GROUP = 16;           // threads a partial sum of the scan
constexpr int CHUNK = 4;            // slots of each lane's run staged at once
// a warp's staging buffer: 32 lanes x CHUNK slots, a pad every 8 lanes
constexpr int STAGE = 32 * CHUNK + 32 / 8;
// blocks an SM: three float blocks (63 KB of shared memory, 80 registers
// a thread)
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 3 : 1; }

template <typename T>
struct Args {
  const T *x, *y, *ux, *uy, *uz, *ig, *w;
  const unsigned char* alive;       // (ntx, nty, cap), 0 or 1
  T* out;                           // (4, ntx, nty, wx, wy)
  int ntx, nty, cap, tx, ty, h, wx, wy;
  bool vec_alive;                   // 16-byte loads of the mask
  T cdx, cdy, c, kcd, kfx, kfy;
};

// the nearest node to x: floor(x) + (x - floor(x) >= 1/2), the difference
// exact
template <typename T>
__device__ __forceinline__ T nearest(T x) {
  const T f = floor(x);
  return x - f >= T(0.5) ? f + T(1) : f;
}

// S0, S1 and DS of one axis on the four nodes from c0 = min(n0, n1) - 1,
// n0 and n1 the nodes nearest x0 and x1 (|n1 - n0| <= 1, so both shapes'
// three nonzero nodes lie among the four); r1 = n1 - min(n0, n1), where
// S1's three nodes start
template <typename T>
__device__ __forceinline__ int shapes(T xw, T v, T* s0, T* s1, T* ds,
                                      int& r1) {
  T x0 = xw - T(0.5) * v, x1 = xw + T(0.5) * v;
  const T n0 = nearest(x0), n1 = nearest(x1);
  r1 = n1 > n0 ? 1 : 0;
  T f = fmin(n0, n1);
  f = fmin(fmax(f, T(-16)), T(1 << 20));
  int c0 = (int)f - 1;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    T c = T(c0 + k);
    s0[k] = m2(c - x0);
    s1[k] = m2(c - x1);
    ds[k] = s1[k] - s0[k];
  }
  return c0;
}

// acc[cx, cy] += v unless v is 0 or (CHECK) the node is off the window
template <bool CHECK, typename T>
__device__ __forceinline__ void add(T* acc, int wx, int wy, int cx, int cy,
                                    T v) {
  if (v != T(0) && (!CHECK || (cx >= 0 && cx < wx && cy >= 0 && cy < wy)))
    atomicAdd(acc + cx * wy + cy, v);
}

// the stencil's adds; CHECK drops the nodes off the window, which a
// stencil inside it (nearly every one) need not test
template <bool CHECK, typename T>
__device__ __forceinline__ void stencil(T* acc, int wx, int wy, int nw,
                                        int cx0, int cy0, int rx1, int ry1,
                                        const T* ax, const T* by,
                                        const T* fx, const T* gy,
                                        const T* dsx, const T* dsy,
                                        const T* s1x, const T* s1y, T cvz,
                                        T cvz12, T cd) {
  T* jx = acc;
  T* jy = acc + nw;
  T* jz = acc + 2 * nw;
  T* rho = acc + 3 * nw;
  // jx on S - 1 x nodes (the last cumsum is the whole telescoping sum,
  // 0), jy on S - 1 y nodes, jz on S x S
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const int cx = cx0 + p;
    const T az = ax[p] * cvz, dz = dsx[p] * cvz12;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int cy = cy0 + q;
      if (p < S - 1) add<CHECK>(jx, wx, wy, cx, cy, fx[p] * by[q]);
      if (q < S - 1) add<CHECK>(jy, wx, wy, cx, cy, ax[p] * gy[q]);
      add<CHECK>(jz, wx, wy, cx, cy, az * by[q] + dz * dsy[q]);
    }
  }
  // rho on S1's three nodes an axis, from cx0 + rx1, cy0 + ry1
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    const T rx = (rx1 ? s1x[p + 1] : s1x[p]) * cd;
#pragma unroll
    for (int q = 0; q < S - 1; ++q)
      add<CHECK>(rho, wx, wy, cx0 + rx1 + p, cy0 + ry1 + q,
                 rx * (ry1 ? s1y[q + 1] : s1y[q]));
  }
}

// one alive slot's payload, the reals as the plain version forms them:
// window coordinates, velocities times c dt / dx and c dt / dy, vz, w
template <typename T>
struct Slot {
  T xw, yw, vxc, vyc, vz, w;
};

template <typename T>
__device__ __forceinline__ Slot<T> load_slot(const Args<T>& a, long long i,
                                             T ox, T oy) {
  const T ig = __ldg(a.ig + i);
  Slot<T> s;
  s.xw = (__ldg(a.x + i) - ox) + T(a.h);
  s.yw = (__ldg(a.y + i) - oy) + T(a.h);
  s.vxc = (__ldg(a.ux + i) * ig) * a.cdx;
  s.vyc = (__ldg(a.uy + i) * ig) * a.cdy;
  s.vz = (__ldg(a.uz + i) * ig) * a.c;
  s.w = __ldg(a.w + i);
  return s;
}

// one particle's stencil into the block's windows
template <typename T>
__device__ __forceinline__ void deposit_particle(const Args<T>& a,
                                                 const Slot<T>& s, T* acc,
                                                 int nw) {
  T s0x[S], s1x[S], dsx[S], s0y[S], s1y[S], dsy[S];
  int rx1, ry1;
  const int cx0 = shapes(s.xw, s.vxc, s0x, s1x, dsx, rx1);
  const int cy0 = shapes(s.yw, s.vyc, s0y, s1y, dsy, ry1);
  const T cd = a.kcd * s.w;
  const T fdx = a.kfx * s.w, fdy = a.kfy * s.w;
  const T cvz = cd * s.vz;
  const T cvz12 = cvz / T(12);
  T ax[S], by[S], fx[S], gy[S];
  T runx = T(0), runy = T(0);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    ax[k] = s0x[k] + T(0.5) * dsx[k];
    by[k] = s0y[k] + T(0.5) * dsy[k];
    runx += dsx[k];
    runy += dsy[k];
    fx[k] = -fdx * runx;
    gy[k] = -fdy * runy;
  }
  if (cx0 >= 0 && cx0 + S <= a.wx && cy0 >= 0 && cy0 + S <= a.wy)
    stencil<false>(acc, a.wx, a.wy, nw, cx0, cy0, rx1, ry1, ax, by, fx, gy,
                   dsx, dsy, s1x, s1y, cvz, cvz12, cd);
  else
    stencil<true>(acc, a.wx, a.wy, nw, cx0, cy0, rx1, ry1, ax, by, fx, gy,
                  dsx, dsy, s1x, s1y, cvz, cvz12, cd);
}

// bit k: slot s0 + k of the tile is alive (k < PER)
template <typename T>
__device__ __forceinline__ unsigned alive_bits(const Args<T>& a,
                                               const unsigned char* al,
                                               int s0) {
  unsigned bits = 0;
  if (a.vec_alive && s0 + PER <= a.cap) {
    const uint4 v = *reinterpret_cast<const uint4*>(al + s0);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < PER; ++k)
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
  } else {
    for (int k = 0; k < PER && s0 + k < a.cap; ++k)
      if (al[s0 + k]) bits |= 1u << k;
  }
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
    deposit(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = a.wx * a.wy;
  T* acc = reinterpret_cast<T*>(smem_raw);             // (4, wx, wy)
  unsigned short* list =
      reinterpret_cast<unsigned short*>(acc + 4 * nw);  // (ROUND,)
  int* cnt = reinterpret_cast<int*>(list + ROUND);      // (THREADS,)
  int* part = cnt + THREADS;                            // (THREADS/GROUP+1,)
  // (warps, 6, STAGE): the payloads of a warp's runs, CHUNK slots a run
  T* stage = reinterpret_cast<T*>(
      ((uintptr_t)(part + THREADS / GROUP + 1) + 15) & ~(uintptr_t)15);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* st = stage + warp * 6 * STAGE;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ti = tile / a.nty, tj = tile % a.nty;
  for (int k = tid; k < 4 * nw; k += THREADS) acc[k] = T(0);
  const T ox = T(ti * a.tx), oy = T(tj * a.ty);
  const long long base = (long long)tile * a.cap;
  const unsigned char* al = a.alive + base;
  for (int r0 = 0; r0 < a.cap; r0 += ROUND) {
    // the round's alive slots, listed in slot order
    const int s0 = r0 + tid * PER;
    unsigned bits = s0 < a.cap ? alive_bits(a, al, s0) : 0u;
    cnt[tid] = __popc(bits);
    __syncthreads();
    if (tid < THREADS / GROUP) {
      int sum = 0;
      for (int k = 0; k < GROUP; ++k) sum += cnt[tid * GROUP + k];
      part[tid + 1] = sum;
    }
    __syncthreads();
    if (tid == 0) {
      part[0] = 0;
      for (int k = 1; k <= THREADS / GROUP; ++k) part[k] += part[k - 1];
    }
    __syncthreads();
    int pos = part[tid / GROUP];
    for (int k = tid - tid % GROUP; k < tid; ++k) pos += cnt[k];
    const int total = part[THREADS / GROUP];
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      list[pos++] = (unsigned short)(tid * PER + k);
    }
    __syncthreads();
    // a blocked run of the list a thread: lane k of warp w takes entries
    // (32 w + k) span + j stride, j < run. The warp stages its runs' next
    // CHUNK slots in shared memory, a load instruction reading 32 / CHUNK
    // runs of CHUNK entries (consecutive slots in the fill's order), then
    // each lane deposits its own from there.
    const int run = (total + THREADS - 1) / THREADS;
    const int stride = 1, span = run;
    for (int c = 0; c < run; c += CHUNK) {
#pragma unroll
      for (int v = 0; v < CHUNK; ++v) {
        const int k = v * (32 / CHUNK) + lane / CHUNK, o = lane % CHUNK;
        const int e = (warp * 32 + k) * span + (c + o) * stride;
        if (c + o < run && e < total) {
          const Slot<T> sl = load_slot(a, base + r0 + list[e], ox, oy);
          const int at = k * CHUNK + o + k / 8;
          st[at] = sl.xw;
          st[STAGE + at] = sl.yw;
          st[2 * STAGE + at] = sl.vxc;
          st[3 * STAGE + at] = sl.vyc;
          st[4 * STAGE + at] = sl.vz;
          st[5 * STAGE + at] = sl.w;
        }
      }
      __syncwarp();
      for (int o = 0; o < CHUNK; ++o) {
        const int e = (warp * 32 + lane) * span + (c + o) * stride;
        if (c + o < run && e < total) {
          const int at = lane * CHUNK + o + lane / 8;
          const Slot<T> sl = {st[at], st[STAGE + at], st[2 * STAGE + at],
                              st[3 * STAGE + at], st[4 * STAGE + at],
                              st[5 * STAGE + at]};
          deposit_particle(a, sl, acc, nw);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  // the four windows, written once
  const long long ntile = (long long)a.ntx * a.nty;
  constexpr int V = 16 / sizeof(T);
  for (int ch = 0; ch < 4; ++ch) {
    T* dst = a.out + (ch * ntile + tile) * nw;
    const T* src = acc + ch * nw;
    if (nw % V == 0) {
      for (int k = tid; k < nw / V; k += THREADS)
        reinterpret_cast<uint4*>(dst)[k] =
            reinterpret_cast<const uint4*>(src)[k];
    } else {
      for (int k = tid; k < nw; k += THREADS) dst[k] = src[k];
    }
  }
}

template <typename T>
size_t smem_bytes(int nw) {
  return sizeof(T) * 4 * nw + sizeof(unsigned short) * ROUND +
         sizeof(int) * (THREADS + THREADS / GROUP + 1) + 16 +
         sizeof(T) * (THREADS / 32) * 6 * STAGE;
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY];
  a.uz = (const T*)p[P_UZ]; a.ig = (const T*)p[P_IG];
  a.w = (const T*)p[P_W];
  a.alive = (const unsigned char*)p[P_ALIVE];
  a.out = (T*)p[P_OUT];
  a.ntx = (int)n[I_NTX]; a.nty = (int)n[I_NTY]; a.cap = (int)n[I_CAP];
  a.tx = (int)n[I_TX]; a.ty = (int)n[I_TY]; a.h = (int)n[I_H];
  a.wx = a.tx + 2 * a.h; a.wy = a.ty + 2 * a.h;
  a.vec_alive = a.cap % 16 == 0 && (uintptr_t)a.alive % 16 == 0;
  a.cdx = (T)r[R_CDX]; a.cdy = (T)r[R_CDY]; a.c = (T)r[R_C];
  a.kcd = (T)r[R_KCD]; a.kfx = (T)r[R_KFX]; a.kfy = (T)r[R_KFY];
  if ((uintptr_t)a.out % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.wx * a.wy);
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

