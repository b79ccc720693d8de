// Device routines shared by the 2D cell-engine kernels: B2's passes and
// deposit (cellstep.cu) and the per-stage kernels B4 (push2d.cu), B5
// (deposit2d.cu), B6 (migrate.cu) and B7 (sortcells.cu), and the 3D
// kernels through cell3d.cuh. One copy each, so the fused and the
// per-stage engines round alike.
//
// Layout: every per-slot array is (cap, nx, ny), cell (ix, iy) at
// ix*ny + iy, slot stride nx*ny. All of it is written as the plain PyTorch
// versions evaluate it and compiled with --fmad=false.
#pragma once

#include "common.cuh"

namespace lp2d {

// deposit tile (cells per side); ops/cellslab.py's TILE, held equal to
// this through lp_cell_tile() when B2's library is first used
constexpr int TILE = 16;
constexpr int PAN = TILE + 4;      // panel side: tile + 2-node rims

// The merge's weight floor: 1e-30 in float32, 1e-300 in float64.
template <typename T> struct WFloor;
template <> struct WFloor<float> { static __device__ float v() { return 1e-30f; } };
template <> struct WFloor<double> { static __device__ double v() { return 1e-300; } };

// A sort entry packs a key of a few bits above a 16-bit slot index: any
// per-cell capacity up to 65536 slots.
constexpr int KEY_SHIFT = 16;
__device__ __forceinline__ int pack_key(int key, int slot) {
  return (key << KEY_SHIFT) | slot;
}
__device__ __forceinline__ int key_of(int k) { return k >> KEY_SHIFT; }
__device__ __forceinline__ int slot_of(int k) { return k & 0xffff; }

// Per-cell capacities up to MAXC_LOCAL sort their entries in a
// thread-local array sized by a template argument (8, 16, 32, 64 or 128).
// Above it a kernel runs one thread per resident slot of a grid-stride
// loop over cells and keeps each thread's entries in a row of a global
// scratch (KEY_ROWS x cap int32 a thread), sized by the resident threads,
// not by the cells.
constexpr int MAXC_LOCAL = 128;
constexpr int KEY_ROWS = 3;
constexpr int MAX_SLOTS = 1 << 16;    // the 16-bit slot index

// MAXC_LOCAL (which = 0), KEY_ROWS (1) or MAX_SLOTS (2): each sorting
// library exports this as lp_key_limits, which ops/cellslab.py holds
// equal to its own copies (they size the scratch) at first use
inline int key_limit(int which) {
  return which == 0 ? MAXC_LOCAL : which == 1 ? KEY_ROWS : MAX_SLOTS;
}

// Run body(cell, k, ks) for the cells of a launch of one thread a cell
// (MAXC > 0: k is a thread-local array of KEY_ROWS rows of ks = MAXC
// entries) or of a grid-stride launch over the cells (MAXC == 0: k is the
// thread's row of ``scratch``, KEY_ROWS rows of ks = cap entries).
template <int MAXC, typename Body>
__device__ __forceinline__ void for_cells(long long ncell, int* scratch,
                                          int cap, Body body) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (MAXC > 0) {
    if (cell < ncell) {
      int k[KEY_ROWS * MAXC];
      body(cell, k, MAXC);
    }
  } else {
    int* k = scratch + cell * KEY_ROWS * cap;
    for (; cell < ncell; cell += (long long)gridDim.x * blockDim.x)
      body(cell, k, cap);
  }
}

// Blocks of ``threads`` for a launch over ncell cells: one thread a cell up
// to MAXC_LOCAL slots a cell, else as many as the scratch has rows
// (key_threads, a multiple of threads); 0 if that scratch is missing.
inline int cell_blocks(long long ncell, int cap, long long key_threads,
                       int threads) {
  long long b = (ncell + threads - 1) / threads;
  if (cap <= MAXC_LOCAL) return (int)b;
  long long rows = key_threads / threads;
  return (int)(b < rows ? b : rows);
}

// Sort packed (key, slot) entries with the compare-exchange list of
// cellpallas.py::_batcher_network, swapping on a strict ka > kb.
__device__ __forceinline__ void net_sort(int* k, const int* __restrict__ ces,
                                         int nces) {
  for (int e = 0; e < nces; ++e) {
    int a = __ldg(ces + 2 * e), b = __ldg(ces + 2 * e + 1);
    int ka = k[a], kb = k[b];
    if (key_of(ka) > key_of(kb)) {
      k[a] = kb;
      k[b] = ka;
    }
  }
}

// The re-binning's 5-way key (3 bits): donor(+1) 0, dead even slot 1, stay
// 2, dead odd slot 3, donor(-1) 4; dead parity from the slot index before
// the sort.
__device__ __forceinline__ int five_way(bool alive, bool out_hi, bool out_lo,
                                        int s) {
  if (out_hi) return 0;
  if (out_lo) return 4;
  if (alive) return 2;
  return (s & 1) == 0 ? 1 : 3;
}

// Add each thread's merge count to one counter, a warp at a time.
__device__ __forceinline__ void add_merges(unsigned long long* counter,
                                           int merges) {
  unsigned mask = __activemask();
  int total = merges;
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(mask, total, off);
  int lane = threadIdx.x & 31;
  int leader = __ffs(mask) - 1;
  // after the reduction the lowest active lane of a full warp holds the
  // sum; for a partial warp fall back to one atomic per thread
  if (mask == 0xffffffffu) {
    if (lane == leader && total) atomicAdd(counter, (unsigned long long)total);
  } else if (merges) {
    atomicAdd(counter, (unsigned long long)merges);
  }
}

// cp.async of one element, global -> shared (sm_80 and later), and the
// wait for all of a thread's copies.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x += u * inv_gamma * h (ops/pusher.py::push_position_2d)
template <typename T>
__device__ __forceinline__ T pushed(T pos, T u, T ig, T h) {
  return pos + (u * ig) * h;
}

// Staggered quadratic gather of one component (ops/cell2d.py::
// gather_cell_2d): x taps {-1,0,1} (integer) or {-2..1} (half), same in y.
template <typename T, typename I>
__device__ __forceinline__ T gather_comp(const T* __restrict__ f, int nyp,
                                         int px, int py, bool half_x,
                                         bool half_y, T dx, T dy) {
  T acc = T(0);
  int ox0 = half_x ? -2 : -1, ox1 = 1;
  int oy0 = half_y ? -2 : -1, oy1 = 1;
  for (int ox = ox0; ox <= ox1; ++ox) {
    T tx = half_x ? m2(T(ox + 0.5) - dx) : m2(T(ox) - dx);
    for (int oy = oy0; oy <= oy1; ++oy) {
      T ty = half_y ? m2(T(oy + 0.5) - dy) : m2(T(oy) - dy);
      acc = acc + (tx * ty) * f[(I)(px + ox) * nyp + (py + oy)];
    }
  }
  return acc;
}

// The six components of E, B at cell-local deltas (dx, dy) of cell
// (ix, iy), from the padded stack eb (6, nx+2g, ny+2g), with indices of
// type I (64-bit in device memory; a shared window of a tile, see
// push2d.cu, is such a stack of its own, 32-bit).
template <typename T, typename I = long long>
__device__ __forceinline__ void gather_eb(const T* __restrict__ eb, int nx,
                                          int ny, int g, int ix, int iy, T dx,
                                          T dy, T* out) {
  const int nxp = nx + 2 * g, nyp = ny + 2 * g;
  const I plane = (I)nxp * nyp;
  const int px = ix + g, py = iy + g;
  out[0] = gather_comp<T, I>(eb + 0 * plane, nyp, px, py, true, false, dx, dy);
  out[1] = gather_comp<T, I>(eb + 1 * plane, nyp, px, py, false, true, dx, dy);
  out[2] = gather_comp<T, I>(eb + 2 * plane, nyp, px, py, false, false, dx, dy);
  out[3] = gather_comp<T, I>(eb + 3 * plane, nyp, px, py, false, true, dx, dy);
  out[4] = gather_comp<T, I>(eb + 4 * plane, nyp, px, py, true, false, dx, dy);
  out[5] = gather_comp<T, I>(eb + 5 * plane, nyp, px, py, true, true, dx, dy);
}

// Boris (ops/pusher.py::boris_push): updates (ux, uy, uz) in place from
// the gathered fields e = (ex ey ez bx by bz) and returns the new
// inv_gamma. ef = q dt / (2 m c), bf = q dt / (2 m). torch evaluates
// 2.0 / t as reciprocal(t) * 2, hence tfac's form.
template <typename T>
__device__ __forceinline__ T boris(T& ux_, T& uy_, T& uz_, const T* e, T ef,
                                   T bfac) {
  T um_x = ux_ + ef * e[0];
  T um_y = uy_ + ef * e[1];
  T um_z = uz_ + ef * e[2];
  T igm = T(1) / sqrt(((T(1) + um_x * um_x) + um_y * um_y) + um_z * um_z);
  T tx = (bfac * e[3]) * igm;
  T ty = (bfac * e[4]) * igm;
  T tz = (bfac * e[5]) * igm;
  T up_x = (um_x + um_y * tz) - um_z * ty;
  T up_y = (um_y + um_z * tx) - um_x * tz;
  T up_z = (um_z + um_x * ty) - um_y * tx;
  T tfac = T(2) * (T(1) / (((T(1) + tx * tx) + ty * ty) + tz * tz));
  T sx = tfac * tx, sy = tfac * ty, sz = tfac * tz;
  T ux = ((um_x + up_y * sz) - up_z * sy) + ef * e[0];
  T uy = ((um_y + up_z * sx) - up_x * sz) + ef * e[1];
  T uz = ((um_z + up_x * sy) - up_y * sx) + ef * e[2];
  ux_ = ux;
  uy_ = uy;
  uz_ = uz;
  return T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
}

// B2's want_chi mode: the pre-push ig0 = 1/sqrt(1 + u^2) of momenta u and
// the quantum parameter of models/qed.py::calculate_chi at u, ig0 and the
// gathered fields e; c the speed of light, chi_factor e hbar / (m_e^2 c^3).
template <typename T>
__device__ __forceinline__ void quantum_chi(const T* e, T ux0, T uy0, T uz0,
                                            T c, T chi_factor, T& chi,
                                            T& ig0) {
  const T ig = T(1) / sqrt(((T(1) + ux0 * ux0) + uy0 * uy0) + uz0 * uz0);
  T gam = T(1) / ig;
  T t1 = gam * e[0] + (uy0 * e[5] - uz0 * e[4]) * c;
  T t2 = gam * e[1] + (uz0 * e[3] - ux0 * e[5]) * c;
  T t3 = gam * e[2] + (ux0 * e[4] - uy0 * e[3]) * c;
  T t4 = (ux0 * e[0] + uy0 * e[1]) + uz0 * e[2];
  T val = ((t1 * t1 + t2 * t2) + t3 * t3) - t4 * t4;
  chi = chi_factor * sqrt(val > T(0) ? val : T(0));
  ig0 = ig;
}

// A photon's inv_gamma (ops/pusher.py::photon_push): 1/|u|, 1 where u = 0.
template <typename T>
__device__ __forceinline__ T photon_ig(T ux, T uy, T uz) {
  T u2 = (ux * ux + uy * uy) + uz * uz;
  const T tiny = T(1e-30);
  return u2 > T(0) ? T(1) / sqrt(u2 > tiny ? u2 : tiny) : T(1);
}

template <typename T>
__device__ __forceinline__ void shapes(T d, T v, T* s0, T* s1) {
  T d0 = d - T(0.5) * v, d1 = d + T(0.5) * v;
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    s0[o] = m2(T(o - 2) - d0);
    s1[o] = m2(T(o - 2) - d1);
  }
}

// Inputs of the tile deposit: the pushed slots of one species.
template <typename T>
struct DepositIn {
  const unsigned char* alive;   // the depositing slots
  const T *x, *y, *ux, *uy, *uz, *ig, *w;
  const T* rims_in;             // null: panels start at 0
  T* rims_out;                  // (C, nbx, nby, PAN, PAN)
  int nx, ny, cap;
  long long ncell;
  T cdx, cdy, c, kcd, kfx, kfy; // c dt/dx, c dt/dy, c, q/(dx dy),
                                // q/(dy dt), q/(dx dt)
};

// The tile deposit of B2's deposit2 (cellstep.cu) and B5 (deposit2d.cu):
// one block per TILE x TILE cell tile (blockDim (TILE, TILE), grid
// (nby, nbx), NC * PAN * PAN reals of dynamic shared memory), NC = 4 with
// rho, else 3. Where ``flagged``, each thread reads its cell's alive bytes
// (the first 64 into a bit mask, and counts them all; an unflagged tile
// reads nothing and holds no alive slot).
// A tile with no alive slot returns false in every thread; it writes
// nothing, or with COPY_EMPTY its panel as rims_in holds it (zeros where
// rims_in is null). Otherwise each thread walks its cell's alive slots once, in
// slot order (above 64 slots the bytes of each further 64 are read again
// into a bit mask, the loads independent of one another), computing each
// particle's shapes once and adding its 5 x 5
// Esirkepov nodes into per-offset sums in registers; then the 25 offsets
// go into the shared panel (rims_in's, or zeros) one after another with
// a barrier between, every thread writing a different node within one
// offset, so the sum needs no atomics and repeats bit for bit; the panel
// goes to rims_out and the call returns true. Panel (bi, bj) node (a, b)
// is the current at interior index (bi*TILE + a - 2, bj*TILE + b - 2).
template <typename T, int NC, bool COPY_EMPTY>
__device__ __forceinline__ bool deposit_panel(const DepositIn<T>& a,
                                              bool flagged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);       // (NC, PAN, PAN)
  const int lx = threadIdx.y, ly = threadIdx.x;
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int nbx = gridDim.y, nby = gridDim.x;
  const int ix = bi * TILE + lx, iy = bj * TILE + ly;
  const bool valid = ix < a.nx && iy < a.ny;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  constexpr int PP = PAN * PAN;
  const long long cell = (long long)ix * a.ny + iy;
  const unsigned char* alive = a.alive + cell;
  int n_alive = 0;
  unsigned long long bits = 0;      // the alive slots among the first 64
  if (valid && flagged) {
#pragma unroll 4
    for (int s = 0; s < a.cap; ++s)
      if (alive[s * a.ncell]) {
        ++n_alive;
        if (s < 64) bits |= 1ull << s;
      }
  }
  // the tile's panel: component c's node e at c * cstride + tile0 + e
  const long long tile0 = ((long long)bi * nby + bj) * PP;
  const long long cstride = (long long)nbx * nby * PP;
  if (!__syncthreads_or(n_alive)) {
    if constexpr (COPY_EMPTY)
      for (int e = tid; e < NC * PP; e += TILE * TILE) {
        const long long g = (e / PP) * cstride + tile0 + e % PP;
        a.rims_out[g] = a.rims_in ? a.rims_in[g] : T(0);
      }
    return false;
  }
  for (int e = tid; e < NC * PP; e += TILE * TILE) {
    const long long g = (e / PP) * cstride + tile0 + e % PP;
    pan[e] = a.rims_in ? a.rims_in[g] : T(0);
  }
  T acc[5][5][NC];
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][j][c] = T(0);
  const T cdx = a.cdx, cdy = a.cdy, kcd = a.kcd, kfx = a.kfx, kfy = a.kfy;
  // the alive slots in slot order, 64 slot indices at a time: the bit
  // mask of slots c0 .. c0 + 63 (the first read's for c0 = 0), then its
  // set bits
  for (int c0 = 0, left = n_alive; left > 0; c0 += 64) {
    if (c0 > 0) {
      bits = 0;
      const int n = a.cap - c0 < 64 ? a.cap - c0 : 64;
#pragma unroll 4
      for (int s = 0; s < n; ++s)
        if (alive[(c0 + s) * a.ncell]) bits |= 1ull << s;
    }
    for (; bits != 0; --left) {
      const int s = c0 + __ffsll(bits) - 1;
      bits &= bits - 1;
      const long long idx = (long long)s * a.ncell + cell;
      const T x = a.x[idx], y = a.y[idx];
      const T ig = a.ig[idx], w = a.w[idx];
      const T vx_c = (a.ux[idx] * ig) * cdx;
      const T vy_c = (a.uy[idx] * ig) * cdy;
      const T vz = (a.uz[idx] * ig) * a.c;
      T s0x[5], s1x[5], s0y[5], s1y[5];
      shapes(x - T(ix), vx_c, s0x, s1x);
      shapes(y - T(iy), vy_c, s0y, s1y);
      const T cd = kcd * w, fdx = kfx * w, fdy = kfy * w;
      const T cvz = cd * vz;
      T run = T(0);
#pragma unroll
      for (int oxi = 0; oxi < 5; ++oxi) {
        run = run + (s1x[oxi] - s0x[oxi]);
        const T fx = (-fdx) * run;
        const T dsx = s1x[oxi] - s0x[oxi];
        const T ax = s0x[oxi] + T(0.5) * dsx;
        T runy = T(0);
#pragma unroll
        for (int oy = 0; oy < 5; ++oy) {
          const T dsy = s1y[oy] - s0y[oy];
          runy = runy + dsy;
          const T gy = (-fdy) * runy;
          const T by = s0y[oy] + T(0.5) * dsy;
          acc[oxi][oy][0] += fx * by;
          acc[oxi][oy][1] += ax * gy;
          acc[oxi][oy][2] += cvz * (ax * by + (dsx * dsy) / T(12));
          if constexpr (NC == 4) acc[oxi][oy][3] += (cd * s1x[oxi]) * s1y[oy];
        }
      }
    }
  }
#pragma unroll
  for (int oxi = 0; oxi < 5; ++oxi)
#pragma unroll
    for (int oy = 0; oy < 5; ++oy) {
      __syncthreads();
      if (valid)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          pan[c * PP + (lx + oxi) * PAN + (ly + oy)] += acc[oxi][oy][c];
    }
  __syncthreads();
  for (int e = tid; e < NC * PP; e += TILE * TILE)
    a.rims_out[(e / PP) * cstride + tile0 + e % PP] = pan[e];
  return true;
}

}  // namespace lp2d
