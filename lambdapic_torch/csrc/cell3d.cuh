// Device routines shared by the 3D cell-engine kernels: B2's tile kernel
// (cellstep3d.cu) and the per-stage kernels B4 (push3d.cu) and B5
// (deposit3d.cu). The key, sort, merge count, half push and Boris are
// cell2d.cuh's, which every rank shares.
//
// The gather is one copy, templated on where it reads the fields: B4 reads
// the padded stack in device memory, B2's tile kernel an 11^3 window of it
// in shared memory, with the same taps in the same order, so the two
// gather alike bit for bit. The deposit is not: B5 (deposit_tile) adds a
// tile's particles into its panel one stencil offset at a time between
// block barriers, in a fixed order, while B2 (deposit_window, or
// deposit_atomic for a particle that moved a cell or more) adds each
// particle's nonzero nodes with shared-memory atomics, whose order changes
// from run to run. Each contribution is the same product and only exact
// zeros are left out; only the order of the sums, and so their rounding,
// differs.
//
// Layout: every per-slot array is (cap, nx, ny, nz), cell (ix, iy, iz) at
// (ix*ny + iy)*nz + iz, slot stride nx*ny*nz, 64-bit offsets. All of it is
// written as the plain PyTorch versions evaluate it and compiled with
// --fmad=false.
#pragma once

#include "cell2d.cuh"

namespace lp3d {

// deposit tile (cells per side); ops/cellslab.py's TILE3, held equal to
// this through lp_cell_tile() / lp_deposit_tile() when a library that
// uses it is first used
constexpr int TILE = 8;
constexpr int PAN = TILE + 4;          // panel side: tile + 2-node rims
constexpr int PAN3 = PAN * PAN * PAN;

constexpr int WIN = TILE + 3;          // gather window side: nodes -2 .. TILE
constexpr int WIN3 = WIN * WIN * WIN;

// Staggered quadratic gather of one component (ops/cell3d.py::
// gather_cell_3d): taps {-1,0,1} on an integer axis, {-2..1} on a
// half-staggered one; the (y, z) pair product is hoisted out of the x loop.
// f: the component's nodes, (., nyp, nzp) strides of index type I (64-bit
// for the padded stack in device memory, int for a shared window).
template <typename T, typename I, bool HX, bool HY, bool HZ>
__device__ __forceinline__ T gather_comp(const T* __restrict__ f, I nyp,
                                         I nzp, int px, int py, int pz,
                                         const T (&gw)[3][3],
                                         const T (&hw)[3][4]) {
  T acc = T(0);
#pragma unroll
  for (int oy = HY ? -2 : -1; oy <= 1; ++oy) {
    T ty = HY ? hw[1][oy + 2] : gw[1][oy + 1];
#pragma unroll
    for (int oz = HZ ? -2 : -1; oz <= 1; ++oz) {
      T tz = HZ ? hw[2][oz + 2] : gw[2][oz + 1];
      T tyz = ty * tz;
#pragma unroll
      for (int ox = HX ? -2 : -1; ox <= 1; ++ox) {
        T tx = HX ? hw[0][ox + 2] : gw[0][ox + 1];
        acc = acc + (tx * tyz) * f[((px + ox) * nyp + (py + oy)) * nzp + (pz + oz)];
      }
    }
  }
  return acc;
}

// The six components (ex ey ez bx by bz) of E, B at cell-local deltas d,
// from component arrays eb + c * vol with strides (., nyp, nzp), the cell
// at node (px, py, pz).
template <typename T, typename I>
__device__ __forceinline__ void gather_six(const T* __restrict__ eb, I vol,
                                           I nyp, I nzp, int px, int py,
                                           int pz, const T (&d)[3], T* out) {
  T gw[3][3], hw[3][4];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int o = -1; o <= 1; ++o) gw[ax][o + 1] = m2(T(o) - d[ax]);
#pragma unroll
    for (int o = -2; o <= 1; ++o) hw[ax][o + 2] = m2(T(o + 0.5) - d[ax]);
  }
  out[0] = gather_comp<T, I, true, false, false>(eb + 0 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[1] = gather_comp<T, I, false, true, false>(eb + 1 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[2] = gather_comp<T, I, false, false, true>(eb + 2 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[3] = gather_comp<T, I, false, true, true>(eb + 3 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[4] = gather_comp<T, I, true, false, true>(eb + 4 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[5] = gather_comp<T, I, true, true, false>(eb + 5 * vol, nyp, nzp, px, py, pz, gw, hw);
}

// E, B of cell (ix, iy, iz) from the padded stack eb (6, nx+2g, ny+2g,
// nz+2g) in device memory (kernel B4).
template <typename T>
__device__ __forceinline__ void gather_eb(const T* __restrict__ eb, int nx,
                                          int ny, int nz, int g, int ix,
                                          int iy, int iz, const T (&d)[3],
                                          T* out) {
  const long long nyp = ny + 2 * g, nzp = nz + 2 * g;
  const long long vol = (long long)(nx + 2 * g) * nyp * nzp;
  gather_six<T, long long>(eb, vol, nyp, nzp, ix + g, iy + g, iz + g, d, out);
}

// E, B of a tile's cell (lx, ly, lz) from the tile's window in shared
// memory, (6, WIN, WIN, WIN) with node w at cell offset w - 2 (kernel B2).
template <typename T>
__device__ __forceinline__ void gather_eb_window(const T* win, int lx, int ly,
                                                 int lz, const T (&d)[3],
                                                 T* out) {
  gather_six<T, int>(win, WIN3, WIN, WIN, lx + 2, ly + 2, lz + 2, d, out);
}

// One axis's Esirkepov taps of one particle (ops/cell3d.py::
// deposit_offsets_3d, axis_taps): the old and new shapes over the offsets
// -2..2, their difference, a = S0 + DS/2, c = S0/2 + DS/3 and the running
// sum of DS.
template <typename T>
struct Taps {
  T s0[5], s1[5], ds[5], a[5], c[5], run[5];
};

template <typename T>
__device__ __forceinline__ void axis_taps(T d, T v, Taps<T>& t) {
  T d0 = d - T(0.5) * v, d1 = d + T(0.5) * v;
  const T third = T(1) / T(3);
  T acc = T(0);
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    t.s0[o] = m2(T(o - 2) - d0);
    t.s1[o] = m2(T(o - 2) - d1);
    t.ds[o] = t.s1[o] - t.s0[o];
    t.a[o] = t.s0[o] + T(0.5) * t.ds[o];
    t.c[o] = T(0.5) * t.s0[o] + t.ds[o] * third;
    acc = acc + t.ds[o];
    t.run[o] = acc;
  }
}

// Inputs of the tile deposit: the pushed slots of one species.
template <typename T>
struct DepositIn {
  const unsigned char* alive;   // null: every slot with w != 0 deposits
  const T *x, *y, *z, *ux, *uy, *uz, *ig, *w;
  const T* rims_in;             // null: panels start at 0
  T* rims_out;                  // (C, nbx, nby, nbz, PAN, PAN, PAN)
  int cap, nx, ny, nz, ncomp;
  long long ncell;
  T cd[3];                      // c dt / d per axis
  T kcd;                        // q / (dx dy dz)
  T kf[3];                      // q / (dy dz dt), q / (dx dz dt), q / (dx dy dt)
};

// One block per TILE^3 cell tile (blockDim (TILE, TILE, TILE) = (z, y, x),
// grid (nbz, nby, nbx), ncomp * PAN3 reals of shared memory), one thread
// per cell: the 5-tap Esirkepov J (and rho) into a shared (C, PAN, PAN,
// PAN) panel. Each thread takes its depositing particles one at a time;
// for one particle the 125 stencil offsets go one after another with a
// barrier between, and within one offset every thread writes a different
// panel node, so the sum needs no atomics and repeats bit for bit. The
// panel starts from rims_in (or 0) and is written to rims_out. Panel
// (bi, bj, bk) node (a, b, c) is the current at interior index
// (bi*TILE + a - 2, bj*TILE + b - 2, bk*TILE + c - 2).
template <typename T>
__device__ __forceinline__ void deposit_tile(const DepositIn<T>& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);       // (ncomp, PAN, PAN, PAN)
  const int lz = threadIdx.x, ly = threadIdx.y, lx = threadIdx.z;
  const int tid = (lx * TILE + ly) * TILE + lz;
  const int C = a.ncomp;
  const long long nblocks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long block =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int e = tid; e < C * PAN3; e += TILE * TILE * TILE) {
    int c = e / PAN3, r = e - c * PAN3;
    pan[e] = a.rims_in ? a.rims_in[((long long)c * nblocks + block) * PAN3 + r]
                       : T(0);
  }
  const int ix = blockIdx.z * TILE + lx, iy = blockIdx.y * TILE + ly,
            iz = blockIdx.x * TILE + lz;
  const bool valid = ix < a.nx && iy < a.ny && iz < a.nz;
  const long long cell = ((long long)ix * a.ny + iy) * a.nz + iz;
  const int node0 = (lx * PAN + ly) * PAN + lz;
  int sl = 0;
  while (true) {
    // this thread's next depositing particle; the block goes on while any
    // thread has one
    bool have = false;
    if (valid) {
      while (sl < a.cap) {
        long long idx = (long long)sl * a.ncell + cell;
        if (a.alive ? a.alive[idx] != 0 : a.w[idx] != T(0)) {
          have = true;
          break;
        }
        ++sl;
      }
    }
    if (!__syncthreads_or(have)) break;
    Taps<T> tx, ty, tz;
    T cd = T(0), nfx = T(0), nfy = T(0), nfz = T(0);
    if (have) {
      long long idx = (long long)sl * a.ncell + cell;
      T ig = a.ig[idx], w = a.w[idx];
      axis_taps(a.x[idx] - T(ix), (a.ux[idx] * ig) * a.cd[0], tx);
      axis_taps(a.y[idx] - T(iy), (a.uy[idx] * ig) * a.cd[1], ty);
      axis_taps(a.z[idx] - T(iz), (a.uz[idx] * ig) * a.cd[2], tz);
      cd = a.kcd * w;
      nfx = -(a.kf[0] * w);
      nfy = -(a.kf[1] * w);
      nfz = -(a.kf[2] * w);
    }
#pragma unroll
    for (int oy = 0; oy < 5; ++oy) {
#pragma unroll
      for (int oz = 0; oz < 5; ++oz) {
        T px = T(0), pr = T(0);
        if (have) {
          px = nfx * (ty.a[oy] * tz.s0[oz] + ty.c[oy] * tz.ds[oz]);
          pr = cd * (ty.s1[oy] * tz.s1[oz]);
        }
#pragma unroll
        for (int ox = 0; ox < 5; ++ox) {
          if (have) {
            T py = nfy * (tx.a[ox] * tz.s0[oz] + tx.c[ox] * tz.ds[oz]);
            T pz = nfz * (tx.a[ox] * ty.s0[oy] + tx.c[ox] * ty.ds[oy]);
            T* node = pan + node0 + (ox * PAN + oy) * PAN + oz;
            node[0] += tx.run[ox] * px;
            node[PAN3] += ty.run[oy] * py;
            node[2 * PAN3] += tz.run[oz] * pz;
            if (C == 4) node[3 * PAN3] += tx.s1[ox] * pr;
          }
          __syncthreads();
        }
      }
    }
    ++sl;
  }
  for (int e = tid; e < C * PAN3; e += TILE * TILE * TILE) {
    int c = e / PAN3, r = e - c * PAN3;
    a.rims_out[((long long)c * nblocks + block) * PAN3 + r] = pan[e];
  }
}

// One particle's 5-tap Esirkepov J (and with C == 4 rho) added into a
// shared (C, PAN, PAN, PAN) panel with atomics (kernel B2's tile kernel):
// the particle's cell sits at panel node node0 + (2, 2, 2); tx, ty, tz its
// axis taps, cd = q w / (dx dy dz), nf = -q w / (d d dt) per axis. Each
// term is deposit_tile's product; exact zeros (the offsets neither shape
// reaches) are not added.
template <typename T>
__device__ __forceinline__ void deposit_atomic(T* pan, int node0, int C,
                                               const Taps<T>& tx,
                                               const Taps<T>& ty,
                                               const Taps<T>& tz, T cd, T nfx,
                                               T nfy, T nfz) {
#pragma unroll
  for (int oy = 0; oy < 5; ++oy) {
#pragma unroll
    for (int oz = 0; oz < 5; ++oz) {
      T px = nfx * (ty.a[oy] * tz.s0[oz] + ty.c[oy] * tz.ds[oz]);
      T pr = cd * (ty.s1[oy] * tz.s1[oz]);
#pragma unroll
      for (int ox = 0; ox < 5; ++ox) {
        T py = nfy * (tx.a[ox] * tz.s0[oz] + tx.c[ox] * tz.ds[oz]);
        T pz = nfz * (tx.a[ox] * ty.s0[oy] + tx.c[ox] * ty.ds[oy]);
        T* node = pan + node0 + (ox * PAN + oy) * PAN + oz;
        T vx = tx.run[ox] * px, vy = ty.run[oy] * py, vz = tz.run[oz] * pz;
        if (vx != T(0)) atomicAdd(node, vx);
        if (vy != T(0)) atomicAdd(node + PAN3, vy);
        if (vz != T(0)) atomicAdd(node + 2 * PAN3, vz);
        if (C == 4) {
          T vr = tx.s1[ox] * pr;
          if (vr != T(0)) atomicAdd(node + 3 * PAN3, vr);
        }
      }
    }
  }
}

// One axis's taps over a window of four offsets lo .. lo + 3 (lo 0 or 1)
// outside which both shapes vanish exactly (ok; always so when the
// particle moves less than a cell a step), picked by selects so that they
// stay in registers.
template <typename T>
struct Win4 {
  T s0[4], s1[4], ds[4], a[4], c[4];
  int lo;
  bool ok;
};

template <typename T>
__device__ __forceinline__ void window4(const Taps<T>& t, Win4<T>& w) {
  const bool lo0 = t.s0[0] != T(0) || t.s1[0] != T(0);
  w.lo = lo0 ? 0 : 1;
  w.ok = !lo0 || (t.s0[4] == T(0) && t.s1[4] == T(0));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w.s0[k] = lo0 ? t.s0[k] : t.s0[k + 1];
    w.s1[k] = lo0 ? t.s1[k] : t.s1[k + 1];
    w.ds[k] = lo0 ? t.ds[k] : t.ds[k + 1];
    w.a[k] = lo0 ? t.a[k] : t.a[k + 1];
    w.c[k] = lo0 ? t.c[k] : t.c[k + 1];
  }
}

// deposit_atomic's terms over the windows only: a current component runs
// all five offsets of its own axis (its running sum may keep a rounding
// residue past the window) and the windows of the other two, rho the
// three windows. Every term it leaves out is an exact zero, so it adds
// the same nonzero terms: 240 nodes (304 with rho) in place of 375 (500).
template <typename T>
__device__ __forceinline__ void deposit_window(
    T* pan, int node0, int C, const Taps<T>& tx, const Taps<T>& ty,
    const Taps<T>& tz, const Win4<T>& wx, const Win4<T>& wy,
    const Win4<T>& wz, T cd, T nfx, T nfy, T nfz) {
  constexpr int SX = PAN * PAN, SY = PAN;
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
    for (int kz = 0; kz < 4; ++kz) {
      T px = nfx * (wy.a[ky] * wz.s0[kz] + wy.c[ky] * wz.ds[kz]);
      T* row = pan + node0 + (wy.lo + ky) * SY + (wz.lo + kz);
#pragma unroll
      for (int ox = 0; ox < 5; ++ox) {
        T v = tx.run[ox] * px;
        if (v != T(0)) atomicAdd(row + ox * SX, v);
      }
    }
  }
#pragma unroll
  for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
    for (int kz = 0; kz < 4; ++kz) {
      T py = nfy * (wx.a[kx] * wz.s0[kz] + wx.c[kx] * wz.ds[kz]);
      T* row = pan + PAN3 + node0 + (wx.lo + kx) * SX + (wz.lo + kz);
#pragma unroll
      for (int oy = 0; oy < 5; ++oy) {
        T v = ty.run[oy] * py;
        if (v != T(0)) atomicAdd(row + oy * SY, v);
      }
    }
  }
#pragma unroll
  for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      T pz = nfz * (wx.a[kx] * wy.s0[ky] + wx.c[kx] * wy.ds[ky]);
      T* row = pan + 2 * PAN3 + node0 + (wx.lo + kx) * SX + (wy.lo + ky) * SY;
#pragma unroll
      for (int oz = 0; oz < 5; ++oz) {
        T v = tz.run[oz] * pz;
        if (v != T(0)) atomicAdd(row + oz, v);
      }
    }
  }
  if (C == 4) {
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
      for (int kz = 0; kz < 4; ++kz) {
        T pr = cd * (wy.s1[ky] * wz.s1[kz]);
        T* row = pan + 3 * PAN3 + node0 + (wy.lo + ky) * SY + (wz.lo + kz);
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
          T v = wx.s1[kx] * pr;
          if (v != T(0)) atomicAdd(row + (wx.lo + kx) * SX, v);
        }
      }
    }
  }
}

// Dynamic shared memory of one deposit block; a float64 panel with rho is
// 55 KB, above the 48 KB a kernel gets without asking, so the launcher
// raises the kernel's limit first.
template <typename T>
inline size_t deposit_smem(int ncomp) { return sizeof(T) * ncomp * PAN3; }

}  // namespace lp3d
