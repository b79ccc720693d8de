// Device routines shared by the 3D cell-engine kernels: B2's tile kernel
// (cellstep3d.cu) and the per-stage push B4 (push3d.cu). The key, sort,
// merge count, half push and Boris are cell2d.cuh's, which every rank
// shares.
//
// Both kernels take one block per 8^3 tile of cells, copy the tile's E/B
// window (11^3 nodes of each component) into shared memory with cp.async
// (load_window) and gather from it with the same taps in the same order
// (gather_eb_window), so the two gather alike bit for bit. B2's deposit
// adds each particle's nonzero nodes into a shared panel with
// shared-memory atomics (deposit_window, or deposit_atomic for a particle
// that moved a cell or more): each contribution is the plain version's
// product and only exact zeros are left out, so only the order of the
// sums, and so their rounding, differs. The per-stage deposit B5
// (deposit3d.cu) shares none of this: it sums in registers.
//
// Layout: every per-slot array is (cap, nx, ny, nz), cell (ix, iy, iz) at
// (ix*ny + iy)*nz + iz, slot stride nx*ny*nz, 64-bit offsets. All of it is
// written as the plain PyTorch versions evaluate it and compiled with
// --fmad=false.
#pragma once

#include "cell2d.cuh"

namespace lp3d {

// tile (cells per side) of B2's tail and of B4; ops/cellslab.py's TILE3,
// held equal to this through lp_cell_tile() when B2's library is first
// used
constexpr int TILE = 8;
constexpr int TILE3 = TILE * TILE * TILE;
constexpr int PAN = TILE + 4;          // panel side: tile + 2-node rims
constexpr int PAN3 = PAN * PAN * PAN;

constexpr int WIN = TILE + 3;          // gather window side: nodes -2 .. TILE
constexpr int WIN3 = WIN * WIN * WIN;

// cp.async of one element and its commit and wait (cell2d.cuh)
using lp2d::copy_async;
using lp2d::copy_async_commit;
using lp2d::copy_async_wait;

// Start the copy of the E/B window of the tile whose first cell is
// (x0, y0, z0) from the padded stack eb (6, nx+2g, ny+2g, nz+2g), g >= 2,
// into win (6, WIN, WIN, WIN): window node (wx, wy, wz) is padded node
// (x0 + g - 2 + wx, ...). The block's nthreads threads share the copies
// (eb's rows of nz + 2g reals are not 16-byte aligned, so element by
// element, not TMA); the caller commits and waits. Nodes past the padded
// stack's end are left unset: only cells past the grid, which hold no
// slot, would read them.
template <typename T>
__device__ __forceinline__ void load_window(T* win, const T* __restrict__ eb,
                                            int nx, int ny, int nz, int g,
                                            int x0, int y0, int z0, int tid,
                                            int nthreads) {
  const int nxp = nx + 2 * g, nyp = ny + 2 * g, nzp = nz + 2 * g;
  const long long vol = (long long)nxp * nyp * nzp;
  for (int e = tid; e < 6 * WIN3; e += nthreads) {
    const int c = e / WIN3, r = e - c * WIN3;
    const int wx = r / (WIN * WIN), wy = (r / WIN) % WIN, wz = r % WIN;
    const int px = x0 + g - 2 + wx, py = y0 + g - 2 + wy,
              pz = z0 + g - 2 + wz;
    if (px < nxp && py < nyp && pz < nzp)
      copy_async(win + e, eb + c * vol + ((long long)px * nyp + py) * nzp + pz);
  }
}

// Staggered quadratic gather of one component (ops/cell3d.py::
// gather_cell_3d) from a window of it, (WIN, WIN, WIN): taps {-1,0,1} on
// an integer axis, {-2..1} on a half-staggered one; the (y, z) pair
// product is hoisted out of the x loop. (px, py, pz): the cell's node.
template <typename T, bool HX, bool HY, bool HZ>
__device__ __forceinline__ T gather_comp(const T* f, int px, int py, int pz,
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
        acc = acc + (tx * tyz) * f[((px + ox) * WIN + (py + oy)) * WIN + (pz + oz)];
      }
    }
  }
  return acc;
}

// E, B (ex ey ez bx by bz) of a tile's cell (lx, ly, lz) at cell-local
// deltas d, from the tile's window win (6, WIN, WIN, WIN) in shared
// memory, node w at cell offset w - 2.
template <typename T>
__device__ __forceinline__ void gather_eb_window(const T* win, int lx, int ly,
                                                 int lz, const T (&d)[3],
                                                 T* out) {
  T gw[3][3], hw[3][4];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int o = -1; o <= 1; ++o) gw[ax][o + 1] = m2(T(o) - d[ax]);
#pragma unroll
    for (int o = -2; o <= 1; ++o) hw[ax][o + 2] = m2(T(o + 0.5) - d[ax]);
  }
  const int px = lx + 2, py = ly + 2, pz = lz + 2;
  out[0] = gather_comp<T, true, false, false>(win + 0 * WIN3, px, py, pz, gw, hw);
  out[1] = gather_comp<T, false, true, false>(win + 1 * WIN3, px, py, pz, gw, hw);
  out[2] = gather_comp<T, false, false, true>(win + 2 * WIN3, px, py, pz, gw, hw);
  out[3] = gather_comp<T, false, true, true>(win + 3 * WIN3, px, py, pz, gw, hw);
  out[4] = gather_comp<T, true, false, true>(win + 4 * WIN3, px, py, pz, gw, hw);
  out[5] = gather_comp<T, true, true, false>(win + 5 * WIN3, px, py, pz, gw, hw);
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

// One particle's 5-tap Esirkepov J (and with C == 4 rho) added into a
// shared (C, PAN, PAN, PAN) panel with atomics (kernel B2's tile kernel):
// the particle's cell sits at panel node node0 + (2, 2, 2); tx, ty, tz its
// axis taps, cd = q w / (dx dy dz), nf = -q w / (d d dt) per axis. Each
// term is the plain version's product; exact zeros (the offsets neither shape
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

}  // namespace lp3d
