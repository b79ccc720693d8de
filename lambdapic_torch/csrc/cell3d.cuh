// Device routines shared by the 3D cell-engine kernels: B2's push and
// deposit (cellstep3d.cu) and the per-stage kernels B4 (push3d.cu) and B5
// (deposit3d.cu). One copy each, so the fused and the per-stage engines
// round alike. The key, sort, merge count, half push and Boris are
// cell2d.cuh's, which every rank shares.
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

// Staggered quadratic gather of one component (ops/cell3d.py::
// gather_cell_3d): taps {-1,0,1} on an integer axis, {-2..1} on a
// half-staggered one; the (y, z) pair product is hoisted out of the x loop.
template <typename T, bool HX, bool HY, bool HZ>
__device__ __forceinline__ T gather_comp(const T* __restrict__ f,
                                         long long nyp, long long nzp, int px,
                                         int py, int pz,
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

// The six components (ex ey ez bx by bz) of E, B at cell-local deltas d of
// cell (ix, iy, iz), from the padded stack eb (6, nx+2g, ny+2g, nz+2g).
template <typename T>
__device__ __forceinline__ void gather_eb(const T* __restrict__ eb, int nx,
                                          int ny, int nz, int g, int ix,
                                          int iy, int iz, const T (&d)[3],
                                          T* out) {
  T gw[3][3], hw[3][4];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int o = -1; o <= 1; ++o) gw[ax][o + 1] = m2(T(o) - d[ax]);
#pragma unroll
    for (int o = -2; o <= 1; ++o) hw[ax][o + 2] = m2(T(o + 0.5) - d[ax]);
  }
  const long long nyp = ny + 2 * g, nzp = nz + 2 * g;
  const long long vol = (long long)(nx + 2 * g) * nyp * nzp;
  const int px = ix + g, py = iy + g, pz = iz + g;
  out[0] = gather_comp<T, true, false, false>(eb + 0 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[1] = gather_comp<T, false, true, false>(eb + 1 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[2] = gather_comp<T, false, false, true>(eb + 2 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[3] = gather_comp<T, false, true, true>(eb + 3 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[4] = gather_comp<T, true, false, true>(eb + 4 * vol, nyp, nzp, px, py, pz, gw, hw);
  out[5] = gather_comp<T, true, true, false>(eb + 5 * vol, nyp, nzp, px, py, pz, gw, hw);
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

// Dynamic shared memory of one deposit block; a float64 panel with rho is
// 55 KB, above the 48 KB a kernel gets without asking, so the launcher
// raises the kernel's limit first.
template <typename T>
inline size_t deposit_smem(int ncomp) { return sizeof(T) * ncomp * PAN3; }

}  // namespace lp3d
