// Kernel B2 in 3D: the 3D cell-engine particle stage of one species,
// default mode.
//
// Replaces the 3D form of the TPU megakernel lambdapic_tpu/ops/cellslab.py::
// unified_cell_step (kernel body :663, pallas_call :1830; the third
// re-binning axis :104, the 3D gather :184, the 125-node deposit :1021).
// Plain PyTorch version: lambdapic_torch/ops/cellslab.py::cell_step_plain
// on 3D slots, i.e. push_position_3d -> migrate_cell_3d (x, then y, then z;
// Batcher order) -> gather_cell_3d -> boris_push -> push_position_3d ->
// deposit into tile panels.
//
// Layout: every per-slot array is (cap, nx, ny, nz), cell (ix, iy, iz) at
// (ix*ny + iy)*nz + iz, slot stride nx*ny*nz. All offsets are 64-bit. Five
// __global__ launches run in order (each re-binning pass must see the
// previous pass's result in all of a cell's neighbours, so a grid-wide
// barrier, the end of a launch, separates them):
//
//  rebin x   one thread per cell. It applies the first half push while
//            loading, builds the 5-way keys (donor+1 / dead-even / stay /
//            dead-odd / donor-1, dead parity from the slot index before the
//            sort) of its own column and its two x neighbours, sorts
//            (key, slot) pairs through the Batcher compare-exchange list of
//            cellpallas.py::_batcher_network (swap on a strict ka > kb; the
//            exchange decisions depend on the keys alone, so permuting the
//            payloads afterwards is bitwise the same), places arrivals by
//            overwrite with lo priority, merges collisions
//            weight-conservingly, adds the -+n coordinate adjust to wrapped
//            arrivals and drops them at open faces. input -> buffer A.
//  rebin y   the same along y, buffer A -> buffer B.
//  rebin z   the same along z, buffer B -> buffer A, zeroing dead slots.
//  push      one thread per slot, in place on buffer A: the staggered
//            quadratic gather from eb_pad (up to 4 x 4 x 3 taps a
//            component), Boris, and the second half push. Dead slots keep
//            their zeros and get inv_gamma 1; nothing downstream reads a
//            dead slot's payload.
//  deposit   one block per 8 x 8 x 8 cell tile, one thread per cell: 5-tap
//            Esirkepov J (and rho) into a shared (C, 12, 12, 12) panel.
//            Each thread takes its alive particles one at a time; for one
//            particle the 125 stencil offsets go one after another with a
//            barrier between, and within one offset every thread writes a
//            different panel node, so the sum needs no atomics and repeats
//            bit for bit. The panel starts from the previous species' panel
//            (rims_in) and is written to rims_out; kernel B3 (fold3d.cu)
//            overlap-adds the panels into the interior J.
//
// Compiled with --fmad=false: positions, keys and merges round exactly as
// the plain version's separate tensor operations do, so cell assignment
// and merge pairing match it slot for slot.
//
// Bound on an H100 (3.35 TB/s): bytes, counted as for the 2D kernel: the
// alive mask (1 B a slot); x, y, z, w, ux, uy, uz, inv_gamma, id_lo, id_hi
// of each alive slot; the E/B nodes the gather reaches from occupied
// cells; one write of every slot and of the panels. This first design
// moves several times that: three passes each read every slot of three
// columns and write every slot, the push reads and writes them again, and
// the deposit reads the alive ones once more.
#include "common.cuh"

namespace {

enum Ptr {
  P_EB,
  P_ALIVE, P_X, P_Y, P_Z, P_W, P_UX, P_UY, P_UZ, P_IG, P_IDLO, P_IDHI,
  P_A_ALIVE, P_A_X, P_A_Y, P_A_Z, P_A_W, P_A_UX, P_A_UY, P_A_UZ, P_A_IG,
  P_A_IDLO, P_A_IDHI,
  P_B_ALIVE, P_B_X, P_B_Y, P_B_Z, P_B_W, P_B_UX, P_B_UY, P_B_UZ, P_B_IDLO,
  P_B_IDHI,
  P_RIMS_IN, P_RIMS_OUT, P_NMERGED, P_CES, P_COUNT
};
enum Int {
  I_CAP, I_NX, I_NY, I_NZ, I_G, I_PERX, I_PERY, I_PERZ, I_NCOMP, I_NCES,
  I_DOUBLE
};
// reals are computed on the host exactly as the plain version computes
// its scalar factors (in double), then rounded to the kernel's type
enum Real {
  R_HX, R_HY, R_HZ,     // c dt / d / 2 per axis: position half push
  R_EF, R_BF,           // q dt / (2 m c), q dt / (2 m): Boris
  R_CDX, R_CDY, R_CDZ,  // c dt / d per axis
  R_KCD,                // q / (dx dy dz)
  R_KFX, R_KFY, R_KFZ   // q / (dy dz dt), q / (dx dz dt), q / (dx dy dt)
};

// deposit tile (cells per side); ops/cellslab.py's TILE3, held equal to
// this through lp_cell_tile() when the library is first used
constexpr int TILE = 8;
constexpr int PAN = TILE + 4;          // panel side: tile + 2-node rims
constexpr int PAN3 = PAN * PAN * PAN;
constexpr int NF = 7;                  // float payloads: x y z w ux uy uz
enum F { FX, FY, FZ, FW, FUX, FUY, FUZ };

template <typename T>
struct SlotsIn {
  const unsigned char* alive;
  const T* f[NF];
  const int* id[2];
};

template <typename T>
struct SlotsOut {
  unsigned char* alive;
  T* f[NF];
  int* id[2];
};

template <typename T>
struct Args {
  const T* eb;
  const T* ig;          // stored inv_gamma of the input slots
  T* ig_out;
  const T* rims_in;
  T* rims_out;
  unsigned long long* n_merged;
  const int* ces;
  int cap, nx, ny, nz, g, per[3], ncomp, nces;
  long long ncell;
  T h[3], ef, bf, cd[3], kcd, kf[3];   // see enum Real
};

// The merge's weight floor: 1e-30 in float32, 1e-300 in float64.
template <typename T> struct WFloor;
template <> struct WFloor<float> { static __device__ float v() { return 1e-30f; } };
template <> struct WFloor<double> { static __device__ double v() { return 1e-300; } };

// One slot's carried values.
template <typename T>
struct Slot {
  T f[NF];
  int id[2];
};

// Sort packed (key << 8 | slot) entries with the compare-exchange list.
__device__ __forceinline__ void net_sort(int* k, const int* __restrict__ ces,
                                         int nces) {
  for (int e = 0; e < nces; ++e) {
    int a = __ldg(ces + 2 * e), b = __ldg(ces + 2 * e + 1);
    int ka = k[a], kb = k[b];
    if ((ka >> 8) > (kb >> 8)) {
      k[a] = kb;
      k[b] = ka;
    }
  }
}

__device__ __forceinline__ int five_way(bool alive, bool out_hi, bool out_lo,
                                        int s) {
  if (out_hi) return 0;
  if (out_lo) return 4;
  if (alive) return 2;
  return (s & 1) == 0 ? 1 : 3;
}

template <typename T>
__device__ __forceinline__ T pushed(T pos, T u, T ig, T h) {
  return pos + (u * ig) * h;
}

// A source slot; the x pass reads the stored slots and applies the first
// half push along all three axes.
template <typename T>
__device__ void load(const Args<T>& a, const SlotsIn<T>& s, long long idx,
                     bool first, Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = s.f[k][idx];
  if (first) {
    T ig = a.ig[idx];
    v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.h[0]);
    v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.h[1]);
    v.f[FZ] = pushed(v.f[FZ], v.f[FUZ], ig, a.h[2]);
  }
  v.id[0] = s.id[0][idx];
  v.id[1] = s.id[1][idx];
}

// Shift a wrapped arrival's coordinate along the pass's axis.
template <typename T>
__device__ __forceinline__ void adjust(Slot<T>& v, int axis, T by) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k == axis) v.f[FX + k] = v.f[FX + k] + by;
}

// Placement and merge of one receiver slot (ops/cell2d.py::migrate_cells):
// lo arrival first, then hi arrival, then the resident stay; two or three
// sources merge (w summed, coordinates and momenta weight-averaged).
template <typename T>
__device__ void place(bool vlo, bool vhi, bool stay, const Slot<T>& lo,
                      const Slot<T>& hi, const Slot<T>& own, Slot<T>& out,
                      int& merges) {
  int n_src = (int)vlo + (int)vhi + (int)stay;
  merges += n_src > 1 ? n_src - 1 : 0;
  const Slot<T>& placed = vlo ? lo : (vhi ? hi : own);
  out = placed;
  if (n_src >= 2) {
    const T zero = T(0);
    T w_lo = vlo ? lo.f[FW] : zero;
    T w_hi = vhi ? hi.f[FW] : zero;
    T w_res = stay ? own.f[FW] : zero;
    T wsum = (w_lo + w_hi) + w_res;
    const T floor_ = WFloor<T>::v();
    T wsafe = wsum > floor_ ? wsum : floor_;
    const int merged[6] = {FX, FY, FZ, FUX, FUY, FUZ};
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      int k = merged[t];
      T vl = vlo ? lo.f[k] : zero;
      T vh = vhi ? hi.f[k] : zero;
      out.f[k] = ((w_lo * vl + w_hi * vh) + w_res * own.f[k]) / wsafe;
    }
    out.f[FW] = wsum;
  }
}

template <typename T>
__device__ void store(const SlotsOut<T>& o, long long idx, const Slot<T>& v,
                      bool alive) {
  o.alive[idx] = alive ? 1 : 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) o.f[k][idx] = v.f[k];
  o.id[0][idx] = v.id[0];
  o.id[1][idx] = v.id[1];
}

__device__ void add_merges(unsigned long long* counter, int merges) {
  unsigned mask = __activemask();
  int total = merges;
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(mask, total, off);
  int lane = threadIdx.x & 31;
  // after the reduction lane 0 of a full warp holds the sum; a partial
  // warp adds one atomic per thread instead
  if (mask == 0xffffffffu) {
    if (lane == 0 && total) atomicAdd(counter, (unsigned long long)total);
  } else if (merges) {
    atomicAdd(counter, (unsigned long long)merges);
  }
}

// One re-binning pass along ``axis`` (0 x, 1 y, 2 z) from src to dst.
template <typename T, int MAXC>
__global__ void __launch_bounds__(128) rebin(Args<T> a, SlotsIn<T> src,
                                             SlotsOut<T> dst, int axis) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int merges = 0;
  if (cell < a.ncell) {
    const long long plane = (long long)a.ny * a.nz;
    int ix = (int)(cell / plane);
    int rem = (int)(cell - (long long)ix * plane);
    int iy = rem / a.nz, iz = rem - iy * a.nz;
    const bool first = axis == 0, last = axis == 2;
    const int i = axis == 0 ? ix : (axis == 1 ? iy : iz);
    const int n = axis == 0 ? a.nx : (axis == 1 ? a.ny : a.nz);
    const long long stride = axis == 0 ? plane : (axis == 1 ? a.nz : 1);
    const int ci[3] = {i > 0 ? i - 1 : n - 1, i, i < n - 1 ? i + 1 : 0};
    const long long nb[3] = {cell + (long long)(ci[0] - i) * stride, cell,
                             cell + (long long)(ci[2] - i) * stride};
    const T* pos = src.f[FX + axis];
    const T* mom = src.f[FUX + axis];
    const T h = a.h[axis];
    int k[3][MAXC];
    for (int c3 = 0; c3 < 3; ++c3) {
      T xi = T(ci[c3]);
      for (int s = 0; s < a.cap; ++s) {
        long long idx = nb[c3] + s * a.ncell;
        bool al = src.alive[idx] != 0;
        T p = first ? pushed(pos[idx], mom[idx], a.ig[idx], h) : pos[idx];
        T local = p - xi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3][s] = (five_way(al, hi, lo, s) << 8) | s;
      }
      net_sort(k[c3], a.ces, a.nces);
    }
    const bool per = a.per[axis] != 0;
    bool lo_ok = per || i != 0;
    bool hi_ok = per || i != n - 1;
    for (int p = 0; p < a.cap; ++p) {
      bool vlo = lo_ok && (k[0][p] >> 8) == 0;
      bool vhi = hi_ok && (k[2][p] >> 8) == 4;
      bool stay = (k[1][p] >> 8) == 2;
      Slot<T> own, lo, hi, out;
      load(a, src, (long long)(k[1][p] & 255) * a.ncell + cell, first, own);
      if (vlo) {
        load(a, src, (long long)(k[0][p] & 255) * a.ncell + nb[0], first, lo);
        if (i == 0) adjust(lo, axis, T(-n));
      }
      if (vhi) {
        load(a, src, (long long)(k[2][p] & 255) * a.ncell + nb[2], first, hi);
        if (i == n - 1) adjust(hi, axis, T(n));
      }
      place(vlo, vhi, stay, lo, hi, own, out, merges);
      bool al = vlo || vhi || stay;
      if (last && !al) {
#pragma unroll
        for (int t = 0; t < NF; ++t) out.f[t] = T(0);
      }
      store(dst, (long long)p * a.ncell + cell, out, al);
    }
  }
  add_merges(a.n_merged, merges);
}

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

// Gather + Boris + second half push of every alive slot, in place.
template <typename T>
__global__ void __launch_bounds__(256) push(Args<T> a, SlotsOut<T> s) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.cap * a.ncell) return;
  if (!s.alive[idx]) {
    a.ig_out[idx] = T(1);
    return;
  }
  long long cell = idx % a.ncell;
  const long long plane = (long long)a.ny * a.nz;
  int ix = (int)(cell / plane);
  int rem = (int)(cell - (long long)ix * plane);
  int iy = rem / a.nz, iz = rem - iy * a.nz;
  T x = s.f[FX][idx], y = s.f[FY][idx], z = s.f[FZ][idx];
  const T d[3] = {x - T(ix), y - T(iy), z - T(iz)};
  T gw[3][3], hw[3][4];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int o = -1; o <= 1; ++o) gw[ax][o + 1] = m2(T(o) - d[ax]);
#pragma unroll
    for (int o = -2; o <= 1; ++o) hw[ax][o + 2] = m2(T(o + 0.5) - d[ax]);
  }
  const long long nyp = a.ny + 2 * a.g, nzp = a.nz + 2 * a.g;
  const long long vol = (long long)(a.nx + 2 * a.g) * nyp * nzp;
  const int px = ix + a.g, py = iy + a.g, pz = iz + a.g;
  T e_x = gather_comp<T, true, false, false>(a.eb + 0 * vol, nyp, nzp, px, py, pz, gw, hw);
  T e_y = gather_comp<T, false, true, false>(a.eb + 1 * vol, nyp, nzp, px, py, pz, gw, hw);
  T e_z = gather_comp<T, false, false, true>(a.eb + 2 * vol, nyp, nzp, px, py, pz, gw, hw);
  T b_x = gather_comp<T, false, true, true>(a.eb + 3 * vol, nyp, nzp, px, py, pz, gw, hw);
  T b_y = gather_comp<T, true, false, true>(a.eb + 4 * vol, nyp, nzp, px, py, pz, gw, hw);
  T b_z = gather_comp<T, true, true, false>(a.eb + 5 * vol, nyp, nzp, px, py, pz, gw, hw);
  // Boris (ops/pusher.py::boris_push)
  const T ef = a.ef, bfac = a.bf;
  T um_x = s.f[FUX][idx] + ef * e_x;
  T um_y = s.f[FUY][idx] + ef * e_y;
  T um_z = s.f[FUZ][idx] + ef * e_z;
  T igm = T(1) / sqrt(((T(1) + um_x * um_x) + um_y * um_y) + um_z * um_z);
  T tx = (bfac * b_x) * igm;
  T ty = (bfac * b_y) * igm;
  T tz = (bfac * b_z) * igm;
  T up_x = (um_x + um_y * tz) - um_z * ty;
  T up_y = (um_y + um_z * tx) - um_x * tz;
  T up_z = (um_z + um_x * ty) - um_y * tx;
  T tfac = T(2) * (T(1) / (((T(1) + tx * tx) + ty * ty) + tz * tz));
  T sx = tfac * tx, sy = tfac * ty, sz = tfac * tz;
  T ux = ((um_x + up_y * sz) - up_z * sy) + ef * e_x;
  T uy = ((um_y + up_z * sx) - up_x * sz) + ef * e_y;
  T uz = ((um_z + up_x * sy) - up_y * sx) + ef * e_z;
  T ig = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
  s.f[FUX][idx] = ux;
  s.f[FUY][idx] = uy;
  s.f[FUZ][idx] = uz;
  s.f[FX][idx] = pushed(x, ux, ig, a.h[0]);
  s.f[FY][idx] = pushed(y, uy, ig, a.h[1]);
  s.f[FZ][idx] = pushed(z, uz, ig, a.h[2]);
  a.ig_out[idx] = ig;
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

template <typename T>
__global__ void __launch_bounds__(TILE * TILE * TILE)
    deposit(Args<T> a, SlotsIn<T> s) {
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
    // this thread's next alive particle; the block goes on while any
    // thread has one
    bool have = false;
    if (valid) {
      while (sl < a.cap) {
        if (s.alive[(long long)sl * a.ncell + cell]) {
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
      T ig = a.ig_out[idx], w = s.f[FW][idx];
      axis_taps(s.f[FX][idx] - T(ix), (s.f[FUX][idx] * ig) * a.cd[0], tx);
      axis_taps(s.f[FY][idx] - T(iy), (s.f[FUY][idx] * ig) * a.cd[1], ty);
      axis_taps(s.f[FZ][idx] - T(iz), (s.f[FUZ][idx] * ig) * a.cd[2], tz);
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

template <typename T>
void unpack_in(SlotsIn<T>& s, void** p, int alive, int first, int id0) {
  s.alive = (const unsigned char*)p[alive];
  for (int k = 0; k < NF; ++k) s.f[k] = (const T*)p[first + k];
  s.id[0] = (const int*)p[id0];
  s.id[1] = (const int*)p[id0 + 1];
}

template <typename T>
void unpack_out(SlotsOut<T>& s, void** p, int alive, int first, int id0) {
  s.alive = (unsigned char*)p[alive];
  for (int k = 0; k < NF; ++k) s.f[k] = (T*)p[first + k];
  s.id[0] = (int*)p[id0];
  s.id[1] = (int*)p[id0 + 1];
}

template <typename T>
struct Buffers {
  SlotsIn<T> in, a_in, b_in;
  SlotsOut<T> a_out, b_out;
};

template <typename T, int MAXC>
int launch_passes(const Args<T>& a, const Buffers<T>& b, cudaStream_t st) {
  int threads = 128;
  int blocks = ceil_div(a.ncell, threads);
  rebin<T, MAXC><<<blocks, threads, 0, st>>>(a, b.in, b.a_out, 0);
  int err = (int)cudaGetLastError();
  if (err) return err;
  rebin<T, MAXC><<<blocks, threads, 0, st>>>(a, b.a_in, b.b_out, 1);
  err = (int)cudaGetLastError();
  if (err) return err;
  rebin<T, MAXC><<<blocks, threads, 0, st>>>(a, b.b_in, b.a_out, 2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  Buffers<T> b;
  a.eb = (const T*)p[P_EB];
  unpack_in(b.in, p, P_ALIVE, P_X, P_IDLO);
  a.ig = (const T*)p[P_IG];
  unpack_out(b.a_out, p, P_A_ALIVE, P_A_X, P_A_IDLO);
  unpack_in(b.a_in, p, P_A_ALIVE, P_A_X, P_A_IDLO);
  a.ig_out = (T*)p[P_A_IG];
  unpack_out(b.b_out, p, P_B_ALIVE, P_B_X, P_B_IDLO);
  unpack_in(b.b_in, p, P_B_ALIVE, P_B_X, P_B_IDLO);
  a.rims_in = (const T*)p[P_RIMS_IN];
  a.rims_out = (T*)p[P_RIMS_OUT];
  a.n_merged = (unsigned long long*)p[P_NMERGED];
  a.ces = (const int*)p[P_CES];
  a.cap = (int)n[I_CAP];
  a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY]; a.nz = (int)n[I_NZ];
  a.g = (int)n[I_G];
  a.per[0] = (int)n[I_PERX]; a.per[1] = (int)n[I_PERY];
  a.per[2] = (int)n[I_PERZ];
  a.ncomp = (int)n[I_NCOMP]; a.nces = (int)n[I_NCES];
  a.ncell = (long long)a.nx * a.ny * a.nz;
  a.h[0] = (T)r[R_HX]; a.h[1] = (T)r[R_HY]; a.h[2] = (T)r[R_HZ];
  a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  a.cd[0] = (T)r[R_CDX]; a.cd[1] = (T)r[R_CDY]; a.cd[2] = (T)r[R_CDZ];
  a.kcd = (T)r[R_KCD];
  a.kf[0] = (T)r[R_KFX]; a.kf[1] = (T)r[R_KFY]; a.kf[2] = (T)r[R_KFZ];
  int err;
  if (a.cap <= 8) err = launch_passes<T, 8>(a, b, st);
  else if (a.cap <= 16) err = launch_passes<T, 16>(a, b, st);
  else if (a.cap <= 32) err = launch_passes<T, 32>(a, b, st);
  else if (a.cap <= 64) err = launch_passes<T, 64>(a, b, st);
  else if (a.cap <= 128) err = launch_passes<T, 128>(a, b, st);
  else return (int)cudaErrorInvalidValue;
  if (err) return err;
  int threads = 256;
  push<T><<<ceil_div((long long)a.cap * a.ncell, threads), threads, 0, st>>>(
      a, b.a_out);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 block(TILE, TILE, TILE);
  dim3 grid(ceil_div(a.nz, TILE), ceil_div(a.ny, TILE), ceil_div(a.nx, TILE));
  size_t smem = sizeof(T) * a.ncomp * PAN3;
  // a float64 panel with rho is 55 KB, above the 48 KB a kernel gets
  // without asking
  err = (int)cudaFuncSetAttribute(deposit<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  deposit<T><<<grid, block, smem, st>>>(a, b.a_in);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_cell_step_3d(void** ptrs, const long long* ints,
                              const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}

LP_EXPORT int lp_cell_tile() { return TILE; }
