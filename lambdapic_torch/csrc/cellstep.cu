// Kernel B2: the 2D cell-engine particle stage of one species, in its
// default, want_chi and photon modes.
//
// Replaces the TPU megakernel lambdapic_tpu/ops/cellslab.py::
// unified_cell_step (kernel body :663, pallas_call :1830, driven by
// slab_species_step :1852). Plain PyTorch version: lambdapic_torch/ops/
// cellslab.py::cell_step_plain, i.e. push_position_2d -> migrate_cells
// (x, then y; Batcher order) -> gather_cell_2d -> boris_push ->
// push_position_2d -> deposit into tile panels.
//
// Layout: every per-slot array is (cap, nx, ny), cell (ix, iy) at
// ix*ny + iy, slot stride nx*ny. Three __global__ functions run in order:
//
//  pass_x    one thread per cell. It recomputes the first half push for
//            its own column and its two x neighbours, builds each
//            column's 5-way keys (donor+1 / dead-even / stay / dead-odd /
//            donor-1, dead parity from the slot index before the sort),
//            sorts (key, slot) pairs through the Batcher compare-exchange
//            list of cellpallas.py::_batcher_network (swap on a strict
//            ka > kb; the exchange decisions depend on the keys alone, so
//            permuting the payloads afterwards is bitwise the same), then
//            places arrivals by overwrite with lo priority, merges
//            collisions weight-conservingly, adds the -+nx coordinate
//            adjust to wrapped arrivals and drops them at open edges.
//            Output goes to scratch arrays.
//  pass_y    the same along y over the scratch arrays, then in registers:
//            dead-slot zeroing, the staggered quadratic gather from eb_pad,
//            Boris, and the second half push; writes the final slots.
//  deposit   one block per 16 x 16 cell tile: 5-tap Esirkepov J (and rho)
//            of every alive slot into a shared (C, 20, 20) tile panel. The
//            25 stencil offsets go one after another with a barrier
//            between, and within one offset every thread writes a
//            different panel node, so the sum needs no atomics and repeats
//            bit for bit. The panel starts from the previous species'
//            panel (rims_in) and is written to rims_out; kernel B3
//            (fold.cu) overlap-adds the panels into the interior J.
//
// Modes (the int I_MODE):
//  default   as above.
//  want_chi  pass_y also writes, between the gather and Boris, the
//            post-migration pre-push ig0 = 1/sqrt(1 + u^2) and the quantum
//            parameter chi (models/qed.py::calculate_chi of the gathered
//            E, B, the momenta and ig0) of every slot; the caller masks
//            chi with alive. Replaces unified_cell_step's want_chi branch
//            (cellslab.py:1094-1109).
//  photon    field free (q = m = 0): pass_y's tail is inv_gamma = 1/|u|
//            (1 where u = 0) and the second half push; no gather, no
//            Boris, no deposit launch, no panels. Replaces the photon
//            branch (cellslab.py:966-986).
// Extra payloads: up to NXF float arrays (a QED species' tau, delta,
// event) ride through both passes. On a collision they take the placed
// slot's value (lo arrival, else hi arrival, else the resident); only
// w, x, y, z, ux, uy, uz are merged. Dead slots keep them as placed.
//
// Compiled with --fmad=false: positions, keys and merges round exactly as
// the plain version's separate tensor operations do, so cell assignment
// and merge pairing match it slot for slot.
//
// Bound on an H100 (3.35 TB/s): bytes. The answer depends on the alive
// mask and on the payloads of alive slots only (a dead slot is never a
// source and leaves zeroed), so the least traffic is: the mask (1 B a
// slot); x, y, z, w, ux, uy, uz, inv_gamma, id_lo, id_hi of each alive
// slot; the E/B nodes the gather reaches from occupied cells; one write
// of every slot (41 B in float32) and of the panels. chip_smoke.py
// computes it from its input. This first design moves far more: every
// pass reads every slot, dead or alive, of all three columns it sorts,
// and the scratch round trip between the passes and the deposit's re-read
// of the final slots come on top. Skipping empty cells and fusing the
// passes is later work.
#include "common.cuh"

namespace {

enum Ptr {
  P_EB,
  P_ALIVE, P_X, P_Y, P_Z, P_W, P_UX, P_UY, P_UZ, P_IG, P_IDLO, P_IDHI,
  P_S_ALIVE, P_S_X, P_S_Y, P_S_Z, P_S_W, P_S_UX, P_S_UY, P_S_UZ, P_S_IDLO,
  P_S_IDHI,
  P_O_ALIVE, P_O_X, P_O_Y, P_O_Z, P_O_W, P_O_UX, P_O_UY, P_O_UZ, P_O_IG,
  P_O_IDLO, P_O_IDHI,
  P_RIMS_IN, P_RIMS_OUT, P_NMERGED, P_CES,
  P_CHI, P_IG0,                     // want_chi outputs
  P_XF_IN, P_XF_S = P_XF_IN + 3, P_XF_O = P_XF_S + 3,  // extra payloads
  P_COUNT = P_XF_O + 3
};
enum Int { I_CAP, I_NX, I_NY, I_G, I_PERX, I_PERY, I_NCOMP, I_NCES, I_DOUBLE,
           I_MODE, I_NXF };
enum Mode { M_DEFAULT = 0, M_WANT_CHI = 1, M_PHOTON = 2 };
// reals are computed on the host exactly as the plain version computes
// its scalar factors (in double), then rounded to the kernel's type
enum Real {
  R_HX, R_HY,       // c dt / dx / 2, c dt / dy / 2: position half push
  R_EF, R_BF,       // q dt / (2 m c), q dt / (2 m): Boris
  R_CDX, R_CDY,     // c dt / dx, c dt / dy
  R_C,              // c
  R_KCD, R_KFX, R_KFY, // q / (dx dy), q / (dy dt), q / (dx dt)
  R_CHI             // e hbar / (m_e^2 c^3)
};

// deposit tile (cells per side); ops/cellslab.py's TILE, held equal to
// this through lp_cell_tile() when the library is first used
constexpr int TILE = 16;
constexpr int PAN = TILE + 4;      // panel side: tile + 2-node rims
constexpr int NF = 7;              // float payloads: x y z w ux uy uz
constexpr int NXF = 3;             // most extra float payloads
enum F { FX, FY, FZ, FW, FUX, FUY, FUZ };

template <typename T>
struct SlotsIn {
  const unsigned char* alive;
  const T* f[NF];
  const int* id[2];
  const T* xf[NXF];
};

template <typename T>
struct SlotsOut {
  unsigned char* alive;
  T* f[NF];
  int* id[2];
  T* xf[NXF];
};

template <typename T>
struct Args {
  const T* eb;
  SlotsIn<T> in;
  const T* ig;
  SlotsOut<T> s;        // scratch, written by pass_x
  SlotsIn<T> sin;       // the same scratch, read by pass_y
  SlotsOut<T> out;
  T* ig_out;
  const T* rims_in;
  T* rims_out;
  unsigned long long* n_merged;
  const int* ces;
  T* chi_out;           // want_chi
  T* ig0_out;
  int cap, nx, ny, g, perx, pery, ncomp, nces, mode, nxf;
  long long ncell;
  T hx, hy, ef, bf, cdx, cdy, c, kcd, kfx, kfy, chi;   // see enum Real
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
  T xf[NXF];
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

// x pass: the stored slots after the first half push
template <typename T>
__device__ __forceinline__ T pushed(T pos, T u, T ig, T h) {
  return pos + (u * ig) * h;
}

template <typename T>
__device__ void load_x(const Args<T>& a, long long idx, Slot<T>& v) {
  T ig = a.ig[idx];
  v.f[FX] = pushed(a.in.f[FX][idx], a.in.f[FUX][idx], ig, a.hx);
  v.f[FY] = pushed(a.in.f[FY][idx], a.in.f[FUY][idx], ig, a.hy);
  v.f[FZ] = a.in.f[FZ][idx];
  v.f[FW] = a.in.f[FW][idx];
  v.f[FUX] = a.in.f[FUX][idx];
  v.f[FUY] = a.in.f[FUY][idx];
  v.f[FUZ] = a.in.f[FUZ][idx];
  v.id[0] = a.in.id[0][idx];
  v.id[1] = a.in.id[1][idx];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) v.xf[k] = a.in.xf[k][idx];
}

template <typename T>
__device__ void load_y(const Args<T>& a, long long idx, Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = a.sin.f[k][idx];
  v.id[0] = a.sin.id[0][idx];
  v.id[1] = a.sin.id[1][idx];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) v.xf[k] = a.sin.xf[k][idx];
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
                      bool alive, int nxf) {
  o.alive[idx] = alive ? 1 : 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) o.f[k][idx] = v.f[k];
  o.id[0][idx] = v.id[0];
  o.id[1][idx] = v.id[1];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < nxf) o.xf[k][idx] = v.xf[k];
}

__device__ void add_merges(unsigned long long* counter, int merges) {
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

template <typename T, int MAXC>
__global__ void __launch_bounds__(128) pass_x(Args<T> a) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = cell < a.ncell;
  int merges = 0;
  if (active) {
    int ix = (int)(cell / a.ny), iy = (int)(cell % a.ny);
    int cols[3] = {ix > 0 ? ix - 1 : a.nx - 1, ix, ix < a.nx - 1 ? ix + 1 : 0};
    int k[3][MAXC];
    for (int c3 = 0; c3 < 3; ++c3) {
      long long base = (long long)cols[c3] * a.ny + iy;
      T xi = T(cols[c3]);
      for (int s = 0; s < a.cap; ++s) {
        long long idx = base + s * a.ncell;
        bool al = a.in.alive[idx] != 0;
        T local = pushed(a.in.f[FX][idx], a.in.f[FUX][idx], a.ig[idx], a.hx) - xi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3][s] = (five_way(al, hi, lo, s) << 8) | s;
      }
      net_sort(k[c3], a.ces, a.nces);
    }
    bool lo_ok = a.perx || ix != 0;
    bool hi_ok = a.perx || ix != a.nx - 1;
    for (int p = 0; p < a.cap; ++p) {
      bool vlo = lo_ok && (k[0][p] >> 8) == 0;
      bool vhi = hi_ok && (k[2][p] >> 8) == 4;
      bool stay = (k[1][p] >> 8) == 2;
      Slot<T> own, lo, hi, out;
      load_x(a, (long long)(k[1][p] & 255) * a.ncell + cell, own);
      if (vlo) {
        load_x(a, (long long)(k[0][p] & 255) * a.ncell +
                      (long long)cols[0] * a.ny + iy, lo);
        if (ix == 0) lo.f[FX] = lo.f[FX] + T(-a.nx);
      }
      if (vhi) {
        load_x(a, (long long)(k[2][p] & 255) * a.ncell +
                      (long long)cols[2] * a.ny + iy, hi);
        if (ix == a.nx - 1) hi.f[FX] = hi.f[FX] + T(a.nx);
      }
      place(vlo, vhi, stay, lo, hi, own, out, merges);
      store(a.s, (long long)p * a.ncell + cell, out, vlo || vhi || stay,
            a.nxf);
    }
  }
  add_merges(a.n_merged, merges);
}

// Staggered quadratic gather of one component (ops/cell2d.py::
// gather_cell_2d): x taps {-1,0,1} (integer) or {-2..1} (half), same in y.
template <typename T>
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
      acc = acc + (tx * ty) * f[(long long)(px + ox) * nyp + (py + oy)];
    }
  }
  return acc;
}

template <typename T, int MAXC>
__global__ void __launch_bounds__(128) pass_y(Args<T> a) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = cell < a.ncell;
  int merges = 0;
  if (active) {
    int ix = (int)(cell / a.ny), iy = (int)(cell % a.ny);
    int rows[3] = {iy > 0 ? iy - 1 : a.ny - 1, iy, iy < a.ny - 1 ? iy + 1 : 0};
    int k[3][MAXC];
    for (int c3 = 0; c3 < 3; ++c3) {
      long long base = (long long)ix * a.ny + rows[c3];
      T yi = T(rows[c3]);
      for (int s = 0; s < a.cap; ++s) {
        long long idx = base + s * a.ncell;
        bool al = a.sin.alive[idx] != 0;
        T local = a.sin.f[FY][idx] - yi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3][s] = (five_way(al, hi, lo, s) << 8) | s;
      }
      net_sort(k[c3], a.ces, a.nces);
    }
    bool lo_ok = a.pery || iy != 0;
    bool hi_ok = a.pery || iy != a.ny - 1;
    const int nxp = a.nx + 2 * a.g, nyp = a.ny + 2 * a.g;
    const long long plane = (long long)nxp * nyp;
    const int px = ix + a.g, py = iy + a.g;
    for (int p = 0; p < a.cap; ++p) {
      bool vlo = lo_ok && (k[0][p] >> 8) == 0;
      bool vhi = hi_ok && (k[2][p] >> 8) == 4;
      bool stay = (k[1][p] >> 8) == 2;
      Slot<T> own, lo, hi, v;
      load_y(a, (long long)(k[1][p] & 255) * a.ncell + cell, own);
      if (vlo) {
        load_y(a, (long long)(k[0][p] & 255) * a.ncell +
                      (long long)ix * a.ny + rows[0], lo);
        if (iy == 0) lo.f[FY] = lo.f[FY] + T(-a.ny);
      }
      if (vhi) {
        load_y(a, (long long)(k[2][p] & 255) * a.ncell +
                      (long long)ix * a.ny + rows[2], hi);
        if (iy == a.ny - 1) hi.f[FY] = hi.f[FY] + T(a.ny);
      }
      place(vlo, vhi, stay, lo, hi, own, v, merges);
      bool al = vlo || vhi || stay;
      if (!al) {
#pragma unroll
        for (int t = 0; t < NF; ++t) v.f[t] = T(0);
      }
      long long o = (long long)p * a.ncell + cell;
      if (a.mode == M_PHOTON) {
        // field-free photon tail (ops/pusher.py::photon_push)
        T u2 = (v.f[FUX] * v.f[FUX] + v.f[FUY] * v.f[FUY]) + v.f[FUZ] * v.f[FUZ];
        const T tiny = T(1e-30);
        T ig = u2 > T(0) ? T(1) / sqrt(u2 > tiny ? u2 : tiny) : T(1);
        v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.hx);
        v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.hy);
        store(a.out, o, v, al, a.nxf);
        a.ig_out[o] = ig;
        continue;
      }
      // gather at the mid-step position (cell-local deltas)
      T dxl = v.f[FX] - T(ix), dyl = v.f[FY] - T(iy);
      T e_x = gather_comp(a.eb + 0 * plane, nyp, px, py, true, false, dxl, dyl);
      T e_y = gather_comp(a.eb + 1 * plane, nyp, px, py, false, true, dxl, dyl);
      T e_z = gather_comp(a.eb + 2 * plane, nyp, px, py, false, false, dxl, dyl);
      T b_x = gather_comp(a.eb + 3 * plane, nyp, px, py, false, true, dxl, dyl);
      T b_y = gather_comp(a.eb + 4 * plane, nyp, px, py, true, false, dxl, dyl);
      T b_z = gather_comp(a.eb + 5 * plane, nyp, px, py, true, true, dxl, dyl);
      if (a.mode == M_WANT_CHI) {
        // models/qed.py::calculate_chi at the pre-push momenta, with the
        // pre-push inv_gamma of the re-binning (ops/cell2d.py)
        const T ux0 = v.f[FUX], uy0 = v.f[FUY], uz0 = v.f[FUZ];
        T ig0 = T(1) / sqrt(((T(1) + ux0 * ux0) + uy0 * uy0) + uz0 * uz0);
        T gam = T(1) / ig0;
        T t1 = gam * e_x + (uy0 * b_z - uz0 * b_y) * a.c;
        T t2 = gam * e_y + (uz0 * b_x - ux0 * b_z) * a.c;
        T t3 = gam * e_z + (ux0 * b_y - uy0 * b_x) * a.c;
        T t4 = (ux0 * e_x + uy0 * e_y) + uz0 * e_z;
        T val = ((t1 * t1 + t2 * t2) + t3 * t3) - t4 * t4;
        a.chi_out[o] = a.chi * sqrt(val > T(0) ? val : T(0));
        a.ig0_out[o] = ig0;
      }
      // Boris (ops/pusher.py::boris_push)
      const T ef = a.ef, bfac = a.bf;
      T um_x = v.f[FUX] + ef * e_x;
      T um_y = v.f[FUY] + ef * e_y;
      T um_z = v.f[FUZ] + ef * e_z;
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
      v.f[FUX] = ux;
      v.f[FUY] = uy;
      v.f[FUZ] = uz;
      v.f[FX] = pushed(v.f[FX], ux, ig, a.hx);
      v.f[FY] = pushed(v.f[FY], uy, ig, a.hy);
      store(a.out, o, v, al, a.nxf);
      a.ig_out[o] = ig;
    }
  }
  add_merges(a.n_merged, merges);
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

template <typename T>
__global__ void __launch_bounds__(TILE * TILE) deposit(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);       // (ncomp, PAN, PAN)
  const int lx = threadIdx.y, ly = threadIdx.x;
  const int bi = blockIdx.y, bj = blockIdx.x;
  const int nbx = gridDim.y, nby = gridDim.x;
  const int ix = bi * TILE + lx, iy = bj * TILE + ly;
  const bool valid = ix < a.nx && iy < a.ny;
  const int C = a.ncomp;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const long long pstride = (long long)PAN * PAN;
  for (int e = tid; e < C * PAN * PAN; e += TILE * TILE) {
    int c = e / (PAN * PAN), r = e % (PAN * PAN);
    long long gidx = (((long long)c * nbx + bi) * nby + bj) * pstride + r;
    pan[e] = a.rims_in ? a.rims_in[gidx] : T(0);
  }
  const long long cell = (long long)ix * a.ny + iy;
  const T cdx = a.cdx, cdy = a.cdy, kcd = a.kcd, kfx = a.kfx, kfy = a.kfy;
#pragma unroll
  for (int oxi = 0; oxi < 5; ++oxi) {
    T acc[5][4];
#pragma unroll
    for (int oy = 0; oy < 5; ++oy)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[oy][c] = T(0);
    if (valid) {
      for (int s = 0; s < a.cap; ++s) {
        long long idx = (long long)s * a.ncell + cell;
        if (!a.out.alive[idx]) continue;
        T x = a.out.f[FX][idx], y = a.out.f[FY][idx];
        T ig = a.ig_out[idx], w = a.out.f[FW][idx];
        T vx_c = (a.out.f[FUX][idx] * ig) * cdx;
        T vy_c = (a.out.f[FUY][idx] * ig) * cdy;
        T vz = (a.out.f[FUZ][idx] * ig) * a.c;
        T s0x[5], s1x[5], s0y[5], s1y[5];
        shapes(x - T(ix), vx_c, s0x, s1x);
        shapes(y - T(iy), vy_c, s0y, s1y);
        T cd = kcd * w, fdx = kfx * w, fdy = kfy * w;
        T cvz = cd * vz;
        T run = T(0);
        for (int o = 0; o <= oxi; ++o) run = run + (s1x[o] - s0x[o]);
        T fx = (-fdx) * run;
        T dsx = s1x[oxi] - s0x[oxi];
        T ax = s0x[oxi] + T(0.5) * dsx;
        T runy = T(0);
#pragma unroll
        for (int oy = 0; oy < 5; ++oy) {
          T dsy = s1y[oy] - s0y[oy];
          runy = runy + dsy;
          T gy = (-fdy) * runy;
          T by = s0y[oy] + T(0.5) * dsy;
          acc[oy][0] += fx * by;
          acc[oy][1] += ax * gy;
          acc[oy][2] += cvz * (ax * by + (dsx * dsy) / T(12));
          acc[oy][3] += (cd * s1x[oxi]) * s1y[oy];
        }
      }
    }
#pragma unroll
    for (int oy = 0; oy < 5; ++oy) {
      __syncthreads();
      if (valid)
        for (int c = 0; c < C; ++c)
          pan[c * pstride + (lx + oxi) * PAN + (ly + oy)] += acc[oy][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < C * PAN * PAN; e += TILE * TILE) {
    int c = e / (PAN * PAN), r = e % (PAN * PAN);
    a.rims_out[(((long long)c * nbx + bi) * nby + bj) * pstride + r] = pan[e];
  }
}

template <typename T>
void unpack_in(SlotsIn<T>& s, void** p, int alive, int first, int id0,
               int xf0) {
  s.alive = (const unsigned char*)p[alive];
  for (int k = 0; k < NF; ++k) s.f[k] = (const T*)p[first + k];
  s.id[0] = (const int*)p[id0];
  s.id[1] = (const int*)p[id0 + 1];
  for (int k = 0; k < NXF; ++k) s.xf[k] = (const T*)p[xf0 + k];
}

template <typename T>
void unpack_out(SlotsOut<T>& s, void** p, int alive, int first, int id0,
                int xf0) {
  s.alive = (unsigned char*)p[alive];
  for (int k = 0; k < NF; ++k) s.f[k] = (T*)p[first + k];
  s.id[0] = (int*)p[id0];
  s.id[1] = (int*)p[id0 + 1];
  for (int k = 0; k < NXF; ++k) s.xf[k] = (T*)p[xf0 + k];
}

template <typename T, int MAXC>
int launch_passes(const Args<T>& a, cudaStream_t st) {
  int threads = 128;
  int blocks = ceil_div(a.ncell, threads);
  pass_x<T, MAXC><<<blocks, threads, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  pass_y<T, MAXC><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.eb = (const T*)p[P_EB];
  unpack_in(a.in, p, P_ALIVE, P_X, P_IDLO, P_XF_IN);
  a.ig = (const T*)p[P_IG];
  unpack_out(a.s, p, P_S_ALIVE, P_S_X, P_S_IDLO, P_XF_S);
  unpack_in(a.sin, p, P_S_ALIVE, P_S_X, P_S_IDLO, P_XF_S);
  unpack_out(a.out, p, P_O_ALIVE, P_O_X, P_O_IDLO, P_XF_O);
  a.chi_out = (T*)p[P_CHI];
  a.ig0_out = (T*)p[P_IG0];
  a.ig_out = (T*)p[P_O_IG];
  a.rims_in = (const T*)p[P_RIMS_IN];
  a.rims_out = (T*)p[P_RIMS_OUT];
  a.n_merged = (unsigned long long*)p[P_NMERGED];
  a.ces = (const int*)p[P_CES];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.g = (int)n[I_G]; a.perx = (int)n[I_PERX]; a.pery = (int)n[I_PERY];
  a.ncomp = (int)n[I_NCOMP]; a.nces = (int)n[I_NCES];
  a.mode = (int)n[I_MODE]; a.nxf = (int)n[I_NXF];
  if (a.nxf < 0 || a.nxf > NXF) return (int)cudaErrorInvalidValue;
  a.ncell = (long long)a.nx * a.ny;
  a.hx = (T)r[R_HX]; a.hy = (T)r[R_HY]; a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  a.cdx = (T)r[R_CDX]; a.cdy = (T)r[R_CDY]; a.c = (T)r[R_C];
  a.kcd = (T)r[R_KCD]; a.kfx = (T)r[R_KFX]; a.kfy = (T)r[R_KFY];
  a.chi = (T)r[R_CHI];
  int err;
  if (a.cap <= 8) err = launch_passes<T, 8>(a, st);
  else if (a.cap <= 16) err = launch_passes<T, 16>(a, st);
  else if (a.cap <= 32) err = launch_passes<T, 32>(a, st);
  else if (a.cap <= 64) err = launch_passes<T, 64>(a, st);
  else if (a.cap <= 128) err = launch_passes<T, 128>(a, st);
  else return (int)cudaErrorInvalidValue;
  if (err || a.mode == M_PHOTON) return err;
  dim3 block(TILE, TILE);
  dim3 grid(ceil_div(a.ny, TILE), ceil_div(a.nx, TILE));
  size_t smem = sizeof(T) * a.ncomp * PAN * PAN;
  deposit<T><<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_cell_step(void** ptrs, const long long* ints,
                           const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}

LP_EXPORT int lp_cell_tile() { return TILE; }
