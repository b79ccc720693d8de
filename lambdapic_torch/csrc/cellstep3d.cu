// Kernel B2 in 3D: the 3D cell-engine particle stage of one species, in
// its default, want_chi and photon modes.
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
//            dead slot's payload. One instance per mode (a template
//            argument), so the default mode's registers do not grow.
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
// Modes (the int I_MODE), as in the 2D kernel (cellstep.cu):
//  default   as above.
//  want_chi  push also writes, between the gather and Boris, the
//            post-migration pre-push ig0 = 1/sqrt(1 + u^2) and the quantum
//            parameter chi of every alive slot (0 and 1 in dead slots; the
//            caller masks chi with alive). Replaces unified_cell_step's
//            want_chi branch (cellslab.py:1094-1109) on 3D slots.
//  photon    field free (q = m = 0): push's work is inv_gamma = 1/|u| (1
//            where u = 0) and the second half push; no gather, no Boris,
//            no deposit launch, no panels. Replaces the photon branch
//            (cellslab.py:966-986) on 3D slots.
// Extra payloads: up to NXF float arrays (a QED species' tau, delta,
// event) ride through the three passes. On a collision they take the
// placed slot's value (lo arrival, else hi arrival, else the resident);
// only w, x, y, z, ux, uy, uz are merged. Dead slots keep them as placed.
//
// On a device mesh (K4: replaces unified_cell_step's merge_axes, tail and
// yz_edges arguments on 3D slots and slab_species_step's edge exchanges,
// cellslab.py:1896-2043) one call is one dispatch on one shard: the rebin
// passes of axes I_MERGE_LO .. I_MERGE_HI, then with I_TAIL the push and
// the deposit. A dispatch's passes alternate between the buffers so that
// the last lands in A, the dispatch's output (the pushed slots with the
// tail; else the re-binned slots the caller hands to the next dispatch).
// An axis whose bit is set in I_EDGE_AXES takes its lo and hi columns
// from the neighbour shards' edge arrays (one cell wide along that axis,
// alive as int32, zero past an open global face) in place of the wrap:
// the x edges are the stored (pre-push) slots, half pushed here; a y or z
// edge is the previous dispatch's output. Their arrivals get the -+n
// coordinate shift of wrapped ones.
//
// Capacity: up to MAXC_LOCAL (128) slots a cell each rebin thread sorts
// its three columns' entries in a local array; above it the passes run a
// grid-stride loop over the cells with the entries in a global scratch
// row per thread (cell2d.cuh's for_cells).
//
// The gather, Boris, half push, key, sort, merge count, chi and tile
// deposit are the shared device code of cell3d.cuh and cell2d.cuh, which
// kernels B4 and B5 in 3D (push3d.cu, deposit3d.cu) run too.
//
// Compiled with --fmad=false: positions, keys and merges round exactly as
// the plain version's separate tensor operations do, so cell assignment
// and merge pairing match it slot for slot.
//
// Bound on an H100 (3.35 TB/s): bytes, counted as for the 2D kernel: the
// alive mask (1 B a slot); x, y, z, w, ux, uy, uz, inv_gamma, id_lo, id_hi
// of each alive slot; the E/B nodes the gather reaches from occupied
// cells; one write of every slot and of the panels (want_chi: chi and ig0
// written too; photon: no fields, no panels). This first design moves
// several times that: three passes each read every slot of three columns
// and write every slot, the push reads and writes them again, and the
// deposit reads the alive ones once more.
#include "cell3d.cuh"

namespace {

using lp2d::add_merges;
using lp2d::five_way;
using lp2d::for_cells;
using lp2d::key_of;
using lp2d::MAXC_LOCAL;
using lp2d::net_sort;
using lp2d::pack_key;
using lp2d::pushed;
using lp2d::slot_of;
using lp2d::WFloor;
using lp3d::TILE;

enum Ptr {
  P_EB,
  P_ALIVE, P_X, P_Y, P_Z, P_W, P_UX, P_UY, P_UZ, P_IG, P_IDLO, P_IDHI,
  P_A_ALIVE, P_A_X, P_A_Y, P_A_Z, P_A_W, P_A_UX, P_A_UY, P_A_UZ, P_A_IG,
  P_A_IDLO, P_A_IDHI,
  P_B_ALIVE, P_B_X, P_B_Y, P_B_Z, P_B_W, P_B_UX, P_B_UY, P_B_UZ, P_B_IDLO,
  P_B_IDHI,
  P_RIMS_IN, P_RIMS_OUT, P_NMERGED, P_CES,
  P_CHI, P_IG0,                     // want_chi outputs
  P_XF_IN, P_XF_A = P_XF_IN + 3, P_XF_B = P_XF_A + 3,  // extra payloads
  P_KEYS = P_XF_B + 3,              // sort scratch above MAXC_LOCAL slots
  // neighbour edges: x lo, x hi, y lo, y hi, z lo, z hi, EDGE_PTRS each
  // (alive int32, x y z w ux uy uz, inv_gamma (x only), id_lo id_hi, 3
  // extras)
  P_EDGES,
  P_COUNT = P_EDGES + 6 * 14
};
enum Int {
  I_CAP, I_NX, I_NY, I_NZ, I_G, I_PERX, I_PERY, I_PERZ, I_NCOMP, I_NCES,
  I_DOUBLE, I_MODE, I_NXF, I_KEY_THREADS, I_MERGE_LO, I_MERGE_HI, I_TAIL,
  I_EDGE_AXES
};
enum Mode { M_DEFAULT = 0, M_WANT_CHI = 1, M_PHOTON = 2 };
// reals are computed on the host exactly as the plain version computes
// its scalar factors (in double), then rounded to the kernel's type
enum Real {
  R_HX, R_HY, R_HZ,     // c dt / d / 2 per axis: position half push
  R_EF, R_BF,           // q dt / (2 m c), q dt / (2 m): Boris
  R_CDX, R_CDY, R_CDZ,  // c dt / d per axis
  R_KCD,                // q / (dx dy dz)
  R_KFX, R_KFY, R_KFZ,  // q / (dy dz dt), q / (dx dz dt), q / (dx dy dt)
  R_C, R_CHI            // c; e hbar / (m_e^2 c^3)
};

constexpr int NF = 7;                  // float payloads: x y z w ux uy uz
constexpr int NXF = 3;                 // most extra float payloads
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

// A neighbour shard's edge (one cell wide along its axis), alive as int32.
template <typename T>
struct Edge {
  const int* alive;
  const T* f[NF];
  const T* ig;          // x edges: the stored inv_gamma, for the half push
  const int* id[2];
  const T* xf[NXF];
};
constexpr int EDGE_PTRS = 1 + NF + 1 + 2 + NXF;

template <typename T>
struct Args {
  const T* eb;
  const T* ig;          // stored inv_gamma of the input slots
  T* ig_out;
  const T* rims_in;
  T* rims_out;
  unsigned long long* n_merged;
  const int* ces;
  T* chi_out;           // want_chi
  T* ig0_out;
  int* keys;            // KEY_ROWS x cap int32 per thread (cap > MAXC_LOCAL)
  long long key_threads;
  int cap, nx, ny, nz, g, per[3], ncomp, nces, mode, nxf;
  int edge_axes;        // bit a: axis a takes neighbour edges
  Edge<T> e[3][2];      // per axis: lo, hi
  long long ncell;
  T h[3], ef, bf, cd[3], kcd, kf[3], c, chi;   // see enum Real
};

// One slot's carried values.
template <typename T>
struct Slot {
  T f[NF];
  int id[2];
  T xf[NXF];
};

// A source slot; the x pass reads the stored slots and applies the first
// half push along all three axes. XF: the species carries extra payloads
// (a compile-time flag, so the default mode's passes keep their
// registers).
template <typename T, bool XF>
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
  if (XF) {
#pragma unroll
    for (int k = 0; k < NXF; ++k)
      if (k < a.nxf) v.xf[k] = s.xf[k][idx];
  }
}

// A source slot of a neighbour edge (index idx of the edge array); as
// ``load``.
template <typename T, bool XF>
__device__ void load_edge(const Args<T>& a, const Edge<T>& e, long long idx,
                          bool first, Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = e.f[k][idx];
  if (first) {
    T ig = e.ig[idx];
    v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.h[0]);
    v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.h[1]);
    v.f[FZ] = pushed(v.f[FZ], v.f[FUZ], ig, a.h[2]);
  }
  v.id[0] = e.id[0][idx];
  v.id[1] = e.id[1][idx];
  if (XF) {
#pragma unroll
    for (int k = 0; k < NXF; ++k)
      if (k < a.nxf) v.xf[k] = e.xf[k][idx];
  }
}

// The 5-way keys of one neighbour edge column of ``axis`` (slot stride
// ``es``, at index ``at`` of the edge), keyed at the neighbour's own cell
// index xi.
template <typename T>
__device__ __forceinline__ void edge_keys(const Args<T>& a, const Edge<T>& e,
                                          int axis, long long es,
                                          long long at, T xi, int* k) {
  const bool first = axis == 0;
  for (int s = 0; s < a.cap; ++s) {
    long long idx = at + s * es;
    bool al = e.alive[idx] != 0;
    T p = first ? pushed(e.f[FX][idx], e.f[FUX][idx], e.ig[idx], a.h[0])
                : e.f[FX + axis][idx];
    T local = p - xi;
    bool hi = al && local >= T(0.5);
    bool lo = al && local < T(-0.5);
    k[s] = pack_key(five_way(al, hi, lo, s), s);
  }
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

template <typename T, bool XF>
__device__ void store(const SlotsOut<T>& o, long long idx, const Slot<T>& v,
                      bool alive, int nxf) {
  o.alive[idx] = alive ? 1 : 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) o.f[k][idx] = v.f[k];
  o.id[0][idx] = v.id[0];
  o.id[1][idx] = v.id[1];
  if (XF) {
#pragma unroll
    for (int k = 0; k < NXF; ++k)
      if (k < nxf) o.xf[k][idx] = v.xf[k];
  }
}

// The edge of ``axis`` on side ``side`` (0 lo, 1 hi), by constant indices
// so the kernel parameters stay in the parameter space.
template <typename T>
__device__ __forceinline__ const Edge<T>& e_of(const Args<T>& a, int axis,
                                               int side) {
  if (axis == 0) return side ? a.e[0][1] : a.e[0][0];
  if (axis == 1) return side ? a.e[1][1] : a.e[1][0];
  return side ? a.e[2][1] : a.e[2][0];
}

// One re-binning pass along ``axis`` (0 x, 1 y, 2 z) of one cell from src
// to dst; k: KEY_ROWS rows of ks sort entries.
template <typename T, bool XF, bool EDGE>
__device__ __forceinline__ void rebin_cell(const Args<T>& a,
                                           const SlotsIn<T>& src,
                                           const SlotsOut<T>& dst, int axis,
                                           long long cell, int* k, int ks,
                                           int& merges) {
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
  // the lo (hi) column comes from the neighbour shard's edge: (cap, ...)
  // with this axis one cell wide, at the cell's index with the axis dropped
  // EDGE: this launch's axis takes edges (a compile-time flag, so the
  // one-device passes keep their own code)
  const bool edge = EDGE;
  const bool elo = edge && i == 0, ehi = edge && i == n - 1;
  const long long es = a.ncell / n;
  const long long at = axis == 0 ? (long long)iy * a.nz + iz
                       : (axis == 1 ? (long long)ix * a.nz + iz
                                    : (long long)ix * a.ny + iy);
  for (int c3 = 0; c3 < 3; ++c3) {
    T xi = T(ci[c3]);
    if (c3 == 0 && elo) {
      edge_keys(a, e_of(a, axis, 0), axis, es, at, xi, k);
    } else if (c3 == 2 && ehi) {
      edge_keys(a, e_of(a, axis, 1), axis, es, at, xi, k + 2 * ks);
    } else {
      for (int s = 0; s < a.cap; ++s) {
        long long idx = nb[c3] + s * a.ncell;
        bool al = src.alive[idx] != 0;
        T p = first ? pushed(pos[idx], mom[idx], a.ig[idx], h) : pos[idx];
        T local = p - xi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3 * ks + s] = pack_key(five_way(al, hi, lo, s), s);
      }
    }
    net_sort(k + c3 * ks, a.ces, a.nces);
  }
  const bool per = a.per[axis] != 0;
  bool lo_ok = per || i != 0 || edge;
  bool hi_ok = per || i != n - 1 || edge;
  for (int p = 0; p < a.cap; ++p) {
    const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];
    bool vlo = lo_ok && key_of(klo) == 0;
    bool vhi = hi_ok && key_of(khi) == 4;
    bool stay = key_of(kown) == 2;
    Slot<T> own, lo, hi, out;
    load<T, XF>(a, src, (long long)slot_of(kown) * a.ncell + cell, first, own);
    if (vlo) {
      if (elo)
        load_edge<T, XF>(a, e_of(a, axis, 0), at + slot_of(klo) * es, first,
                         lo);
      else
        load<T, XF>(a, src, (long long)slot_of(klo) * a.ncell + nb[0], first,
                    lo);
      if (i == 0) adjust(lo, axis, T(-n));
    }
    if (vhi) {
      if (ehi)
        load_edge<T, XF>(a, e_of(a, axis, 1), at + slot_of(khi) * es, first,
                         hi);
      else
        load<T, XF>(a, src, (long long)slot_of(khi) * a.ncell + nb[2], first,
                    hi);
      if (i == n - 1) adjust(hi, axis, T(n));
    }
    place(vlo, vhi, stay, lo, hi, own, out, merges);
    bool al = vlo || vhi || stay;
    if (last && !al) {
#pragma unroll
      for (int t = 0; t < NF; ++t) out.f[t] = T(0);
    }
    store<T, XF>(dst, (long long)p * a.ncell + cell, out, al, a.nxf);
  }
}

template <typename T, int MAXC, bool XF, bool EDGE>
__global__ void __launch_bounds__(128) rebin(Args<T> a, SlotsIn<T> src,
                                             SlotsOut<T> dst, int axis) {
  int merges = 0;
  for_cells<MAXC>(a.ncell, a.keys, a.cap, [&](long long cell, int* k, int ks) {
    rebin_cell<T, XF, EDGE>(a, src, dst, axis, cell, k, ks, merges);
  });
  add_merges(a.n_merged, merges);
}

// The slots' push, in place on buffer A, by mode: gather + Boris (with
// want_chi the pre-push ig0 and chi between the two) + second half push
// (the gather and Boris are cell3d.cuh's and cell2d.cuh's, as kernel B4
// runs them), or a photon's 1/|u| and second half push.
template <typename T, int MODE>
__global__ void __launch_bounds__(256) push(Args<T> a, SlotsOut<T> s) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.cap * a.ncell) return;
  if (!s.alive[idx]) {
    a.ig_out[idx] = T(1);
    if (MODE == M_WANT_CHI) {
      a.chi_out[idx] = T(0);
      a.ig0_out[idx] = T(1);
    }
    return;
  }
  T x = s.f[FX][idx], y = s.f[FY][idx], z = s.f[FZ][idx];
  T ux, uy, uz, ig;
  if (MODE == M_PHOTON) {
    ux = s.f[FUX][idx]; uy = s.f[FUY][idx]; uz = s.f[FUZ][idx];
    ig = lp2d::photon_ig(ux, uy, uz);
  } else {
    long long cell = idx % a.ncell;
    const long long plane = (long long)a.ny * a.nz;
    int ix = (int)(cell / plane);
    int rem = (int)(cell - (long long)ix * plane);
    int iy = rem / a.nz, iz = rem - iy * a.nz;
    const T d[3] = {x - T(ix), y - T(iy), z - T(iz)};
    T e[6];
    lp3d::gather_eb(a.eb, a.nx, a.ny, a.nz, a.g, ix, iy, iz, d, e);
    ux = s.f[FUX][idx]; uy = s.f[FUY][idx]; uz = s.f[FUZ][idx];
    if (MODE == M_WANT_CHI)
      lp2d::quantum_chi(e, ux, uy, uz, a.c, a.chi, a.chi_out[idx],
                        a.ig0_out[idx]);
    ig = lp2d::boris(ux, uy, uz, e, a.ef, a.bf);
    s.f[FUX][idx] = ux;
    s.f[FUY][idx] = uy;
    s.f[FUZ][idx] = uz;
  }
  s.f[FX][idx] = pushed(x, ux, ig, a.h[0]);
  s.f[FY][idx] = pushed(y, uy, ig, a.h[1]);
  s.f[FZ][idx] = pushed(z, uz, ig, a.h[2]);
  a.ig_out[idx] = ig;
}

// The deposit from the pushed buffer A: cell3d.cuh's tile deposit of the
// alive slots, chained through rims_in.
template <typename T>
__global__ void __launch_bounds__(TILE * TILE * TILE)
    deposit(lp3d::DepositIn<T> d) {
  lp3d::deposit_tile(d);
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

template <typename T>
struct Buffers {
  SlotsIn<T> in, a_in, b_in;
  SlotsOut<T> a_out, b_out;
};

// The passes of axes lo .. hi, input -> ... -> buffer A: an odd count
// starts into A (in -> A -> B -> A), an even one into B (in -> B -> A).
template <typename T, int MAXC, bool XF>
int launch_passes_xf(const Args<T>& a, const Buffers<T>& b, int lo, int hi,
                     cudaStream_t st) {
  int threads = 128;
  int blocks = lp2d::cell_blocks(a.ncell, a.cap, a.key_threads, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  SlotsIn<T> src = b.in;
  bool to_a = (hi - lo) % 2 == 0;
  for (int axis = lo; axis <= hi; ++axis) {
    SlotsOut<T> dst = to_a ? b.a_out : b.b_out;
    if ((a.edge_axes >> axis) & 1)
      rebin<T, MAXC, XF, true><<<blocks, threads, 0, st>>>(a, src, dst, axis);
    else
      rebin<T, MAXC, XF, false><<<blocks, threads, 0, st>>>(a, src, dst, axis);
    int err = (int)cudaGetLastError();
    if (err) return err;
    src = to_a ? b.a_in : b.b_in;
    to_a = !to_a;
  }
  return 0;
}

template <typename T, int MAXC>
int launch_passes(const Args<T>& a, const Buffers<T>& b, int lo, int hi,
                  cudaStream_t st) {
  return a.nxf > 0 ? launch_passes_xf<T, MAXC, true>(a, b, lo, hi, st)
                   : launch_passes_xf<T, MAXC, false>(a, b, lo, hi, st);
}

template <typename T>
void unpack_edge(Edge<T>& e, void** p) {
  e.alive = (const int*)p[0];
  for (int k = 0; k < NF; ++k) e.f[k] = (const T*)p[1 + k];
  e.ig = (const T*)p[1 + NF];
  e.id[0] = (const int*)p[2 + NF];
  e.id[1] = (const int*)p[3 + NF];
  for (int k = 0; k < NXF; ++k) e.xf[k] = (const T*)p[4 + NF + k];
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  Buffers<T> b;
  a.eb = (const T*)p[P_EB];
  unpack_in(b.in, p, P_ALIVE, P_X, P_IDLO, P_XF_IN);
  a.ig = (const T*)p[P_IG];
  unpack_out(b.a_out, p, P_A_ALIVE, P_A_X, P_A_IDLO, P_XF_A);
  unpack_in(b.a_in, p, P_A_ALIVE, P_A_X, P_A_IDLO, P_XF_A);
  a.ig_out = (T*)p[P_A_IG];
  unpack_out(b.b_out, p, P_B_ALIVE, P_B_X, P_B_IDLO, P_XF_B);
  unpack_in(b.b_in, p, P_B_ALIVE, P_B_X, P_B_IDLO, P_XF_B);
  a.chi_out = (T*)p[P_CHI];
  a.ig0_out = (T*)p[P_IG0];
  a.keys = (int*)p[P_KEYS];
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
  a.mode = (int)n[I_MODE]; a.nxf = (int)n[I_NXF];
  a.key_threads = n[I_KEY_THREADS];
  a.ncell = (long long)a.nx * a.ny * a.nz;
  if (a.nxf < 0 || a.nxf > NXF || a.mode < M_DEFAULT || a.mode > M_PHOTON ||
      a.cap < 1 || a.cap > lp2d::MAX_SLOTS || (a.cap > MAXC_LOCAL && !a.keys) ||
      (a.mode == M_WANT_CHI && (!a.chi_out || !a.ig0_out)))
    return (int)cudaErrorInvalidValue;
  a.h[0] = (T)r[R_HX]; a.h[1] = (T)r[R_HY]; a.h[2] = (T)r[R_HZ];
  a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  a.cd[0] = (T)r[R_CDX]; a.cd[1] = (T)r[R_CDY]; a.cd[2] = (T)r[R_CDZ];
  a.kcd = (T)r[R_KCD];
  a.kf[0] = (T)r[R_KFX]; a.kf[1] = (T)r[R_KFY]; a.kf[2] = (T)r[R_KFZ];
  a.c = (T)r[R_C]; a.chi = (T)r[R_CHI];
  const int lo = (int)n[I_MERGE_LO], hi = (int)n[I_MERGE_HI];
  const int tail = (int)n[I_TAIL];
  a.edge_axes = (int)n[I_EDGE_AXES];
  // a dispatch re-bins consecutive axes; the tail follows the z pass only;
  // only a dispatch's first axis takes edges
  if (lo < 0 || hi > 2 || lo > hi || (tail != (hi == 2)) ||
      (a.edge_axes & ~(1 << lo)))
    return (int)cudaErrorInvalidValue;
  for (int ax = 0; ax < 3; ++ax)
    for (int sd = 0; sd < 2; ++sd)
      unpack_edge(a.e[ax][sd], p + P_EDGES + (2 * ax + sd) * EDGE_PTRS);
  int err;
  if (a.cap <= 8) err = launch_passes<T, 8>(a, b, lo, hi, st);
  else if (a.cap <= 16) err = launch_passes<T, 16>(a, b, lo, hi, st);
  else if (a.cap <= 32) err = launch_passes<T, 32>(a, b, lo, hi, st);
  else if (a.cap <= 64) err = launch_passes<T, 64>(a, b, lo, hi, st);
  else if (a.cap <= MAXC_LOCAL) err = launch_passes<T, MAXC_LOCAL>(a, b, lo, hi, st);
  else err = launch_passes<T, 0>(a, b, lo, hi, st);
  if (err || !tail) return err;
  int threads = 256;
  int pblocks = ceil_div((long long)a.cap * a.ncell, threads);
  if (a.mode == M_PHOTON)
    push<T, M_PHOTON><<<pblocks, threads, 0, st>>>(a, b.a_out);
  else if (a.mode == M_WANT_CHI)
    push<T, M_WANT_CHI><<<pblocks, threads, 0, st>>>(a, b.a_out);
  else
    push<T, M_DEFAULT><<<pblocks, threads, 0, st>>>(a, b.a_out);
  err = (int)cudaGetLastError();
  if (err || a.mode == M_PHOTON) return err;
  lp3d::DepositIn<T> d;
  d.alive = b.a_in.alive;
  d.x = b.a_in.f[FX]; d.y = b.a_in.f[FY]; d.z = b.a_in.f[FZ];
  d.ux = b.a_in.f[FUX]; d.uy = b.a_in.f[FUY]; d.uz = b.a_in.f[FUZ];
  d.ig = a.ig_out; d.w = b.a_in.f[FW];
  d.rims_in = a.rims_in; d.rims_out = a.rims_out;
  d.cap = a.cap; d.nx = a.nx; d.ny = a.ny; d.nz = a.nz; d.ncomp = a.ncomp;
  d.ncell = a.ncell;
  for (int k = 0; k < 3; ++k) { d.cd[k] = a.cd[k]; d.kf[k] = a.kf[k]; }
  d.kcd = a.kcd;
  dim3 block(TILE, TILE, TILE);
  dim3 grid(ceil_div(a.nz, TILE), ceil_div(a.ny, TILE), ceil_div(a.nx, TILE));
  size_t smem = lp3d::deposit_smem<T>(a.ncomp);
  err = (int)cudaFuncSetAttribute(deposit<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  deposit<T><<<grid, block, smem, st>>>(d);
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

// the sort scratch's limits (cell2d.cuh::key_limit)
LP_EXPORT int lp_key_limits(int which) { return lp2d::key_limit(which); }
