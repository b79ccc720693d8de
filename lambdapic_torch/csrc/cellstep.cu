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
// On a device mesh (K4: replaces unified_cell_step's merge_axes, tail and
// yz_edges arguments and slab_species_step's edge exchanges,
// cellslab.py:1896-2043) one call is one dispatch on one shard:
//  x edges   with I_XEDGE, pass_x takes the lo and hi x columns from the
//            x neighbour shards' stored (pre-push) slots, (cap, 1, ny)
//            arrays with alive as int32 (zero past an open global face),
//            in place of the wrap: it applies their half push, keys them
//            at the neighbour's own cell index (nx-1 or 0), and adds
//            -+nx to their arrivals, as for wrapped columns.
//  dispatch  I_MERGE_LO .. I_MERGE_HI (0 x, 1 y) are the passes to run.
//            A mesh that splits y runs x alone (its output, the scratch
//            slots, goes back to the caller), exchanges the y edge rows of
//            that output, then runs y with the tail (I_MERGE_LO = 1: pass_y
//            reads its input from the scratch pointers).
//  y edges   with I_YEDGE, pass_y takes the lo and hi y rows, (cap, nx, 1),
//            of the y neighbours' x-pass output in place of the wrap.
//
// Capacity: up to MAXC_LOCAL (128) slots a cell each pass thread sorts its
// three columns' (key, slot) entries in a local array; above it the
// passes run a grid-stride loop over the cells with the entries in a
// global scratch row per thread (cell2d.cuh's for_cells).
//
// The sort, key, merge count, gather, Boris, chi and deposit routines live
// in cell2d.cuh, shared with the 3D kernel and the per-stage kernels
// B4-B7.
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
#include "cell2d.cuh"

namespace {

using namespace lp2d;

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
  P_KEYS = P_XF_O + 3,              // sort scratch above MAXC_LOCAL slots
  // neighbour edge columns: x lo, x hi, y lo, y hi, EDGE_PTRS each (alive
  // int32, x y z w ux uy uz, inv_gamma (x only), id_lo id_hi, 3 extras)
  P_EDGES,
  P_COUNT = P_EDGES + 4 * 14
};
enum Int { I_CAP, I_NX, I_NY, I_G, I_PERX, I_PERY, I_NCOMP, I_NCES, I_DOUBLE,
           I_MODE, I_NXF, I_KEY_THREADS, I_MERGE_LO, I_MERGE_HI, I_XEDGE,
           I_YEDGE };
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

// A neighbour shard's edge column (or row): one cell wide along the pass's
// axis, alive as int32.
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
  int* keys;            // KEY_ROWS x cap int32 per thread (cap > MAXC_LOCAL)
  long long key_threads;
  int cap, nx, ny, g, perx, pery, ncomp, nces, mode, nxf;
  int xedge, yedge;     // neighbour edges in place of the x / y wrap
  Edge<T> ex[2], ey[2]; // lo, hi
  long long ncell;
  T hx, hy, ef, bf, cdx, cdy, c, kcd, kfx, kfy, chi;   // see enum Real
};

// One slot's carried values.
template <typename T>
struct Slot {
  T f[NF];
  int id[2];
  T xf[NXF];
};

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

// An x-edge slot (index s*ny + iy of a (cap, 1, ny) edge), half pushed.
template <typename T>
__device__ void load_x_edge(const Args<T>& a, const Edge<T>& e, long long idx,
                            Slot<T>& v) {
  T ig = e.ig[idx];
  v.f[FX] = pushed(e.f[FX][idx], e.f[FUX][idx], ig, a.hx);
  v.f[FY] = pushed(e.f[FY][idx], e.f[FUY][idx], ig, a.hy);
  v.f[FZ] = e.f[FZ][idx];
  v.f[FW] = e.f[FW][idx];
  v.f[FUX] = e.f[FUX][idx];
  v.f[FUY] = e.f[FUY][idx];
  v.f[FUZ] = e.f[FUZ][idx];
  v.id[0] = e.id[0][idx];
  v.id[1] = e.id[1][idx];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) v.xf[k] = e.xf[k][idx];
}

// A y-edge slot (index s*nx + ix of a (cap, nx, 1) edge).
template <typename T>
__device__ void load_y_edge(const Args<T>& a, const Edge<T>& e, long long idx,
                            Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = e.f[k][idx];
  v.id[0] = e.id[0][idx];
  v.id[1] = e.id[1][idx];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) v.xf[k] = e.xf[k][idx];
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

// The 5-way keys of one neighbour edge column (X: an x edge of stored
// slots, keyed after its half push; else a y edge), slot stride ``stride``,
// at index ``at`` of the edge, keyed at the neighbour's own cell index xi.
template <typename T, bool X>
__device__ __forceinline__ void edge_keys(const Args<T>& a, const Edge<T>& e,
                                          int stride, int at, T xi, int* k) {
  for (int s = 0; s < a.cap; ++s) {
    long long ei = (long long)s * stride + at;
    bool al = e.alive[ei] != 0;
    T local = X ? pushed(e.f[FX][ei], e.f[FUX][ei], e.ig[ei], a.hx) - xi
                : e.f[FY][ei] - xi;
    bool hi = al && local >= T(0.5);
    bool lo = al && local < T(-0.5);
    k[s] = pack_key(five_way(al, hi, lo, s), s);
  }
}

// The x pass of one cell; k: KEY_ROWS rows of ks sort entries. EDGE: the
// launch takes the x neighbours' edge columns (a compile-time flag, so the
// one-device pass keeps its own code).
template <typename T, bool EDGE>
__device__ __forceinline__ void pass_x_cell(const Args<T>& a, long long cell,
                                            int* k, int ks, int& merges) {
  int ix = (int)(cell / a.ny), iy = (int)(cell % a.ny);
  int cols[3] = {ix > 0 ? ix - 1 : a.nx - 1, ix, ix < a.nx - 1 ? ix + 1 : 0};
  // the lo (hi) column comes from the x neighbour shard's edge
  const bool elo = EDGE && ix == 0, ehi = EDGE && ix == a.nx - 1;
  for (int c3 = 0; c3 < 3; ++c3) {
    long long base = (long long)cols[c3] * a.ny + iy;
    T xi = T(cols[c3]);
    if (c3 == 0 && elo) {
      edge_keys<T, true>(a, a.ex[0], a.ny, iy, xi, k);
    } else if (c3 == 2 && ehi) {
      edge_keys<T, true>(a, a.ex[1], a.ny, iy, xi, k + 2 * ks);
    } else {
      for (int s = 0; s < a.cap; ++s) {
        long long idx = base + s * a.ncell;
        bool al = a.in.alive[idx] != 0;
        T local =
            pushed(a.in.f[FX][idx], a.in.f[FUX][idx], a.ig[idx], a.hx) - xi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3 * ks + s] = pack_key(five_way(al, hi, lo, s), s);
      }
    }
    net_sort(k + c3 * ks, a.ces, a.nces);
  }
  bool lo_ok = EDGE || a.perx || ix != 0;
  bool hi_ok = EDGE || a.perx || ix != a.nx - 1;
  for (int p = 0; p < a.cap; ++p) {
    const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];
    bool vlo = lo_ok && key_of(klo) == 0;
    bool vhi = hi_ok && key_of(khi) == 4;
    bool stay = key_of(kown) == 2;
    Slot<T> own, lo, hi, out;
    load_x(a, (long long)slot_of(kown) * a.ncell + cell, own);
    if (vlo) {
      if (elo)
        load_x_edge(a, a.ex[0], (long long)slot_of(klo) * a.ny + iy, lo);
      else
        load_x(a, (long long)slot_of(klo) * a.ncell +
                      (long long)cols[0] * a.ny + iy, lo);
      if (ix == 0) lo.f[FX] = lo.f[FX] + T(-a.nx);
    }
    if (vhi) {
      if (ehi)
        load_x_edge(a, a.ex[1], (long long)slot_of(khi) * a.ny + iy, hi);
      else
        load_x(a, (long long)slot_of(khi) * a.ncell +
                      (long long)cols[2] * a.ny + iy, hi);
      if (ix == a.nx - 1) hi.f[FX] = hi.f[FX] + T(a.nx);
    }
    place(vlo, vhi, stay, lo, hi, own, out, merges);
    store(a.s, (long long)p * a.ncell + cell, out, vlo || vhi || stay,
          a.nxf);
  }
}

template <typename T, int MAXC, bool EDGE>
__global__ void __launch_bounds__(128) pass_x(Args<T> a) {
  int merges = 0;
  for_cells<MAXC>(a.ncell, a.keys, a.cap, [&](long long cell, int* k, int ks) {
    pass_x_cell<T, EDGE>(a, cell, k, ks, merges);
  });
  add_merges(a.n_merged, merges);
}

// The y pass of one cell and the push of its slots; k: KEY_ROWS rows of
// ks sort entries. EDGE: the launch takes the y neighbours' edge rows.
template <typename T, bool EDGE>
__device__ __forceinline__ void pass_y_cell(const Args<T>& a, long long cell,
                                            int* k, int ks, int& merges) {
  int ix = (int)(cell / a.ny), iy = (int)(cell % a.ny);
  int rows[3] = {iy > 0 ? iy - 1 : a.ny - 1, iy, iy < a.ny - 1 ? iy + 1 : 0};
  // the lo (hi) row comes from the y neighbour shard's edge
  const bool elo = EDGE && iy == 0, ehi = EDGE && iy == a.ny - 1;
  for (int c3 = 0; c3 < 3; ++c3) {
    long long base = (long long)ix * a.ny + rows[c3];
    T yi = T(rows[c3]);
    if (c3 == 0 && elo) {
      edge_keys<T, false>(a, a.ey[0], a.nx, ix, yi, k);
    } else if (c3 == 2 && ehi) {
      edge_keys<T, false>(a, a.ey[1], a.nx, ix, yi, k + 2 * ks);
    } else {
      for (int s = 0; s < a.cap; ++s) {
        long long idx = base + s * a.ncell;
        bool al = a.sin.alive[idx] != 0;
        T local = a.sin.f[FY][idx] - yi;
        bool hi = al && local >= T(0.5);
        bool lo = al && local < T(-0.5);
        k[c3 * ks + s] = pack_key(five_way(al, hi, lo, s), s);
      }
    }
    net_sort(k + c3 * ks, a.ces, a.nces);
  }
  bool lo_ok = EDGE || a.pery || iy != 0;
  bool hi_ok = EDGE || a.pery || iy != a.ny - 1;
  for (int p = 0; p < a.cap; ++p) {
    const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];
    bool vlo = lo_ok && key_of(klo) == 0;
    bool vhi = hi_ok && key_of(khi) == 4;
    bool stay = key_of(kown) == 2;
    Slot<T> own, lo, hi, v;
    load_y(a, (long long)slot_of(kown) * a.ncell + cell, own);
    if (vlo) {
      if (elo)
        load_y_edge(a, a.ey[0], (long long)slot_of(klo) * a.nx + ix, lo);
      else
        load_y(a, (long long)slot_of(klo) * a.ncell +
                      (long long)ix * a.ny + rows[0], lo);
      if (iy == 0) lo.f[FY] = lo.f[FY] + T(-a.ny);
    }
    if (vhi) {
      if (ehi)
        load_y_edge(a, a.ey[1], (long long)slot_of(khi) * a.nx + ix, hi);
      else
        load_y(a, (long long)slot_of(khi) * a.ncell +
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
      T ig = photon_ig(v.f[FUX], v.f[FUY], v.f[FUZ]);
      v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.hx);
      v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.hy);
      store(a.out, o, v, al, a.nxf);
      a.ig_out[o] = ig;
      continue;
    }
    // gather at the mid-step position (cell-local deltas)
    T e[6];
    gather_eb(a.eb, a.nx, a.ny, a.g, ix, iy, v.f[FX] - T(ix),
              v.f[FY] - T(iy), e);
    if (a.mode == M_WANT_CHI) {
      // models/qed.py::calculate_chi at the pre-push momenta, with the
      // pre-push inv_gamma of the re-binning (ops/cell2d.py)
      quantum_chi(e, v.f[FUX], v.f[FUY], v.f[FUZ], a.c, a.chi, a.chi_out[o],
                  a.ig0_out[o]);
    }
    T ig = boris(v.f[FUX], v.f[FUY], v.f[FUZ], e, a.ef, a.bf);
    v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.hx);
    v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.hy);
    store(a.out, o, v, al, a.nxf);
    a.ig_out[o] = ig;
  }
}

template <typename T, int MAXC, bool EDGE>
__global__ void __launch_bounds__(128) pass_y(Args<T> a) {
  int merges = 0;
  for_cells<MAXC>(a.ncell, a.keys, a.cap, [&](long long cell, int* k, int ks) {
    pass_y_cell<T, EDGE>(a, cell, k, ks, merges);
  });
  add_merges(a.n_merged, merges);
}

template <typename T>
__global__ void __launch_bounds__(TILE * TILE) deposit(Args<T> a) {
  DepositIn<T> d;
  d.alive = a.out.alive;
  d.x = a.out.f[FX]; d.y = a.out.f[FY];
  d.ux = a.out.f[FUX]; d.uy = a.out.f[FUY]; d.uz = a.out.f[FUZ];
  d.ig = a.ig_out; d.w = a.out.f[FW];
  d.rims_in = a.rims_in; d.rims_out = a.rims_out;
  d.nx = a.nx; d.ny = a.ny; d.cap = a.cap; d.ncomp = a.ncomp;
  d.ncell = a.ncell;
  d.cdx = a.cdx; d.cdy = a.cdy; d.c = a.c;
  d.kcd = a.kcd; d.kfx = a.kfx; d.kfy = a.kfy;
  deposit_tile(d);
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
int launch_passes(const Args<T>& a, int lo, int hi, cudaStream_t st) {
  int threads = 128;
  int blocks = cell_blocks(a.ncell, a.cap, a.key_threads, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  if (lo == 0) {
    if (a.xedge)
      pass_x<T, MAXC, true><<<blocks, threads, 0, st>>>(a);
    else
      pass_x<T, MAXC, false><<<blocks, threads, 0, st>>>(a);
    int err = (int)cudaGetLastError();
    if (err || hi == 0) return err;
  }
  if (a.yedge)
    pass_y<T, MAXC, true><<<blocks, threads, 0, st>>>(a);
  else
    pass_y<T, MAXC, false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
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
  a.keys = (int*)p[P_KEYS];
  a.key_threads = n[I_KEY_THREADS];
  if (a.cap < 1 || a.cap > lp2d::MAX_SLOTS || (a.cap > MAXC_LOCAL && !a.keys))
    return (int)cudaErrorInvalidValue;
  const int lo = (int)n[I_MERGE_LO], hi = (int)n[I_MERGE_HI];
  a.xedge = (int)n[I_XEDGE];
  a.yedge = (int)n[I_YEDGE];
  // dispatches: x and y (the whole stage), x alone, y with the tail
  if (lo < 0 || hi > 1 || lo > hi || (a.xedge && lo != 0) ||
      (a.yedge && lo != 1))
    return (int)cudaErrorInvalidValue;
  for (int e = 0; e < 2; ++e) {
    unpack_edge(a.ex[e], p + P_EDGES + e * EDGE_PTRS);
    unpack_edge(a.ey[e], p + P_EDGES + (2 + e) * EDGE_PTRS);
  }
  int err;
  if (a.cap <= 8) err = launch_passes<T, 8>(a, lo, hi, st);
  else if (a.cap <= 16) err = launch_passes<T, 16>(a, lo, hi, st);
  else if (a.cap <= 32) err = launch_passes<T, 32>(a, lo, hi, st);
  else if (a.cap <= 64) err = launch_passes<T, 64>(a, lo, hi, st);
  else if (a.cap <= MAXC_LOCAL) err = launch_passes<T, MAXC_LOCAL>(a, lo, hi, st);
  else err = launch_passes<T, 0>(a, lo, hi, st);
  if (err || a.mode == M_PHOTON || hi == 0) return err;
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

LP_EXPORT int lp_cell_tile() { return lp2d::TILE; }

// the sort scratch's limits (cell2d.cuh::key_limit)
LP_EXPORT int lp_key_limits(int which) { return lp2d::key_limit(which); }
