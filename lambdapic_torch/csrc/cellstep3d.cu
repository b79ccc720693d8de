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
// (ix*ny + iy)*nz + iz, slot stride nx*ny*nz. All offsets are 64-bit. Four
// __global__ launches run in order (each re-binning pass must see the
// previous pass's result in all of a cell's neighbours, so a grid-wide
// barrier, the end of a launch, separates them):
//
//  rebin3 x  up to 32 slots a cell (rebin3w), one thread per cell and
//            slot, a block of 32 cells x 4, 8, 16 or 32 slots, a warp one
//            slot of 32 neighbouring cells. Each thread applies the first
//            half push while loading and builds its slot's 5-way key
//            (donor+1 / dead-even / stay / dead-odd / donor-1, dead parity
//            from the slot index before the sort) in the cell's own column
//            and its two x neighbours, into shared memory; the threads of
//            slots 0, 1, 2 sort one column's (key, slot) pairs each through
//            the Batcher compare-exchange list of cellpallas.py::
//            _batcher_network (swap on a strict ka > kb; the exchange
//            decisions depend on the keys alone, so permuting the payloads
//            afterwards is bitwise the same); then each thread places its
//            output slot: arrivals by overwrite with lo priority, collisions
//            merged weight-conservingly, the -+n coordinate adjust of
//            wrapped arrivals, the drop at open faces. input -> buffer A.
//            Above 32 slots a cell (rebin3) one thread per cell does the
//            same for all its slots. A pass reads a source slot's payload
//            only when it is placed alive (the keys read a dead slot's
//            alive byte alone) and writes payloads only to alive output
//            slots, the alive byte to every slot: a dead slot of buffer A
//            or B holds whatever it held.
//  rebin3 y  the same along y, buffer A -> buffer B.
//  rebin3 z  the same along z, buffer B -> buffer A; it gives every dead
//            slot the stage's dead values: the plain version's zero floats
//            (and zero extras), inv_gamma 1, want_chi's chi 0 and ig0 1.
//            Dead ids are not written.
//  tail3     one 256-thread block per 8 x 8 x 8 cell tile, in place on
//            buffer A. The block copies the tile's E/B window (six
//            components of 11^3 nodes, cells -2 .. +8 of each axis: 31.9 KB
//            in float32) and its rims_in panel ((C, 12, 12, 12)) from
//            device memory into shared memory with cp.async (eb_pad's rows
//            of nz + 2g reals are not 16-byte aligned, so not TMA); while
//            they fly it tests the tile's slots, 1024 a round, and lists
//            the alive ones in slot order (each thread's count, a warp
//            scan and the warps' sums), so a warp's particles sit in
//            different cells. Each thread then takes one listed particle:
//            the staggered quadratic gather from the shared window (the
//            taps and their order of cell3d.cuh::gather_six, as kernel B4
//            reads them from device memory), with want_chi the pre-push
//            ig0 and chi, Boris, the second half push, the slot written
//            back, and its Esirkepov stencil added into the shared panel
//            with shared-memory atomics: over each axis's window of four
//            offsets where its shapes live (cell3d.cuh::deposit_window;
//            the five-tap deposit_atomic for a particle that moved a cell
//            or more), exact zeros skipped. Whole rounds of 256 particles
//            run; the rest is carried into the next round. The panel goes to rims_out;
//            kernel B3 (fold3d.cu) overlap-adds the panels into the
//            interior J. Dead slots are not touched.
//  photon3   the photon mode's tail, one thread a slot: 1/|u| and the
//            second half push of each alive slot; no fields, no panels.
//
// Repeatability: the panel sums run in the order the atomics land, which
// changes from run to run, so the panels (and J) do not repeat bit for
// bit; two runs agree to the rounding of the sums (float64 checks hold
// them within 1e-12 of the peak, float32 within 1e-4). Slots, merges and
// ids do repeat bit for bit.
//
// No tensor cores: the gather and the stencil are per-particle outer
// products of 3-5 tap vectors, far below a wgmma tile, and TF32 would
// break the float32 gates.
//
// Modes (the int I_MODE), as in the 2D kernel (cellstep.cu):
//  default   as above.
//  want_chi  the tail also writes, between the gather and Boris, the
//            post-migration pre-push ig0 = 1/sqrt(1 + u^2) and the quantum
//            parameter chi of every alive slot (0 and 1 in dead slots; the
//            caller masks chi with alive). Replaces unified_cell_step's
//            want_chi branch (cellslab.py:1094-1109) on 3D slots.
//  photon    field free (q = m = 0): photon3 in place of tail3, no panels.
//            Replaces the photon branch (cellslab.py:966-986) on 3D slots.
// Extra payloads: up to NXF float arrays (a QED species' tau, delta,
// event) ride through the three passes. On a collision they take the
// placed slot's value (lo arrival, else hi arrival, else the resident);
// only w, x, y, z, ux, uy, uz are merged.
//
// On a device mesh (K4: replaces unified_cell_step's merge_axes, tail and
// yz_edges arguments on 3D slots and slab_species_step's edge exchanges,
// cellslab.py:1896-2043) one call is one dispatch on one shard: the rebin
// passes of axes I_MERGE_LO .. I_MERGE_HI, then with I_TAIL the tail. A
// dispatch's passes alternate between the buffers so that the last lands
// in A, the dispatch's output (the pushed slots with the tail; else the
// re-binned slots the caller hands to the next dispatch, whose dead slots
// hold whatever they held). An axis whose bit is set in I_EDGE_AXES takes
// its lo and hi columns from the neighbour shards' edge arrays (one cell
// wide along that axis, alive as int32, zero past an open global face) in
// place of the wrap: the x edges are the stored (pre-push) slots, half
// pushed here; a y or z edge is the previous dispatch's output. Their
// arrivals get the -+n coordinate shift of wrapped ones.
//
// Capacity: up to 32 slots a cell rebin3w keeps a block's sort entries in
// shared memory; up to MAXC_LOCAL (128) rebin3 keeps a thread's in a local
// array; above it the passes run a grid-stride loop over the cells with the
// entries in a global scratch row per thread (as cell2d.cuh's for_cells).
// tail3 takes any capacity: it walks a tile's slots in rounds.
//
// Compiled with --fmad=false: positions, keys and merges round exactly as
// the plain version's separate tensor operations do, so cell assignment
// and merge pairing match it slot for slot.
//
// Bound on an H100 (3.35 TB/s): bytes, counted as for the 2D kernel: the
// alive mask (1 B a slot); x, y, z, w, ux, uy, uz, inv_gamma, id_lo, id_hi
// of each alive slot; the E/B nodes the gather reaches from occupied
// cells; one write of every slot and of the panels (want_chi: chi and ig0
// written too; photon: no fields, no panels). Operations: about 3300 flops
// an alive particle (the gather's 252 taps, Boris, 125 nodes of the
// stencil). What bounds the design: the passes read and write whole
// 32-byte sectors of some ten slot arrays, and at 20-30% occupancy nearly
// every sector holds an alive slot, so reading and writing alive slots
// alone saves few bytes; their time is that of moving the arrays three
// times. In tail3 the stencil's shared-memory float atomics, which sm_90
// runs as compare-and-swap loops (ATOMS.CAST.SPIN), take most of the time:
// the windowed form adds 240 nodes a particle (304 with rho) where the
// five-tap loops would add 375 (500); the gather's 252 shared loads and the
// particle's slot traffic take the rest. tail3 runs three blocks an SM
// (at most 85 registers a thread, a few spilled), which measured faster
// than one or two.
#include "cell3d.cuh"

namespace {

using lp2d::add_merges;
using lp2d::five_way;
using lp2d::key_of;
using lp2d::MAXC_LOCAL;
using lp2d::pack_key;
using lp2d::pushed;
using lp2d::slot_of;
using lp2d::WFloor;
using lp3d::PAN;
using lp3d::PAN3;
using lp3d::TILE;
using lp3d::WIN;
using lp3d::WIN3;

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

constexpr int REBIN_THREADS = 128;   // rebin3's block

// Sort entries of the re-binning. A (key, slot) entry of a thread's cell
// column is reached through Keys: rebin3w keeps a block's entries in
// shared memory, (column, slot, cell) with the cell fastest, so that a
// warp (32 cells, one slot) hits 32 banks; rebin3 in a thread-local array
// or in the global scratch row, as cell2d.cuh's for_cells keeps them.
template <int STRIDE>
struct Keys {
  int* p;
  __device__ __forceinline__ int& operator[](int i) const {
    return p[i * STRIDE];
  }
};

// net_sort (cell2d.cuh) on entries off .. of k: the compare-exchange list
// of cellpallas.py::_batcher_network, swapping on a strict ka > kb.
template <typename K>
__device__ __forceinline__ void sort_keys(const K& k, int off,
                                          const int* __restrict__ ces,
                                          int nces) {
  for (int e = 0; e < nces; ++e) {
    int a = off + __ldg(ces + 2 * e), b = off + __ldg(ces + 2 * e + 1);
    int ka = k[a], kb = k[b];
    if (key_of(ka) > key_of(kb)) {
      k[a] = kb;
      k[b] = ka;
    }
  }
}

// Shift a wrapped arrival's coordinate along the pass's axis.
template <typename T>
__device__ __forceinline__ void adjust(Slot<T>& v, int axis, T by) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k == axis) v.f[FX + k] = v.f[FX + k] + by;
}

// A receiver slot that two or three sources reach (ops/cell2d.py::
// migrate_cells): it takes the lo arrival's ids and extras, else the hi
// arrival's, else the resident's; w is summed and the coordinates and
// momenta weight-averaged. A source that is absent is not read.
template <typename T>
__device__ void merge(bool vlo, bool vhi, bool stay, const Slot<T>& lo,
                      const Slot<T>& hi, const Slot<T>& own, Slot<T>& out) {
#pragma unroll
  for (int k = 0; k < NF; ++k)
    out.f[k] = vlo ? lo.f[k] : (vhi ? hi.f[k] : own.f[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    out.id[k] = vlo ? lo.id[k] : (vhi ? hi.id[k] : own.id[k]);
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    out.xf[k] = vlo ? lo.xf[k] : (vhi ? hi.xf[k] : own.xf[k]);
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
    T vr = stay ? own.f[k] : zero;
    out.f[k] = ((w_lo * vl + w_hi * vh) + w_res * vr) / wsafe;
  }
  out.f[FW] = wsum;
}

// An alive output slot: the alive byte and every payload.
template <typename T, bool XF>
__device__ __forceinline__ void store_alive(const SlotsOut<T>& o,
                                            long long idx, const Slot<T>& v,
                                            int nxf) {
  o.alive[idx] = 1;
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

// A dead slot of the stage's output (the last pass): the plain version's
// zero floats (and extras), inv_gamma 1, want_chi's chi 0 and ig0 1. Its
// ids are not written.
template <typename T, bool XF>
__device__ __forceinline__ void store_dead_last(const Args<T>& a,
                                                const SlotsOut<T>& o,
                                                long long idx) {
  o.alive[idx] = 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) o.f[k][idx] = T(0);
  if (XF) {
#pragma unroll
    for (int k = 0; k < NXF; ++k)
      if (k < a.nxf) o.xf[k][idx] = T(0);
  }
  a.ig_out[idx] = T(1);
  if (a.mode == M_WANT_CHI) {
    a.chi_out[idx] = T(0);
    a.ig0_out[idx] = T(1);
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

// One cell of a re-binning pass along ``axis`` (0 x, 1 y, 2 z): its index
// i along the axis and its lo, own and hi neighbour columns. The lo (hi)
// column comes from the neighbour shard's edge where the axis takes edges
// (EDGE, a compile-time flag, so the one-device passes keep their own
// code): (cap, ...) with this axis one cell wide, at index ``at`` (the
// cell's index with the axis dropped), slot stride ``es``.
struct Pass {
  long long cell, nb[3], es, at;
  int axis, i, n;
  bool first, last, elo, ehi, lo_ok, hi_ok;
};

template <typename T, bool EDGE>
__device__ __forceinline__ Pass make_pass(const Args<T>& a, int axis,
                                          long long cell) {
  Pass q;
  const long long plane = (long long)a.ny * a.nz;
  const int ix = (int)(cell / plane);
  const int rem = (int)(cell - (long long)ix * plane);
  const int iy = rem / a.nz, iz = rem - iy * a.nz;
  q.cell = cell;
  q.axis = axis;
  q.first = axis == 0;
  q.last = axis == 2;
  q.i = axis == 0 ? ix : (axis == 1 ? iy : iz);
  q.n = axis == 0 ? a.nx : (axis == 1 ? a.ny : a.nz);
  const long long stride = axis == 0 ? plane : (axis == 1 ? a.nz : 1);
  const int ilo = q.i > 0 ? q.i - 1 : q.n - 1, ihi = q.i < q.n - 1 ? q.i + 1 : 0;
  q.nb[0] = cell + (long long)(ilo - q.i) * stride;
  q.nb[1] = cell;
  q.nb[2] = cell + (long long)(ihi - q.i) * stride;
  q.elo = EDGE && q.i == 0;
  q.ehi = EDGE && q.i == q.n - 1;
  q.es = a.ncell / q.n;
  q.at = axis == 0 ? (long long)iy * a.nz + iz
         : (axis == 1 ? (long long)ix * a.nz + iz : (long long)ix * a.ny + iy);
  const bool per = a.per[axis] != 0;
  q.lo_ok = per || q.i != 0 || EDGE;
  q.hi_ok = per || q.i != q.n - 1 || EDGE;
  return q;
}

// The 5-way key of slot s of column c3 (0 lo, 1 own, 2 hi), keyed at the
// column's own cell index (a neighbour shard's edge column at the
// neighbour's); the x pass keys the first half-pushed position. A dead
// slot's payload is not read.
template <typename T>
__device__ __forceinline__ int slot_key(const Args<T>& a,
                                        const SlotsIn<T>& src, const Pass& q,
                                        int c3, int s) {
  const int ci = c3 == 0 ? (q.i > 0 ? q.i - 1 : q.n - 1)
                 : (c3 == 1 ? q.i : (q.i < q.n - 1 ? q.i + 1 : 0));
  const T xi = T(ci);
  const int ax = q.axis;
  bool al, hi = false, lo = false;
  T p = T(0);
  if ((c3 == 0 && q.elo) || (c3 == 2 && q.ehi)) {
    const Edge<T>& e = e_of(a, ax, c3 == 2);
    const long long idx = q.at + s * q.es;
    al = e.alive[idx] != 0;
    if (al)
      p = q.first ? pushed(e.f[FX][idx], e.f[FUX][idx], e.ig[idx], a.h[0])
                  : e.f[FX + ax][idx];
  } else {
    const long long idx = q.nb[c3] + s * a.ncell;
    al = src.alive[idx] != 0;
    if (al)
      p = q.first ? pushed(src.f[FX][idx], src.f[FUX][idx], a.ig[idx], a.h[0])
                  : src.f[FX + ax][idx];
  }
  if (al) {
    const T local = p - xi;
    hi = local >= T(0.5);
    lo = local < T(-0.5);
  }
  return pack_key(five_way(al, hi, lo, s), s);
}

// Output slot p of the pass's cell from the sorted entries klo, kown, khi
// (slot p of the lo, own and hi columns): placement by overwrite with lo
// priority, the merge of collisions, the -+n shift of wrapped arrivals and
// the drop at open faces. Only the sources placed are read, and a dead
// output slot gets its alive byte alone but in the last pass.
template <typename T, bool XF>
__device__ __forceinline__ void place_slot(const Args<T>& a,
                                           const SlotsIn<T>& src,
                                           const SlotsOut<T>& dst,
                                           const Pass& q, int p, int klo,
                                           int kown, int khi, int& merges) {
  const bool vlo = q.lo_ok && key_of(klo) == 0;
  const bool vhi = q.hi_ok && key_of(khi) == 4;
  const bool stay = key_of(kown) == 2;
  const long long out = (long long)p * a.ncell + q.cell;
  const int n_src = (int)vlo + (int)vhi + (int)stay;
  if (n_src == 0) {
    if (q.last)
      store_dead_last<T, XF>(a, dst, out);
    else
      dst.alive[out] = 0;
    return;
  }
  auto fetch_lo = [&](Slot<T>& v) {
    if (q.elo)
      load_edge<T, XF>(a, e_of(a, q.axis, 0), q.at + slot_of(klo) * q.es,
                       q.first, v);
    else
      load<T, XF>(a, src, (long long)slot_of(klo) * a.ncell + q.nb[0],
                  q.first, v);
    if (q.i == 0) adjust(v, q.axis, T(-q.n));
  };
  auto fetch_hi = [&](Slot<T>& v) {
    if (q.ehi)
      load_edge<T, XF>(a, e_of(a, q.axis, 1), q.at + slot_of(khi) * q.es,
                       q.first, v);
    else
      load<T, XF>(a, src, (long long)slot_of(khi) * a.ncell + q.nb[2],
                  q.first, v);
    if (q.i == q.n - 1) adjust(v, q.axis, T(q.n));
  };
  auto fetch_own = [&](Slot<T>& v) {
    load<T, XF>(a, src, (long long)slot_of(kown) * a.ncell + q.cell, q.first,
                v);
  };
  Slot<T> v;
  if (n_src == 1) {
    if (vlo)
      fetch_lo(v);
    else if (vhi)
      fetch_hi(v);
    else
      fetch_own(v);
  } else {
    merges += n_src - 1;
    Slot<T> lo = {}, hi = {}, own = {};
    if (vlo) fetch_lo(lo);
    if (vhi) fetch_hi(hi);
    if (stay) fetch_own(own);
    merge(vlo, vhi, stay, lo, hi, own, v);
  }
  store_alive<T, XF>(dst, out, v, a.nxf);
}

// A pass up to 32 slots a cell (MAXC 8, 16 or 32): one thread per cell and
// slot, a block of RB_CELLS cells x MAXC slots (thread t: slot t /
// RB_CELLS, cell t % RB_CELLS, so a warp takes one slot of 32 neighbouring
// cells and its loads coalesce). Each thread keys its slot in the three
// columns, the threads of slots 0, 1 and 2 sort one column each, then each
// thread places its output slot. The slots' loads run in parallel threads,
// not one after another in a cell's thread.
constexpr int RB_CELLS = 32;

template <typename T, int MAXC, bool XF, bool EDGE>
__global__ void __launch_bounds__(RB_CELLS * MAXC)
    rebin3w(Args<T> a, SlotsIn<T> src, SlotsOut<T> dst, int axis) {
  __shared__ int sk[3 * MAXC * RB_CELLS];
  const int lc = threadIdx.x % RB_CELLS, s = threadIdx.x / RB_CELLS;
  const long long cell = (long long)blockIdx.x * RB_CELLS + lc;
  const bool valid = cell < a.ncell;
  Pass q;
  if (valid) q = make_pass<T, EDGE>(a, axis, cell);
  if (valid && s < a.cap) {
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3)
      sk[(c3 * MAXC + s) * RB_CELLS + lc] = slot_key(a, src, q, c3, s);
  }
  __syncthreads();
  if (valid && s < 3)
    sort_keys(Keys<RB_CELLS>{sk + s * MAXC * RB_CELLS + lc}, 0, a.ces,
              a.nces);
  __syncthreads();
  int merges = 0;
  if (valid && s < a.cap)
    place_slot<T, XF>(a, src, dst, q, s, sk[s * RB_CELLS + lc],
                      sk[(MAXC + s) * RB_CELLS + lc],
                      sk[(2 * MAXC + s) * RB_CELLS + lc], merges);
  add_merges(a.n_merged, merges);
}

// A pass above 32 slots a cell: one thread per cell (MAXC 64 or 128, the
// entries in a thread-local array) or a grid-stride loop over the cells
// with the entries in the global scratch row (MAXC 0, above MAXC_LOCAL).
template <typename T, int MAXC, bool XF, bool EDGE>
__global__ void __launch_bounds__(REBIN_THREADS)
    rebin3(Args<T> a, SlotsIn<T> src, SlotsOut<T> dst, int axis) {
  int merges = 0;
  auto body = [&](long long cell, const auto& k, int ks) {
    const Pass q = make_pass<T, EDGE>(a, axis, cell);
    for (int c3 = 0; c3 < 3; ++c3) {
      for (int s = 0; s < a.cap; ++s) k[c3 * ks + s] = slot_key(a, src, q, c3, s);
      sort_keys(k, c3 * ks, a.ces, a.nces);
    }
    for (int p = 0; p < a.cap; ++p)
      place_slot<T, XF>(a, src, dst, q, p, k[p], k[ks + p], k[2 * ks + p],
                        merges);
  };
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (MAXC > 0) {
    if (cell < a.ncell) {
      int k[lp2d::KEY_ROWS * MAXC];
      body(cell, Keys<1>{k}, MAXC);
    }
  } else {
    Keys<1> k{a.keys + cell * lp2d::KEY_ROWS * a.cap};
    for (; cell < a.ncell; cell += (long long)gridDim.x * blockDim.x)
      body(cell, k, a.cap);
  }
  add_merges(a.n_merged, merges);
}

// -- the tail: push and deposit of one 8^3 tile a block ----------------------

constexpr int TILE3 = TILE * TILE * TILE;
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr int PER_THREAD = 4;                // slots a thread tests a round
constexpr int ROUND = PER_THREAD * TAIL_THREADS;

// Dynamic shared memory of a tail block: the E/B window, the panel, the
// list of alive slots (a round's and those carried over) and the warps'
// counts. A float32 block takes 56.5 KB (63.2 KB with rho; three blocks an
// SM), a float64 one 121.4 KB.
template <typename T>
inline size_t tail_smem(int ncomp) {
  return sizeof(T) * (6 * WIN3 + (size_t)ncomp * PAN3) +
         sizeof(int) * (ROUND + TAIL_THREADS + TAIL_WARPS);
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

// Candidate c of a tile (slot-major, then x, y, z within the tile) as the
// slot index of the per-slot arrays, or -1 past the grid.
template <typename T>
__device__ __forceinline__ long long tile_slot(const Args<T>& a, int c,
                                               int x0, int y0, int z0) {
  const int sl = c / TILE3, r = c - sl * TILE3;
  const int ix = x0 + r / (TILE * TILE), iy = y0 + (r / TILE) % TILE,
            iz = z0 + r % TILE;
  if (ix >= a.nx || iy >= a.ny || iz >= a.nz) return -1;
  return (long long)sl * a.ncell + ((long long)ix * a.ny + iy) * a.nz + iz;
}

// One alive particle of the tile: the gather from the shared window (with
// want_chi the pre-push ig0 and chi), Boris, the second half push, the
// slot written back, then its stencil added into the shared panel.
template <typename T, int MODE>
__device__ __forceinline__ void tail_particle(const Args<T>& a,
                                              const SlotsOut<T>& s,
                                              const T* win, T* pan, int c,
                                              int x0, int y0, int z0) {
  const int sl = c / TILE3, r = c - sl * TILE3;
  const int lx = r / (TILE * TILE), ly = (r / TILE) % TILE, lz = r % TILE;
  const int ix = x0 + lx, iy = y0 + ly, iz = z0 + lz;
  const long long idx =
      (long long)sl * a.ncell + ((long long)ix * a.ny + iy) * a.nz + iz;
  T x = s.f[FX][idx], y = s.f[FY][idx], z = s.f[FZ][idx];
  const T d[3] = {x - T(ix), y - T(iy), z - T(iz)};
  T e[6];
  lp3d::gather_eb_window(win, lx, ly, lz, d, e);
  T ux = s.f[FUX][idx], uy = s.f[FUY][idx], uz = s.f[FUZ][idx];
  if (MODE == M_WANT_CHI)
    lp2d::quantum_chi(e, ux, uy, uz, a.c, a.chi, a.chi_out[idx],
                      a.ig0_out[idx]);
  const T ig = lp2d::boris(ux, uy, uz, e, a.ef, a.bf);
  x = pushed(x, ux, ig, a.h[0]);
  y = pushed(y, uy, ig, a.h[1]);
  z = pushed(z, uz, ig, a.h[2]);
  s.f[FX][idx] = x;
  s.f[FY][idx] = y;
  s.f[FZ][idx] = z;
  s.f[FUX][idx] = ux;
  s.f[FUY][idx] = uy;
  s.f[FUZ][idx] = uz;
  a.ig_out[idx] = ig;
  const T w = s.f[FW][idx];
  lp3d::Taps<T> tx, ty, tz;
  lp3d::axis_taps(x - T(ix), (ux * ig) * a.cd[0], tx);
  lp3d::axis_taps(y - T(iy), (uy * ig) * a.cd[1], ty);
  lp3d::axis_taps(z - T(iz), (uz * ig) * a.cd[2], tz);
  lp3d::Win4<T> wx, wy, wz;
  lp3d::window4(tx, wx);
  lp3d::window4(ty, wy);
  lp3d::window4(tz, wz);
  const int node0 = (lx * PAN + ly) * PAN + lz;
  const T cd = a.kcd * w, nfx = -(a.kf[0] * w), nfy = -(a.kf[1] * w),
          nfz = -(a.kf[2] * w);
  if (wx.ok && wy.ok && wz.ok)
    lp3d::deposit_window(pan, node0, a.ncomp, tx, ty, tz, wx, wy, wz, cd, nfx,
                         nfy, nfz);
  else
    lp3d::deposit_atomic(pan, node0, a.ncomp, tx, ty, tz, cd, nfx, nfy, nfz);
}

// The tail of the default and want_chi modes, one block per 8^3 tile of
// cells (tile (bi, bj, bk) = block (bi*nby + bj)*nbz + bk, the panels'
// order): the tile's E/B window (nodes -2 .. 8 of each axis, six
// components) and its rims_in panel go into shared memory by cp.async;
// meanwhile the block tests the tile's slots ROUND at a time and lists the
// alive ones (a prefix sum of the threads' counts); each thread then takes
// one listed particle at a time, whole rounds of TAIL_THREADS, the rest
// carried into the next round. The panel is written to rims_out.
template <typename T, int MODE>
__global__ void __launch_bounds__(TAIL_THREADS, 3) tail3(Args<T> a,
                                                      SlotsOut<T> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* pan = win + 6 * WIN3;
  const int C = a.ncomp;
  int* list = reinterpret_cast<int*>(pan + C * PAN3);
  int* wtot = list + ROUND + TAIL_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nby = (a.ny + TILE - 1) / TILE, nbz = (a.nz + TILE - 1) / TILE;
  const long long nblocks = gridDim.x, block = blockIdx.x;
  const int bi = (int)(block / ((long long)nby * nbz));
  const int rb = (int)(block - (long long)bi * nby * nbz);
  const int bj = rb / nbz, bk = rb - bj * nbz;
  const int x0 = bi * TILE, y0 = bj * TILE, z0 = bk * TILE;
  // window node (wx, wy, wz) is padded node (x0 + g - 2 + wx, ...); nodes
  // past the padded stack's end are left unset: only cells past the grid,
  // which hold no slot, would read them
  const int nxp = a.nx + 2 * a.g, nyp = a.ny + 2 * a.g, nzp = a.nz + 2 * a.g;
  const long long vol = (long long)nxp * nyp * nzp;
  for (int e = tid; e < 6 * WIN3; e += TAIL_THREADS) {
    const int c = e / WIN3, r = e - c * WIN3;
    const int wx = r / (WIN * WIN), wy = (r / WIN) % WIN, wz = r % WIN;
    const int px = x0 + a.g - 2 + wx, py = y0 + a.g - 2 + wy,
              pz = z0 + a.g - 2 + wz;
    if (px < nxp && py < nyp && pz < nzp)
      copy_async(win + e, a.eb + c * vol + ((long long)px * nyp + py) * nzp + pz);
  }
  for (int e = tid; e < C * PAN3; e += TAIL_THREADS) {
    const int c = e / PAN3, r = e - c * PAN3;
    if (a.rims_in)
      copy_async(pan + e, a.rims_in + ((long long)c * nblocks + block) * PAN3 + r);
    else
      pan[e] = T(0);
  }
  copy_async_commit();
  const int total = a.cap * TILE3;
  int carry = 0;
  bool ready = false;
  for (int base = 0; base < total; base += ROUND) {
    // a thread tests neighbouring candidates, so the list runs in
    // candidate order and a warp's particles sit in different cells (two
    // in one cell would hit the same nodes with one atomic instruction)
    unsigned m = 0;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int c = base + PER_THREAD * tid + r;
      if (c < total) {
        const long long idx = tile_slot(a, c, x0, y0, z0);
        if (idx >= 0 && s.alive[idx]) m |= 1u << r;
      }
    }
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < TAIL_WARPS; ++w) {
      const int t = wtot[w];
      before += w < warp ? t : 0;
      sum += t;
    }
    int at = carry + before + incl - cnt;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r)
      if ((m >> r) & 1) list[at++] = base + PER_THREAD * tid + r;
    const int n = carry + sum;
    const int full = base + ROUND >= total ? n : n - n % TAIL_THREADS;
    if (!ready) {
      copy_async_wait();
      ready = true;
    }
    __syncthreads();
    for (int j = tid; j < full; j += TAIL_THREADS)
      tail_particle<T, MODE>(a, s, win, pan, list[j], x0, y0, z0);
    __syncthreads();
    carry = n - full;
    if (full > 0 && tid < carry) list[tid] = list[full + tid];
    __syncthreads();
  }
  for (int e = tid; e < C * PAN3; e += TAIL_THREADS) {
    const int c = e / PAN3, r = e - c * PAN3;
    a.rims_out[((long long)c * nblocks + block) * PAN3 + r] = pan[e];
  }
}

// The photon mode's tail, one thread a slot: inv_gamma = 1/|u| and the
// second half push of each alive slot (the last pass gave the dead ones
// their values).
template <typename T>
__global__ void __launch_bounds__(256) photon3(Args<T> a, SlotsOut<T> s) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.cap * a.ncell || !s.alive[idx]) return;
  const T ux = s.f[FUX][idx], uy = s.f[FUY][idx], uz = s.f[FUZ][idx];
  const T ig = lp2d::photon_ig(ux, uy, uz);
  s.f[FX][idx] = pushed(s.f[FX][idx], ux, ig, a.h[0]);
  s.f[FY][idx] = pushed(s.f[FY][idx], uy, ig, a.h[1]);
  s.f[FZ][idx] = pushed(s.f[FZ][idx], uz, ig, a.h[2]);
  a.ig_out[idx] = ig;
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
// MAXC 4 .. 32: rebin3w, one thread a cell and slot; 64, 128 and 0:
// rebin3, one thread a cell.
template <typename T, int MAXC, bool XF>
int launch_passes_xf(const Args<T>& a, const Buffers<T>& b, int lo, int hi,
                     cudaStream_t st) {
  constexpr bool wide = MAXC > 0 && MAXC <= 32;
  int threads = wide ? RB_CELLS * MAXC : REBIN_THREADS;
  int blocks = wide ? ceil_div(a.ncell, RB_CELLS)
                    : lp2d::cell_blocks(a.ncell, a.cap, a.key_threads, threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  SlotsIn<T> src = b.in;
  bool to_a = (hi - lo) % 2 == 0;
  for (int axis = lo; axis <= hi; ++axis) {
    SlotsOut<T> dst = to_a ? b.a_out : b.b_out;
    const bool edge = (a.edge_axes >> axis) & 1;
    if constexpr (wide) {
      if (edge)
        rebin3w<T, MAXC, XF, true><<<blocks, threads, 0, st>>>(a, src, dst, axis);
      else
        rebin3w<T, MAXC, XF, false><<<blocks, threads, 0, st>>>(a, src, dst, axis);
    } else {
      if (edge)
        rebin3<T, MAXC, XF, true><<<blocks, threads, 0, st>>>(a, src, dst, axis);
      else
        rebin3<T, MAXC, XF, false><<<blocks, threads, 0, st>>>(a, src, dst, axis);
    }
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

template <typename T, int MODE>
int launch_tail(const Args<T>& a, const SlotsOut<T>& s, cudaStream_t st) {
  const int nblocks = ceil_div(a.nx, TILE) * ceil_div(a.ny, TILE) *
                      ceil_div(a.nz, TILE);
  const size_t smem = tail_smem<T>(a.ncomp);
  int err = (int)cudaFuncSetAttribute(
      tail3<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  tail3<T, MODE><<<nblocks, TAIL_THREADS, smem, st>>>(a, s);
  return (int)cudaGetLastError();
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
      (a.edge_axes & ~(1 << lo)) ||
      (tail && a.mode != M_PHOTON && (a.g < 2 || a.ncomp < 3 || a.ncomp > 4)))
    return (int)cudaErrorInvalidValue;
  for (int ax = 0; ax < 3; ++ax)
    for (int sd = 0; sd < 2; ++sd)
      unpack_edge(a.e[ax][sd], p + P_EDGES + (2 * ax + sd) * EDGE_PTRS);
  int err;
  if (a.cap <= 4) err = launch_passes<T, 4>(a, b, lo, hi, st);
  else if (a.cap <= 8) err = launch_passes<T, 8>(a, b, lo, hi, st);
  else if (a.cap <= 16) err = launch_passes<T, 16>(a, b, lo, hi, st);
  else if (a.cap <= 32) err = launch_passes<T, 32>(a, b, lo, hi, st);
  else if (a.cap <= 64) err = launch_passes<T, 64>(a, b, lo, hi, st);
  else if (a.cap <= MAXC_LOCAL) err = launch_passes<T, MAXC_LOCAL>(a, b, lo, hi, st);
  else err = launch_passes<T, 0>(a, b, lo, hi, st);
  if (err || !tail) return err;
  if (a.mode == M_PHOTON) {
    int threads = 256;
    photon3<T><<<ceil_div((long long)a.cap * a.ncell, threads), threads, 0,
                 st>>>(a, b.a_out);
    return (int)cudaGetLastError();
  }
  return a.mode == M_WANT_CHI ? launch_tail<T, M_WANT_CHI>(a, b.a_out, st)
                              : launch_tail<T, M_DEFAULT>(a, b.a_out, st);
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
