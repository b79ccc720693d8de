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
// ix*ny + iy, slot stride nx*ny. Three __global__ functions run in order
// (the y pass must see the x pass's result in a cell's y neighbours, so
// the end of a launch separates them):
//
//  rebin2x   one block a tile of 8 x 32 cells (x rows of a warp's 32
//            contiguous cells), input -> scratch. Each thread keys one
//            column (a cell's cap slots) of the tile and of its two halo
//            rows along x into shared memory: the first half push, then
//            the 5-way key (donor+1 / dead-even / stay / dead-odd /
//            donor-1, dead parity from the slot index before the sort),
//            the payloads read for alive slots only. The same thread sorts
//            its column's (key, slot) pairs through the Batcher
//            compare-exchange list of cellpallas.py::_batcher_network
//            (swap on a strict ka > kb; the exchange decisions depend on
//            the keys alone, so permuting the payloads afterwards is
//            bitwise the same). All threads run the same list, so a
//            warp's accesses of one step fall on 32 neighbouring entries:
//            each column is sorted once, not by each of the three cells
//            that read it; a column with nothing alive is not sorted (its
//            keys are all dead, which places nothing). A block whose
//            columns hold nothing alive (__syncthreads_or) writes its
//            tile's flag 0 and stops (in a mesh's x-only dispatch, whose
//            output is returned, also its dead slots). Otherwise each
//            thread places its cell's output slots: arrivals by overwrite
//            with lo priority, collisions merged weight-conservingly, the
//            -+nx coordinate adjust of wrapped arrivals, the drop at open
//            faces; then the tile's flag says whether any slot is alive. A
//            source slot's payload is read only when it is placed alive,
//            and payloads are written only to alive output slots (the
//            alive byte to every slot): in a one-device call as one
//            record a slot (Rec), read by rebin2y in one or two sectors
//            instead of one an array; y also to its array, for the keys.
//  rebin2y   the same along y, tiles of 8 x 32 cells with one halo column
//            at each end of a row, scratch -> output; an alive slot then
//            gets, in registers, the staggered quadratic gather from
//            eb_pad, Boris and the second half push. Every dead output
//            slot gets the stage's dead values: the plain version's zero
//            floats (and zero extras), inv_gamma 1, want_chi's chi 0 and
//            ig0 1; dead ids are not written. A tile whose own and halo
//            tiles rebin2x flagged empty writes those without reading the
//            scratch, and stops; columns of a flagged tile are keyed dead
//            unread. Two blocks an SM (at most 128 registers a thread).
//  deposit2  one block per 16 x 16 cell tile: 5-tap Esirkepov J (and rho)
//            of every alive slot into a shared (C, 20, 20) tile panel
//            (cell2d.cuh::deposit_panel, shared with kernel B5). A tile
//            with no alive slot (rebin2y's flags of the pass tiles it
//            overlaps, then its alive bytes) copies rims_in to rims_out and
//            stops.
//            Otherwise each thread walks its cell's alive slots once (bit
//            masks of 64 slot indices), computes a particle's shapes once
//            and adds its 25 nodes into per-offset sums in registers; the 25
//            offsets then go into the panel one after another with a barrier
//            between, and within one offset every thread writes a different
//            panel node, so the sum needs no atomics and repeats bit for bit.
//            The panel starts from the previous species' panel (rims_in)
//            and is written to rims_out; kernel B3 (fold.cu) overlap-adds
//            the panels into the interior J.
//
// Modes (the int I_MODE):
//  default   as above.
//  want_chi  rebin2y also writes, between the gather and Boris, the
//            post-migration pre-push ig0 = 1/sqrt(1 + u^2) and the quantum
//            parameter chi (models/qed.py::calculate_chi of the gathered
//            E, B, the momenta and ig0) of every alive slot; the caller
//            masks chi with alive. Replaces unified_cell_step's want_chi
//            branch (cellslab.py:1094-1109).
//  photon    field free (q = m = 0): rebin2y's tail is inv_gamma = 1/|u|
//            (1 where u = 0) and the second half push; no gather, no
//            Boris, no deposit launch, no panels. Replaces the photon
//            branch (cellslab.py:966-986).
// Extra payloads: up to NXF float arrays (a QED species' tau, delta,
// event) ride through both passes. On a collision they take the placed
// slot's value (lo arrival, else hi arrival, else the resident); only
// w, x, y, z, ux, uy, uz are merged.
//
// On a device mesh (K4: replaces unified_cell_step's merge_axes, tail and
// yz_edges arguments and slab_species_step's edge exchanges,
// cellslab.py:1896-2043) one call is one dispatch on one shard:
//  x edges   with I_XEDGE, rebin2x takes its halo rows at x = -1 and nx
//            from the x neighbour shards' stored (pre-push) slots, (cap, 1,
//            ny) arrays with alive as int32 (zero past an open global
//            face), in place of the wrap: it applies their half push, keys
//            them at the neighbour's own cell index (nx-1 or 0), and adds
//            -+nx to their arrivals, as for wrapped columns.
//  dispatch  I_MERGE_LO .. I_MERGE_HI (0 x, 1 y) are the passes to run.
//            A mesh that splits y runs x alone (its output, the scratch
//            slots, goes back to the caller; its dead slots get zero floats
//            and extras), exchanges the y edge rows of that output, then
//            runs y with the tail (I_MERGE_LO = 1: rebin2y reads its input
//            from the scratch pointers).
//  y edges   with I_YEDGE, rebin2y takes its halo columns at y = -1 and ny,
//            (cap, nx, 1), from the y neighbours' x-pass output in place of
//            the wrap.
//
// Capacity: up to MAXC_LOCAL (128) slots a cell the sort entries are
// 16-bit (key, slot) pairs in shared memory (320 columns of cap entries
// a tile in rebin2x: 51 KB at 82 slots); above it 32-bit pairs in the
// block's part of the global key scratch (KEY_ROWS x cap int32 a thread,
// blocks of 4 x 32 cells in a grid-stride loop over the tiles).
//
// The key, merge count, gather, Boris, chi and deposit routines live in
// cell2d.cuh, shared with the 3D kernel and the per-stage kernels B4-B7.
//
// Compiled with --fmad=false: positions, keys and merges round exactly as
// the plain version's separate tensor operations do, so cell assignment
// and merge pairing match it slot for slot.
//
// No tensor cores: the gather and the stencil are per-particle outer
// products of 3-5 tap vectors, far below a wgmma tile, and TF32 would
// break the float32 gates.
//
// Bound on an H100 (3.35 TB/s): bytes. The answer depends on the alive
// mask and on the payloads of alive slots only (a dead slot is never a
// source), so the least traffic is: the mask (1 B a slot); x, y, z, w,
// ux, uy, uz, inv_gamma, id_lo, id_hi of each alive slot; the E/B nodes
// the gather reaches from occupied cells; one write of every slot (41 B
// in float32) and of the panels. chip_smoke.py computes it from its
// input. What bounds the design: where most tiles are empty (the 2D
// slice's foil fills 6% of its cells) the write of every dead output slot
// (33 B, ids not written) and the latency of the few occupied tiles, whose
// threads walk their cells' slots in chains of dependent loads; where most
// are occupied, the sector reads of the alive sources (the sort's
// permutation gives a warp's lanes different slots, so each alive source
// costs a 32-byte sector in each of rebin2x's 13 input arrays; the sort
// itself, some 900 compare-exchange steps a column at 82 slots, takes a
// few percent).
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
  P_FLAGS = P_EDGES + 4 * 14,       // tile flags (uint8, I_FLAG_BYTES)
  P_REC,                            // whole dispatch: the slot records
  P_COUNT
};
enum Int { I_CAP, I_NX, I_NY, I_G, I_PERX, I_PERY, I_NCOMP, I_NCES, I_DOUBLE,
           I_MODE, I_NXF, I_KEY_THREADS, I_MERGE_LO, I_MERGE_HI, I_XEDGE,
           I_YEDGE, I_FLAG_BYTES, I_REC_BYTES };
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
  SlotsOut<T> s;        // scratch, written by rebin2x
  SlotsIn<T> sin;       // the same scratch, read by rebin2y
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
  int head;             // a dispatch of rebin2x alone: its output is returned
  int whole;            // both passes: rebin2y reads rebin2x's tile flags
  int tx;               // the passes' tile rows (TX_S or TX_G)
  // per pass tile, whether the pass's output holds an alive slot (rebin2x:
  // xflags, rebin2y: yflags); in a whole dispatch rebin2x writes nothing
  // else for a tile with nothing alive in reach, and rebin2y reads no
  // scratch there
  unsigned char* xflags;
  unsigned char* yflags;
  // whole dispatch: rebin2x's output slots as records of Rec<T>::WORDS
  // 32-bit words (rebin2y reads a source slot in one or two sectors, not
  // one an array); alive and y stay in the scratch arrays for the keys
  uint4* rec;
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

// A slot between the passes of a whole dispatch, as 32-bit words: x y z w
// ux uy uz, id_lo id_hi, the extras, padded to whole 16-byte vectors.
template <typename T>
struct Rec {
  static constexpr int W = sizeof(T) / 4;            // words a real
  static constexpr int WORDS = (NF * W + 2 + NXF * W + 3) / 4 * 4;
  static constexpr int VECS = WORDS / 4;
};

__device__ __forceinline__ void put_word(unsigned* w, int i, float v) {
  w[i] = __float_as_uint(v);
}
__device__ __forceinline__ void put_word(unsigned* w, int i, double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  w[i] = (unsigned)b;
  w[i + 1] = (unsigned)(b >> 32);
}
__device__ __forceinline__ void get_word(const unsigned* w, int i, float& v) {
  v = __uint_as_float(w[i]);
}
__device__ __forceinline__ void get_word(const unsigned* w, int i, double& v) {
  v = __longlong_as_double((long long)(((unsigned long long)w[i + 1] << 32) |
                                       w[i]));
}

template <typename T>
__device__ __forceinline__ void store_rec(uint4* r, const Slot<T>& v) {
  constexpr int W = Rec<T>::W;
  unsigned w[Rec<T>::WORDS] = {};
#pragma unroll
  for (int k = 0; k < NF; ++k) put_word(w, k * W, v.f[k]);
  w[NF * W] = (unsigned)v.id[0];
  w[NF * W + 1] = (unsigned)v.id[1];
#pragma unroll
  for (int k = 0; k < NXF; ++k) put_word(w, NF * W + 2 + k * W, v.xf[k]);
#pragma unroll
  for (int i = 0; i < Rec<T>::VECS; ++i)
    r[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

template <typename T>
__device__ __forceinline__ void load_rec(const uint4* r, Slot<T>& v) {
  constexpr int W = Rec<T>::W;
  unsigned w[Rec<T>::WORDS];
#pragma unroll
  for (int i = 0; i < Rec<T>::VECS; ++i) {
    const uint4 q = r[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) get_word(w, k * W, v.f[k]);
  v.id[0] = (int)w[NF * W];
  v.id[1] = (int)w[NF * W + 1];
#pragma unroll
  for (int k = 0; k < NXF; ++k) get_word(w, NF * W + 2 + k * W, v.xf[k]);
}

template <typename T>
__device__ __forceinline__ void load_x(const Args<T>& a, long long idx,
                                       Slot<T>& v) {
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
__device__ __forceinline__ void load_x_edge(const Args<T>& a, const Edge<T>& e,
                                            long long idx, Slot<T>& v) {
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
__device__ __forceinline__ void load_y_edge(const Args<T>& a, const Edge<T>& e,
                                            long long idx, Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = e.f[k][idx];
  v.id[0] = e.id[0][idx];
  v.id[1] = e.id[1][idx];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) v.xf[k] = e.xf[k][idx];
}

template <typename T>
__device__ __forceinline__ void load_y(const Args<T>& a, long long idx,
                                       Slot<T>& v) {
  if (a.whole) {
    load_rec(a.rec + idx * Rec<T>::VECS, v);
    return;
  }
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
// sources merge (w summed, coordinates and momenta weight-averaged). The
// placed slot is chosen field by field, so the three sources stay in
// registers.
template <typename T>
__device__ __forceinline__ void place(bool vlo, bool vhi, bool stay,
                                      const Slot<T>& lo, const Slot<T>& hi,
                                      const Slot<T>& own, Slot<T>& out,
                                      int& merges) {
  int n_src = (int)vlo + (int)vhi + (int)stay;
  merges += n_src > 1 ? n_src - 1 : 0;
#pragma unroll
  for (int k = 0; k < NF; ++k)
    out.f[k] = vlo ? lo.f[k] : (vhi ? hi.f[k] : own.f[k]);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    out.id[k] = vlo ? lo.id[k] : (vhi ? hi.id[k] : own.id[k]);
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    out.xf[k] = vlo ? lo.xf[k] : (vhi ? hi.xf[k] : own.xf[k]);
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

// ---------------------------------------------------------------------------
// The re-binning passes
// ---------------------------------------------------------------------------

// A pass covers the cells in tiles of TX x TY (TY = a warp's 32 cells
// along y, contiguous in memory); block thread t places cell
// (x0 + t / TY, y0 + t % TY). Its sort entries are (key, slot) pairs,
// entry s of column c at e[s * NCOL + c]: in shared memory as 16-bit pairs
// up to MAXC_LOCAL slots a cell (TX_S rows), else in the block's part of
// the global key scratch as 32-bit ones (TX_G rows, a grid-stride loop
// over the tiles).
constexpr int TY = 32;
constexpr int TX_S = 8;
constexpr int TX_G = 4;

template <typename K> struct Entry;
template <> struct Entry<unsigned short> { static constexpr int SHIFT = 8; };
template <> struct Entry<int> { static constexpr int SHIFT = KEY_SHIFT; };

template <typename K>
__device__ __forceinline__ K entry(int key, int slot) {
  return (K)((key << Entry<K>::SHIFT) | slot);
}
template <typename K>
__device__ __forceinline__ int ekey(K e) { return (int)e >> Entry<K>::SHIFT; }
template <typename K>
__device__ __forceinline__ int eslot(K e) {
  return (int)e & ((1 << Entry<K>::SHIFT) - 1);
}

// Key the cap slots of one column into its entries: alive(s) says whether
// slot s is alive, local(s) is its coordinate relative to the column's
// cell along the pass's axis, read for alive slots only. Returns whether
// any slot is alive.
template <typename T, typename K, typename Alive, typename Local>
__device__ __forceinline__ bool key_column(K* e, int ncol, int col, int cap,
                                           Alive alive, Local local) {
  bool any = false;
  for (int s = 0; s < cap; ++s) {
    bool al = alive(s), hi = false, lo = false;
    if (al) {
      T l = local(s);
      hi = l >= T(0.5);
      lo = l < T(-0.5);
      any = true;
    }
    e[(long long)s * ncol + col] = entry<K>(five_way(al, hi, lo, s), s);
  }
  return any;
}

// Sort one column's entries with the compare-exchange list of
// cellpallas.py::_batcher_network, swapping on a strict ka > kb. Every
// thread of a block runs the same list on its own column, so a warp's 32
// accesses of one step fall on 32 neighbouring entries.
template <typename K>
__device__ __forceinline__ void sort_column(K* e, int ncol, int col,
                                            const int2* __restrict__ ces,
                                            int nces) {
  for (int i = 0; i < nces; ++i) {
    const int2 p = __ldg(ces + i);
    K* pa = e + (long long)p.x * ncol + col;
    K* pb = e + (long long)p.y * ncol + col;
    const K ka = *pa, kb = *pb;
    if (ekey(ka) > ekey(kb)) {
      *pa = kb;
      *pb = ka;
    }
  }
}

// A dead slot's values at the end of the stage (the plain version's): zero
// floats and extras, inv_gamma 1, want_chi's chi 0 and ig0 1. Ids are not
// written.
template <typename T>
__device__ __forceinline__ void store_dead(const Args<T>& a, long long o) {
  a.out.alive[o] = 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) a.out.f[k][o] = T(0);
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < a.nxf) a.out.xf[k][o] = T(0);
  a.ig_out[o] = T(1);
  if (a.mode == M_WANT_CHI) {
    a.chi_out[o] = T(0);
    a.ig0_out[o] = T(1);
  }
}

// rebin2x's output slot of a dead slot: the alive byte; in a head
// dispatch, whose output goes back to the caller, also zero payloads.
template <typename T>
__device__ __forceinline__ void store_dead_x(const Args<T>& a, long long o) {
  a.s.alive[o] = 0;
  if (a.head) {
#pragma unroll
    for (int k = 0; k < NF; ++k) a.s.f[k][o] = T(0);
#pragma unroll
    for (int k = 0; k < NXF; ++k)
      if (k < a.nxf) a.s.xf[k][o] = T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_payload(const SlotsOut<T>& o,
                                              long long idx, const Slot<T>& v,
                                              int nxf) {
  o.alive[idx] = 1;
#pragma unroll
  for (int k = 0; k < NF; ++k) o.f[k][idx] = v.f[k];
  o.id[0][idx] = v.id[0];
  o.id[1][idx] = v.id[1];
#pragma unroll
  for (int k = 0; k < NXF; ++k)
    if (k < nxf) o.xf[k][idx] = v.xf[k];
}

template <typename T>
__device__ __forceinline__ void zero_slot(Slot<T>& v) {
#pragma unroll
  for (int k = 0; k < NF; ++k) v.f[k] = T(0);
}

// The x pass of one tile: input -> scratch. Columns: TX + 2 rows of TY,
// row r at x = x0 - 1 + r (-1 and nx: the wrap, or with EDGE the x
// neighbours' edge columns; at an open face not keyed), each keyed after
// the first half push at its own cell index and sorted once by one thread.
template <typename T, typename K, int TX, bool EDGE>
__device__ __forceinline__ void pass_x_tile(const Args<T>& a, K* e,
                                            long long t, int x0, int y0,
                                            int& merges) {
  constexpr int NT = TX * TY, NCOL = (TX + 2) * TY;
  const int tid = threadIdx.x;
  const int2* ces = reinterpret_cast<const int2*>(a.ces);
  bool any = false;
  for (int col = tid; col < NCOL; col += NT) {
    const int x = x0 - 1 + col / TY, iy = y0 + col % TY;
    if (iy >= a.ny || x > a.nx) continue;
    const bool wrap = x < 0 || x == a.nx;
    if (wrap && !EDGE && !a.perx) continue;          // open face
    const int xc = x < 0 ? a.nx - 1 : (x == a.nx ? 0 : x);
    const T xi = T(xc);
    bool col_any;
    if (wrap && EDGE) {
      const Edge<T>& ed = a.ex[x < 0 ? 0 : 1];
      col_any = key_column<T, K>(
          e, NCOL, col, a.cap,
          [&](int s) { return ed.alive[(long long)s * a.ny + iy] != 0; },
          [&](int s) {
            long long i = (long long)s * a.ny + iy;
            return pushed(ed.f[FX][i], ed.f[FUX][i], ed.ig[i], a.hx) - xi;
          });
    } else {
      const long long base = (long long)xc * a.ny + iy;
      col_any = key_column<T, K>(
          e, NCOL, col, a.cap,
          [&](int s) { return a.in.alive[base + s * a.ncell] != 0; },
          [&](int s) {
            long long i = base + s * a.ncell;
            return pushed(a.in.f[FX][i], a.in.f[FUX][i], a.ig[i], a.hx) - xi;
          });
    }
    // a column with nothing alive keys every slot dead (1 or 3), which
    // places nothing wherever the sort would move them: left unsorted
    if (col_any) sort_column(e, NCOL, col, ces, a.nces);
    any |= col_any;
  }
  const int w = tid / TY, lane = tid % TY;
  const int ix = x0 + w, iy = y0 + lane;
  const bool valid = ix < a.nx && iy < a.ny;
  const long long cell = (long long)ix * a.ny + iy;
  if (!__syncthreads_or(any)) {
    // nothing alive within reach: every output slot is dead (the flag
    // says so to rebin2y in a whole dispatch)
    if (tid == 0) a.xflags[t] = 0;
    if (valid && !a.whole)
      for (int p = 0; p < a.cap; ++p) store_dead_x(a, p * a.ncell + cell);
    return;
  }
  bool wrote = false;
  if (valid) {
    const int clo = w * TY + lane, cown = clo + TY, chi = clo + 2 * TY;
    const bool lo_ok = EDGE || a.perx || ix != 0;
    const bool hi_ok = EDGE || a.perx || ix != a.nx - 1;
    const bool elo = EDGE && ix == 0, ehi = EDGE && ix == a.nx - 1;
    const long long src_lo =
        (long long)(ix > 0 ? ix - 1 : a.nx - 1) * a.ny + iy;
    const long long src_hi =
        (long long)(ix < a.nx - 1 ? ix + 1 : 0) * a.ny + iy;
    for (int p = 0; p < a.cap; ++p) {
      const K kown = e[p * NCOL + cown];
      const K klo = lo_ok ? e[p * NCOL + clo] : K(0);
      const K khi = hi_ok ? e[p * NCOL + chi] : K(0);
      const bool stay = ekey(kown) == 2;
      const bool vlo = lo_ok && ekey(klo) == 0;
      const bool vhi = hi_ok && ekey(khi) == 4;
      const long long o = p * a.ncell + cell;
      if (!(vlo || vhi || stay)) {
        store_dead_x(a, o);
        continue;
      }
      Slot<T> own, lo, hi, out;
      if (stay)
        load_x(a, (long long)eslot(kown) * a.ncell + cell, own);
      else
        zero_slot(own);
      if (vlo) {
        if (elo)
          load_x_edge(a, a.ex[0], (long long)eslot(klo) * a.ny + iy, lo);
        else
          load_x(a, (long long)eslot(klo) * a.ncell + src_lo, lo);
        if (ix == 0) lo.f[FX] = lo.f[FX] + T(-a.nx);
      }
      if (vhi) {
        if (ehi)
          load_x_edge(a, a.ex[1], (long long)eslot(khi) * a.ny + iy, hi);
        else
          load_x(a, (long long)eslot(khi) * a.ncell + src_hi, hi);
        if (ix == a.nx - 1) hi.f[FX] = hi.f[FX] + T(a.nx);
      }
      place(vlo, vhi, stay, lo, hi, own, out, merges);
      if (a.whole) {
        a.s.alive[o] = 1;
        a.s.f[FY][o] = out.f[FY];
        store_rec(a.rec + o * Rec<T>::VECS, out);
      } else {
        store_payload(a.s, o, out, a.nxf);
      }
      wrote = true;
    }
  }
  wrote = __syncthreads_or(wrote);
  if (tid == 0) a.xflags[t] = wrote;
}

// The y pass of one tile, scratch -> output, and the push of its alive
// slots. Columns: the tile's NT (row w, lane) and two halo columns a row
// at NT + 2w (y0 - 1) and NT + 2w + 1 (the next tile's first, or at the
// last tile of a row the wrap: with EDGE the y neighbours' edge rows; at
// an open face not keyed).
template <typename T, typename K, int TX, bool EDGE>
__device__ __forceinline__ void pass_y_tile(const Args<T>& a, K* e,
                                            long long t, int nty, int x0,
                                            int y0, int& merges) {
  constexpr int NT = TX * TY, NCOL = NT + 2 * TX;
  const int tid = threadIdx.x;
  const int w = tid / TY, lane = tid % TY;
  const int ix = x0 + w, iy = y0 + lane;
  const bool valid = ix < a.nx && iy < a.ny;
  const long long cell = (long long)ix * a.ny + iy;
  // in a whole dispatch, whether rebin2x left anything alive in this tile
  // and in the tiles of its halo columns (the wrap's when periodic)
  const int by = (int)(t % nty);
  const long long t_lo = by > 0 ? t - 1 : (a.pery ? t + nty - 1 : -1);
  const long long t_hi = by < nty - 1 ? t + 1 : (a.pery ? t - (nty - 1) : -1);
  const bool f_own = !a.whole || a.xflags[t];
  const bool f_lo = !a.whole || (t_lo >= 0 && a.xflags[t_lo]);
  const bool f_hi = !a.whole || (t_hi >= 0 && a.xflags[t_hi]);
  if (!(f_own || f_lo || f_hi)) {
    if (tid == 0) a.yflags[t] = 0;
    if (valid)
      for (int p = 0; p < a.cap; ++p) store_dead(a, p * a.ncell + cell);
    return;
  }
  const int2* ces = reinterpret_cast<const int2*>(a.ces);
  bool any = false;
  for (int col = tid; col < NCOL; col += NT) {
    int cx, y;
    bool live;                      // the scratch holds this column
    if (col < NT) {
      cx = x0 + col / TY;
      y = y0 + col % TY;
      live = f_own;
      if (y >= a.ny) continue;
    } else {
      const int h = col - NT;
      cx = x0 + h / 2;
      y = (h & 1) ? min(y0 + TY, a.ny) : y0 - 1;
      live = (h & 1) ? f_hi : f_lo;
    }
    if (cx >= a.nx) continue;
    const bool wrap = y < 0 || y == a.ny;
    if (wrap && !EDGE && !a.pery) continue;          // open face
    const int yc = y < 0 ? a.ny - 1 : (y == a.ny ? 0 : y);
    const T yi = T(yc);
    bool col_any;
    if (wrap && EDGE) {
      const Edge<T>& ed = a.ey[y < 0 ? 0 : 1];
      col_any = key_column<T, K>(
          e, NCOL, col, a.cap,
          [&](int s) { return ed.alive[(long long)s * a.nx + cx] != 0; },
          [&](int s) { return ed.f[FY][(long long)s * a.nx + cx] - yi; });
    } else {
      const long long base = (long long)cx * a.ny + yc;
      col_any = key_column<T, K>(
          e, NCOL, col, a.cap,
          [&](int s) { return live && a.sin.alive[base + s * a.ncell] != 0; },
          [&](int s) { return a.sin.f[FY][base + s * a.ncell] - yi; });
    }
    if (col_any) sort_column(e, NCOL, col, ces, a.nces);
    any |= col_any;
  }
  if (!__syncthreads_or(any)) {
    if (tid == 0) a.yflags[t] = 0;
    if (valid)
      for (int p = 0; p < a.cap; ++p) store_dead(a, p * a.ncell + cell);
    return;
  }
  bool wrote = false;
  if (valid) {
    const int cown = w * TY + lane;
    const int clo = lane > 0 ? cown - 1 : NT + 2 * w;
    const int chi =
        lane < TY - 1 && iy + 1 < a.ny ? cown + 1 : NT + 2 * w + 1;
    const bool lo_ok = EDGE || a.pery || iy != 0;
    const bool hi_ok = EDGE || a.pery || iy != a.ny - 1;
    const bool elo = EDGE && iy == 0, ehi = EDGE && iy == a.ny - 1;
    const long long src_lo =
        (long long)ix * a.ny + (iy > 0 ? iy - 1 : a.ny - 1);
    const long long src_hi =
        (long long)ix * a.ny + (iy < a.ny - 1 ? iy + 1 : 0);
    for (int p = 0; p < a.cap; ++p) {
      const K kown = e[p * NCOL + cown];
      const K klo = lo_ok ? e[p * NCOL + clo] : K(0);
      const K khi = hi_ok ? e[p * NCOL + chi] : K(0);
      const bool stay = ekey(kown) == 2;
      const bool vlo = lo_ok && ekey(klo) == 0;
      const bool vhi = hi_ok && ekey(khi) == 4;
      const long long o = p * a.ncell + cell;
      if (!(vlo || vhi || stay)) {
        store_dead(a, o);
        continue;
      }
      Slot<T> own, lo, hi, v;
      if (stay)
        load_y(a, (long long)eslot(kown) * a.ncell + cell, own);
      else
        zero_slot(own);
      if (vlo) {
        if (elo)
          load_y_edge(a, a.ey[0], (long long)eslot(klo) * a.nx + ix, lo);
        else
          load_y(a, (long long)eslot(klo) * a.ncell + src_lo, lo);
        if (iy == 0) lo.f[FY] = lo.f[FY] + T(-a.ny);
      }
      if (vhi) {
        if (ehi)
          load_y_edge(a, a.ey[1], (long long)eslot(khi) * a.nx + ix, hi);
        else
          load_y(a, (long long)eslot(khi) * a.ncell + src_hi, hi);
        if (iy == a.ny - 1) hi.f[FY] = hi.f[FY] + T(a.ny);
      }
      place(vlo, vhi, stay, lo, hi, own, v, merges);
      if (a.mode == M_PHOTON) {
        // field-free photon tail (ops/pusher.py::photon_push)
        T ig = photon_ig(v.f[FUX], v.f[FUY], v.f[FUZ]);
        v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.hx);
        v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.hy);
        store_payload(a.out, o, v, a.nxf);
        a.ig_out[o] = ig;
        wrote = true;
        continue;
      }
      // gather at the mid-step position (cell-local deltas)
      T eb[6];
      gather_eb(a.eb, a.nx, a.ny, a.g, ix, iy, v.f[FX] - T(ix),
                v.f[FY] - T(iy), eb);
      if (a.mode == M_WANT_CHI) {
        // models/qed.py::calculate_chi at the pre-push momenta, with the
        // pre-push inv_gamma of the re-binning (ops/cell2d.py)
        quantum_chi(eb, v.f[FUX], v.f[FUY], v.f[FUZ], a.c, a.chi, a.chi_out[o],
                    a.ig0_out[o]);
      }
      T ig = boris(v.f[FUX], v.f[FUY], v.f[FUZ], eb, a.ef, a.bf);
      v.f[FX] = pushed(v.f[FX], v.f[FUX], ig, a.hx);
      v.f[FY] = pushed(v.f[FY], v.f[FUY], ig, a.hy);
      store_payload(a.out, o, v, a.nxf);
      a.ig_out[o] = ig;
      wrote = true;
    }
  }
  wrote = __syncthreads_or(wrote);
  if (tid == 0) a.yflags[t] = wrote;
}

// The block's sort entries: dynamic shared memory, or (GLOBAL) its part of
// the key scratch, KEY_ROWS x cap int32 for each of its threads.
template <typename K, bool GLOBAL>
__device__ __forceinline__ K* block_entries(const int* keys, int cap) {
  if constexpr (GLOBAL) {
    return (K*)keys + (long long)blockIdx.x * blockDim.x * KEY_ROWS * cap;
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<K*>(smem_raw);
  }
}

// One block a tile (a grid-stride loop over the tiles with GLOBAL
// entries), tiles in row-major order of (x0 / TX, y0 / TY).
template <typename T, typename K, int TX, bool GLOBAL, bool EDGE>
__global__ void __launch_bounds__(TX * TY) rebin2x(Args<T> a) {
  K* e = block_entries<K, GLOBAL>(a.keys, a.cap);
  const int nty = (a.ny + TY - 1) / TY;
  const long long ntiles = (long long)((a.nx + TX - 1) / TX) * nty;
  int merges = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    pass_x_tile<T, K, TX, EDGE>(a, e, t, (int)(t / nty) * TX,
                                (int)(t % nty) * TY, merges);
    __syncthreads();
  }
  add_merges(a.n_merged, merges);
}

// rebin2y at two blocks an SM (at most 128 registers a thread): its
// gather and Boris would take some 180 and leave one block an SM, too few
// warps to cover the dead slots' stores
template <typename T, typename K, int TX, bool GLOBAL, bool EDGE>
__global__ void __launch_bounds__(TX * TY, 2) rebin2y(Args<T> a) {
  K* e = block_entries<K, GLOBAL>(a.keys, a.cap);
  const int nty = (a.ny + TY - 1) / TY;
  const long long ntiles = (long long)((a.nx + TX - 1) / TX) * nty;
  int merges = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    pass_y_tile<T, K, TX, EDGE>(a, e, t, nty, (int)(t / nty) * TX,
                                (int)(t % nty) * TY, merges);
    __syncthreads();
  }
  add_merges(a.n_merged, merges);
}

// deposit2: one block per TILE x TILE cell tile (blockDim (TILE, TILE),
// grid (nby, nbx), NC * PAN * PAN reals of shared memory), NC = 4 with
// rho, else 3: cell2d.cuh::deposit_panel, the tile deposit that kernel B5
// (deposit2d.cu) runs too, so both sum each tile in one order. A tile
// reads its alive bytes only where rebin2y flagged one of the pass tiles
// it overlaps; a tile with no alive slot copies rims_in to rims_out.
template <typename T, int NC>
__global__ void __launch_bounds__(TILE * TILE, 2) deposit2(Args<T> a) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  // rebin2y's flags of the pass tiles that this tile overlaps
  const int nty = (a.ny + TY - 1) / TY, ntx = (a.nx + a.tx - 1) / a.tx;
  const int by = bj * TILE / TY;
  bool flagged = false;
  const int bx1 = min((bi * TILE + TILE - 1) / a.tx, ntx - 1);
  for (int bx = bi * TILE / a.tx; bx <= bx1; ++bx)
    flagged |= a.yflags[(long long)bx * nty + by] != 0;
  DepositIn<T> d;
  d.alive = a.out.alive;
  d.x = a.out.f[FX]; d.y = a.out.f[FY];
  d.ux = a.out.f[FUX]; d.uy = a.out.f[FUY]; d.uz = a.out.f[FUZ];
  d.ig = a.ig_out; d.w = a.out.f[FW];
  d.rims_in = a.rims_in;
  d.rims_out = a.rims_out;
  d.nx = a.nx; d.ny = a.ny; d.cap = a.cap; d.ncell = a.ncell;
  d.cdx = a.cdx; d.cdy = a.cdy; d.c = a.c;
  d.kcd = a.kcd; d.kfx = a.kfx; d.kfy = a.kfy;
  deposit_panel<T, NC, true>(d, flagged);
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

// Launch one pass kernel: one block a tile with shared entries, or the
// key scratch's blocks with global ones.
template <typename T, typename K, int TX, bool GLOBAL, typename Kernel>
int launch_pass(Kernel kernel, const Args<T>& a, int ncol, cudaStream_t st) {
  constexpr int threads = TX * TY;
  long long tiles = (long long)ceil_div(a.nx, TX) * ceil_div(a.ny, TY);
  long long blocks = tiles;
  size_t smem = 0;
  if constexpr (GLOBAL) {
    long long rows = a.key_threads / threads;
    blocks = tiles < rows ? tiles : rows;
  } else {
    smem = sizeof(K) * (size_t)ncol * a.cap;
    if (smem > 48 * 1024) {
      int err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
    }
  }
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename K, int TX, bool GLOBAL>
int launch_passes(const Args<T>& a, int lo, int hi, cudaStream_t st) {
  if (lo == 0) {
    constexpr int ncol = (TX + 2) * TY;
    int err = a.xedge
        ? launch_pass<T, K, TX, GLOBAL>(rebin2x<T, K, TX, GLOBAL, true>, a,
                                        ncol, st)
        : launch_pass<T, K, TX, GLOBAL>(rebin2x<T, K, TX, GLOBAL, false>, a,
                                        ncol, st);
    if (err || hi == 0) return err;
  }
  constexpr int ncol = TX * TY + 2 * TX;
  return a.yedge
      ? launch_pass<T, K, TX, GLOBAL>(rebin2y<T, K, TX, GLOBAL, true>, a,
                                      ncol, st)
      : launch_pass<T, K, TX, GLOBAL>(rebin2y<T, K, TX, GLOBAL, false>, a,
                                      ncol, st);
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
  a.head = hi == 0;
  a.whole = lo == 0 && hi == 1;
  // dispatches: x and y (the whole stage), x alone, y with the tail
  if (lo < 0 || hi > 1 || lo > hi || (a.xedge && lo != 0) ||
      (a.yedge && lo != 1))
    return (int)cudaErrorInvalidValue;
  a.tx = a.cap <= MAXC_LOCAL ? TX_S : TX_G;
  const long long ntiles = (long long)ceil_div(a.nx, a.tx) * ceil_div(a.ny, TY);
  a.xflags = (unsigned char*)p[P_FLAGS];
  a.yflags = a.xflags + ntiles;
  if (!a.xflags || 2 * ntiles > n[I_FLAG_BYTES])
    return (int)cudaErrorInvalidValue;
  a.rec = (uint4*)p[P_REC];
  if (a.whole && (!a.rec || (long long)sizeof(unsigned) * Rec<T>::WORDS *
                                    a.cap * a.ncell > n[I_REC_BYTES]))
    return (int)cudaErrorInvalidValue;
  for (int e = 0; e < 2; ++e) {
    unpack_edge(a.ex[e], p + P_EDGES + e * EDGE_PTRS);
    unpack_edge(a.ey[e], p + P_EDGES + (2 + e) * EDGE_PTRS);
  }
  int err = a.cap <= MAXC_LOCAL
      ? launch_passes<T, unsigned short, TX_S, false>(a, lo, hi, st)
      : launch_passes<T, int, TX_G, true>(a, lo, hi, st);
  if (err || a.mode == M_PHOTON || hi == 0) return err;
  dim3 block(TILE, TILE);
  dim3 grid(ceil_div(a.ny, TILE), ceil_div(a.nx, TILE));
  size_t smem = sizeof(T) * a.ncomp * PAN * PAN;
  if (a.ncomp == 4)
    deposit2<T, 4><<<grid, block, smem, st>>>(a);
  else if (a.ncomp == 3)
    deposit2<T, 3><<<grid, block, smem, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
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
