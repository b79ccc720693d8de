// Kernel B6: one axis of the cell re-binning (the fast overwrite-merge
// scheme) of 2D or 3D slots in one pass: per-cell Batcher sort by the
// 5-way key, the +-1 neighbour exchange, placement by overwrite with
// weighted merges, and the merge count.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// migrate_axis_fused (:860, kernel :956, pallas_call :1090), driven per
// axis by migrate_cells_fused (:1143). Plain PyTorch version: lambdapic_
// torch/ops/cell2d.py::migrate_cells (fast scheme, Batcher order).
//
// Two designs, chosen by the capacity (no switch, no fallback):
//  - up to TILE_MAXC (32) slots a cell, 2D or 3D: the tile kernel
//    (migrate_tile, below), the design of this note. 2D slots (nx, ny)
//    run as 3D slots (1, nx, ny): the 2D x axis is the tile kernel's y
//    axis with one outer index, the 2D y axis (the contiguous one) its z
//    axis in rows of ny cells; a 2D edge column, (cap, 1, ny) along x or
//    (cap, nx, 1) along y, is indexed as the 3D one of that axis;
//  - above 32 slots a cell, 2D or 3D: one thread per cell (migrate_axis),
//    rank-generic: the slots are (cap, ncell) with the cells flattened in
//    C order, the axis named by its length n and its stride (ny*nz, nz, 1
//    in 3D; ny, 1 in 2D). A thread builds the keys of its own column and
//    of its two neighbours along the axis, sorts each in a thread-local
//    array (up to MAXC_LOCAL, 128, slots a cell; above it in a global
//    scratch row per thread, cell2d.cuh's for_cells) and places its slots
//    from device memory.
//
// What both compute, as the plain version: the 5-way keys (donor+1 0 /
// dead-even 1 / stay 2 / dead-odd 3 / donor-1 4, dead parity from the
// slot index before the sort) of each column, keyed at its own cell index
// along the axis, sorted through the compare-exchange list of
// cellpallas.py::_batcher_network (strict ka > kb); output slot p takes
// the lo neighbour's sorted slot p if that is a donor(+1), else the hi
// neighbour's if that is a donor(-1), else its own; two or three sources
// merge (w summed; the payloads of the merge set weight-averaged,
// ((w_lo vl + w_hi vh) + w_res vo) / wsafe; the others take the placed
// value). Arrivals through a periodic wrap shift their coordinate by -+n;
// at an open face the neighbour outside sends nothing (the TPU kernel's
// key 9).
//
// On a device mesh (K7: replaces migrate_cells_fused's fix_wrap,
// cellpallas.py:1203-1222, which ppermutes each axis's wrap entry of the
// key and payload strips from the neighbour shard): with I_EDGE the
// caller passes the lo and hi neighbour shards' edge columns along the
// axis, (cap, cells with the axis one wide) arrays of the mask (int32,
// zero past an open global face) and of every carried payload, as the
// neighbours hold them before this axis. The first and last cells along
// the axis read their outside neighbour there in place of the wrap: keyed
// at the neighbour's own index (n-1 or 0), sorted by the same list, and
// their arrivals shifted by -+n as wrapped ones are.
//
// Payloads are run-time lists: up to MAXF float payloads of the kernel's
// type and MAXI int32 payloads. The caller ping-pongs two sets of buffers
// between the axes. On the last axis (I_FINAL) the kernel also does the
// tail of migrate_cells_fused (cellpallas.py:1235-1245): dead slots'
// payloads of the sanitize set become 0, and inv_gamma is recomputed as
// 1/sqrt(1 + u^2) into its own output (I_RECOMPUTE_IG) or, carried as a
// payload (a photon species), set to 1 in dead slots (I_IG_ONE). Every
// output slot, dead ones included, is written as the plain version
// writes it; compiled with --fmad=false, so keys, placements and merges
// match it bit for bit.
//
// Bound on an H100 (3.35 TB/s): bytes: the mask and every carried payload
// of every slot read and written once an axis, plus the two edge columns
// under K7 (the answer depends on every slot: a dead slot carries its
// payloads through a non-final axis). At the slices' shapes, float32 and
// nine 4-byte payloads (37 B a slot each way): 2.965 ms an axis at 512 x
// 256 x 256 cells of 4 slots, 0.741 ms at 256 x 128 x 128 of 8; in 2D
// 0.4633 ms at 1024 x 1024 cells of 20 slots (B6 2D), 0.1161 ms a launch
// on a 512 x 512 shard of them with its edge columns (K7 2D).
//
// The tile kernel. The one-thread-a-cell design spent about 80% of its
// time moving payloads one 4-byte load at a time (each thread's loads
// depend on its own sorted keys, so a warp's loads scatter over slot
// rows), and keyed and sorted every column three times, in local memory
// (kernel_ab.py migrate3's ablations: keys and sort alone 18% of the
// axis, migrate2's 30% at 20 slots a cell; it reached about 1.5 TB/s
// where a copy of the same arrays reaches 2.8-3.0). One 256-thread block a
// tile: W cells along z by S along the axis (x, y: 32 x 8 up to 8 slots a
// cell, 32 x 4 at 16, 24 and 32; z: rows of 128 x 2 where 128 cells hold
// the row, else 256 x 1; one row of 128 at 16, 24 and 32 slots), with its
// halo: the rows before and after it along x or y (the wrap or an edge row
// at the faces), along z the cell before and after each row (none where
// the tile holds whole rows without edges: the wrapped neighbours are the
// row's own cells).
//  - A thread finds its share of the tile's storage once (Part: runs of
//    16 bytes of one row in float32 where nz % 4 == 0 and every array is
//    aligned, else single cells, and the z halo cells) and reuses it for
//    every payload.
//  - The payloads stream through a ring of shared buffers by cp.async
//    (RING bytes: all but one of them in flight while one is placed),
//    the coordinate first: the keys are built from it and the alive bytes
//    once (8-bit entries, key << 5 | slot), and each column is sorted
//    once, in registers, by the compare-exchange list unrolled at compile
//    time (batcher_net).
//  - Above 8 slots a cell a tile whose cells and halo hold no alive slot
//    skips keys and sort: its columns' order is one permutation, from the
//    slot parities alone, computed on the host at each launch (Geo::dead).
//  - The placement map of each output slot (its source's storage offset
//    and flags) is built once, in registers, since the same thread places
//    the slot for every payload; so is the merge count. A payload's
//    placement is then one shared load and one coalesced store a slot;
//    merges (rare) read the three sources from the buffer and their
//    weights from device memory.
// Measured in 3D (kernel_ab.py migrate3, H100 80GB HBM3, 700 W): 4.05,
// 4.03 and 4.83 ms for x, y, z on 512 x 256 x 256 cells of 4 slots (6.80,
// 6.46, 6.54 before), 73% of the bound along x and y; 1.12, 1.10, 1.27 ms
// on 256 x 128 x 128 of 8 (2.30, 2.22, 2.24). Ablations: keys, sort and
// the placement map without payloads take 1.1 ms of an axis at 4 slots (a
// latency chain each block runs before its first store, hidden only by
// the other blocks of its SM); writing every payload back to its own slot
// takes as long as the real placement, so the rest is the stream itself:
// four blocks an SM at up to 4 slots (64 registers, some spilled), three
// above, and the halo's reads (a quarter more along x and y). A deeper
// ring at two blocks an SM, 32-bit copy offsets (spills) and z rows with
// a halo cell on each side were slower.
//
// 2D slots (the 2D slices hold 20 a cell: class 24, 12 slots a thread, two
// threads a column). Tile shapes and the rest chosen on the card
// (kernel_ab.py variants, band state, device ms an axis, x / y): 32 x 4
// cells along x and rows of 128 along y 0.69 / 0.76; class 32 (16 slots a
// thread) 0.92 / 0.87; x tiles of 16 x 8 0.98; y rows of 64 x 2 0.79; two
// blocks an SM 0.77 / 0.85; 1 + u^2 summed in registers 0.79 / 0.76; no
// dead-tile shortcut 0.80 / 0.86 (in 3D, at 4 and 8 slots, the shortcut
// made every axis 3-4% slower). The first form, the 3D slots' class-32
// tiles of 16 x 4 and rows of 64 with each column sorted in shared memory
// (103 exchanges at 20 slots, one thread a column: a chain of microseconds
// before a block's first store), ran 1.30 / 1.13 (CUDA events) against the
// old kernel's 1.39 / 1.41.
#include <utility>

#include "cell2d.cuh"

namespace {

using namespace lp2d;

constexpr int MAXF = 16;
constexpr int MAXI = 4;

enum Ptr { P_ALIVE, P_ALIVE_OUT, P_NMERGED, P_CES, P_IG_OUT,
           P_FIN, P_FOUT = P_FIN + MAXF, P_IIN = P_FOUT + MAXF,
           P_IOUT = P_IIN + MAXI, P_KEYS = P_IOUT + MAXI,
           // lo edge, then hi edge: mask, MAXF floats, MAXI ints each
           P_EDGES, P_COUNT = P_EDGES + 2 * (1 + MAXF + MAXI) };
enum Int { I_CAP, I_NCELL, I_N, I_STRIDE, I_PERIODIC, I_NF, I_NI, I_COORD, I_W,
           I_MERGE_MASK, I_FINAL, I_SANITIZE_MASK, I_UX, I_UY, I_UZ,
           I_RECOMPUTE_IG, I_IG_ONE, I_NCES, I_DOUBLE, I_KEY_THREADS,
           I_EDGE, I_NX, I_NY, I_NZ, I_AXIS };

// A neighbour shard's edge column along the axis.
template <typename T>
struct Edge {
  const int* alive;
  const T* f[MAXF];
  const int* i[MAXI];
};

template <typename T>
struct Args {
  const unsigned char* alive;
  unsigned char* alive_out;
  unsigned long long* n_merged;
  const int* ces;
  T* ig_out;
  const T* fin[MAXF];
  T* fout[MAXF];
  const int* iin[MAXI];
  int* iout[MAXI];
  int* keys;            // KEY_ROWS x cap int32 per thread (cap > MAXC_LOCAL)
  Edge<T> edge[2];      // with has_edge: the lo and hi neighbours' columns
  int cap, n, periodic, nf, ni, coord, w, merge_mask, final_,
      sanitize_mask, iux, iuy, iuz, recompute_ig, ig_one, nces, has_edge;
  long long ncell, stride;
};

// One axis of the re-binning of one cell; k: KEY_ROWS rows of ks sort
// entries.
template <typename T>
__device__ __forceinline__ void migrate_cell(const Args<T>& a, long long cell,
                                             int* k, int ks, int& merges) {
  const int n = a.n;
  const long long st = a.stride;
  const int i = (int)((cell / st) % n);
  // the lo neighbour, the cell itself, the hi neighbour (wrapped)
  const long long cols[3] = {i > 0 ? cell - st : cell + (n - 1) * st, cell,
                             i < n - 1 ? cell + st : cell - (n - 1) * st};
  const int ipos[3] = {i > 0 ? i - 1 : n - 1, i, i < n - 1 ? i + 1 : 0};
  // the outside neighbours of the first and last cells come from the edge
  // columns, cell (outer, inner) of ncell / n cells
  const bool from_edge[3] = {a.has_edge && i == 0, false,
                             a.has_edge && i == n - 1};
  const long long encell = a.ncell / n;
  const long long ecell = (cell / ((long long)n * st)) * st + cell % st;
  for (int c3 = 0; c3 < 3; ++c3) {
    const T ci = T(ipos[c3]);
    const bool fe = from_edge[c3];
    const Edge<T>& ed = a.edge[c3 == 0 ? 0 : 1];
    const T* pos = fe ? ed.f[a.coord] : a.fin[a.coord];
    for (int s = 0; s < a.cap; ++s) {
      long long idx = fe ? ecell + s * encell : cols[c3] + s * a.ncell;
      bool al = fe ? ed.alive[idx] != 0 : a.alive[idx] != 0;
      T local = pos[idx] - ci;
      bool hi = al && local >= T(0.5);
      bool lo = al && local < T(-0.5);
      k[c3 * ks + s] = pack_key(five_way(al, hi, lo, s), s);
    }
    net_sort(k + c3 * ks, a.ces, a.nces);
  }
  const bool lo_ok = a.has_edge || a.periodic || i != 0;
  const bool hi_ok = a.has_edge || a.periodic || i != n - 1;
  // the source arrays and cell of the lo and hi neighbours
  const T* const* flo = from_edge[0] ? a.edge[0].f : a.fin;
  const T* const* fhi = from_edge[2] ? a.edge[1].f : a.fin;
  const int* const* ilo = from_edge[0] ? a.edge[0].i : a.iin;
  const int* const* ihi = from_edge[2] ? a.edge[1].i : a.iin;
  const long long nlo = from_edge[0] ? encell : a.ncell;
  const long long nhi = from_edge[2] ? encell : a.ncell;
  const long long clo = from_edge[0] ? ecell : cols[0];
  const long long chi = from_edge[2] ? ecell : cols[2];
  // coordinate shift of arrivals through the wrap
  const T adj_lo = i == 0 ? T(-n) : T(0);
  const T adj_hi = i == n - 1 ? T(n) : T(0);
  const bool wrap_lo = i == 0, wrap_hi = i == n - 1;
  const T floor_ = WFloor<T>::v();
  for (int p = 0; p < a.cap; ++p) {
    const int klo = k[p], kown = k[ks + p], khi = k[2 * ks + p];
    const bool vlo = lo_ok && key_of(klo) == 0;
    const bool vhi = hi_ok && key_of(khi) == 4;
    const bool stay = key_of(kown) == 2;
    const long long s_lo = (long long)slot_of(klo) * nlo + clo;
    const long long s_own = (long long)slot_of(kown) * a.ncell + cell;
    const long long s_hi = (long long)slot_of(khi) * nhi + chi;
    const long long o = (long long)p * a.ncell + cell;
    const int n_src = (int)vlo + (int)vhi + (int)stay;
    merges += n_src > 1 ? n_src - 1 : 0;
    const bool multi = n_src >= 2;
    const bool al = vlo || vhi || stay;
    const bool dead_final = a.final_ && !al;
    T w_lo = T(0), w_hi = T(0), w_res = T(0), wsum = T(0), wsafe = T(0);
    if (multi) {
      w_lo = vlo ? flo[a.w][s_lo] : T(0);
      w_hi = vhi ? fhi[a.w][s_hi] : T(0);
      w_res = stay ? a.fin[a.w][s_own] : T(0);
      wsum = (w_lo + w_hi) + w_res;
      wsafe = wsum > floor_ ? wsum : floor_;
    }
    T u[3] = {T(0), T(0), T(0)};
    for (int f = 0; f < a.nf; ++f) {
      const T* src = a.fin[f];
      const bool is_coord = f == a.coord;
      T v;
      if (multi && ((a.merge_mask >> f) & 1)) {
        if (f == a.w) {
          v = wsum;
        } else {
          T vl = flo[f][s_lo], vh = fhi[f][s_hi], vo = src[s_own];
          if (is_coord && wrap_lo) vl = vl + adj_lo;
          if (is_coord && wrap_hi) vh = vh + adj_hi;
          v = ((w_lo * vl + w_hi * vh) + w_res * vo) / wsafe;
        }
      } else if (vlo) {
        v = flo[f][s_lo];
        if (is_coord && wrap_lo) v = v + adj_lo;
      } else if (vhi) {
        v = fhi[f][s_hi];
        if (is_coord && wrap_hi) v = v + adj_hi;
      } else {
        v = src[s_own];
      }
      if (dead_final) {
        if ((a.sanitize_mask >> f) & 1) v = T(0);
        if (f == a.ig_one) v = T(1);
      }
      if (f == a.iux) u[0] = v;
      if (f == a.iuy) u[1] = v;
      if (f == a.iuz) u[2] = v;
      a.fout[f][o] = v;
    }
    for (int t = 0; t < a.ni; ++t) {
      a.iout[t][o] = vlo ? ilo[t][s_lo]
                         : (vhi ? ihi[t][s_hi] : a.iin[t][s_own]);
    }
    a.alive_out[o] = al ? 1 : 0;
    if (a.final_ && a.recompute_ig)
      a.ig_out[o] = T(1) / sqrt(((T(1) + u[0] * u[0]) + u[1] * u[1]) +
                                u[2] * u[2]);
  }
}

template <typename T, int MAXC>
__global__ void __launch_bounds__(128) migrate_axis(Args<T> a) {
  int merges = 0;
  for_cells<MAXC>(a.ncell, a.keys, a.cap, [&](long long cell, int* k, int ks) {
    migrate_cell(a, cell, k, ks, merges);
  });
  add_merges(a.n_merged, merges);
}


// ---------------------------------------------------------------------------
// The tile kernel: one axis of the re-binning of 3D slots (2D slots as 3D
// slots (1, nx, ny)) up to TILE_MAXC slots a cell (the source note at the
// top says why and what it found).
namespace tile {

constexpr int THREADS = 256;
constexpr int TILE_MAXC = 32;
constexpr int SLOT_BITS = 5;    // a shared sort entry: key << 5 | slot

// The compare-exchange list of cellpallas.py::_batcher_network for N = 2^k
// entries, built at compile time. Entries past a cell's capacity held at
// a key above every real one (the list's virtual +inf entries) never move
// under a strict ka > kb, and the exchanges the pruned list leaves out
// then swap nothing, so the list of N sorts every capacity of the
// class as the list pruned to that capacity does.
template <int N>
struct Net {
  int n;
  unsigned char a[6 * N], b[6 * N];   // up to 191 exchanges at N = 32
};

template <int N>
__host__ __device__ constexpr Net<N> batcher_net() {
  Net<N> t{};
  for (int p = 1; p < N; p *= 2)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j < N - k; j += 2 * k)
        for (int i = 0; i < k && i < N - j - k; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            t.a[t.n] = (unsigned char)(i + j);
            t.b[t.n] = (unsigned char)(i + j + k);
            ++t.n;
          }
  return t;
}

template <int N>
constexpr Net<N> NET = batcher_net<N>();

// The network size of capacity class MAXC.
__host__ __device__ constexpr int net_size(int maxc) {
  int n = 1;
  while (n < maxc) n *= 2;
  return n;
}

template <int A, int B, int N>
__device__ __forceinline__ void exchange(unsigned (&k)[N]) {
  const unsigned ka = k[A], kb = k[B];
  const bool swap = (ka >> SLOT_BITS) > (kb >> SLOT_BITS);
  k[A] = swap ? kb : ka;
  k[B] = swap ? ka : kb;
}

// Sort a column's entries (key << SLOT_BITS | slot), in registers.
template <int N, int... E>
__device__ __forceinline__ void sort_column(unsigned (&k)[N],
                                            std::integer_sequence<int, E...>) {
  (exchange<batcher_net<N>().a[E], batcher_net<N>().b[E]>(k), ...);
}

// The tile of a capacity class MAXC (4, 8, 16, 32 slots a cell; class 4
// is class 8's tile with half the slots, for four blocks an SM) along the
// axis Z (0: x or y; 1: z up to 8 slots a cell, the narrow tile, used
// where its W cells hold a whole row; 2: z, the wide one): W cells along
// z by S along the axis (rows along z), 256 output columns up to 8 slots,
// 128 at 16, 64 at 32. The storage of one slot of a payload: along x or y
// the (S + 2) rows of W cells of the tile and its halo rows; along z S
// rows of RP = W + 4 entries, the row's W cells, then its lo and hi halo
// cells, then two unused, so that every row starts 16-byte aligned. P
// pitches a slot's storage to a multiple of 32 entries, so that a warp
// reading one column of 32 different slot rows hits 32 banks. Chosen on the
// card among other shapes: rows of 32 cells along x and y, along z the
// fewest halo cells.
template <int MAXC, int Z>
struct Dims;
template <> struct Dims<4, 0> { static constexpr int W = 32, S = 8; };
template <> struct Dims<8, 0> { static constexpr int W = 32, S = 8; };
template <> struct Dims<16, 0> { static constexpr int W = 32, S = 4; };
template <> struct Dims<24, 0> { static constexpr int W = 32, S = 4; };
template <> struct Dims<32, 0> { static constexpr int W = 32, S = 4; };
template <> struct Dims<4, 1> { static constexpr int W = 128, S = 2; };
template <> struct Dims<8, 1> { static constexpr int W = 128, S = 2; };
template <> struct Dims<4, 2> { static constexpr int W = 256, S = 1; };
template <> struct Dims<8, 2> { static constexpr int W = 256, S = 1; };
template <> struct Dims<16, 2> { static constexpr int W = 128, S = 1; };
template <> struct Dims<24, 2> { static constexpr int W = 128, S = 1; };
template <> struct Dims<32, 2> { static constexpr int W = 128, S = 1; };

template <int MAXC, int Z>
struct Shape {
  static constexpr int W = Dims<MAXC, Z>::W, S = Dims<MAXC, Z>::S;
  static constexpr int RP = W + 4;
  static constexpr int SRC = Z ? S * RP : (S + 2) * W;   // storage a slot
  static constexpr int P = (SRC + 31) / 32 * 32;
  static constexpr int COUT = S * W;                     // output columns
  static constexpr int TPC = THREADS / COUT;             // threads a column
  static constexpr int ITEMS = MAXC / TPC;               // slots a thread
  static constexpr int RUNS = Z ? S * W : SRC;           // row cells a slot
  static constexpr int NH = (MAXC * S * 2 + THREADS - 1) / THREADS;
};

// The geometry of a launch (host-computed).
struct Geo {
  int n, nz;              // cells along the axis, along z
  long long st;           // x, y: cells between neighbours along the axis
  long long ost;          // x, y: cells between neighbouring outer indices
  long long nrows;        // z: rows (nx ny)
  int nseg, nzt;          // tiles along the axis (z: row groups), along z
  long long encell;       // an edge array's slot stride
  int nbuf;               // payload buffers in the ring
  int whole;              // z: a tile holds whole rows and no edge: the
                          // wrapped neighbours are the row's own cells
  // the payload stream: a float payload's index, or -1 - t for int
  // payload t; the axis's coordinate first, then the floats, then the
  // ints (so ux, uy, uz in their order)
  signed char order[MAXF + MAXI];
  // the sorted order of a column of dead slots (keys from the slot
  // parities alone): the slot at each position
  unsigned char dead[TILE_MAXC];
};

// The block's tile: x, y: outer index (y for x, x for y), first cell
// along the axis; z: first row. z0 its first z.
struct Tile {
  long long outer, q0;
  int i0, z0;
};

// Where a tile's storage entry o (of one slot) comes from: kind 0 none
// (past the grid), 1 the slots, 2 the lo edge, 3 the hi edge; the cell (or
// edge cell) idx; the cell index ci along the axis at which its shard keys
// it. Along x or y a halo row is the wrapped row or an edge row; along z
// a row's lo halo is the cell before the tile (wrapped or an edge cell at
// z0 = 0) and its hi halo the cell after the tile's last cell in the grid.
template <int MAXC, int Z>
__device__ __forceinline__ void locate(const Geo& g, const Tile& t,
                                       bool edge, int o, int& kind,
                                       long long& idx, int& ci) {
  using Sh = Shape<MAXC, Z>;
  kind = 0;
  idx = 0;
  ci = 0;
  int i, z;
  long long row = 0;
  if constexpr (!Z) {
    const int a = o / Sh::W - 1;
    z = t.z0 + o % Sh::W;
    i = t.i0 + a;
    if (z >= g.nz || i > g.n) return;
  } else {
    const int r = o / Sh::RP, oo = o % Sh::RP;
    row = t.q0 + r;
    if (row >= g.nrows || oo > Sh::W + 1) return;
    if (oo < Sh::W) {
      z = t.z0 + oo;
      if (z >= g.nz) return;
    } else if (oo == Sh::W) {
      z = t.z0 - 1;
    } else {
      z = t.z0 + Sh::W < g.nz ? t.z0 + Sh::W : g.nz;
    }
    i = z;
  }
  const bool lo = i < 0, hi = i == g.n;
  ci = lo ? g.n - 1 : (hi ? 0 : i);
  if ((lo || hi) && edge) {
    kind = lo ? 2 : 3;
    idx = Z ? row : t.outer * g.nz + z;
  } else {
    kind = 1;
    idx = Z ? row * g.nz + ci : t.outer * g.ost + ci * g.st + z;
  }
}

// cp.async of B (4, 8 or 16) bytes, global -> shared; 16-byte copies are
// not kept in L1.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if constexpr (B == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of the thread's copy groups are in flight (n above
// 7 waits as for 7).
__device__ __forceinline__ void wait_pending(int n) {
  switch (n < 7 ? n : 7) {
    case 0: wait_pending<0>(); break;
    case 1: wait_pending<1>(); break;
    case 2: wait_pending<2>(); break;
    case 3: wait_pending<3>(); break;
    case 4: wait_pending<4>(); break;
    case 5: wait_pending<5>(); break;
    case 6: wait_pending<6>(); break;
    default: wait_pending<7>(); break;
  }
}

// A thread's share of the tile's storage, found once and used for every
// payload: runs of CW row cells (one 16-byte copy in float32 where rows
// and pointers allow, CW 4; else CW 1) and, along
// z, the halo cells. Each: the element offset of its first cell in its
// source (slot s included), its storage offset and slot, its source kind
// (0: nothing to copy).
template <int MAXC, int Z, int CW>
struct Part {
  using Sh = Shape<MAXC, Z>;
  static constexpr int NR = (MAXC * Sh::RUNS / CW + THREADS - 1) / THREADS;
  static constexpr int NH = Z ? Sh::NH : 0;
  long long off[NR + NH];
  unsigned meta[NR + NH];   // storage offset | kind << 16 | slot << 18
};

template <int MAXC, int Z, int CW>
__device__ __forceinline__ void find_part(Part<MAXC, Z, CW>& pt,
                                          const Geo& g, const Tile& t,
                                          bool edge, int cap,
                                          long long ncell) {
  using Sh = Shape<MAXC, Z>;
  using Pt = Part<MAXC, Z, CW>;
  constexpr int PER = Sh::RUNS / CW;       // runs a slot
#pragma unroll
  for (int k = 0; k < Pt::NR + Pt::NH; ++k) {
    pt.off[k] = 0;
    pt.meta[k] = 0;
    int s, o;
    if (k < Pt::NR) {
      const int e = threadIdx.x + k * THREADS;
      if (e >= cap * PER) continue;
      s = e / PER;
      const int r = (e - s * PER) * CW;
      o = Z ? r / Sh::W * Sh::RP + r % Sh::W : r;
    } else {
      const int e = threadIdx.x + (k - Pt::NR) * THREADS;
      if (g.whole || e >= cap * Sh::S * 2) continue;
      s = e / (Sh::S * 2);
      const int h = e - s * Sh::S * 2;
      o = h / 2 * Sh::RP + Sh::W + (h & 1);
    }
    int kind, ci;
    long long idx;
    locate<MAXC, Z>(g, t, edge, o, kind, idx, ci);
    if (!kind) continue;
    pt.off[k] = s * (kind == 1 ? ncell : g.encell) + idx;
    pt.meta[k] = (unsigned)(s * Sh::P + o) | (unsigned)kind << 16 |
                 (unsigned)s << 18;
  }
}

// Start the copies of one payload's tile (every slot, halo included) into
// dst (cap rows of P entries).
template <int MAXC, int Z, int CW, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src,
                                          const E* elo, const E* ehi,
                                          const Part<MAXC, Z, CW>& pt) {
  using Pt = Part<MAXC, Z, CW>;
#pragma unroll
  for (int k = 0; k < Pt::NR + Pt::NH; ++k) {
    const unsigned m = pt.meta[k];
    const unsigned kind = (m >> 16) & 3;
    if (!kind) continue;
    const E* from = (kind == 1 ? src : (kind == 2 ? elo : ehi)) + pt.off[k];
    E* to = dst + (m & 0xffff);
    if (k < Pt::NR)
      copy_async<CW * (int)sizeof(E)>(to, from);
    else
      copy_async<(int)sizeof(E)>(to, from);
  }
}

// Start payload j of the stream (g.order) into buffer dst.
template <typename T, int MAXC, int Z, int CW>
__device__ __forceinline__ void start_payload(const Args<T>& a,
                                              const Geo& g, int j,
                                              unsigned char* dst,
                                              const Part<MAXC, Z, CW>& pt) {
  const int f = g.order[j];
  if (f >= 0)
    copy_tile<MAXC, Z, CW>((T*)dst, a.fin[f], a.edge[0].f[f],
                           a.edge[1].f[f], pt);
  else
    copy_tile<MAXC, Z, CW>((int*)dst, a.iin[-1 - f], a.edge[0].i[-1 - f],
                           a.edge[1].i[-1 - f], pt);
}

// A thread's output column c: its cell, its index i along the axis and
// the storage columns of its lo, own and hi sources.
struct Col {
  long long cell;
  int i, so_lo, so_own, so_hi;
  bool valid;
};

template <int MAXC, int Z>
__device__ __forceinline__ Col out_col(const Geo& g, const Tile& t, int c) {
  using Sh = Shape<MAXC, Z>;
  Col k;
  const int a = c / Sh::W, zz = c % Sh::W;
  const int z = t.z0 + zz;
  if constexpr (!Z) {
    k.i = t.i0 + a;
    k.valid = k.i < g.n && z < g.nz;
    k.cell = t.outer * g.ost + (long long)k.i * g.st + z;
    k.so_own = (a + 1) * Sh::W + zz;
    k.so_lo = k.so_own - Sh::W;
    k.so_hi = k.so_own + Sh::W;
  } else {
    const long long row = t.q0 + a;
    k.i = z;
    k.valid = row < g.nrows && z < g.nz;
    k.cell = row * g.nz + z;
    k.so_own = a * Sh::RP + zz;
    k.so_lo = zz > 0 ? k.so_own - 1
              : a * Sh::RP + (g.whole ? g.nz - 1 : Sh::W);
    k.so_hi = zz < Sh::W - 1 && z < g.nz - 1 ? k.so_own + 1
              : a * Sh::RP + (g.whole ? 0 : Sh::W + 1);
  }
  return k;
}

// A placement map entry: bits 0-15 the storage offset of the placed source
// slot, 16-17 its column (0 own, 1 lo, 2 hi), then the flags.
constexpr unsigned M_MULTI = 1u << 18, M_DEAD = 1u << 19, M_ADJ = 1u << 20,
                   M_VLO = 1u << 21, M_VHI = 1u << 22, M_STAY = 1u << 23;

// The weight of storage entry so's slot in device memory, for a merge.
template <typename T, int MAXC, int Z>
__device__ __forceinline__ T source_w(const Args<T>& a, const Geo& g,
                                      const Tile& t, int so, int slot) {
  int kind, ci;
  long long idx;
  locate<MAXC, Z>(g, t, a.has_edge, so, kind, idx, ci);
  if (kind == 1) return a.fin[a.w][slot * a.ncell + idx];
  return a.edge[kind == 2 ? 0 : 1].f[a.w][slot * g.encell + idx];
}

template <typename T, int MAXC, int Z, int CW>
__global__ void __launch_bounds__(THREADS, MAXC <= 4 ? 4 : 3)
    migrate_tile(const __grid_constant__ Args<T> a,
                 const __grid_constant__ Geo g) {
  using Sh = Shape<MAXC, Z>;
  using Pt = Part<MAXC, Z, CW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = a.cap;
  const int buf_bytes = cap * Sh::P * (int)sizeof(T);
  const int nbuf = g.nbuf;
  unsigned char* sk = smem + nbuf * buf_bytes;
  const int tid = threadIdx.x;

  Tile t;
  {
    const long long b = blockIdx.x;
    if constexpr (!Z) {
      const int seg = (int)(b % g.nseg);
      const long long r = b / g.nseg;
      t.i0 = seg * Sh::S;
      t.z0 = (int)(r % g.nzt) * Sh::W;
      t.outer = r / g.nzt;
      t.q0 = 0;
    } else {
      t.z0 = (int)(b % g.nzt) * Sh::W;
      t.q0 = b / g.nzt * Sh::S;
      t.i0 = 0;
      t.outer = 0;
    }
  }
  Pt pt;
  find_part<MAXC, Z, CW>(pt, g, t, a.has_edge, cap, a.ncell);

  // the first nbuf payloads of the stream take off, the coordinate first
  const int nstream = a.nf + a.ni;
  for (int j = 0; j < nbuf; ++j) {
    start_payload<T, MAXC, Z, CW>(a, g, j, smem + j * buf_bytes, pt);
    commit();
  }
  // the alive bytes of the thread's runs and halo cells, while the
  // coordinate flies: bit k CW + u of run k's cell u
  unsigned al_bits = 0;
#pragma unroll
  for (int k = 0; k < Pt::NR + Pt::NH; ++k) {
    const unsigned m = pt.meta[k];
    const unsigned kind = (m >> 16) & 3;
    const int nc = k < Pt::NR ? CW : 1;
    for (int u = 0; u < nc; ++u) {
      bool al = false;
      if (kind == 1) al = a.alive[pt.off[k] + u] != 0;
      else if (kind) al = a.edge[kind - 2].alive[pt.off[k] + u] != 0;
      al_bits |= (unsigned)al << (k * CW + u);
    }
  }
  // above 8 slots a cell, a tile whose cells and halo hold no alive slot
  // (most of a foil's grid): every column's sorted order is g.dead, so its
  // keys and sort are skipped and its map built from that order (at up to
  // 8 the keys and sort are short, and the shortcut's branch costs the
  // other tiles more than it saves)
  bool live = true;
  if constexpr (MAXC > 8) live = __syncthreads_or(al_bits != 0);
  if (live) {
    wait_pending(nbuf - 1);
    __syncthreads();
    // keys, from the alive bytes and the coordinate (buffer 0), each
    // keyed at its cell's own index along the axis (a wrapped or edge cell
    // at the index its shard gives it)
    const T* pos = (const T*)smem;
#pragma unroll
    for (int k = 0; k < Pt::NR + Pt::NH; ++k) {
      const unsigned m = pt.meta[k];
      if (!((m >> 16) & 3)) continue;
      const int so = (int)(m & 0xffff), s = (int)(m >> 18);
      int kind, ci;
      long long idx;
      locate<MAXC, Z>(g, t, a.has_edge, so - s * Sh::P, kind, idx, ci);
      const int nc = k < Pt::NR ? CW : 1;
      for (int u = 0; u < nc; ++u) {
        const bool al = (al_bits >> (k * CW + u)) & 1;
        bool hi = false, lo = false;
        if (al) {
          const T local = pos[so + u] - T(Z ? ci + u : ci);
          hi = local >= T(0.5);
          lo = local < T(-0.5);
        }
        sk[so + u] =
            (unsigned char)((five_way(al, hi, lo, s) << SLOT_BITS) | s);
      }
    }
    __syncthreads();
    // each storage column sorted once, in registers: the compare-exchange
    // list of cellpallas.py::_batcher_network (batcher_net), swapping on a
    // strict ka > kb
    constexpr int NS = net_size(MAXC);
    for (int o = tid; o < Sh::SRC; o += THREADS) {
      unsigned k[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s)
        k[s] = s < cap ? sk[s * Sh::P + o] : 0xffu;
      sort_column(k, std::make_integer_sequence<int, batcher_net<NS>().n>{});
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (s < cap) sk[s * Sh::P + o] = (unsigned char)k[s];
    }
    __syncthreads();
  }

  // the placement map of the thread's output slots (column c, slot p =
  // phase + k TPC), in registers, since the same thread places the slot
  // for every payload; the alive bytes and the merge count here, once
  const int phase = tid / Sh::COUT;
  const Col cl = out_col<MAXC, Z>(g, t, tid % Sh::COUT);
  unsigned mp[Sh::ITEMS];
  int merges = 0;
#pragma unroll
  for (int k = 0; k < Sh::ITEMS; ++k) {
    const int p = phase + k * Sh::TPC;
    mp[k] = 0;
    if (p < cap && cl.valid) {
      const bool lo_ok = a.has_edge || a.periodic || cl.i != 0;
      const bool hi_ok = a.has_edge || a.periodic || cl.i != g.n - 1;
      // in a dead tile every column's entry p: a dead key and g.dead's slot
      const int kd = 1 << SLOT_BITS | g.dead[p];
      const int klo = live ? sk[p * Sh::P + cl.so_lo] : kd;
      const int kown = live ? sk[p * Sh::P + cl.so_own] : kd;
      const int khi = live ? sk[p * Sh::P + cl.so_hi] : kd;
      const bool vlo = lo_ok && (klo >> SLOT_BITS) == 0;
      const bool vhi = hi_ok && (khi >> SLOT_BITS) == 4;
      const bool stay = (kown >> SLOT_BITS) == 2;
      const int n_src = (int)vlo + (int)vhi + (int)stay;
      merges += n_src > 1 ? n_src - 1 : 0;
      const unsigned kind = vlo ? 1u : (vhi ? 2u : 0u);
      const int ks = vlo ? klo : (vhi ? khi : kown);
      const int so = vlo ? cl.so_lo : (vhi ? cl.so_hi : cl.so_own);
      const bool adj = (vlo && cl.i == 0) || (!vlo && vhi && cl.i == g.n - 1);
      mp[k] = (unsigned)((ks & 31) * Sh::P + so) | kind << 16 |
              (n_src > 1 ? M_MULTI : 0) | (n_src == 0 ? M_DEAD : 0) |
              (adj ? M_ADJ : 0) | (vlo ? M_VLO : 0) | (vhi ? M_VHI : 0) |
              (stay ? M_STAY : 0);
      a.alive_out[p * a.ncell + cl.cell] = n_src > 0 ? 1 : 0;
    }
  }
  // output slot k of the thread: obase + k ostep
  const long long ostep = Sh::TPC * a.ncell;
  const long long obase = phase * a.ncell + cl.cell;

  // the payloads, one at a time through the ring of nbuf buffers: payloads
  // j + 1 .. j + nbuf - 1 fly while j is placed
  const T adj_lo = T(-g.n), adj_hi = T(g.n);
  const T floor_ = WFloor<T>::v();
  // inv_gamma on the final axis: 1 + u^2 summed in registers as ux, uy, uz
  // stream by (up to 8 slots a thread), or where uz is placed from ux and
  // uy as this thread wrote them (they stream before uz), which frees the
  // registers of a map of 12 or 16 slots a thread
  constexpr bool SUM_U = Sh::ITEMS <= 8;
  T acc[SUM_U ? Sh::ITEMS : 1];
#pragma unroll
  for (int k = 0; k < (SUM_U ? Sh::ITEMS : 1); ++k) acc[k] = T(1);
  for (int j = 0; j < nstream; ++j) {
    const int f = g.order[j];
    unsigned char* b = smem + (j % nbuf) * buf_bytes;
    wait_pending(nbuf - 1);
    __syncthreads();
    if (f >= 0) {
      const T* v_in = (const T*)b;
      T* out = a.fout[f];
      const bool is_coord = f == a.coord, is_w = f == a.w;
      const bool merged = (a.merge_mask >> f) & 1;
      const bool san = (a.sanitize_mask >> f) & 1, one = f == a.ig_one;
      const bool usq = SUM_U && a.final_ && a.recompute_ig &&
                       (f == a.iux || f == a.iuy || f == a.iuz);
      const bool ig_here = !SUM_U && a.final_ && a.recompute_ig &&
                           f == a.iuz;
      // the flags that change this payload's value
      const unsigned special = (merged ? M_MULTI : 0) |
                               (is_coord ? M_ADJ : 0) |
                               (a.final_ && (san || one) ? M_DEAD : 0);
#pragma unroll
      for (int k = 0; k < Sh::ITEMS; ++k) {
        const unsigned m = mp[k];
        if (!m) continue;
        T v = v_in[m & 0xffff];
        if (m & special) {
          const int p = phase + k * Sh::TPC;
          if ((m & M_MULTI) && merged) {
            // a merge: the plain version's weighted average, every
            // source's value read, the weights from device memory
            const int slo = sk[p * Sh::P + cl.so_lo] & 31;
            const int sown = sk[p * Sh::P + cl.so_own] & 31;
            const int shi = sk[p * Sh::P + cl.so_hi] & 31;
            const T w_lo = (m & M_VLO)
                ? source_w<T, MAXC, Z>(a, g, t, cl.so_lo, slo) : T(0);
            const T w_hi = (m & M_VHI)
                ? source_w<T, MAXC, Z>(a, g, t, cl.so_hi, shi) : T(0);
            const T w_res = (m & M_STAY)
                ? a.fin[a.w][sown * a.ncell + cl.cell] : T(0);
            const T wsum = (w_lo + w_hi) + w_res;
            if (is_w) {
              v = wsum;
            } else {
              const T wsafe = wsum > floor_ ? wsum : floor_;
              T vl = v_in[slo * Sh::P + cl.so_lo];
              T vh = v_in[shi * Sh::P + cl.so_hi];
              const T vo = v_in[sown * Sh::P + cl.so_own];
              if (is_coord && cl.i == 0) vl = vl + adj_lo;
              if (is_coord && cl.i == g.n - 1) vh = vh + adj_hi;
              v = ((w_lo * vl + w_hi * vh) + w_res * vo) / wsafe;
            }
          } else if (is_coord && (m & M_ADJ)) {
            v = v + ((m & M_VLO) ? adj_lo : adj_hi);
          }
          if (a.final_ && (m & M_DEAD)) {
            if (san) v = T(0);
            if (one) v = T(1);
          }
        }
        const long long o = obase + k * ostep;
        out[o] = v;
        if (usq) acc[SUM_U ? k : 0] = acc[SUM_U ? k : 0] + v * v;
        if (ig_here) {
          const T ux = a.fout[a.iux][o], uy = a.fout[a.iuy][o];
          a.ig_out[o] = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + v * v);
        }
      }
    } else {
      const int* v_in = (const int*)b;
      int* out = a.iout[-1 - f];
#pragma unroll
      for (int k = 0; k < Sh::ITEMS; ++k) {
        const unsigned m = mp[k];
        if (m) out[obase + k * ostep] = v_in[m & 0xffff];
      }
    }
    __syncthreads();
    if (j + nbuf < nstream)
      start_payload<T, MAXC, Z, CW>(a, g, j + nbuf, b, pt);
    commit();
  }
  wait_pending<0>();
  if (SUM_U && a.final_ && a.recompute_ig) {
#pragma unroll
    for (int k = 0; k < Sh::ITEMS; ++k)
      if (mp[k])
        a.ig_out[obase + k * ostep] = T(1) / sqrt(acc[SUM_U ? k : 0]);
  }
  add_merges(a.n_merged, merges);
}

// The payload ring's shared memory: as many buffers as fit in RING bytes
// (32 KiB at up to 4 slots a cell, four blocks an SM; 48 KiB above, three
// blocks), at least two, at most one a payload.
constexpr int RING4 = 32 * 1024, RING = 48 * 1024;
constexpr int MAX_DEVICES = 64;

// Shared memory of a launch: the payload buffers and the sort entries.
template <typename T, int MAXC, int Z>
size_t smem_bytes(int cap, int nbuf) {
  using Sh = Shape<MAXC, Z>;
  return nbuf * (size_t)cap * Sh::P * sizeof(T) + (size_t)cap * Sh::P;
}

template <typename T, int MAXC, int Z>
int launch_shape(const Args<T>& a, Geo g, long long nouter, bool vec,
                 cudaStream_t st) {
  using Sh = Shape<MAXC, Z>;
  g.nzt = (g.nz + Sh::W - 1) / Sh::W;
  g.whole = Z && g.nz <= Sh::W && !a.has_edge;
  long long blocks;
  if constexpr (!Z) {
    g.nseg = (g.n + Sh::S - 1) / Sh::S;
    blocks = (long long)g.nseg * g.nzt * nouter;
  } else {
    g.nseg = (int)((g.nrows + Sh::S - 1) / Sh::S);
    blocks = (long long)g.nseg * g.nzt;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the dead column's order: slot parities (dead even 1, dead odd 3, as
  // five_way) through the class's list
  {
    constexpr int NS = net_size(MAXC);
    unsigned k[NS];
    for (int s = 0; s < NS; ++s)
      k[s] = s < a.cap ? (s & 1 ? 3u : 1u) << SLOT_BITS | s : 0xffu;
    for (int e = 0; e < NET<NS>.n; ++e) {
      const int i = NET<NS>.a[e], j = NET<NS>.b[e];
      if ((k[i] >> SLOT_BITS) > (k[j] >> SLOT_BITS)) {
        const unsigned t = k[i];
        k[i] = k[j];
        k[j] = t;
      }
    }
    for (int s = 0; s < TILE_MAXC; ++s)
      g.dead[s] = (unsigned char)(s < a.cap ? k[s] & 31 : 0);
  }
  const int buf_bytes = a.cap * Sh::P * (int)sizeof(T);
  const int nstream = a.nf + a.ni;
  const int fit = (MAXC <= 4 ? RING4 : RING) / buf_bytes;
  g.nbuf = fit < 2 ? 2 : fit;
  if (g.nbuf > nstream) g.nbuf = nstream;
  const size_t bytes = smem_bytes<T, MAXC, Z>(a.cap, g.nbuf);
  // the shared memory a kernel may take, raised where a launch needs more
  // than its device's kernel was given (per kernel: the copy widths 4, 1)
  static int allowed[2][MAX_DEVICES];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || dev >= MAX_DEVICES) return err ? err : (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel, int& room) {
    if ((int)bytes > room) {
      int e = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e) return e;
      room = (int)bytes;
    }
    kernel<<<(unsigned)blocks, THREADS, bytes, st>>>(a, g);
    return (int)cudaGetLastError();
  };
  if constexpr (sizeof(T) == 4)
    if (vec) return run(migrate_tile<T, MAXC, Z, 4>, allowed[0][dev]);
  return run(migrate_tile<T, MAXC, Z, 1>, allowed[1][dev]);
}

// The tile of capacity class MAXC for the axis: x or y; z in rows of the
// narrow tile where they are whole, else in rows of the wide one.
template <typename T, int MAXC>
int pick(const Args<T>& a, const Geo& g, long long nouter, bool vec,
         cudaStream_t st, int z, int nz) {
  if (!z) return launch_shape<T, MAXC, 0>(a, g, nouter, vec, st);
  if constexpr (MAXC <= 8)
    if (nz <= Dims<MAXC, 1>::W)
      return launch_shape<T, MAXC, 1>(a, g, nouter, vec, st);
  return launch_shape<T, MAXC, 2>(a, g, nouter, vec, st);
}

// One axis of 3D slots (nx, ny, nz) through the tile kernel (2D slots:
// nx = 1).
template <typename T>
int launch(const Args<T>& a, int nx, int ny, int nz, int axis,
           cudaStream_t st) {
  Geo g;
  g.nz = nz;
  g.n = axis == 0 ? nx : (axis == 1 ? ny : nz);
  g.st = axis == 0 ? (long long)ny * nz : nz;
  g.ost = axis == 0 ? nz : (long long)ny * nz;
  g.nrows = (long long)nx * ny;
  g.encell = a.ncell / g.n;
  g.nseg = g.nzt = g.nbuf = 0;
  g.whole = 0;
  int j = 0;
  g.order[j++] = (signed char)a.coord;
  for (int f = 0; f < a.nf; ++f)
    if (f != a.coord) g.order[j++] = (signed char)f;
  for (int t = 0; t < a.ni; ++t) g.order[j++] = (signed char)(-1 - t);
  const long long nouter = axis == 0 ? ny : nx;
  // float32: 16-byte copies of runs of 4 cells where rows hold a multiple
  // of 4 cells and every payload (and edge) array is 16-byte aligned
  // (float64, which only the tests run, copies cell by cell)
  bool vec = sizeof(T) == 4 && nz % 4 == 0;
  auto al16 = [&](const void* p) { return ((size_t)p & 15) == 0; };
  for (int f = 0; f < a.nf; ++f) {
    vec = vec && al16(a.fin[f]) && al16(a.alive);
    if (a.has_edge)
      vec = vec && al16(a.edge[0].f[f]) && al16(a.edge[1].f[f]);
  }
  for (int i = 0; i < a.ni; ++i) {
    vec = vec && al16(a.iin[i]);
    if (a.has_edge)
      vec = vec && al16(a.edge[0].i[i]) && al16(a.edge[1].i[i]);
  }
  const int z = axis == 2;
  if (a.cap <= 4)
    return pick<T, 4>(a, g, nouter, vec, st, z, nz);
  if (a.cap <= 8)
    return pick<T, 8>(a, g, nouter, vec, st, z, nz);
  if (a.cap <= 16)
    return pick<T, 16>(a, g, nouter, vec, st, z, nz);
  if (a.cap <= 24)
    return pick<T, 24>(a, g, nouter, vec, st, z, nz);
  return pick<T, 32>(a, g, nouter, vec, st, z, nz);
}

}  // namespace tile

template <typename T>
int launch(void** p, const long long* n, cudaStream_t st) {
  Args<T> a;
  a.alive = (const unsigned char*)p[P_ALIVE];
  a.alive_out = (unsigned char*)p[P_ALIVE_OUT];
  a.n_merged = (unsigned long long*)p[P_NMERGED];
  a.ces = (const int*)p[P_CES];
  a.ig_out = (T*)p[P_IG_OUT];
  for (int f = 0; f < MAXF; ++f) {
    a.fin[f] = (const T*)p[P_FIN + f];
    a.fout[f] = (T*)p[P_FOUT + f];
  }
  for (int t = 0; t < MAXI; ++t) {
    a.iin[t] = (const int*)p[P_IIN + t];
    a.iout[t] = (int*)p[P_IOUT + t];
  }
  a.cap = (int)n[I_CAP]; a.ncell = n[I_NCELL]; a.n = (int)n[I_N];
  a.stride = n[I_STRIDE]; a.periodic = (int)n[I_PERIODIC];
  a.nf = (int)n[I_NF]; a.ni = (int)n[I_NI]; a.coord = (int)n[I_COORD];
  a.w = (int)n[I_W]; a.merge_mask = (int)n[I_MERGE_MASK];
  a.final_ = (int)n[I_FINAL]; a.sanitize_mask = (int)n[I_SANITIZE_MASK];
  a.iux = (int)n[I_UX]; a.iuy = (int)n[I_UY]; a.iuz = (int)n[I_UZ];
  a.recompute_ig = (int)n[I_RECOMPUTE_IG]; a.ig_one = (int)n[I_IG_ONE];
  a.nces = (int)n[I_NCES];
  a.keys = (int*)p[P_KEYS];
  a.has_edge = (int)n[I_EDGE];
  for (int side = 0; side < 2; ++side) {
    const int b = P_EDGES + side * (1 + MAXF + MAXI);
    a.edge[side].alive = (const int*)p[b];
    for (int f = 0; f < MAXF; ++f) a.edge[side].f[f] = (const T*)p[b + 1 + f];
    for (int t = 0; t < MAXI; ++t)
      a.edge[side].i[t] = (const int*)p[b + 1 + MAXF + t];
    if (a.has_edge) {
      if (!a.edge[side].alive) return (int)cudaErrorInvalidValue;
      for (int f = 0; f < a.nf; ++f)
        if (!a.edge[side].f[f]) return (int)cudaErrorInvalidValue;
      for (int t = 0; t < a.ni; ++t)
        if (!a.edge[side].i[t]) return (int)cudaErrorInvalidValue;
    }
  }
  if (a.cap > lp2d::MAX_SLOTS || (a.cap > MAXC_LOCAL && !a.keys) || a.nf < 1 || a.nf > MAXF || a.ni < 0 || a.ni > MAXI ||
      a.coord < 0 || a.coord >= a.nf || a.w < 0 || a.w >= a.nf ||
      a.n < 1 || a.stride < 1 || a.ncell % ((long long)a.n * a.stride) ||
      (a.final_ && a.recompute_ig &&
       (a.iux < 0 || a.iuy < 0 || a.iuz < 0 || !a.ig_out)))
    return (int)cudaErrorInvalidValue;
  if (a.ncell == 0 || a.cap == 0) return 0;
  const int nz = (int)n[I_NZ], axis = (int)n[I_AXIS];
  if (a.cap <= tile::TILE_MAXC) {
    // up to 32 slots a cell: the tile kernel; 2D slots (nx, ny) are 3D
    // slots (1, nx, ny), their x axis the tile kernel's y, their y axis
    // its z
    const long long nx = n[I_NX], ny = n[I_NY];
    if (nx * ny * (nz > 0 ? nz : 1) != a.ncell || axis < 0 ||
        axis > (nz > 0 ? 2 : 1) ||
        (a.final_ && a.recompute_ig && !(a.iux < a.iuy && a.iuy < a.iuz)))
      return (int)cudaErrorInvalidValue;
    if (nz > 0) return tile::launch<T>(a, (int)nx, (int)ny, nz, axis, st);
    return tile::launch<T>(a, 1, (int)nx, (int)ny, axis + 1, st);
  }
  int threads = 128;
  int blocks = cell_blocks(a.ncell, a.cap, n[I_KEY_THREADS], threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  // above 32 slots a cell, 2D or 3D: one thread a cell
  if (a.cap <= 64) migrate_axis<T, 64><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= MAXC_LOCAL)
    migrate_axis<T, MAXC_LOCAL><<<blocks, threads, 0, st>>>(a);
  else migrate_axis<T, 0><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals unused.
LP_EXPORT int lp_migrate_axis(void** ptrs, const long long* ints,
                              const double* reals, void* stream) {
  (void)reals;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, st);
  return launch<float>(ptrs, ints, st);
}

// MAXF (which = 0) or MAXI (which = 1), held equal to the wrapper's
// limits when the library is first used
LP_EXPORT int lp_migrate_max_payloads(int which) {
  return which == 0 ? MAXF : MAXI;
}

// the sort scratch's limits (cell2d.cuh::key_limit)
LP_EXPORT int lp_key_limits(int which) { return lp2d::key_limit(which); }
