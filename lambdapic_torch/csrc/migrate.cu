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
// Rank-generic: the slots are (cap, ncell) with the cells flattened in C
// order, and the caller names the axis by its length n and its stride
// (the cells between neighbours along it: ny*nz, nz, 1 in 3D; ny, 1 in
// 2D), so one source serves both ranks and B6 in 3D is this kernel with a
// third axis. Cell c's index along the axis is (c / stride) % n.
//
// One thread per cell, as kernel B2's pass_x: it builds the 5-way keys
// (donor+1 0 / dead-even 1 / stay 2 / dead-odd 3 / donor-1 4, dead parity
// from the slot index before the sort) of its own column and of its two
// neighbours along the axis, sorts each through the compare-exchange list
// of cellpallas.py::_batcher_network (strict ka > kb), and places slot p
// from the lo neighbour's sorted slot p if that is a donor(+1), else from
// the hi neighbour's if that is a donor(-1), else its own; two or three
// sources merge (w summed; the payloads of the merge set weight-averaged;
// the others take the placed value). Arrivals through a periodic wrap
// shift their coordinate by -+n; at an open face the neighbour outside
// sends nothing (the TPU kernel's key 9).
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
// their arrivals shifted by -+n as wrapped ones are. The edges are read
// with plain loads.
//
// Payloads are run-time lists: up to MAXF float payloads of the kernel's
// type and MAXI int32 payloads. The caller ping-pongs two sets of buffers
// between the axes. On the last axis (I_FINAL) the kernel also does the
// tail of migrate_cells_fused (cellpallas.py:1235-1245): dead slots'
// payloads of the sanitize set become 0, and inv_gamma is recomputed as
// 1/sqrt(1 + u^2) into its own output (I_RECOMPUTE_IG) or, carried as a
// payload (a photon species), set to 1 in dead slots (I_IG_ONE).
//
// Compiled with --fmad=false and written as the plain version evaluates
// it, so keys, placements and merges match it bit for bit.
//
// Capacity: up to MAXC_LOCAL (128) slots a cell each thread keeps 3 x cap
// packed keys in local memory (96 B at 8 slots a cell, 1,536 B at 128);
// above it a grid-stride loop over the cells keeps them in a global
// scratch row per thread (cell2d.cuh's for_cells).
//
// Bound on an H100 (3.35 TB/s): bytes: the mask and every payload read
// and written once. Each thread reads its neighbours' masks and positions
// again; along x in 3D the neighbours are ny*nz cells apart, so a warp's
// loads stay coalesced along z.
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
           I_EDGE };

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
  int threads = 128;
  int blocks = cell_blocks(a.ncell, a.cap, n[I_KEY_THREADS], threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  if (a.cap <= 8) migrate_axis<T, 8><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 16) migrate_axis<T, 16><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 32) migrate_axis<T, 32><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 64) migrate_axis<T, 64><<<blocks, threads, 0, st>>>(a);
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
