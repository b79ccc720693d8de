// Kernel B3 in 3D: fold the species-summed tile panels into the interior
// J; on a device mesh (K5) also the guard strips that go to the neighbour
// shards.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellslab.py::fold_reduce_slab
// (:2098, kernel :2165, pallas_call :2228) for 3D rims, its cross-device
// strips (:2135-2153) included. Plain PyTorch versions: the whole
// function, lambdapic_torch/ops/cellslab.py::fold_reduce_plain (panel
// overlap-add axis by axis, then parallel/halo.py::halo_reduce with a
// 2-cell guard); each launch, fold3_plain, fold_cut_3d_plain and
// fold_pend_3d_plain there.
//
// Panels (C, nbx, nby, nbz, 12, 12, 12) come from kernel B2
// (cellstep3d.cu), tile T = 8: panel (bi, bj, bk) node (u, v, w) is the
// current at padded index (8 bi + u, 8 bj + v, 8 bk + w), interior index
// padded - 2. Along one axis, padded index p gathers panel p / 8's node
// p % 8 and, if p % 8 < 4, panel p / 8 - 1's node p % 8 + 8. So interior
// index i of tile t (a = i % 8) takes panel t's node a + 2, and panel
// t - 1's node a + 10 for a < 2, panel t + 1's node a - 6 for a >= 6:
// panel t's nodes 0, 1 belong to tile t - 1, nodes 2..9 to tile t and
// nodes 10, 11 to tile t + 1. Every node has one owner.
//
// fold3_pencil (B3 3D): one 64-thread block a pencil (component, x tile,
// y tile), one thread an (x, y) column of the tile, walking the pencil's
// z panels in order. For each z panel the block copies into shared
// memory, with 16-byte cp.async, the 12-node z rows (48 B in float32,
// 16-byte aligned) of every (x node, y node) its columns gather: the own
// panel's rows u, v in 2..9, the x neighbours' planes u in {10, 11} /
// {0, 1} and the y neighbours' rows v in {10, 11} / {0, 1}, corners
// included: 144 rows, each panel row copied by exactly one block, each
// run of rows a whole number of 32-byte sectors; double buffered, so the
// next panel's copies run under this one's sums. A thread adds its
// column's x pairs, then the y pairs of those (the plain fold's order),
// for all 12 z nodes; it keeps the z overlap in registers (nodes 10, 11
// go into the next tile, nodes 0, 1 into the previous one, which is
// finished one step late), so no z piece is fetched apart. Finished
// tiles collect in a shared buffer, and every RT = 4 tiles the block
// writes each column's run of 32 values (128 B in float32) with 16-byte
// stores of consecutive threads, so that each store instruction fills
// whole 32-byte sectors: a thread storing its own column's 8 values as
// two 16-byte halves, 1 KB from its neighbour's, wrote J far more slowly
// (kernel_ab.py fold3 times RT = 1, 2 and 8 beside it).
// Index math is 32-bit within a component (the wrapper refuses larger
// shapes), divisions only by constants but in the small mesh launches;
// tiles other than T = 8 are refused. No atomics: the sum repeats bit for
// bit.
//
// Faces. An open face drops its guard nodes: no block gathers them. On
// one device a periodic axis wraps them in place (I_WRAPX..Z): a face tile's
// source lists also take the guard nodes that wrap onto it (padded
// i + 2 + n for i < 2, i + 2 - n for i >= n - 2; up to 18 rows an axis
// when n % 8 != 0, 12 when n % 8 == 0, where the wrapped nodes fill the
// missing neighbour's slots); along z the first tile stays in registers
// until the walk has passed the last panels, and panel 0's nodes 0, 1
// are carried for the last tile. The wrap sums in another order than
// halo_reduce (the same terms, within rounding).
//
// K5, on a device mesh: every axis that is split or periodic ("strip
// axis"; a periodic axis of one shard trades with itself) sends its two
// guard strips to its neighbours, in reverse axis order z, y, x, as
// halo_reduce does; an unsplit open axis drops them. Per shard:
//  - fold3_cut (one launch, before the fold) computes each strip axis's
//    two strips straight from the panels: its guard rows (padded 0, 1 and
//    n + 2, n + 3), padded (n + 4) along a strip axis exchanged after it
//    (a lower axis), interior along the others. The caller swaps them
//    with the neighbours (exchange_strips: ppermute);
//  - fold3_pend (one launch after each exchange that a later strip axis
//    follows) adds the received strips' parts that lie in a later strip
//    axis's guard rows into that axis's strips, still to be sent: so a
//    corner reaches the diagonal shard through two exchanges;
//  - fold3_pencil then writes J once: the panels' interior sum plus, per
//    strip axis in the order z, y, x, the received lo and hi strips on
//    the first and last two rows, halo_reduce's order (interior + lo +
//    hi per axis), which makes the mesh result bitwise the plain one.
// Four launches a shard on a 2 x 2 x 2 mesh, and no launch reads or
// writes the shard's whole J but the fold, once.
//
// Bound on an H100 (3.35 TB/s): bytes. B3 3D: the panels read once
// ((T+4)^3 / T^3 = 3.375 values a cell and component) and J written
// once: at 512 x 256 x 256 cells, three components in float32, 1.36 GB
// + 0.40 GB, 0.526 ms. K5 adds the strips written, sent, received and
// read (2 x 2 rows a strip axis, a few MB a shard). The panel stream
// alone (no J written) runs at about 2.8 TB/s, where a copy of the panels
// reaches 3.0.
#include "common.cuh"

namespace {

constexpr int TT = 8;              // tile cells a side
constexpr int PW = TT + 4;         // panel nodes a side
constexpr int PN = PW * PW * PW;   // panel nodes
constexpr int THREADS = 64;        // one thread an (x, y) column of a tile
constexpr int CORE = 12;           // fixed source slots an axis
constexpr int MAXS = CORE + 6;     // with the wrapped guards of n % 8 != 0
constexpr int MAXL = 6;            // sources of one interior index
constexpr int RT = 4;              // z tiles a block writes out at once

enum Ptr { P_RIMS, P_OUT, P_RLO, P_RHI, P_STRIPS, P_COUNT = P_STRIPS + 6 };
enum Int { I_C, I_NX, I_NY, I_NZ, I_TILE, I_WRAPX, I_WRAPY, I_WRAPZ,
           I_STRIPX, I_STRIPY, I_STRIPZ, I_AXIS, I_DOUBLE };

struct Axis {
  int n, nb, wrap, strip;
};
struct Geo {
  Axis a[3];
};
// the six strips of the three axes, (lo, hi) each, null off strip axes
template <typename T>
struct Strips {
  T* s[3][2];
};

// The panel sources of padded index p >= 0 along an axis of nb panels:
// the own panel p / 8's node p % 8, then panel p / 8 - 1's node p % 8 + 8,
// each where it exists (fixed slots, so no register array is indexed at
// run time).
struct Src {
  int b[2], n[2];
  bool ok[2];
};

__device__ __forceinline__ Src sources(int p, int nb) {
  Src s;
  const int b = p >> 3, l = p & 7;
  s.b[0] = b;
  s.n[0] = l;
  s.ok[0] = b < nb;
  s.b[1] = b - 1;
  s.n[1] = l + 8;
  s.ok[1] = l < 4 && b >= 1;
  return s;
}

// Dimension b of axis AX's strips: 2 along AX, n + 4 along a strip axis
// exchanged after AX (b < AX), n along the others.
template <int AX>
__device__ __forceinline__ int strip_dim(const Geo& g, int b) {
  if (b == AX) return 2;
  return (g.a[b].strip && b < AX) ? g.a[b].n + 4 : g.a[b].n;
}

// Values of one of axis AX's strips, a component.
template <int AX>
__device__ __forceinline__ long long strip_len(const Geo& g) {
  return (long long)strip_dim<AX>(g, 0) * strip_dim<AX>(g, 1) *
         strip_dim<AX>(g, 2);
}

// One axis's sources for the 8 interior indices of tile t: slots 0..11
// hold the fixed core nodes (t-1: 10, 11; t: 2..9; t+1: 0, 1), empty
// (blk -1) where that panel does not exist; wrapped guard nodes take the
// empty slot of their node if there is one, else slots from 12 on.
struct Lists {
  int cnt;
  int blk[MAXS], node[MAXS];
  int nsrc[TT];
  unsigned char idx[TT][MAXL];
};

__device__ __forceinline__ int core_slot(int node) {
  return node >= 10 ? node - 10 : (node <= 1 ? node + 10 : node);
}

__device__ void build_lists(Lists& L, int t, Axis ax) {
  for (int e = 0; e < CORE; ++e) {
    const int node = e < 2 ? e + 10 : (e < 10 ? e : e - 10);
    const int blk = e < 2 ? t - 1 : (e < 10 ? t : t + 1);
    const bool ok = blk >= 0 && blk < ax.nb;
    L.blk[e] = ok ? blk : -1;
    L.node[e] = node;
  }
  L.cnt = CORE;
  for (int a = 0; a < TT; ++a) {
    L.nsrc[a] = 0;
    const int i = t * TT + a;
    if (i >= ax.n) continue;
    int ps[3], np = 0;
    ps[np++] = i + 2;
    if (ax.wrap && i < 2) ps[np++] = i + 2 + ax.n;
    if (ax.wrap && i >= ax.n - 2) ps[np++] = i + 2 - ax.n;
    for (int q = 0; q < np; ++q) {
      const Src sr = sources(ps[q], ax.nb);
      for (int e = 0; e < 2; ++e) {
        if (!sr.ok[e]) continue;
        const int bl = sr.b[e], nd = sr.n[e];
        int s = 0;
        while (s < L.cnt && (L.blk[s] != bl || L.node[s] != nd)) ++s;
        if (s == L.cnt) {
          const int c = core_slot(nd);
          if (L.blk[c] < 0 && L.node[c] == nd) {
            s = c;
          } else if (L.cnt < MAXS) {
            s = L.cnt++;
          } else {
            continue;      // cannot happen: at most 6 wrapped sources
          }
          L.blk[s] = bl;
          L.node[s] = nd;
        }
        L.idx[a][L.nsrc[a]++] = (unsigned char)s;
      }
    }
  }
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte vectors of the kernel's type
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ static void put(float* v, float4 x) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static float4 get(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ static void put(double* v, double2 x) { v[0] = x.x; v[1] = x.y; }
  __device__ static double2 get(const double* v) {
    return make_double2(v[0], v[1]);
  }
};

// v[w] with w known only at run time, without indexing a register array
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[PW], int w) {
  T r = T(0);
#pragma unroll
  for (int u = 0; u < PW; ++u) r = (u == w) ? v[u] : r;
  return r;
}

template <typename T>
struct Pencil {
  Geo g;
  Strips<T> rs;
  T* out;
  T* ob;          // shared: RT tiles of each column, a row a thread
  // the buffer's row stride, one 16-byte piece past the RT tiles so that
  // a quarter warp's 16-byte stores into its rows hit distinct banks
  static constexpr int OBS = RT * TT + 16 / (int)sizeof(T);
  int c, bx, by, i, j;
  bool valid;
  T xy0[2];

  // the finished column of tile t: wrap of panel 0's z nodes 0, 1 onto
  // the last two rows (periodic z, one device), the received strips
  // (mesh) z, y, x, each lo then hi
  __device__ __forceinline__ void finish(int t, T (&acc)[TT]) {
    if (!valid) return;
    const int nx = g.a[0].n, ny = g.a[1].n, nz = g.a[2].n;
#pragma unroll
    for (int k = 0; k < TT; ++k) {
      const int kz = t * TT + k;
      if (g.a[2].wrap) {
        if (kz == nz - 2) acc[k] += xy0[0];
        if (kz == nz - 1) acc[k] += xy0[1];
      }
    }
    const int sx = g.a[0].strip ? 2 : 0, sy = g.a[1].strip ? 2 : 0;
    const int X = nx + 2 * sx;
    if (g.a[2].strip) {
      const int Y = ny + 2 * sy;
      const int off = ((c * X + i + sx) * Y + j + sy) * 2;
#pragma unroll
      for (int k = 0; k < TT; ++k) {
        const int kz = t * TT + k;
        if (kz < 2) acc[k] += rs.s[2][0][off + kz];
        if (kz >= nz - 2 && kz < nz) acc[k] += rs.s[2][1][off + kz - (nz - 2)];
      }
    }
    if (g.a[1].strip) {
      const bool lo = j < 2, hi = j >= ny - 2;
      if (lo) {
        const T* p = rs.s[1][0] + ((c * X + i + sx) * 2 + j) * nz + t * TT;
#pragma unroll
        for (int k = 0; k < TT; ++k)
          if (t * TT + k < nz) acc[k] += p[k];
      }
      if (hi) {
        const T* p = rs.s[1][1] + ((c * X + i + sx) * 2 + j - (ny - 2)) * nz +
                     t * TT;
#pragma unroll
        for (int k = 0; k < TT; ++k)
          if (t * TT + k < nz) acc[k] += p[k];
      }
    }
    if (g.a[0].strip) {
      if (i < 2) {
        const T* p = rs.s[0][0] + ((c * 2 + i) * ny + j) * nz + t * TT;
#pragma unroll
        for (int k = 0; k < TT; ++k)
          if (t * TT + k < nz) acc[k] += p[k];
      }
      if (i >= nx - 2) {
        const T* p = rs.s[0][1] + ((c * 2 + i - (nx - 2)) * ny + j) * nz +
                     t * TT;
#pragma unroll
        for (int k = 0; k < TT; ++k)
          if (t * TT + k < nz) acc[k] += p[k];
      }
    }
  }

  // tile t's column into its slot of the write-out buffer
  __device__ __forceinline__ void keep(int t, const T (&acc)[TT]) {
    using V = typename Vec<T>::type;
    constexpr int N = Vec<T>::N;
    T* o = ob + threadIdx.x * OBS + (t % RT) * TT;
#pragma unroll
    for (int q = 0; q < TT / N; ++q)
      reinterpret_cast<V*>(o)[q] = Vec<T>::get(acc + q * N);
  }

  // The block writes tiles t0 .. t1 (t0 % RT == 0, t1 - t0 < RT; from
  // t0 + 1 with ``skip0``) of its 64 columns from the buffer: each
  // column's run of up to RT x 8 values (128 B in float32) by 16-byte
  // stores of consecutive threads.
  __device__ __forceinline__ void flush(int t0, int t1, bool skip0) {
    __syncthreads();
    const int nx = g.a[0].n, ny = g.a[1].n, nz = g.a[2].n;
    const int z0 = t0 * TT + (skip0 ? TT : 0);
    const int z1 = (t1 + 1) * TT < nz ? (t1 + 1) * TT : nz;
    T* base = out + (long long)c * nx * ny * nz;
    if ((nz & (TT - 1)) == 0) {
      constexpr int EPC = 16 / (int)sizeof(T);
      constexpr int CH = RT * TT / EPC;         // 16-byte pieces a column
      for (int q = threadIdx.x; q < THREADS * CH; q += THREADS) {
        const int col = q / CH, h = q - col * CH;
        const int ci = bx * TT + (col >> 3), cj = by * TT + (col & 7);
        const int z = t0 * TT + h * EPC;
        if (ci >= nx || cj >= ny || z < z0 || z >= z1) continue;
        using V = typename Vec<T>::type;
        reinterpret_cast<V*>(base + (ci * ny + cj) * nz + z)[0] =
            reinterpret_cast<const V*>(ob + col * OBS + h * EPC)[0];
      }
    } else {
      for (int q = threadIdx.x; q < THREADS * RT * TT; q += THREADS) {
        const int col = q / (RT * TT), h = q - col * (RT * TT);
        const int ci = bx * TT + (col >> 3), cj = by * TT + (col & 7);
        const int z = t0 * TT + h;
        if (ci >= nx || cj >= ny || z < z0 || z >= z1) continue;
        base[(ci * ny + cj) * nz + z] = ob[col * OBS + h];
      }
    }
    __syncthreads();
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
fold3_pencil(const T* __restrict__ rims, T* __restrict__ out, Geo g,
             Strips<T> rs, int capx, int capy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Lists lx, ly;
  __shared__ int rowoff[MAXS * MAXS];
  __shared__ __align__(16) T ob[THREADS * Pencil<T>::OBS];
  T* stage = reinterpret_cast<T*>(smem_raw);
  const int by = blockIdx.x, bx = blockIdx.y, c = blockIdx.z;
  const int nbx = g.a[0].nb, nby = g.a[1].nb, nbz = g.a[2].nb;
  const int nz = g.a[2].n;
  if (threadIdx.x == 0) build_lists(lx, bx, g.a[0]);
  if (threadIdx.x == 32) build_lists(ly, by, g.a[1]);
  __syncthreads();
  if (lx.cnt > capx || ly.cnt > capy) return;     // sized by the wrapper
  const int rows = capx * capy;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const int e = capy == CORE ? r / CORE : r / MAXS, f = r - e * capy;
    int off = -1;
    if (e < lx.cnt && f < ly.cnt && lx.blk[e] >= 0 && ly.blk[f] >= 0)
      off = (lx.blk[e] * nby + ly.blk[f]) * nbz * PN +
            (lx.node[e] * PW + ly.node[f]) * PW;
    rowoff[r] = off;
  }
  __syncthreads();
  const T* src = rims + (long long)c * nbx * nby * nbz * PN;
  const int stage_len = rows * PW;
  constexpr int CH = PW * (int)sizeof(T) / 16;    // 16-byte pieces a row
  constexpr int EPC = 16 / (int)sizeof(T);
  auto issue = [&](int s) {
    T* dst = stage + (s & 1) * stage_len;
    for (int q = threadIdx.x; q < rows * CH; q += THREADS) {
      const int r = q / CH, h = q - r * CH;
      const int off = rowoff[r];
      if (off >= 0) cp16(dst + r * PW + h * EPC, src + off + s * PN + h * EPC);
    }
    cp_commit();
  };

  const int a = threadIdx.x >> 3, b = threadIdx.x & 7;
  Pencil<T> pen{g,      rs,        out,   ob,
                 c,      bx,        by,    bx * TT + a,
                 by * TT + b,       false, {T(0), T(0)}};
  pen.valid = pen.i < g.a[0].n && pen.j < g.a[1].n;
  const int na = lx.nsrc[a], nb_ = ly.nsrc[b];
  const bool zwrap = g.a[2].wrap;
  const bool hold = zwrap && nbz >= 3;    // tile 0 waits for the last panels
  T carry[2] = {T(0), T(0)};
  T prv[TT], fst[TT];
#pragma unroll
  for (int k = 0; k < TT; ++k) prv[k] = fst[k] = T(0);

  issue(0);
  for (int s = 0; s < nbz; ++s) {
    if (s + 1 < nbz) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* S = stage + (s & 1) * stage_len;
    T xy[PW];
#pragma unroll
    for (int w = 0; w < PW; ++w) xy[w] = T(0);
    for (int fb = 0; fb < nb_; ++fb) {
      const int f = ly.idx[b][fb];
      T tx[PW];
#pragma unroll
      for (int w = 0; w < PW; ++w) tx[w] = T(0);
      for (int ea = 0; ea < na; ++ea) {
        const T* row = S + (lx.idx[a][ea] * capy + f) * PW;
        using V = typename Vec<T>::type;
        constexpr int N = Vec<T>::N;
        T r[PW];
#pragma unroll
        for (int q = 0; q < PW / N; ++q)
          Vec<T>::put(r + q * N, reinterpret_cast<const V*>(row)[q]);
#pragma unroll
        for (int w = 0; w < PW; ++w) tx[w] += r[w];
      }
#pragma unroll
      for (int w = 0; w < PW; ++w) xy[w] += tx[w];
    }
    __syncthreads();      // this buffer is refilled by the next step's issue

    // z: tile s starts (own nodes 2..9, the previous panel's 10, 11);
    // tile s - 1 ends (this panel's nodes 0, 1)
    if (s >= 1) {
      prv[6] += xy[0];
      prv[7] += xy[1];
    }
    T cur[TT];
#pragma unroll
    for (int k = 0; k < TT; ++k) cur[k] = xy[k + 2];
    cur[0] += carry[0];
    cur[1] += carry[1];
    carry[0] = xy[10];
    carry[1] = xy[11];
    if (zwrap) {
      if (s == 0) {
        pen.xy0[0] = xy[0];
        pen.xy0[1] = xy[1];
      }
      // the guard nodes padded nz + 2, nz + 3 that wrap onto tile 0's
      // rows 0, 1
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= nz) continue;
        const Src sr = sources(q + 2 + nz, nbz);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!sr.ok[e] || sr.b[e] != s) continue;
          const T v = pick(xy, sr.n[e]);
          if (s == 0) cur[q] += v;
          else if (s == 1) prv[q] += v;
          else fst[q] += v;
        }
      }
    }
    if (s >= 1) {
      const int t = s - 1;
      if (t == 0 && hold) {
#pragma unroll
        for (int k = 0; k < TT; ++k) fst[k] = prv[k];
      } else {
        pen.finish(t, prv);
        pen.keep(t, prv);
      }
      if (t % RT == RT - 1) pen.flush(t - (RT - 1), t, hold && t < RT);
    }
#pragma unroll
    for (int k = 0; k < TT; ++k) prv[k] = cur[k];
  }
  const int last = nbz - 1;
  if (!(last == 0 && hold)) {
    pen.finish(last, prv);
    pen.keep(last, prv);
  }
  pen.flush(last - last % RT, last, hold && last < RT);
  if (hold) {                    // tile 0, once the last panels are in
    pen.finish(0, fst);
    pen.keep(0, fst);
    pen.flush(0, 0, false);
  }
}

// The value of the padded current (the panels' overlap-add, no wrap) at
// padded (p0, p1, p2): x pairs, then y pairs, then z pairs, the plain
// fold's order.
template <typename T>
__device__ T padded_value(const T* __restrict__ src, const Geo& g,
                          const int (&p)[3]) {
  const Src sx = sources(p[0], g.a[0].nb), sy = sources(p[1], g.a[1].nb),
            sz = sources(p[2], g.a[2].nb);
  const int nby = g.a[1].nb, nbz = g.a[2].nb;
  T v = T(0);
#pragma unroll
  for (int zz = 0; zz < 2; ++zz) {
    if (!sz.ok[zz]) continue;
    T vy = T(0);
#pragma unroll
    for (int yy = 0; yy < 2; ++yy) {
      if (!sy.ok[yy]) continue;
      T vx = T(0);
#pragma unroll
      for (int xx = 0; xx < 2; ++xx)
        if (sx.ok[xx])
          vx += src[((sx.b[xx] * nby + sy.b[yy]) * nbz + sz.b[zz]) * PN +
                    (sx.n[xx] * PW + sy.n[yy]) * PW + sz.n[zz]];
      vy += vx;
    }
    v += vy;
  }
  return v;
}

// K5's strip cut of axis AX, one side (lo: padded rows 0, 1; hi: n + 2,
// n + 3) of component c: a grid-stride loop over the strip's elements.
template <typename T, int AX>
__device__ void cut_axis(const T* __restrict__ src, const Geo& g,
                         T* __restrict__ dst, int side) {
  int d[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) d[b] = strip_dim<AX>(g, b);
  const int count = d[0] * d[1] * d[2];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += gridDim.x * blockDim.x) {
    int q[3];
    q[2] = e % d[2];
    const int r = e / d[2];
    q[1] = r % d[1];
    q[0] = r / d[1];
    int p[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (b == AX)
        p[b] = side ? g.a[b].n + 2 + q[b] : q[b];
      else
        p[b] = (g.a[b].strip && b < AX) ? q[b] : q[b] + 2;
    }
    dst[e] = padded_value(src, g, p);
  }
}

// K5's strip cut: blockIdx.y = 2 * axis + side, blockIdx.z = component.
template <typename T>
__global__ void fold3_cut(const T* __restrict__ rims, Geo g, Strips<T> st) {
  const int ax = blockIdx.y >> 1, side = blockIdx.y & 1, c = blockIdx.z;
  const T* src =
      rims + (long long)c * g.a[0].nb * g.a[1].nb * g.a[2].nb * PN;
  if (ax == 0 && g.a[0].strip)
    cut_axis<T, 0>(src, g, (side ? st.s[0][1] : st.s[0][0]) +
                               c * strip_len<0>(g), side);
  else if (ax == 1 && g.a[1].strip)
    cut_axis<T, 1>(src, g, (side ? st.s[1][1] : st.s[1][0]) +
                               c * strip_len<1>(g), side);
  else if (ax == 2 && g.a[2].strip)
    cut_axis<T, 2>(src, g, (side ? st.s[2][1] : st.s[2][0]) +
                               c * strip_len<2>(g), side);
}

// K5's pending add after axis AX's exchange into strip axis B < AX's
// strip (one side, component c): on its rows along AX that the received
// strips cover (interior 0, 1 from lo, n - 2, n - 1 from hi, in that
// order), the received values at the same place.
template <typename T, int AX, int B>
__device__ void pend_axis(const Geo& g, const T* __restrict__ lo,
                          const T* __restrict__ hi, T* __restrict__ dst,
                          int side) {
  int ds[3], dr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ds[k] = strip_dim<B>(g, k);
    dr[k] = strip_dim<AX>(g, k);
  }
  const int nax = g.a[AX].n;
  const int F = nax < 4 ? nax : 4;          // the face rows along AX
  int dl[3] = {ds[0], ds[1], ds[2]};
  dl[AX] = F;
  const int count = dl[0] * dl[1] * dl[2];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += gridDim.x * blockDim.x) {
    int q[3];
    q[2] = e % dl[2];
    const int r = e / dl[2];
    q[1] = r % dl[1];
    q[0] = r / dl[1];
    const int row = F < 4 ? q[AX] : (q[AX] < 2 ? q[AX] : nax - 4 + q[AX]);
    int sc[3], rc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sc[k] = k == AX ? row : q[k];
      if (k == B)
        rc[k] = side ? g.a[B].n + 2 + q[k] : q[k];
      else if (k != AX)
        rc[k] = q[k] + (dr[k] - ds[k]) / 2;   // padded there, not here: +2
      else
        rc[k] = 0;
    }
    const int si = (sc[0] * ds[1] + sc[1]) * ds[2] + sc[2];
    T v = dst[si];
    if (row < 2) {
      rc[AX] = row;
      v += lo[(rc[0] * dr[1] + rc[1]) * dr[2] + rc[2]];
    }
    if (row >= nax - 2) {
      rc[AX] = row - (nax - 2);
      v += hi[(rc[0] * dr[1] + rc[1]) * dr[2] + rc[2]];
    }
    dst[si] = v;
  }
}

// K5's pending add after axis AX's exchange (rlo, rhi: the received
// strips): blockIdx.y = 2 * b + side over the strip axes b < AX,
// blockIdx.z = component.
template <typename T, int AX>
__global__ void fold3_pend(Geo g, const T* __restrict__ rlo,
                           const T* __restrict__ rhi, Strips<T> st) {
  const int b = blockIdx.y >> 1, side = blockIdx.y & 1, c = blockIdx.z;
  const T* lo = rlo + c * strip_len<AX>(g);
  const T* hi = rhi + c * strip_len<AX>(g);
  if (b == 0 && g.a[0].strip)
    pend_axis<T, AX, 0>(g, lo, hi, (side ? st.s[0][1] : st.s[0][0]) +
                                       c * strip_len<0>(g), side);
  if constexpr (AX == 2) {
    if (b == 1 && g.a[1].strip)
      pend_axis<T, 2, 1>(g, lo, hi, (side ? st.s[1][1] : st.s[1][0]) +
                                        c * strip_len<1>(g), side);
  }
}

Geo geometry(const long long* n) {
  Geo g;
  for (int k = 0; k < 3; ++k) {
    g.a[k].n = (int)n[I_NX + k];
    g.a[k].nb = (int)((n[I_NX + k] + TT - 1) / TT);
    g.a[k].wrap = (int)n[I_WRAPX + k];
    g.a[k].strip = (int)n[I_STRIPX + k];
  }
  return g;
}

template <typename T>
Strips<T> strips(void** p) {
  Strips<T> s;
  for (int k = 0; k < 3; ++k)
    for (int h = 0; h < 2; ++h) s.s[k][h] = (T*)p[P_STRIPS + 2 * k + h];
  return s;
}

template <typename T>
int launch_fold(void** p, const long long* n, cudaStream_t st) {
  const Geo g = geometry(n);
  const int C = (int)n[I_C];
  // staged rows an axis: the 12 core slots, 18 where wrapped guards of
  // n % 8 != 0 need their own
  int cap[2];
  for (int k = 0; k < 2; ++k)
    cap[k] = (g.a[k].wrap && g.a[k].n % TT != 0) ? MAXS : CORE;
  const size_t smem = 2 * (size_t)cap[0] * cap[1] * PW * sizeof(T);
  int err = (int)cudaFuncSetAttribute(
      fold3_pencil<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  dim3 grid(g.a[1].nb, g.a[0].nb, C);
  fold3_pencil<T><<<grid, THREADS, smem, st>>>(
      (const T*)p[P_RIMS], (T*)p[P_OUT], g, strips<T>(p), cap[0], cap[1]);
  return (int)cudaGetLastError();
}

int grid_x(long long count) {
  long long b = (count + 255) / 256;
  return (int)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

template <typename T>
int launch_cut(void** p, const long long* n, cudaStream_t st) {
  const Geo g = geometry(n);
  long long most = 1;
  for (int ax = 0; ax < 3; ++ax) {
    long long cnt = 1;
    for (int b = 0; b < 3; ++b)
      cnt *= b == ax ? 2
                     : ((g.a[b].strip && b < ax) ? g.a[b].n + 4 : g.a[b].n);
    if (g.a[ax].strip && cnt > most) most = cnt;
  }
  dim3 grid(grid_x(most), 6, (int)n[I_C]);
  fold3_cut<T><<<grid, 256, 0, st>>>((const T*)p[P_RIMS], g, strips<T>(p));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pend(void** p, const long long* n, cudaStream_t st) {
  const Geo g = geometry(n);
  const int ax = (int)n[I_AXIS];
  if (ax < 1 || ax > 2 || !g.a[ax].strip) return (int)cudaErrorInvalidValue;
  long long most = 1;
  for (int b = 0; b < ax; ++b) {
    long long cnt = 1;
    for (int k = 0; k < 3; ++k)
      cnt *= k == b ? 2
                    : (k == ax ? 4
                               : ((g.a[k].strip && k < b) ? g.a[k].n + 4
                                                          : g.a[k].n));
    if (g.a[b].strip && cnt > most) most = cnt;
  }
  dim3 grid(grid_x(most), 2 * ax, (int)n[I_C]);
  if (ax == 1)
    fold3_pend<T, 1><<<grid, 256, 0, st>>>(g, (const T*)p[P_RLO],
                                           (const T*)p[P_RHI], strips<T>(p));
  else
    fold3_pend<T, 2><<<grid, 256, 0, st>>>(g, (const T*)p[P_RLO],
                                           (const T*)p[P_RHI], strips<T>(p));
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr (rims, J, the six received strips by axis, lo then hi);
// ints: enum Int (I_AXIS unused); reals unused.
LP_EXPORT int lp_fold_3d(void** ptrs, const long long* ints,
                         const double* reals, void* stream) {
  (void)reals;
  if (ints[I_TILE] != TT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch_fold<double>(ptrs, ints, st);
  return launch_fold<float>(ptrs, ints, st);
}

// ptrs: P_RIMS and the six strips to write; ints: enum Int (wraps and
// I_AXIS unused).
LP_EXPORT int lp_fold_cut_3d(void** ptrs, const long long* ints,
                             const double* reals, void* stream) {
  (void)reals;
  if (ints[I_TILE] != TT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch_cut<double>(ptrs, ints, st);
  return launch_cut<float>(ptrs, ints, st);
}

// ptrs: P_RLO, P_RHI (axis I_AXIS's received strips) and the six pending
// strips, added into in place; ints: enum Int (wraps unused).
LP_EXPORT int lp_fold_pend_3d(void** ptrs, const long long* ints,
                              const double* reals, void* stream) {
  (void)reals;
  if (ints[I_TILE] != TT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch_pend<double>(ptrs, ints, st);
  return launch_pend<float>(ptrs, ints, st);
}
