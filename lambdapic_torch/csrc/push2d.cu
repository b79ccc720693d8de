// Kernel B4: gather, Boris and half push of a freshly re-binned 2D cell
// species, with the six gathered components on request (want_eb).
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// fused_push_cell_2d (:308, kernel :333, pallas_call :411). Plain PyTorch
// version: lambdapic_torch/ops/cellpallas.py::fused_push_cell_2d_plain,
// i.e. [a first half push at inv_gamma = 1/sqrt(1 + u^2)] ->
// gather_cell_2d -> boris_push -> push_position_2d, with the dead slots'
// values put in at the end.
//
// push (one __global__): one 256-thread block per tile of TX x TY = 8 x 32
// cells (x rows of a warp's 32 contiguous y cells; tile (bi, bj) = block
// bi*nty + bj), one cell a thread. The block takes the slots a chunk of up
// to 256 slot indices at a time: each warp reads its cells' alive bytes
// of the chunk once, as one ballot word a slot index, into shared memory,
// and a block scan numbers the alive slots in (slot index, cell) order. A
// chunk with no alive slot writes its dead values and reads nothing else.
// Otherwise the block copies the tile's E/B window (six components of
// (TX+3) x (TY+3) nodes, cells -2 .. +TX and -2 .. +TY: 9.2 KB in
// float32, 18.5 KB in float64) into shared memory with cp.async, once a
// block, and goes through the chunk in rounds of consecutive slot indices
// that hold at most STAGE alive slots together (a slot index joins the
// round of its first particle's number / (STAGE - 256), so a round holds
// over STAGE - 256 particles unless it is the chunk's last): it lists the
// round's alive slots while the copy flies, and each thread takes one
// listed particle: the optional first half push, the gather from the
// window (cell2d.cuh::gather_eb on the window as a padded stack of its
// own: the taps and order of the plain version and of B2's rebin2y),
// Boris (cell2d.cuh::boris) and the second half push, its 6 (12 with
// want_eb) outputs kept in a shared stage. Last, every slot of the round
// is written once, neighbouring threads on neighbouring cells: the
// stage's values into the alive slots, the dead values into the others.
// Two barriers a round. Four blocks an SM (at most 64 registers a
// thread): the stores of the dead slots want warps in flight.
//
// Alive mask (P_ALIVE, uint8, required): only alive slots are pushed, and
// a dead slot gets B2's dead values: zero floats, inv_gamma 1 and, with
// want_eb, zero fields. What reads a dead slot's outputs downstream: the
// next step's first half push (a zero move), the exact re-binning
// (ops/cell2d.py::migrate_cells keys and moves alive slots only), QED's
// update_chi_and_events (its draws and events are masked by alive) and
// B5 (the mask; the plain version's w = 0); tests/test_torch_deadslots2d.py
// holds the per-stage 2D step to that.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32): bytes: the mask, five
// reals of each alive slot read, six (twelve with want_eb) reals of every
// slot written, and the E/B nodes once. Operations: about 770 a particle.
// Where most cells are empty (the 2D slice's foil fills 6% of them) the
// writes of the dead slots set it. What the design does about it: a dead
// slot costs its stores and no arithmetic (the old one-thread-a-slot
// kernel gathered 66 taps from device memory and ran Boris for every
// slot); every store covers whole 32-byte sectors (the alive slots'
// results go out with their dead neighbours'); an empty tile reads only
// its mask; the rounds are packed by the alive count, not by slot index,
// so a sparse tile pushes its particles in one or two full passes.
// Compiled with --fmad=false, so an alive slot is bitwise the plain
// version's.
#include "cell2d.cuh"

namespace {

using namespace lp2d;

enum Ptr { P_EB, P_X, P_Y, P_UX, P_UY, P_UZ,
           P_OX, P_OY, P_OUX, P_OUY, P_OUZ, P_OIG, P_OEB,
           P_ALIVE = P_OEB + 6, P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_G, I_WANT_EB, I_DO_POS1, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_HX, R_HY,       // c dt / dx / 2, c dt / dy / 2
            R_EF, R_BF };     // q dt / (2 m c), q dt / (2 m)

constexpr int TX = 8, TY = 32;        // tile: TX x-rows of TY y cells
constexpr int THREADS = TX * TY;      // one cell a thread
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;        // slot indices a chunk, at most
constexpr int STAGE = 512;            // particles a round, at most
constexpr int HOP = STAGE - THREADS;  // a slot index holds <= THREADS
constexpr int WX = TX + 3, WY = TY + 3;
constexpr int WINDOW_REALS = 6 * WX * WY;
constexpr int NOUT = 12;              // outputs: x y ux uy uz ig, 6 fields
constexpr int IG_OUT = 5;             // inv_gamma's output (dead value 1)

template <typename T>
struct Args {
  const T* eb;
  const unsigned char* alive;
  const T *x, *y, *ux, *uy, *uz;
  T* out[NOUT];                 // x y ux uy uz inv_gamma [ex .. bz]
  int cap, nx, ny, g, nout, do_pos1, chunk;
  long long ncell;
  T hx, hy, ef, bf;
};

// Dynamic shared memory of a block: the E/B window, a round's outputs
// (nout arrays of STAGE), the chunk's ballot words and particle numbers
// (chunk x WARPS each), the rounds' first slot indices, a round's list
// and the scan's warp sums. float32 at 20 slots a cell: 38.7 KB with
// want_eb, 26.4 KB without.
template <typename T>
inline size_t push_smem(int nout, int chunk) {
  return sizeof(T) * (WINDOW_REALS + (size_t)nout * STAGE) +
         sizeof(int) * (2 * (size_t)chunk * WARPS + chunk + 1 + STAGE +
                        WARPS);
}

// The exclusive sum of v over the block's threads in thread order, and
// the block's total; red holds WARPS ints. One barrier.
__device__ __forceinline__ int block_scan(int v, int* red, int lane,
                                          int warp, int& total) {
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = red[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// Start the copy of the E/B window of the tile whose first cell is
// (x0, y0) from the padded stack eb (6, nx+2g, ny+2g), g >= 2, into win
// (6, WX, WY): window node (wx, wy) is padded node (x0 + g - 2 + wx,
// y0 + g - 2 + wy), so the window is a padded stack of a (TX - 1) x
// (TY - 1) grid with g = 2 and the tile's cell (lx, ly) its cell (lx, ly).
// Element by element (eb's rows of ny + 2g reals are not 16-byte aligned),
// neighbouring threads on neighbouring y nodes; nodes past the padded
// stack's end are left unset: only cells past the grid, which push
// nothing, would read them.
template <typename T>
__device__ __forceinline__ void load_window(T* win, const T* __restrict__ eb,
                                            int nx, int ny, int g, int x0,
                                            int y0, int tid) {
  const int nxp = nx + 2 * g, nyp = ny + 2 * g;
  const long long plane = (long long)nxp * nyp;
  for (int e = tid; e < WINDOW_REALS; e += THREADS) {
    const int c = e / (WX * WY), r = e - c * (WX * WY);
    const int wx = r / WY, wy = r - wx * WY;
    const int px = x0 + g - 2 + wx, py = y0 + g - 2 + wy;
    if (px < nxp && py < nyp)
      copy_async(win + e, eb + c * plane + (long long)px * nyp + py);
  }
}

// One listed particle, slot idx of the tile's cell (lx, ly) at (ix, iy):
// its outputs into stage[k * STAGE + li].
template <typename T>
__device__ __forceinline__ void push_one(const Args<T>& a, const T* win,
                                         T* stage, int li, long long idx,
                                         int lx, int ly, int ix, int iy) {
  T x = a.x[idx], y = a.y[idx];
  T ux = a.ux[idx], uy = a.uy[idx], uz = a.uz[idx];
  if (a.do_pos1) {
    T ig0 = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
    x = pushed(x, ux, ig0, a.hx);
    y = pushed(y, uy, ig0, a.hy);
  }
  T e[6];
  gather_eb<T, int>(win, TX - 1, TY - 1, 2, lx, ly, x - T(ix), y - T(iy), e);
  T ig = boris(ux, uy, uz, e, a.ef, a.bf);
  T* o = stage + li;
  o[0 * STAGE] = pushed(x, ux, ig, a.hx);
  o[1 * STAGE] = pushed(y, uy, ig, a.hy);
  o[2 * STAGE] = ux;
  o[3 * STAGE] = uy;
  o[4 * STAGE] = uz;
  o[IG_OUT * STAGE] = ig;
  if (a.nout == NOUT) {
#pragma unroll
    for (int k = 0; k < 6; ++k) o[(6 + k) * STAGE] = e[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4) push(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* stage = win + WINDOW_REALS;
  unsigned* ball = reinterpret_cast<unsigned*>(stage + a.nout * STAGE);
  int* num = reinterpret_cast<int*>(ball + a.chunk * WARPS);
  int* first = num + a.chunk * WARPS;     // rounds' first slot indices
  int* list = first + a.chunk + 1;
  int* red = list + STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int nty = (a.ny + TY - 1) / TY;
  const int bi = blockIdx.x / nty, bj = blockIdx.x - bi * nty;
  const int x0 = bi * TX, y0 = bj * TY;
  // this thread's cell: neighbouring threads on neighbouring y cells, so
  // each store of a slot index covers whole rows
  const int ix = x0 + warp, iy = y0 + lane;
  const bool in = ix < a.nx && iy < a.ny;
  const long long cell = (long long)ix * a.ny + iy;
  bool loading = false, loaded = false;
  for (int c0 = 0; c0 < a.cap; c0 += a.chunk) {
    const int nch = min(a.chunk, a.cap - c0);
    const long long s0 = (long long)c0 * a.ncell + cell;
    if (c0 > 0) __syncthreads();        // the last chunk's tables read
    // the chunk's alive bytes, once: ball[s][w] is warp w's ballot of
    // slot index c0 + s
#pragma unroll 4
    for (int s = 0; s < nch; ++s) {
      const bool v = in && a.alive[s0 + s * a.ncell] != 0;
      const unsigned b = __ballot_sync(0xffffffffu, v);
      if (lane == 0) ball[s * WARPS + warp] = b;
    }
    __syncthreads();
    // number the alive slots in (slot index, cell) order: num[s][w] is
    // the number of warp w's first alive slot of slot index c0 + s
    int cnt = 0;
    if (tid < nch)
#pragma unroll
      for (int w = 0; w < WARPS; ++w) cnt += __popc(ball[tid * WARPS + w]);
    int total;
    const int at = block_scan(cnt, red, lane, warp, total);
    if (total == 0) {
      // no alive slot in the chunk: the dead values, nothing else read
      if (in)
        for (int s = 0; s < nch; ++s)
          for (int k = 0; k < a.nout; ++k)
            a.out[k][s0 + s * a.ncell] = T(k == IG_OUT ? 1 : 0);
      continue;
    }
    if (!loaded) {
      load_window(win, a.eb, a.nx, a.ny, a.g, x0, y0, tid);
      copy_async_commit();
      loading = loaded = true;
    }
    if (tid < nch) {
      int run = at;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        num[tid * WARPS + w] = run;
        run += __popc(ball[tid * WARPS + w]);
      }
    }
    __syncthreads();
    // slot index s joins round num[s][0] / HOP; it opens that round where
    // the slot index before it belongs to an earlier one (a slot index
    // holds at most HOP particles, so no round is empty)
    if (tid < nch) {
      const int r = num[tid * WARPS] / HOP;
      if (tid == 0 || num[(tid - 1) * WARPS] / HOP != r) first[r] = tid;
    }
    const int nrounds = num[(nch - 1) * WARPS] / HOP + 1;
    if (tid == 0) first[nrounds] = nch;
    __syncthreads();
    for (int r = 0; r < nrounds; ++r) {
      const int sa = first[r], sb = first[r + 1];
      const int base = num[sa * WARPS];
      const int n = (sb < nch ? num[sb * WARPS] : total) - base;
      // list the round's alive slots: (slot index - sa) * THREADS + tid
      for (int s = sa; s < sb; ++s) {
        const unsigned b = ball[s * WARPS + warp];
        if ((b >> lane) & 1u)
          list[num[s * WARPS + warp] + __popc(b & below) - base] =
              (s - sa) * THREADS + tid;
      }
      if (loading) {
        copy_async_wait();
        loading = false;
      }
      __syncthreads();
      // push the listed particles, outputs into the stage
      for (int j = tid; j < n; j += THREADS) {
        const int e = list[j];
        const int s = sa + e / THREADS, c = e % THREADS;
        const int lx = c >> 5, ly = c & 31;
        const int px = x0 + lx, py = y0 + ly;
        push_one(a, win, stage, j,
                 (long long)(c0 + s) * a.ncell + (long long)px * a.ny + py,
                 lx, ly, px, py);
      }
      __syncthreads();
      // every slot of the round written once, coalesced: the stage's
      // values into the alive slots, the dead values (0, inv_gamma 1)
      // into the rest
      if (in)
        for (int s = sa; s < sb; ++s) {
          const unsigned b = ball[s * WARPS + warp];
          const bool live = (b >> lane) & 1u;
          const int j = num[s * WARPS + warp] + __popc(b & below) - base;
          const long long idx = s0 + s * a.ncell;
          for (int k = 0; k < a.nout; ++k)
            a.out[k][idx] = live ? stage[k * STAGE + j]
                                 : T(k == IG_OUT ? 1 : 0);
        }
    }
  }
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.eb = (const T*)p[P_EB];
  a.alive = (const unsigned char*)p[P_ALIVE];
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY]; a.uz = (const T*)p[P_UZ];
  for (int k = 0; k < NOUT; ++k) a.out[k] = (T*)p[P_OX + k];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.g = (int)n[I_G];
  a.nout = n[I_WANT_EB] ? NOUT : 6;
  a.do_pos1 = (int)n[I_DO_POS1];
  a.ncell = (long long)a.nx * a.ny;
  a.hx = (T)r[R_HX]; a.hy = (T)r[R_HY]; a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  if (a.g < 2 || a.cap < 0 || !a.alive) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a.nout; ++k)
    if (!a.out[k]) return (int)cudaErrorInvalidValue;
  if (a.ncell == 0 || a.cap == 0) return 0;
  a.chunk = a.cap < CHUNK ? a.cap : CHUNK;
  const int nblocks = ceil_div(a.nx, TX) * ceil_div(a.ny, TY);
  const size_t smem = push_smem<T>(a.nout, a.chunk);
  int err = (int)cudaFuncSetAttribute(
      push<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)push_smem<T>(NOUT, CHUNK));
  if (err) return err;
  push<T><<<nblocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_push_2d(void** ptrs, const long long* ints,
                         const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
