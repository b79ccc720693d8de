// Kernel B7: sort (key, payloads) along the slot axis, separately for
// every cell, through the Batcher compare-exchange list.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// sort_cells_pallas (:769, kernel :802, pallas_call :824), the sort of the
// re-binning's migrate_cells when the fused migration is off. Plain
// PyTorch version: lambdapic_torch/ops/cell2d.py::batcher_sort.
//
// Arrays are (cap, ncell): slot s of cell c at s*ncell + c, any number of
// cell dims flattened. One thread per cell loads its cap keys, runs the
// list of cellpallas.py::_batcher_network (swap on a strict ka > kb) on
// (key, slot) pairs, then writes the sorted keys and moves every payload
// by the permutation. The exchange decisions depend on the keys alone, so
// this is bitwise the same as carrying the payloads through every
// exchange. Payloads are moved as bytes: their count and element sizes
// (1, 2, 4 or 8 bytes: bool, float32, int32, float64, ...) are run-time
// arguments.
//
// Capacity: up to MAXC_LOCAL (128) slots a cell the keys and an 8-bit
// permutation sit in thread-local arrays; above it a grid-stride loop
// over the cells keeps the keys and a 16-bit permutation in a global
// scratch row per thread (KEY_ROWS x cap int32: the keys, then the
// permutation).
//
// Bound on an H100 (3.35 TB/s): bytes: the key and every payload read and
// written once.
#include "cell2d.cuh"

namespace {

constexpr int MAXP = 24;

enum Ptr { P_KEY, P_KEY_OUT, P_CES, P_KEYS, P_IN, P_OUT = P_IN + MAXP,
           P_COUNT = P_OUT + MAXP };
enum Int { I_CAP, I_NCELL, I_NP, I_NCES, I_KEY_THREADS,
           I_ESIZE };   // I_ESIZE + MAXP

struct Args {
  const int* key;
  int* key_out;
  const int* ces;
  int* keys;            // KEY_ROWS x cap int32 per thread (cap > MAXC_LOCAL)
  const void* in[MAXP];
  void* out[MAXP];
  int esize[MAXP];
  int cap, np, nces;
  long long ncell;
};

template <typename E, typename I>
__device__ __forceinline__ void permute(const void* in, void* out,
                                        const I* idx, int cap,
                                        long long ncell, long long cell) {
  const E* src = (const E*)in;
  E* dst = (E*)out;
  for (int s = 0; s < cap; ++s)
    dst[(long long)s * ncell + cell] = src[(long long)idx[s] * ncell + cell];
}

// Sort one cell's slots; k and idx (the permutation, I wide enough for
// the slot index): cap entries each.
template <typename I>
__device__ __forceinline__ void sort_cell(const Args& a, long long cell, int* k,
                                          I* idx) {
  for (int s = 0; s < a.cap; ++s) {
    k[s] = a.key[(long long)s * a.ncell + cell];
    idx[s] = (I)s;
  }
  for (int e = 0; e < a.nces; ++e) {
    int i = __ldg(a.ces + 2 * e), j = __ldg(a.ces + 2 * e + 1);
    int ki = k[i], kj = k[j];
    if (ki > kj) {
      k[i] = kj;
      k[j] = ki;
      I t = idx[i];
      idx[i] = idx[j];
      idx[j] = t;
    }
  }
  for (int s = 0; s < a.cap; ++s) a.key_out[(long long)s * a.ncell + cell] = k[s];
  for (int q = 0; q < a.np; ++q) {
    switch (a.esize[q]) {
      case 1: permute<unsigned char>(a.in[q], a.out[q], idx, a.cap, a.ncell, cell); break;
      case 2: permute<unsigned short>(a.in[q], a.out[q], idx, a.cap, a.ncell, cell); break;
      case 4: permute<unsigned int>(a.in[q], a.out[q], idx, a.cap, a.ncell, cell); break;
      default: permute<unsigned long long>(a.in[q], a.out[q], idx, a.cap, a.ncell, cell); break;
    }
  }
}

template <int MAXC>
__global__ void __launch_bounds__(128) sort_cells(Args a) {
  long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (MAXC > 0) {
    if (cell >= a.ncell) return;
    int k[MAXC];
    unsigned char idx[MAXC];
    sort_cell(a, cell, k, idx);
  } else {
    int* k = a.keys + cell * lp2d::KEY_ROWS * a.cap;
    unsigned short* idx = reinterpret_cast<unsigned short*>(k + a.cap);
    for (; cell < a.ncell; cell += (long long)gridDim.x * blockDim.x)
      sort_cell(a, cell, k, idx);
  }
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int followed by MAXP element sizes; reals
// unused.
LP_EXPORT int lp_sort_cells(void** p, const long long* n, const double* r,
                            void* stream) {
  (void)r;
  cudaStream_t st = (cudaStream_t)stream;
  Args a;
  a.key = (const int*)p[P_KEY];
  a.key_out = (int*)p[P_KEY_OUT];
  a.ces = (const int*)p[P_CES];
  a.cap = (int)n[I_CAP];
  a.ncell = n[I_NCELL];
  a.np = (int)n[I_NP];
  a.nces = (int)n[I_NCES];
  a.keys = (int*)p[P_KEYS];
  if (a.np < 0 || a.np > MAXP || a.cap > lp2d::MAX_SLOTS ||
      (a.cap > lp2d::MAXC_LOCAL && !a.keys))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < MAXP; ++q) {
    a.in[q] = p[P_IN + q];
    a.out[q] = p[P_OUT + q];
    a.esize[q] = (int)n[I_ESIZE + q];
    if (q < a.np && a.esize[q] != 1 && a.esize[q] != 2 && a.esize[q] != 4 &&
        a.esize[q] != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (a.ncell == 0 || a.cap == 0) return 0;
  int threads = 128;
  int blocks = lp2d::cell_blocks(a.ncell, a.cap, n[I_KEY_THREADS], threads);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  if (a.cap <= 8) sort_cells<8><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 16) sort_cells<16><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 32) sort_cells<32><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= 64) sort_cells<64><<<blocks, threads, 0, st>>>(a);
  else if (a.cap <= lp2d::MAXC_LOCAL)
    sort_cells<lp2d::MAXC_LOCAL><<<blocks, threads, 0, st>>>(a);
  else sort_cells<0><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

LP_EXPORT int lp_sort_max_payloads() { return MAXP; }

// the sort scratch's limits (cell2d.cuh::key_limit)
LP_EXPORT int lp_key_limits(int which) { return lp2d::key_limit(which); }
