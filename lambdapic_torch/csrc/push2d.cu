// Kernel B4: gather, Boris and half push of a freshly re-binned 2D cell
// species, with the six gathered components on request (want_eb).
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// fused_push_cell_2d (:308, kernel :333, pallas_call :411). Plain PyTorch
// version: lambdapic_torch/ops/cellpallas.py::fused_push_cell_2d_plain,
// i.e. [a first half push at inv_gamma = 1/sqrt(1 + u^2)] ->
// gather_cell_2d -> boris_push -> push_position_2d.
//
// One thread per slot (cap * nx * ny). The gather and Boris are cell2d.cuh's,
// the code kernel B2's pass_y runs. A dead slot (x = y = u = 0 after the
// re-binning) is pushed like any other, as in the plain version and in
// the TPU kernel's occupied blocks: beyond the first two cells of each
// axis it gathers zeros, keeps u = 0 and leaves inv_gamma = 1 (what the
// TPU kernel's empty-block branch writes, cellpallas.py:394-400); nearer
// the low faces x = y = 0 lies within the stencil and it gathers, which
// nothing reads (its w is 0 for the deposit and the next re-binning
// zeroes it).
//
// Bound on an H100 (3.35 TB/s): bytes: five reals read and six (twelve
// with want_eb) written a slot, plus the E/B nodes the gather reaches.
#include "cell2d.cuh"

namespace {

using namespace lp2d;

enum Ptr { P_EB, P_X, P_Y, P_UX, P_UY, P_UZ,
           P_OX, P_OY, P_OUX, P_OUY, P_OUZ, P_OIG, P_OEB, P_COUNT = P_OEB + 6 };
enum Int { I_CAP, I_NX, I_NY, I_G, I_WANT_EB, I_DO_POS1, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_HX, R_HY,       // c dt / dx / 2, c dt / dy / 2
            R_EF, R_BF };     // q dt / (2 m c), q dt / (2 m)

template <typename T>
struct Args {
  const T* eb;
  const T *x, *y, *ux, *uy, *uz;
  T *ox, *oy, *oux, *ouy, *ouz, *oig;
  T* oeb[6];
  int cap, nx, ny, g, want_eb, do_pos1;
  long long ncell, total;
  T hx, hy, ef, bf;
};

template <typename T>
__global__ void __launch_bounds__(256) push(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.total) return;
  long long cell = idx % a.ncell;
  int ix = (int)(cell / a.ny), iy = (int)(cell % a.ny);
  T x = a.x[idx], y = a.y[idx];
  T ux = a.ux[idx], uy = a.uy[idx], uz = a.uz[idx];
  if (a.do_pos1) {
    T ig0 = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
    x = pushed(x, ux, ig0, a.hx);
    y = pushed(y, uy, ig0, a.hy);
  }
  T e[6];
  gather_eb(a.eb, a.nx, a.ny, a.g, ix, iy, x - T(ix), y - T(iy), e);
  T ig = boris(ux, uy, uz, e, a.ef, a.bf);
  a.ox[idx] = pushed(x, ux, ig, a.hx);
  a.oy[idx] = pushed(y, uy, ig, a.hy);
  a.oux[idx] = ux;
  a.ouy[idx] = uy;
  a.ouz[idx] = uz;
  a.oig[idx] = ig;
  if (a.want_eb) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a.oeb[c][idx] = e[c];
  }
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.eb = (const T*)p[P_EB];
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY]; a.uz = (const T*)p[P_UZ];
  a.ox = (T*)p[P_OX]; a.oy = (T*)p[P_OY];
  a.oux = (T*)p[P_OUX]; a.ouy = (T*)p[P_OUY]; a.ouz = (T*)p[P_OUZ];
  a.oig = (T*)p[P_OIG];
  for (int c = 0; c < 6; ++c) a.oeb[c] = (T*)p[P_OEB + c];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.g = (int)n[I_G]; a.want_eb = (int)n[I_WANT_EB];
  a.do_pos1 = (int)n[I_DO_POS1];
  a.ncell = (long long)a.nx * a.ny;
  a.total = a.ncell * a.cap;
  a.hx = (T)r[R_HX]; a.hy = (T)r[R_HY]; a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  if (a.total == 0) return 0;
  if (a.want_eb)
    for (int c = 0; c < 6; ++c)
      if (!a.oeb[c]) return (int)cudaErrorInvalidValue;
  int threads = 256;
  push<T><<<ceil_div(a.total, threads), threads, 0, st>>>(a);
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
