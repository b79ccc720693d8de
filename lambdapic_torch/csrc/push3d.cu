// Kernel B4 in 3D: gather, Boris and half push of a freshly re-binned 3D
// cell species, with the six gathered components on request (want_eb).
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// fused_push_cell_3d (:523, kernel :546, pallas_call :630). Plain PyTorch
// version: lambdapic_torch/ops/cellpallas.py::fused_push_cell_3d_plain,
// i.e. [a first half push at inv_gamma = 1/sqrt(1 + u^2)] ->
// gather_cell_3d -> boris_push -> push_position_3d.
//
// One thread per slot (cap * nx * ny * nz), 64-bit offsets. The gather is
// cell3d.cuh's and Boris cell2d.cuh's, the code kernel B2 in 3D runs. A
// dead slot is pushed like any other, as in the plain version (see
// push2d.cu): away from the low faces it gathers zeros and keeps u = 0
// and inv_gamma = 1; nothing reads what it gets nearer them.
//
// Bound on an H100 (3.35 TB/s): bytes: six reals read and seven (thirteen
// with want_eb) written a slot, plus the E/B nodes the gather reaches.
// The stencil reads 4 x 4 x 3 nodes a component from the padded fields,
// which stay in L1 and L2 for the slots of neighbouring cells; each slot
// is read and written once, coalesced along z.
#include "cell3d.cuh"

namespace {

using lp2d::pushed;

enum Ptr { P_EB, P_X, P_Y, P_Z, P_UX, P_UY, P_UZ,
           P_OX, P_OY, P_OZ, P_OUX, P_OUY, P_OUZ, P_OIG, P_OEB,
           P_COUNT = P_OEB + 6 };
enum Int { I_CAP, I_NX, I_NY, I_NZ, I_G, I_WANT_EB, I_DO_POS1, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_HX, R_HY, R_HZ,   // c dt / d / 2 per axis
            R_EF, R_BF };       // q dt / (2 m c), q dt / (2 m)

template <typename T>
struct Args {
  const T* eb;
  const T *x, *y, *z, *ux, *uy, *uz;
  T *ox, *oy, *oz, *oux, *ouy, *ouz, *oig;
  T* oeb[6];
  int cap, nx, ny, nz, g, want_eb, do_pos1;
  long long ncell, total;
  T h[3], ef, bf;
};

template <typename T>
__global__ void __launch_bounds__(256) push3d(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.total) return;
  long long cell = idx % a.ncell;
  const long long plane = (long long)a.ny * a.nz;
  int ix = (int)(cell / plane);
  int rem = (int)(cell - (long long)ix * plane);
  int iy = rem / a.nz, iz = rem - iy * a.nz;
  T x = a.x[idx], y = a.y[idx], z = a.z[idx];
  T ux = a.ux[idx], uy = a.uy[idx], uz = a.uz[idx];
  if (a.do_pos1) {
    T ig0 = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
    x = pushed(x, ux, ig0, a.h[0]);
    y = pushed(y, uy, ig0, a.h[1]);
    z = pushed(z, uz, ig0, a.h[2]);
  }
  const T d[3] = {x - T(ix), y - T(iy), z - T(iz)};
  T e[6];
  lp3d::gather_eb(a.eb, a.nx, a.ny, a.nz, a.g, ix, iy, iz, d, e);
  T ig = lp2d::boris(ux, uy, uz, e, a.ef, a.bf);
  a.ox[idx] = pushed(x, ux, ig, a.h[0]);
  a.oy[idx] = pushed(y, uy, ig, a.h[1]);
  a.oz[idx] = pushed(z, uz, ig, a.h[2]);
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
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y]; a.z = (const T*)p[P_Z];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY]; a.uz = (const T*)p[P_UZ];
  a.ox = (T*)p[P_OX]; a.oy = (T*)p[P_OY]; a.oz = (T*)p[P_OZ];
  a.oux = (T*)p[P_OUX]; a.ouy = (T*)p[P_OUY]; a.ouz = (T*)p[P_OUZ];
  a.oig = (T*)p[P_OIG];
  for (int c = 0; c < 6; ++c) a.oeb[c] = (T*)p[P_OEB + c];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.nz = (int)n[I_NZ]; a.g = (int)n[I_G]; a.want_eb = (int)n[I_WANT_EB];
  a.do_pos1 = (int)n[I_DO_POS1];
  a.ncell = (long long)a.nx * a.ny * a.nz;
  a.total = a.ncell * a.cap;
  a.h[0] = (T)r[R_HX]; a.h[1] = (T)r[R_HY]; a.h[2] = (T)r[R_HZ];
  a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  if (a.total == 0) return 0;
  if (a.want_eb)
    for (int c = 0; c < 6; ++c)
      if (!a.oeb[c]) return (int)cudaErrorInvalidValue;
  int threads = 256;
  push3d<T><<<ceil_div(a.total, threads), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_push_3d(void** ptrs, const long long* ints,
                         const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
