// Kernel B1: one E or B half-step of the 2D Yee solver with CPML.
//
// Replaces the TPU kernel lambdapic_tpu/ops/fieldspallas.py::_update_half
// (kernel body :264, pallas_call :464). Plain PyTorch version:
// lambdapic_torch/ops/maxwell.py::update_efield / update_bfield.
//
// One thread per cell (i, j). It reads its own cell and the -1 (E) or +1
// (B) neighbours along x and y, with the periodic-wrap or zero rule of
// ops/shifts.py, updates the interior with the 1/kappa-scaled curl, and on
// PML slab rows advances psi and adds the correction (x axis first, then
// y, as ops/maxwell.py does). Psi arrays are slab-restricted: row maps rx
// (nx) / ry (ny) give each grid row's psi row or -1.
//
// Bound on an H100 (3.35 TB/s): bytes. An E half-step at 1024^2 in
// float32 reads nine fields and writes three, 48 MiB, about 15 us; a B
// half-step reads six and writes three. The design keeps every field to
// one read per thread: neighbour reads hit the lines that the adjacent
// threads load, so device memory sees each array about once.
#include "common.cuh"

namespace {

enum Ptr {
  P_EX, P_EY, P_EZ, P_BX, P_BY, P_BZ, P_JX, P_JY, P_JZ,
  P_OUT0, P_OUT1, P_OUT2,
  P_PSIX_A, P_PSIX_B, P_PSIX_A_OUT, P_PSIX_B_OUT,
  P_PSIY_A, P_PSIY_B, P_PSIY_A_OUT, P_PSIY_B_OUT,
  P_IKX, P_IKY, P_BXC, P_CXC, P_BYC, P_CYC, P_RX, P_RY, P_COUNT
};
enum Int { I_NX, I_NY, I_PERX, I_PERY, I_WHICH, I_WX, I_WY, I_DOUBLE };
enum Real { R_FAC, R_JF, R_DX, R_DY };

template <typename T>
struct Args {
  const T *ex, *ey, *ez, *bx, *by, *bz, *jx, *jy, *jz;
  T *o0, *o1, *o2;
  const T *pxa, *pxb;
  T *pxa_o, *pxb_o;
  const T *pya, *pyb;
  T *pya_o, *pyb_o;
  const T *ikx, *iky, *bxc, *cxc, *byc, *cyc;
  const int *rx, *ry;
  int nx, ny, perx, pery, wx, wy;
  T fac, jf, dx, dy;
};

template <typename T>
__global__ void e_half(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.nx * a.ny) return;
  int i = (int)(idx / a.ny), j = (int)(idx % a.ny);
  const T zero = T(0);
  T bz_c = a.bz[idx], by_c = a.by[idx], bx_c = a.bx[idx];
  T bz_xm, by_xm, bz_ym, bx_ym;
  if (i > 0) {
    bz_xm = a.bz[idx - a.ny];
    by_xm = a.by[idx - a.ny];
  } else if (a.perx) {
    bz_xm = a.bz[(long long)(a.nx - 1) * a.ny + j];
    by_xm = a.by[(long long)(a.nx - 1) * a.ny + j];
  } else {
    bz_xm = zero;
    by_xm = zero;
  }
  if (j > 0) {
    bz_ym = a.bz[idx - 1];
    bx_ym = a.bx[idx - 1];
  } else if (a.pery) {
    bz_ym = a.bz[idx + a.ny - 1];
    bx_ym = a.bx[idx + a.ny - 1];
  } else {
    bz_ym = zero;
    bx_ym = zero;
  }
  T dbz_y = (bz_c - bz_ym) / a.dy;
  T dbz_x = (bz_c - bz_xm) / a.dx;
  T dby_x = (by_c - by_xm) / a.dx;
  T dbx_y = (bx_c - bx_ym) / a.dy;
  T ikx = a.ikx[i], iky = a.iky[j];
  T bf = a.fac;
  T nex = (a.ex[idx] + (bf * iky) * dbz_y) - a.jf * a.jx[idx];
  T ney = (a.ey[idx] - (bf * ikx) * dbz_x) - a.jf * a.jy[idx];
  T nez = (a.ez[idx] + bf * (ikx * dby_x - iky * dbx_y)) - a.jf * a.jz[idx];
  int r = a.rx[i];
  if (r >= 0) {
    long long k = (long long)r * a.ny + j;
    T b = a.bxc[i], c = a.cxc[i];
    T p = b * a.pxa[k] + c * (bz_c - bz_xm);   // psi_ey_x
    a.pxa_o[k] = p;
    ney = ney + (-bf) * p;
    T q = b * a.pxb[k] + c * (by_c - by_xm);   // psi_ez_x
    a.pxb_o[k] = q;
    nez = nez + bf * q;
  }
  int s = a.ry[j];
  if (s >= 0) {
    long long k = (long long)i * a.wy + s;
    T b = a.byc[j], c = a.cyc[j];
    T p = b * a.pya[k] + c * (bz_c - bz_ym);   // psi_ex_y
    a.pya_o[k] = p;
    nex = nex + bf * p;
    T q = b * a.pyb[k] + c * (bx_c - bx_ym);   // psi_ez_y
    a.pyb_o[k] = q;
    nez = nez + (-bf) * q;
  }
  a.o0[idx] = nex;
  a.o1[idx] = ney;
  a.o2[idx] = nez;
}

template <typename T>
__global__ void b_half(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.nx * a.ny) return;
  int i = (int)(idx / a.ny), j = (int)(idx % a.ny);
  const T zero = T(0);
  T ez_c = a.ez[idx], ey_c = a.ey[idx], ex_c = a.ex[idx];
  T ez_xp, ey_xp, ez_yp, ex_yp;
  if (i < a.nx - 1) {
    ez_xp = a.ez[idx + a.ny];
    ey_xp = a.ey[idx + a.ny];
  } else if (a.perx) {
    ez_xp = a.ez[j];
    ey_xp = a.ey[j];
  } else {
    ez_xp = zero;
    ey_xp = zero;
  }
  if (j < a.ny - 1) {
    ez_yp = a.ez[idx + 1];
    ex_yp = a.ex[idx + 1];
  } else if (a.pery) {
    ez_yp = a.ez[idx - (a.ny - 1)];
    ex_yp = a.ex[idx - (a.ny - 1)];
  } else {
    ez_yp = zero;
    ex_yp = zero;
  }
  T dez_y = (ez_yp - ez_c) / a.dy;
  T dez_x = (ez_xp - ez_c) / a.dx;
  T dey_x = (ey_xp - ey_c) / a.dx;
  T dex_y = (ex_yp - ex_c) / a.dy;
  T ikx = a.ikx[i], iky = a.iky[j];
  T dtc = a.fac;
  T nbx = a.bx[idx] - (dtc * iky) * dez_y;
  T nby = a.by[idx] + (dtc * ikx) * dez_x;
  T nbz = a.bz[idx] - ((dtc * ikx) * dey_x - (dtc * iky) * dex_y);
  int r = a.rx[i];
  if (r >= 0) {
    long long k = (long long)r * a.ny + j;
    T b = a.bxc[i], c = a.cxc[i];
    T p = b * a.pxa[k] + c * (ez_xp - ez_c);   // psi_by_x
    a.pxa_o[k] = p;
    nby = nby + dtc * p;
    T q = b * a.pxb[k] + c * (ey_xp - ey_c);   // psi_bz_x
    a.pxb_o[k] = q;
    nbz = nbz + (-dtc) * q;
  }
  int s = a.ry[j];
  if (s >= 0) {
    long long k = (long long)i * a.wy + s;
    T b = a.byc[j], c = a.cyc[j];
    T p = b * a.pya[k] + c * (ez_yp - ez_c);   // psi_bx_y
    a.pya_o[k] = p;
    nbx = nbx + (-dtc) * p;
    T q = b * a.pyb[k] + c * (ex_yp - ex_c);   // psi_bz_y
    a.pyb_o[k] = q;
    nbz = nbz + dtc * q;
  }
  a.o0[idx] = nbx;
  a.o1[idx] = nby;
  a.o2[idx] = nbz;
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.ex = (const T*)p[P_EX]; a.ey = (const T*)p[P_EY]; a.ez = (const T*)p[P_EZ];
  a.bx = (const T*)p[P_BX]; a.by = (const T*)p[P_BY]; a.bz = (const T*)p[P_BZ];
  a.jx = (const T*)p[P_JX]; a.jy = (const T*)p[P_JY]; a.jz = (const T*)p[P_JZ];
  a.o0 = (T*)p[P_OUT0]; a.o1 = (T*)p[P_OUT1]; a.o2 = (T*)p[P_OUT2];
  a.pxa = (const T*)p[P_PSIX_A]; a.pxb = (const T*)p[P_PSIX_B];
  a.pxa_o = (T*)p[P_PSIX_A_OUT]; a.pxb_o = (T*)p[P_PSIX_B_OUT];
  a.pya = (const T*)p[P_PSIY_A]; a.pyb = (const T*)p[P_PSIY_B];
  a.pya_o = (T*)p[P_PSIY_A_OUT]; a.pyb_o = (T*)p[P_PSIY_B_OUT];
  a.ikx = (const T*)p[P_IKX]; a.iky = (const T*)p[P_IKY];
  a.bxc = (const T*)p[P_BXC]; a.cxc = (const T*)p[P_CXC];
  a.byc = (const T*)p[P_BYC]; a.cyc = (const T*)p[P_CYC];
  a.rx = (const int*)p[P_RX]; a.ry = (const int*)p[P_RY];
  a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.perx = (int)n[I_PERX]; a.pery = (int)n[I_PERY];
  a.wx = (int)n[I_WX]; a.wy = (int)n[I_WY];
  a.fac = (T)r[R_FAC]; a.jf = (T)r[R_JF]; a.dx = (T)r[R_DX]; a.dy = (T)r[R_DY];
  long long cells = (long long)a.nx * a.ny;
  int threads = 256;
  int blocks = ceil_div(cells, threads);
  if (n[I_WHICH] == 0)
    e_half<T><<<blocks, threads, 0, st>>>(a);
  else
    b_half<T><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_fields_half(void** ptrs, const long long* ints,
                             const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
