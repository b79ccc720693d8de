// Kernel B1 in 3D: one E or B half-step of the 3D Yee solver with CPML.
//
// Replaces the 3D branch of the TPU kernel lambdapic_tpu/ops/
// fieldspallas.py::_update_half (kernel body :264, 3D at :207 and :321-348,
// pallas_call :464). Plain PyTorch version: lambdapic_torch/ops/
// maxwell.py::update_efield / update_bfield on a 3D grid.
//
// One thread per cell (i, j, k), k fastest. It reads its own cell and the
// -1 (E) or +1 (B) neighbours along x, y and z, with the periodic-wrap or
// zero rule of ops/shifts.py, updates the interior with the 1/kappa-scaled
// curl, and on PML slab rows advances psi and adds the correction, x axis
// first, then y, then z, as ops/maxwell.py does; a cell on an edge or in a
// corner of the box lies in two or three slabs and takes each axis's
// correction in that order. Psi arrays are slab-restricted along their own
// axis: (wx, ny, nz), (nx, wy, nz), (nx, ny, wz); row maps rx / ry / rz
// give each grid row's psi row or -1.
//
// Bound on an H100 (3.35 TB/s): bytes. An E half-step reads nine fields
// and writes three, a B half-step reads six and writes three, plus each
// half-step's own six psi slabs read and written. The design keeps every
// field to one read per thread: neighbour reads hit the lines that
// adjacent threads (z), or the threads one row (y) or one plane (x) away,
// load, so device memory sees each array about once. All offsets are 64-bit.
#include "common.cuh"

namespace {

enum Ptr {
  P_EX, P_EY, P_EZ, P_BX, P_BY, P_BZ, P_JX, P_JY, P_JZ,
  P_OUT0, P_OUT1, P_OUT2,
  P_PSIX_A, P_PSIX_B, P_PSIX_A_OUT, P_PSIX_B_OUT,
  P_PSIY_A, P_PSIY_B, P_PSIY_A_OUT, P_PSIY_B_OUT,
  P_PSIZ_A, P_PSIZ_B, P_PSIZ_A_OUT, P_PSIZ_B_OUT,
  P_IKX, P_IKY, P_IKZ, P_BXC, P_CXC, P_BYC, P_CYC, P_BZC, P_CZC,
  P_RX, P_RY, P_RZ, P_COUNT
};
enum Int {
  I_NX, I_NY, I_NZ, I_PERX, I_PERY, I_PERZ, I_WHICH, I_WX, I_WY, I_WZ,
  I_DOUBLE
};
enum Real { R_FAC, R_JF, R_DX, R_DY, R_DZ };

template <typename T>
struct Args {
  const T *ex, *ey, *ez, *bx, *by, *bz, *jx, *jy, *jz;
  T *o0, *o1, *o2;
  const T *pxa, *pxb;
  T *pxa_o, *pxb_o;
  const T *pya, *pyb;
  T *pya_o, *pyb_o;
  const T *pza, *pzb;
  T *pza_o, *pzb_o;
  const T *ikx, *iky, *ikz, *bxc, *cxc, *byc, *cyc, *bzc, *czc;
  const int *rx, *ry, *rz;
  int nx, ny, nz, perx, pery, perz, wx, wy, wz;
  T fac, jf, dx, dy, dz;
};

// Neighbour of cell (i along one axis of extent n, linear index idx, axis
// stride s) one step down (E half-step) or up (B half-step): the wrapped
// cell when periodic, zero at an open face.
template <typename T>
__device__ __forceinline__ T below(const T* f, long long idx, int i, int n,
                                   long long s, int per) {
  if (i > 0) return f[idx - s];
  return per ? f[idx + (long long)(n - 1) * s] : T(0);
}

template <typename T>
__device__ __forceinline__ T above(const T* f, long long idx, int i, int n,
                                   long long s, int per) {
  if (i < n - 1) return f[idx + s];
  return per ? f[idx - (long long)(n - 1) * s] : T(0);
}

template <typename T>
__global__ void e_half3(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sx = (long long)a.ny * a.nz, sy = a.nz;
  if (idx >= (long long)a.nx * sx) return;
  int i = (int)(idx / sx);
  int rem = (int)(idx - (long long)i * sx);
  int j = rem / a.nz, k = rem - j * a.nz;
  T bx_c = a.bx[idx], by_c = a.by[idx], bz_c = a.bz[idx];
  T bz_xm = below(a.bz, idx, i, a.nx, sx, a.perx);
  T by_xm = below(a.by, idx, i, a.nx, sx, a.perx);
  T bz_ym = below(a.bz, idx, j, a.ny, sy, a.pery);
  T bx_ym = below(a.bx, idx, j, a.ny, sy, a.pery);
  T by_zm = below(a.by, idx, k, a.nz, 1, a.perz);
  T bx_zm = below(a.bx, idx, k, a.nz, 1, a.perz);
  T dbz_y = (bz_c - bz_ym) / a.dy;
  T dbz_x = (bz_c - bz_xm) / a.dx;
  T dby_x = (by_c - by_xm) / a.dx;
  T dbx_y = (bx_c - bx_ym) / a.dy;
  T dby_z = (by_c - by_zm) / a.dz;
  T dbx_z = (bx_c - bx_zm) / a.dz;
  T ikx = a.ikx[i], iky = a.iky[j], ikz = a.ikz[k];
  T bf = a.fac;
  T nex = (a.ex[idx] + bf * (iky * dbz_y - ikz * dby_z)) - a.jf * a.jx[idx];
  T ney = (a.ey[idx] + bf * (ikz * dbx_z - ikx * dbz_x)) - a.jf * a.jy[idx];
  T nez = (a.ez[idx] + bf * (ikx * dby_x - iky * dbx_y)) - a.jf * a.jz[idx];
  int r = a.rx[i];
  if (r >= 0) {
    long long p = (long long)r * sx + rem;
    T b = a.bxc[i], c = a.cxc[i];
    T u = b * a.pxa[p] + c * (bz_c - bz_xm);   // psi_ey_x
    a.pxa_o[p] = u;
    ney = ney + (-bf) * u;
    T v = b * a.pxb[p] + c * (by_c - by_xm);   // psi_ez_x
    a.pxb_o[p] = v;
    nez = nez + bf * v;
  }
  r = a.ry[j];
  if (r >= 0) {
    long long p = ((long long)i * a.wy + r) * a.nz + k;
    T b = a.byc[j], c = a.cyc[j];
    T u = b * a.pya[p] + c * (bz_c - bz_ym);   // psi_ex_y
    a.pya_o[p] = u;
    nex = nex + bf * u;
    T v = b * a.pyb[p] + c * (bx_c - bx_ym);   // psi_ez_y
    a.pyb_o[p] = v;
    nez = nez + (-bf) * v;
  }
  r = a.rz[k];
  if (r >= 0) {
    long long p = ((long long)i * a.ny + j) * a.wz + r;
    T b = a.bzc[k], c = a.czc[k];
    T u = b * a.pza[p] + c * (by_c - by_zm);   // psi_ex_z
    a.pza_o[p] = u;
    nex = nex + (-bf) * u;
    T v = b * a.pzb[p] + c * (bx_c - bx_zm);   // psi_ey_z
    a.pzb_o[p] = v;
    ney = ney + bf * v;
  }
  a.o0[idx] = nex;
  a.o1[idx] = ney;
  a.o2[idx] = nez;
}

template <typename T>
__global__ void b_half3(Args<T> a) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sx = (long long)a.ny * a.nz, sy = a.nz;
  if (idx >= (long long)a.nx * sx) return;
  int i = (int)(idx / sx);
  int rem = (int)(idx - (long long)i * sx);
  int j = rem / a.nz, k = rem - j * a.nz;
  T ex_c = a.ex[idx], ey_c = a.ey[idx], ez_c = a.ez[idx];
  T ez_xp = above(a.ez, idx, i, a.nx, sx, a.perx);
  T ey_xp = above(a.ey, idx, i, a.nx, sx, a.perx);
  T ez_yp = above(a.ez, idx, j, a.ny, sy, a.pery);
  T ex_yp = above(a.ex, idx, j, a.ny, sy, a.pery);
  T ey_zp = above(a.ey, idx, k, a.nz, 1, a.perz);
  T ex_zp = above(a.ex, idx, k, a.nz, 1, a.perz);
  T dez_y = (ez_yp - ez_c) / a.dy;
  T dez_x = (ez_xp - ez_c) / a.dx;
  T dey_x = (ey_xp - ey_c) / a.dx;
  T dex_y = (ex_yp - ex_c) / a.dy;
  T dey_z = (ey_zp - ey_c) / a.dz;
  T dex_z = (ex_zp - ex_c) / a.dz;
  T ikx = a.ikx[i], iky = a.iky[j], ikz = a.ikz[k];
  T dtc = a.fac;
  T nbx = a.bx[idx] - ((dtc * iky) * dez_y - (dtc * ikz) * dey_z);
  T nby = a.by[idx] - ((dtc * ikz) * dex_z - (dtc * ikx) * dez_x);
  T nbz = a.bz[idx] - ((dtc * ikx) * dey_x - (dtc * iky) * dex_y);
  int r = a.rx[i];
  if (r >= 0) {
    long long p = (long long)r * sx + rem;
    T b = a.bxc[i], c = a.cxc[i];
    T u = b * a.pxa[p] + c * (ez_xp - ez_c);   // psi_by_x
    a.pxa_o[p] = u;
    nby = nby + dtc * u;
    T v = b * a.pxb[p] + c * (ey_xp - ey_c);   // psi_bz_x
    a.pxb_o[p] = v;
    nbz = nbz + (-dtc) * v;
  }
  r = a.ry[j];
  if (r >= 0) {
    long long p = ((long long)i * a.wy + r) * a.nz + k;
    T b = a.byc[j], c = a.cyc[j];
    T u = b * a.pya[p] + c * (ez_yp - ez_c);   // psi_bx_y
    a.pya_o[p] = u;
    nbx = nbx + (-dtc) * u;
    T v = b * a.pyb[p] + c * (ex_yp - ex_c);   // psi_bz_y
    a.pyb_o[p] = v;
    nbz = nbz + dtc * v;
  }
  r = a.rz[k];
  if (r >= 0) {
    long long p = ((long long)i * a.ny + j) * a.wz + r;
    T b = a.bzc[k], c = a.czc[k];
    T u = b * a.pza[p] + c * (ey_zp - ey_c);   // psi_bx_z
    a.pza_o[p] = u;
    nbx = nbx + dtc * u;
    T v = b * a.pzb[p] + c * (ex_zp - ex_c);   // psi_by_z
    a.pzb_o[p] = v;
    nby = nby + (-dtc) * v;
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
  a.pza = (const T*)p[P_PSIZ_A]; a.pzb = (const T*)p[P_PSIZ_B];
  a.pza_o = (T*)p[P_PSIZ_A_OUT]; a.pzb_o = (T*)p[P_PSIZ_B_OUT];
  a.ikx = (const T*)p[P_IKX]; a.iky = (const T*)p[P_IKY];
  a.ikz = (const T*)p[P_IKZ];
  a.bxc = (const T*)p[P_BXC]; a.cxc = (const T*)p[P_CXC];
  a.byc = (const T*)p[P_BYC]; a.cyc = (const T*)p[P_CYC];
  a.bzc = (const T*)p[P_BZC]; a.czc = (const T*)p[P_CZC];
  a.rx = (const int*)p[P_RX]; a.ry = (const int*)p[P_RY];
  a.rz = (const int*)p[P_RZ];
  a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY]; a.nz = (int)n[I_NZ];
  a.perx = (int)n[I_PERX]; a.pery = (int)n[I_PERY]; a.perz = (int)n[I_PERZ];
  a.wx = (int)n[I_WX]; a.wy = (int)n[I_WY]; a.wz = (int)n[I_WZ];
  a.fac = (T)r[R_FAC]; a.jf = (T)r[R_JF];
  a.dx = (T)r[R_DX]; a.dy = (T)r[R_DY]; a.dz = (T)r[R_DZ];
  long long cells = (long long)a.nx * a.ny * a.nz;
  int threads = 256;
  int blocks = ceil_div(cells, threads);
  if (n[I_WHICH] == 0)
    e_half3<T><<<blocks, threads, 0, st>>>(a);
  else
    b_half3<T><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_fields_half_3d(void** ptrs, const long long* ints,
                                const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
