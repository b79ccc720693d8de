// Kernel B5 in 3D: the 5-tap (125-node) Esirkepov deposit of one
// re-binned 3D cell species into the padded current (4, nx+2g, ny+2g,
// nz+2g): jx, jy, jz and rho.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// deposit_cell_3d_pallas (:635, kernel :653, pallas_call :736) and its
// XLA fold _fold_xy (:291). Plain PyTorch version: lambdapic_torch/ops/
// cell3d.py::deposit_cell_3d (same contract: home-cell binned slots, dead
// slots carry w = 0). The kernel also takes the alive mask (P_ALIVE,
// uint8, required) and reads no dead slot's payload.
//
// Two __global__ functions:
//  deposit3d  one warp per column of 4 x 8 (y, z) cells over a segment of
//             up to SEG (32) cells along x, one lane a (y, z) cell; two
//             warps a block, each on its own column, with no block
//             barrier. The warp walks the node planes X of its segment
//             (xs - 2 .. xe + 1) one after another. Plane X takes the
//             x offset o = X + 2 - ix of each cell ix of the window
//             X - 2 .. X + 2, so each lane sums the contributions of its
//             five window cells' alive slots (cell by cell, slot order) to
//             its 5 x 5 (y, z) offsets of that plane in registers (100
//             sums in float32; float64 goes one y offset at a time), then
//             the warp adds them into a shared 8 x 12 plane panel, one
//             offset after another with __syncwarp between (within one
//             offset every lane writes a different node, so the sum needs
//             no atomics and repeats bit for bit), writes the plane to the
//             column's panel in device memory and clears it. A lane walks
//             its window's slots as one list, so a warp runs as long as
//             its busiest lane's window, not the sum of each cell's
//             busiest lane. Each lane reads its cells' alive bytes once,
//             a plane ahead of their use, and keeps them as bits (up to
//             64 slots a cell; above, it reads them again a plane). A
//             plane whose window holds no alive slot in the whole warp is
//             written as zeros. Contribution terms are the plain
//             version's closed forms (ops/cell3d.py::
//             deposit_offsets_3d), the spline weights in the three-weight
//             form (shape5), the prefactors folded and the sums taken with
//             fused multiply-adds.
//  fold_pad3  one thread per padded node: the sum of the (at most two per
//             axis) column panel nodes that land on it, in a fixed order,
//             so J repeats bit for bit. Panel (s, bj, bk) plane q node
//             (r, t) is the current at interior index (s*SEG + q - 2,
//             bj*4 + r - 2, bk*8 + t - 2), its four components side by
//             side.
// The sums run in another order than the plain version's offset-by-offset
// slice adds, and with fused multiply-adds, so the two agree to rounding,
// not bitwise.
//
// Bound on an H100 (67 TFLOP/s float32; 3.35 TB/s): operations: about
// 2300 an alive particle (30 spline weights, 125 nodes of four channels),
// above its bytes (the mask, seven reals of each alive slot, J written
// once). What sets the design's time: the instructions a lane issues.
// Each particle is visited in the five planes its stencil reaches, its
// shapes recomputed at each visit (registers hold one plane's sums, and
// the shapes of a window's particles do not fit in shared memory beside
// twelve warps an SM); each plane's 25 shared read-modify-writes of four
// channels a lane, in order; and lanes idle while the busiest lane's
// window runs. The registers are capped at 168 a thread (six blocks, 12
// warps an SM), which measured faster than 223 with fewer warps. What
// the design does about the old kernel's costs: no block barrier a
// particle (the old one took 125 a round of a 512-cell tile's fullest
// cell), no shared float atomics (sm_90 runs those as compare-and-swap
// loops), the alive bytes read once (the old one scanned w of every
// slot), and panels along x segments (3.38 nodes a cell, 1.81 GB in
// float32 on 512 x 256 x 256 cells, as the 8^3 tiles' panels were),
// which fold_pad3 reads once more.
#include "common.cuh"

namespace {

enum Ptr { P_X, P_Y, P_Z, P_UX, P_UY, P_UZ, P_IG, P_W, P_PANELS, P_JPAD,
           P_ALIVE, P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_NZ, I_G, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY, R_CDZ,    // c dt / d per axis
            R_KCD,                  // q / (dx dy dz)
            R_KFX, R_KFY, R_KFZ };  // q / (dy dz dt), q / (dx dz dt),
                                    // q / (dx dy dt)

constexpr int NC = 4;               // jx, jy, jz, rho
constexpr int SEG = 32;             // cells of a column's x segment
constexpr int CY = 4, CZ = 8;       // a column's (y, z) cells, a lane each
constexpr int QY = CY + 4, QZ = CZ + 4;   // plane panel: 8 x 12 nodes
constexpr int QN = QY * QZ;
constexpr int QPLANES = SEG + 4;    // planes of a segment's panel
constexpr int WARPS = 2;            // columns a block
constexpr int MASK_SLOTS = 64;      // alive bits a cell

// y offsets summed at once: all five in float32 (100 sums a lane), one in
// float64 (20 doubles), which would otherwise spill
template <typename T> struct Slab { static constexpr int NOY = 5; };
template <> struct Slab<double> { static constexpr int NOY = 1; };

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct Args {
  const unsigned char* alive;
  const T *x, *y, *z, *ux, *uy, *uz, *ig, *w;
  T* panels;                    // (nseg, nby, nbz, QPLANES, QY, QZ, NC)
  int cap, nx, ny, nz, nseg, nby, nbz;
  long long ncell;
  T cd[3];                      // c dt / d per axis
  T kcd;                        // q / (dx dy dz)
  T kf[3];                      // q / (dy dz dt), q / (dx dz dt), q / (dx dy dt)
};

// The quadratic spline's weights m2(o - d) at the offsets o = -2 .. 2
// (slots 0 .. 4), in closed form: the three nonzero ones sit at i0 - 1,
// i0, i0 + 1 with i0 = rint(d), f = d - i0: 0.5 (0.5 - f)^2, 0.75 - f^2,
// 0.5 (0.5 + f)^2. For |d| < 1.5, i0 is -1, 0 or 1 and two flags place
// the three without a branch: always so for a home-binned particle (|x -
// ix| <= 1/2) that moves less than a cell a step (|v| < 1, which the
// Courant limit keeps), B5's contract.
template <typename T>
__device__ __forceinline__ void shape5(T d, T (&s)[5]) {
  const T i0 = rint(d), f = d - i0;
  const T lo = T(0.5) - f, hi = T(0.5) + f;
  const T wl = T(0.5) * (lo * lo), wc = T(0.75) - f * f,
          wr = T(0.5) * (hi * hi);
  const bool l = i0 < T(0), h = i0 > T(0);
  s[0] = l ? wl : T(0);
  s[1] = l ? wc : (h ? T(0) : wl);
  s[2] = l ? wr : (h ? wl : wc);
  s[3] = l ? T(0) : (h ? wc : wr);
  s[4] = h ? wr : T(0);
}

// The old (d - v/2) and new (d + v/2) shapes of one axis.
template <typename T>
__device__ __forceinline__ void shapes(T d, T v, T (&s0)[5], T (&s1)[5]) {
  shape5(d - T(0.5) * v, s0);
  shape5(d + T(0.5) * v, s1);
}

// The contributions of one particle (slot idx of cell (ix, iy, iz)) to
// the node plane ix + o - 2 (o = 0 .. 4), at y offsets oy0 .. oy0 + NOY -
// 1 and all five z offsets, added into acc[y][z][channel]. The closed
// forms of ops/cell3d.py::deposit_offsets_3d:
// jx = runx nfx (ay S0z + cy DSz), jy = runy nfy (ax S0z + cx DSz),
// jz = runz nfz (ax S0y + cx DSy), rho = cd S1x S1y S1z,
// a = S0 + DS/2, c = S0/2 + DS/3, run the running sum of DS.
template <typename T, int NOY>
__device__ __forceinline__ void add_particle(const Args<T>& a, long long idx,
                                             int ix, int iy, int iz, int o,
                                             int oy0, T (&acc)[NOY][5][NC]) {
  const T third = T(1) / T(3);
  const T ig = a.ig[idx], w = a.w[idx];
  // x at offset o: its running sum of DS, S0, S1
  T runx = T(0), s0o = T(0), s1o = T(0);
  {
    T s0x[5], s1x[5];
    shapes(a.x[idx] - T(ix), (a.ux[idx] * ig) * a.cd[0], s0x, s1x);
    T run = T(0);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      run = run + (s1x[k] - s0x[k]);
      if (k == o) {
        runx = run;
        s0o = s0x[k];
        s1o = s1x[k];
      }
    }
  }
  T s0y[5], s1y[5], s0z[5], s1z[5];
  shapes(a.y[idx] - T(iy), (a.uy[idx] * ig) * a.cd[1], s0y, s1y);
  shapes(a.z[idx] - T(iz), (a.uz[idx] * ig) * a.cd[2], s0z, s1z);
  const T dso = s1o - s0o;
  const T ax = s0o + T(0.5) * dso, cx = T(0.5) * s0o + dso * third;
  const T cd = a.kcd * w, nfx = -(a.kf[0] * w), nfy = -(a.kf[1] * w),
          nfz = -(a.kf[2] * w);
  const T rx = runx * nfx;
  const T axy = nfy * ax, cxy = nfy * cx, axz = nfz * ax, cxz = nfz * cx;
  const T rr = cd * s1o;
  T dsz[5], runz[5], pyz[5];
  T acc_z = T(0);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dsz[k] = s1z[k] - s0z[k];
    acc_z = acc_z + dsz[k];
    runz[k] = acc_z;
    pyz[k] = fmadd(axy, s0z[k], cxy * dsz[k]);
  }
  T runy = T(0);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= oy0 + NOY) break;
    const T dsy = s1y[k] - s0y[k];
    runy = runy + dsy;
    if (k < oy0) continue;
    const int j = k - oy0;
    const T ay = s0y[k] + T(0.5) * dsy, cy = T(0.5) * s0y[k] + dsy * third;
    const T ayr = rx * ay, cyr = rx * cy;
    const T pz = fmadd(axz, s0y[k], cxz * dsy);
    const T ry = rr * s1y[k];
#pragma unroll
    for (int oz = 0; oz < 5; ++oz) {
      acc[j][oz][0] = fmadd(ayr, s0z[oz], fmadd(cyr, dsz[oz], acc[j][oz][0]));
      acc[j][oz][1] = fmadd(runy, pyz[oz], acc[j][oz][1]);
      acc[j][oz][2] = fmadd(runz[oz], pz, acc[j][oz][2]);
      acc[j][oz][3] = fmadd(ry, s1z[oz], acc[j][oz][3]);
    }
  }
}

// The alive slots of one cell as bits (up to MASK_SLOTS slots; above, bit
// 0 alone says that the cell holds any).
template <typename T>
__device__ __forceinline__ unsigned long long cell_bits(const Args<T>& a,
                                                        long long cell) {
  unsigned long long b = 0;
  if (a.cap <= MASK_SLOTS) {
#pragma unroll 4
    for (int s = 0; s < a.cap; ++s)
      if (a.alive[(long long)s * a.ncell + cell]) b |= 1ull << s;
  } else {
    for (int s = 0; s < a.cap && !b; ++s)
      b = a.alive[(long long)s * a.ncell + cell];
  }
  return b;
}

// 16-byte loads and stores of a node's four channels.
__device__ __forceinline__ void add4(float* p, const float (&v)[NC]) {
  float4 q = *reinterpret_cast<float4*>(p);
  q.x += v[0]; q.y += v[1]; q.z += v[2]; q.w += v[3];
  *reinterpret_cast<float4*>(p) = q;
}
__device__ __forceinline__ void add4(double* p, const double (&v)[NC]) {
  double2 q = *reinterpret_cast<double2*>(p);
  double2 r = *reinterpret_cast<double2*>(p + 2);
  q.x += v[0]; q.y += v[1]; r.x += v[2]; r.y += v[3];
  *reinterpret_cast<double2*>(p) = q;
  *reinterpret_cast<double2*>(p + 2) = r;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS, 6) deposit3d(Args<T> a) {
  constexpr int NOY = Slab<T>::NOY;
  __shared__ __align__(16) T planes[WARPS][QN * NC];
  const int lane = threadIdx.x;
  T* pl = planes[threadIdx.y];
  const long long col = (long long)blockIdx.x * WARPS + threadIdx.y;
  if (col >= (long long)a.nseg * a.nby * a.nbz) return;
  const int bk = (int)(col % a.nbz);
  const long long rest = col / a.nbz;
  const int bj = (int)(rest % a.nby), seg = (int)(rest / a.nby);
  const int ly = lane / CZ, lz = lane % CZ;
  const int iy = bj * CY + ly, iz = bk * CZ + lz;
  const bool valid = iy < a.ny && iz < a.nz;
  const int xs = seg * SEG, xe = min(xs + SEG, a.nx);
  const long long plane_cells = (long long)a.ny * a.nz;
  const long long cell0 = (long long)iy * a.nz + iz;   // cell at x = 0
  T* out = a.panels + col * (long long)(QPLANES * QN * NC);
  for (int e = lane; e < QN * NC; e += 32) pl[e] = T(0);
  // alive bits of the cells X - 2 .. X + 3 at plane X: the window (slots
  // 0 .. 4) and the next cell (5, read a plane ahead of its use)
  unsigned long long b0 = 0, b1 = 0, b2 = 0, b3 = 0, b4 = 0, b5 = 0;
  if (valid && xs < xe) b5 = cell_bits(a, cell0 + xs * plane_cells);
  for (int X = xs - 2; X <= xe + 1; ++X) {
    b0 = b1; b1 = b2; b2 = b3; b3 = b4; b4 = b5;
    b5 = 0;
    if (valid && X + 3 < xe)
      b5 = cell_bits(a, cell0 + (X + 3) * plane_cells);
    T* dst = out + (long long)(X - xs + 2) * (QN * NC);
    if (!__any_sync(0xffffffffu, (b0 | b1 | b2 | b3 | b4) != 0)) {
      for (int e = lane; e < QN * NC; e += 32) dst[e] = T(0);
      continue;
    }
#pragma unroll
    for (int oy0 = 0; oy0 < 5; oy0 += NOY) {
      T acc[NOY][5][NC];
#pragma unroll
      for (int j = 0; j < NOY; ++j)
#pragma unroll
        for (int k = 0; k < 5; ++k)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[j][k][c] = T(0);
      if (a.cap <= MASK_SLOTS) {
        // the window's alive slots one after another, cell by cell, so a
        // warp runs as long as its busiest lane's window
        unsigned long long c0 = b0, c1 = b1, c2 = b2, c3 = b3, c4 = b4;
        while (c0 | c1 | c2 | c3 | c4) {
          const int j = c0 ? 0 : c1 ? 1 : c2 ? 2 : c3 ? 3 : 4;
          const unsigned long long bb =
              j == 0 ? c0 : j == 1 ? c1 : j == 2 ? c2 : j == 3 ? c3 : c4;
          const unsigned long long rest_bits = bb & (bb - 1);
          c0 = j == 0 ? rest_bits : c0;
          c1 = j == 1 ? rest_bits : c1;
          c2 = j == 2 ? rest_bits : c2;
          c3 = j == 3 ? rest_bits : c3;
          c4 = j == 4 ? rest_bits : c4;
          const int ix = X - 2 + j;
          const long long idx = (long long)(__ffsll((long long)bb) - 1) *
                                a.ncell + cell0 + ix * plane_cells;
          add_particle<T, NOY>(a, idx, ix, iy, iz, 4 - j, oy0, acc);
        }
      } else {
        const bool on[5] = {b0 != 0, b1 != 0, b2 != 0, b3 != 0, b4 != 0};
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          if (!on[j]) continue;
          const int ix = X - 2 + j;
          const long long cell = cell0 + ix * plane_cells;
          for (int s = 0; s < a.cap; ++s) {
            const long long idx = (long long)s * a.ncell + cell;
            if (a.alive[idx])
              add_particle<T, NOY>(a, idx, ix, iy, iz, 4 - j, oy0, acc);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NOY; ++j) {
#pragma unroll
        for (int oz = 0; oz < 5; ++oz) {
          __syncwarp();
          if (valid)
            add4(pl + ((ly + oy0 + j) * QZ + (lz + oz)) * NC, acc[j][oz]);
        }
      }
    }
    __syncwarp();
    for (int e = lane; e < QN * NC; e += 32) {
      dst[e] = pl[e];
      pl[e] = T(0);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void fold_pad3(const T* __restrict__ pan, T* __restrict__ out,
                          int nx, int ny, int nz, int g, int nseg, int nby,
                          int nbz) {
  const long long nxp = nx + 2 * g, nyp = ny + 2 * g, nzp = nz + 2 * g;
  const long long vol = nxp * nyp * nzp;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vol) return;
  // interior node indices + 2: the offset of a node in its panel's first
  // segment, column and plane
  const int u = (int)(idx / (nyp * nzp)) - g + 2;
  const long long rem = idx % (nyp * nzp);
  const int v = (int)(rem / nzp) - g + 2;
  const int t = (int)(rem % nzp) - g + 2;
  T acc[NC] = {T(0), T(0), T(0), T(0)};
  if (u >= 0 && v >= 0 && t >= 0) {
    for (int s = u / SEG - 1; s <= u / SEG; ++s) {
      const int q = u - s * SEG;
      // the planes a segment wrote: up to its last cell + 2
      if (s < 0 || s >= nseg || q > min(SEG, nx - s * SEG) + 3) continue;
      for (int bj = v / CY - 1; bj <= v / CY; ++bj) {
        const int r = v - bj * CY;
        if (bj < 0 || bj >= nby || r >= QY) continue;
        for (int bk = t / CZ - 1; bk <= t / CZ; ++bk) {
          const int z = t - bk * CZ;
          if (bk < 0 || bk >= nbz || z >= QZ) continue;
          const long long col = ((long long)s * nby + bj) * nbz + bk;
          const T* p = pan + ((col * QPLANES + q) * QN + r * QZ + z) * NC;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] += p[c];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c * vol + idx] = acc[c];
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.alive = (const unsigned char*)p[P_ALIVE];
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y]; a.z = (const T*)p[P_Z];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY]; a.uz = (const T*)p[P_UZ];
  a.ig = (const T*)p[P_IG]; a.w = (const T*)p[P_W];
  a.panels = (T*)p[P_PANELS];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.nz = (int)n[I_NZ];
  a.nseg = ceil_div(a.nx, SEG);
  a.nby = ceil_div(a.ny, CY);
  a.nbz = ceil_div(a.nz, CZ);
  a.ncell = (long long)a.nx * a.ny * a.nz;
  a.cd[0] = (T)r[R_CDX]; a.cd[1] = (T)r[R_CDY]; a.cd[2] = (T)r[R_CDZ];
  a.kcd = (T)r[R_KCD];
  a.kf[0] = (T)r[R_KFX]; a.kf[1] = (T)r[R_KFY]; a.kf[2] = (T)r[R_KFZ];
  const int g = (int)n[I_G];
  if (g < 2 || a.cap < 0 || !a.alive) return (int)cudaErrorInvalidValue;
  const long long total = (long long)(a.nx + 2 * g) * (a.ny + 2 * g) *
                          (a.nz + 2 * g);
  const int threads = 256;
  if (a.ncell > 0 && a.cap > 0) {
    const long long cols = (long long)a.nseg * a.nby * a.nbz;
    deposit3d<T><<<ceil_div(cols, WARPS), dim3(32, WARPS), 0, st>>>(a);
    int err = (int)cudaGetLastError();
    if (err) return err;
  } else {
    a.nseg = 0;          // nothing deposited: the fold writes zeros
  }
  fold_pad3<T><<<ceil_div(total, threads), threads, 0, st>>>(
      a.panels, (T*)p[P_JPAD], a.nx, a.ny, a.nz, g, a.nseg, a.nby, a.nbz);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_deposit_3d(void** ptrs, const long long* ints,
                            const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}

// The column geometry (0: SEG, 1: CY, 2: CZ, 3: QPLANES, 4: QY, 5: QZ),
// which ops/cellpallas.py holds equal to its copy (it sizes the panels)
// when the library is first used.
LP_EXPORT int lp_deposit_geometry(int which) {
  const int g[] = {SEG, CY, CZ, QPLANES, QY, QZ};
  return which >= 0 && which < 6 ? g[which] : -1;
}
