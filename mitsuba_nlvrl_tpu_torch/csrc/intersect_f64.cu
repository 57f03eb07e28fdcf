// Dense ray x triangle Moller-Trumbore sweep in float64 with a fused
// nearest-hit or any-hit reduction, for Hopper (sm_90a): the double
// variant's intersection.
//
// A second port of mitsuba_nlvrl_tpu/ops/pallas/intersect_tpu.py::
// _mt_kernel, for scenes whose tables are float64 (the reference's *_double
// build configurations; csrc/intersect.cu is the float32 port). Contract:
// for each ray, a triangle is a hit when |det| > 1e-12, u >= 0, v >= 0,
// u + v <= 1 and mint <= t <= maxt. Nearest hit keeps (t, idx, u, v) of
// the smallest t, and at equal t the lowest triangle index wins. Any hit
// writes t alone: the smallest hit t, so t is finite exactly when some
// triangle is hit (the plain version returns the same t).
//
// Design, simple first. One ray a thread, 256 threads a block, one block
// for every 256 rays. The triangles stream through shared memory in tiles
// of kTileTris: the block copies a tile (9 doubles a triangle: v0, e1, e2)
// with coalesced 8-byte loads, waits at a barrier, and each thread tests
// its ray against the tile's triangles in increasing index, replacing its
// best hit only on a strict `<` (the lowest-index tie rule). No early
// exits, no asynchronous copies, no repacking.
//
// Numerics. The arithmetic is written in the order of the reference's
// _moller_trumbore and of the plain version (ops/cuda/intersect_cuda.py::
// _moller_trumbore), the file is built with -fmad=false, and 1/det is a
// true double division (IEEE, correctly rounded). So every operation
// rounds as the plain version's elementwise float64 operations round, and
// the two agree in idx and in the bits of t, u and v.
//
// Bound. At the main path's shape (N = 262,144 camera rays, T = 12
// Cornell-box triangles) a launch reads 64 B a ray (o, d, mint, maxt) and
// writes 28 B a ray (t, u, v in float64, idx in int32): 24.1 MB, about
// 7.2 us at an H100 SXM's 3.35 TB/s; its 46 flops a pair take about
// 4.3 us at the card's 34 TFLOP/s float64 vector rate. So it is bound by
// bytes there; what it reaches is in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 256;
constexpr int kTriDoubles = 9;
constexpr int64_t kMaxRows = (int64_t{1} << 31) / 3 - 1;

struct Params {
  const double* v0;
  const double* e1;
  const double* e2;
  const double* o;
  const double* d;
  const double* mint;
  const double* maxt;
  double* t_out;
  int* i_out;
  double* u_out;
  double* v_out;
  int n_tris;
  int n_rays;
  int any_hit;
};

__global__ void __launch_bounds__(kThreads) mt_kernel_f64(Params p) {
  __shared__ double tile[kTileTris * kTriDoubles];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < p.n_rays;
  double ox = 0.0, oy = 0.0, oz = 0.0, dx = 0.0, dy = 0.0, dz = 0.0;
  double rmin = 0.0, rmax = 0.0;
  if (live) {
    ox = p.o[3 * ray];
    oy = p.o[3 * ray + 1];
    oz = p.o[3 * ray + 2];
    dx = p.d[3 * ray];
    dy = p.d[3 * ray + 1];
    dz = p.d[3 * ray + 2];
    rmin = p.mint[ray];
    rmax = p.maxt[ray];
  }
  double best_t = CUDART_INF;
  double best_u = 0.0, best_v = 0.0;
  int best_i = -1;
  for (int base = 0; base < p.n_tris; base += kTileTris) {
    const int count = min(kTileTris, p.n_tris - base);
    // tile layout: v0 (count x 3), then e1, then e2, each row-major
    for (int k = threadIdx.x; k < 3 * count; k += kThreads) {
      const int64_t src = 3 * static_cast<int64_t>(base) + k;
      tile[k] = p.v0[src];
      tile[3 * kTileTris + k] = p.e1[src];
      tile[6 * kTileTris + k] = p.e2[src];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < count; ++j) {
        const double* a = tile + 3 * j;
        const double* b = tile + 3 * kTileTris + 3 * j;
        const double* c = tile + 6 * kTileTris + 3 * j;
        const double e1x = b[0], e1y = b[1], e1z = b[2];
        const double e2x = c[0], e2y = c[1], e2z = c[2];
        // pvec = d x e2
        const double px = dy * e2z - dz * e2y;
        const double py = dz * e2x - dx * e2z;
        const double pz = dx * e2y - dy * e2x;
        const double det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabs(det) > 1e-12;
        const double inv_det = ok ? 1.0 / det : 0.0;
        const double tx = ox - a[0];
        const double ty = oy - a[1];
        const double tz = oz - a[2];
        const double u = (tx * px + ty * py + tz * pz) * inv_det;
        // qvec = tvec x e1
        const double qx = ty * e1z - tz * e1y;
        const double qy = tz * e1x - tx * e1z;
        const double qz = tx * e1y - ty * e1x;
        const double v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const double t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = ok && u >= 0.0 && v >= 0.0 && u + v <= 1.0 &&
                         t >= rmin && t <= rmax;
        if (hit && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_i = base + j;
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  p.t_out[ray] = best_t;
  if (!p.any_hit) {
    p.i_out[ray] = best_i;
    p.u_out[ray] = best_u;
    p.v_out[ray] = best_v;
  }
}

// The arguments of one launch, packed as for csrc/intersect.cu (one int64
// field each, in this order; LAUNCH_FIELDS in ops/cuda/intersect_cuda.py):
// device pointers of contiguous float64 (T, 3) triangle arrays, float64
// (N, 3) / (N,) ray arrays and the (N,) outputs t (float64), idx (int32),
// u, v (float64); with any_hit only t is written and the other three may
// be 0. `stream` is a cudaStream_t.
struct LaunchArgs {
  int64_t v0;
  int64_t e1;
  int64_t e2;
  int64_t n_tris;
  int64_t o;
  int64_t d;
  int64_t mint;
  int64_t maxt;
  int64_t n_rays;
  int64_t any_hit;
  int64_t t_out;
  int64_t i_out;
  int64_t u_out;
  int64_t v_out;
  int64_t stream;
};

template <typename T>
T* ptr(int64_t address) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(address));
}

}  // namespace

// Launch the sweep on the current device. Counts the kernel cannot take
// are refused with cudaErrorInvalidValue. Returns cudaGetLastError() after
// the launch.
extern "C" int mnt_intersect_tris_f64(const void* packed) {
  const LaunchArgs& a = *static_cast<const LaunchArgs*>(packed);
  if (a.n_rays == 0) return 0;
  if (a.n_rays < 0 || a.n_tris < 0 || a.n_rays > kMaxRows ||
      a.n_tris > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{ptr<const double>(a.v0),   ptr<const double>(a.e1),
                 ptr<const double>(a.e2),   ptr<const double>(a.o),
                 ptr<const double>(a.d),    ptr<const double>(a.mint),
                 ptr<const double>(a.maxt), ptr<double>(a.t_out),
                 ptr<int>(a.i_out),         ptr<double>(a.u_out),
                 ptr<double>(a.v_out),      static_cast<int>(a.n_tris),
                 static_cast<int>(a.n_rays), a.any_hit != 0 ? 1 : 0};
  const unsigned grid =
      static_cast<unsigned>((a.n_rays + kThreads - 1) / kThreads);
  mt_kernel_f64<<<grid, kThreads, 0,
                  reinterpret_cast<cudaStream_t>(
                      static_cast<uintptr_t>(a.stream))>>>(p);
  return static_cast<int>(cudaGetLastError());
}
