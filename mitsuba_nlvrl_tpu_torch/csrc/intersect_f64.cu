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
// Design: the float32 kernel's, in float64, with one ray a thread.
// - Persistent blocks. mnt_intersect_tris_f64 launches at most as many
//   blocks of 256 threads as fit on the card at once (launch_geometry
//   below) and each block walks tiles of kRayTile rays with a grid stride.
//   Every thread holds one ray in registers. (Two rays a thread, so that
//   one shared-memory read serves both, was faster on coherent camera
//   rays and slower on a render's own rays, the traffic this kernel gets:
//   a block's first tile, loaded before any test, was then twice as
//   large. PERF.md has both.)
// - Asynchronous staging, by warp. Each warp copies its own rays of the
//   next tile (o, d, mint, maxt) into its half of a double buffer in shared
//   memory with 16-byte cp.async copies while it tests the current tile,
//   and waits for its own copies alone. A ray array whose base is not
//   16-byte aligned, and the ragged last tile, are copied with 8-byte
//   copies at the ends of the span (stage_span).
// - Triangles in shared memory. Up to kWholeMaxTris triangles are copied
//   into shared memory once per block, before the first ray tile (the one
//   block-wide barrier), in dynamic shared memory sized by the set. Above
//   that the triangles stream through a two-stage ring of kRingTris each,
//   one stage loading while the block tests the other. A triangle is
//   repacked from its three (T, 3) rows into 10 doubles {v0x v0y}
//   {v0z e1x}{e1y e1z}{e2x e2y}{e2z -}, read with five 16-byte loads.
// - Fewer instructions a pair. any_hit is a template parameter. A warp
//   leaves a pair's test together, by vote, once none of its lanes can
//   still hit: after u and after v. Camera rays in a warp are coherent, so
//   a warp skips the rest of the work of the triangles it misses. Any hit
//   writes the smallest hit t, so it cannot stop at the first hit: it
//   leaves the same way and skips only the bookkeeping of idx, u and v.
//   The best t starts just above maxt, so one compare says both t <= maxt
//   and t beats the best. (Measured and dropped, PERF.md: a sign test of
//   u's numerator against det before the division, which cost more than
//   it saved; __drcp_rn for the division, no faster; a register budget
//   for three blocks an SM, which spills.)
// - Triangles are visited in increasing index and the best hit is replaced
//   only on a strict `<`, which gives the lowest-index tie rule with no
//   extra work.
//
// Numerics. The arithmetic is written in the order of the reference's
// _moller_trumbore and of the plain version (ops/cuda/intersect_cuda.py::
// _moller_trumbore), the file is built with -fmad=false, and 1/det is a
// true double division (IEEE, correctly rounded). So every operation
// rounds as the plain version's elementwise float64 operations round, and
// the two agree in idx and in the bits of t, u and v. Every early exit
// keeps the outcome of each comparison it skips.
//
// Bound. At the main path's shape (N = 262,144 camera rays, T = 12
// Cornell-box triangles) a launch reads 64 B a ray (o, d, mint, maxt) and
// writes 28 B a ray (t, u, v in float64, idx in int32): 24.1 MB, about
// 7.2 us at an H100 SXM's 3.35 TB/s; its 46 flops a pair take about
// 4.3 us at the card's 34 TFLOP/s float64 vector rate. That rate counts a
// fused multiply-add as two operations; without fused multiply-adds
// (-fmad=false) each add, multiply and compare issues alone, and a pair
// tested in full issues about 70 fp64 instructions (the division's
// among them): about 13 us at this shape at the card's issue rate, and
// 1.1 ms at 1,023 triangles, where the kernel is bound by that. Only the
// early exits can beat the floor. What the kernel reaches is in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRays = 32;        // rays of one warp a tile
constexpr int kRayTile = kThreads;
constexpr int kTriDoubles = 10;       // one repacked triangle
constexpr int kWholeMaxTris = 512;    // whole set in shared memory up to this
constexpr int kRingTris = 256;        // triangles per ring stage above it
// one warp's ray buffer: o and d (3 doubles a ray), mint and maxt, each
// region with 2 doubles of slack so that a misaligned source keeps its
// 16-byte phase; a block has one for each warp, twice (double buffer)
constexpr int kWarpBufDoubles = 8 * kWarpRays + 8;
constexpr int kRayBufDoubles = kWarps * kWarpBufDoubles;
constexpr int kRayBytes = 2 * kRayBufDoubles * 8;

static_assert(kWarpRays % 2 == 0, "ray regions must stay 16-byte aligned");

constexpr int smem_bytes_for(bool ring, int n_tris) {
  return kRayBytes + kTriDoubles * 8 * (ring ? 2 * kRingTris : n_tris);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes of shared memory at a shared-window address
__device__ __forceinline__ double2 lds128(unsigned addr) {
  double2 v;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(v.x), "=d"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// double offset of p from the 16-byte boundary below it (0 or 1)
__device__ __forceinline__ int phase(const double* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
}

// Copy src[0, n) to region + phase(src) (the region is 16-byte aligned with
// 2 doubles of slack), by the 32 lanes of one warp: 16-byte copies where
// both sides are aligned, 8-byte copies for the at most 1 + 1 doubles at
// the ends.
__device__ __forceinline__ void stage_span(double* region, const double* src,
                                           int n, int lane) {
  const int m = phase(src);
  double* dst = region + m;
  const int head = min(n, m);
  const int body = (n - head) >> 1;
  const int tail = head + 2 * body;
  if (lane == 0 && head > 0) cp_async8(dst, src);
  if (lane == 1 && tail < n) cp_async8(dst + tail, src + tail);
  for (int c = lane; c < body; c += 32)
    cp_async16(dst + head + 2 * c, src + head + 2 * c);
}

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
};

// shared-memory regions of one warp's ray buffer
__device__ __forceinline__ double* region_o(double* buf) { return buf; }
__device__ __forceinline__ double* region_d(double* buf) {
  return buf + 3 * kWarpRays + 2;
}
__device__ __forceinline__ double* region_mint(double* buf) {
  return buf + 6 * kWarpRays + 4;
}
__device__ __forceinline__ double* region_maxt(double* buf) {
  return buf + 7 * kWarpRays + 6;
}

// The rays of this warp in ray tile `tile` (kWarpRays from
// tile * kRayTile + warp * kWarpRays) into the warp's buffer wbuf.
__device__ __forceinline__ void stage_rays(double* wbuf, const Params& p,
                                           int tile, int warp, int lane) {
  const int first = tile * kRayTile + warp * kWarpRays;
  const int n = min(kWarpRays, p.n_rays - first);
  if (n <= 0) return;
  stage_span(region_o(wbuf), p.o + 3 * static_cast<int64_t>(first), 3 * n,
             lane);
  stage_span(region_d(wbuf), p.d + 3 * static_cast<int64_t>(first), 3 * n,
             lane);
  stage_span(region_mint(wbuf), p.mint + first, n, lane);
  stage_span(region_maxt(wbuf), p.maxt + first, n, lane);
}

// Repack triangles [first, first + count) into 10-double records at dst,
// reading each (T, 3) array with consecutive threads on consecutive
// doubles.
__device__ __forceinline__ void stage_tris(double* dst, const Params& p,
                                           int first, int count) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double* src = (a == 0 ? p.v0 : a == 1 ? p.e1 : p.e2) +
                        3 * static_cast<int64_t>(first);
    for (int f = threadIdx.x; f < 3 * count; f += kThreads) {
      const int k = f / 3;
      cp_async8(dst + kTriDoubles * k + 3 * a + (f - 3 * k), src + f);
    }
  }
}

// A ray and its best hit so far. t starts at the double just above tmax
// (tmax itself for +inf and NaN), so that one compare t < best says both
// t <= tmax and t beats the best; a ray that keeps i = -1 reports t = inf.
struct RayState {
  double ox, oy, oz, dx, dy, dz, tmin;
  double t, u, v;
  int i;
};

// Test the thread's ray against triangle j, given as its five 16-byte
// rows. The warp leaves the test together, once none of its lanes can
// still hit: after u (u outside [0, 1]; u > 1 cannot pass u + v <= 1 with
// v >= 0) and after v.
template <bool kAnyHit>
__device__ __forceinline__ void mt_test(RayState& r, const double2 a,
                                        const double2 b, const double2 c,
                                        const double2 d, const double2 e,
                                        int j) {
  const double v0x = a.x, v0y = a.y, v0z = b.x;
  const double e1x = b.y, e1y = c.x, e1z = c.y;
  const double e2x = d.x, e2y = d.y, e2z = e.x;
  // pvec = d x e2
  const double px = r.dy * e2z - r.dz * e2y;
  const double py = r.dz * e2x - r.dx * e2z;
  const double pz = r.dx * e2y - r.dy * e2x;
  const double det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabs(det) > 1e-12;
  const double inv_det = 1.0 / (ok ? det : 1.0);
  const double tx = r.ox - v0x;
  const double ty = r.oy - v0y;
  const double tz = r.oz - v0z;
  const double u = (tx * px + ty * py + tz * pz) * inv_det;
  ok = ok && u >= 0.0 && u <= 1.0;
  if (!__any_sync(0xffffffffu, ok)) return;
  // qvec = tvec x e1
  const double qx = ty * e1z - tz * e1y;
  const double qy = tz * e1x - tx * e1z;
  const double qz = tx * e1y - ty * e1x;
  const double v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  ok = ok && v >= 0.0 && u + v <= 1.0;
  if (!__any_sync(0xffffffffu, ok)) return;
  const double t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  // r.t starts just above tmax, so t < r.t also says t <= tmax
  if (ok && t >= r.tmin && t < r.t) {
    r.t = t;
    r.i = j;
    if (!kAnyHit) {
      r.u = u;
      r.v = v;
    }
  }
}

// Test the thread's ray against `count` triangles at tris (first index
// `first`).
template <bool kAnyHit>
__device__ __forceinline__ void sweep(RayState& r, const double* tris,
                                      int first, int count) {
  unsigned base = smem_addr(tris);
  asm volatile("" : "+r"(base));   // keep it in a register, not re-derived
  for (int j = 0; j < count; ++j) {
    const unsigned at = base + j * (kTriDoubles * 8);
    mt_test<kAnyHit>(r, lds128(at), lds128(at + 16), lds128(at + 32),
                     lds128(at + 48), lds128(at + 64), first + j);
  }
}

// Each warp owns its rays of a tile and their buffers, so in whole-set
// mode a warp waits only for its own copies (cp.async.wait_group and
// __syncwarp) and tests while the other warps' rays still arrive; the
// block synchronises once, for the triangles. The ring shares triangle
// stages between the warps and synchronises the block at every stage.
template <bool kAnyHit, bool kRing>
__global__ void __launch_bounds__(kThreads, 2)
mt_kernel_f64(const Params p) {
  extern __shared__ __align__(16) double smem[];
  double* const tbuf = smem + 2 * kRayBufDoubles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's ray buffers: wbuf + 0 and wbuf + kRayBufDoubles
  double* const wbuf = smem + warp * kWarpBufDoubles;
  const int n_tiles = (p.n_rays + kRayTile - 1) / kRayTile;
  const int n_tri_tiles =
      kRing ? (p.n_tris + kRingTris - 1) / kRingTris : 1;
  const int o_m = phase(p.o), d_m = phase(p.d);
  const int mint_m = phase(p.mint), maxt_m = phase(p.maxt);

  int tile = blockIdx.x;
  stage_tris(tbuf, p, 0, kRing ? min(p.n_tris, kRingTris) : p.n_tris);
  cp_async_commit();
  stage_rays(wbuf, p, tile, warp, lane);
  cp_async_commit();
  if (!kRing) {
    cp_async_wait_one();   // this thread's triangle copies
    __syncthreads();       // everyone's
  }

  RayState r;
  int step = 0;
  for (int rb = 0; tile < n_tiles; tile += gridDim.x, rb ^= 1) {
    for (int k = 0; k < n_tri_tiles; ++k, ++step) {
      // prefetch what the next step reads into the buffers not read now
      double* next_tris = tbuf + ((step + 1) & 1) * kRingTris * kTriDoubles;
      if (k + 1 < n_tri_tiles) {
        const int first = (k + 1) * kRingTris;
        stage_tris(next_tris, p, first, min(kRingTris, p.n_tris - first));
      } else if (tile + gridDim.x < n_tiles) {
        stage_rays(wbuf + (rb ^ 1) * kRayBufDoubles, p, tile + gridDim.x,
                   warp, lane);
        if (kRing) stage_tris(next_tris, p, 0, min(kRingTris, p.n_tris));
      }
      cp_async_commit();
      cp_async_wait_one();
      if (kRing)
        __syncthreads();
      else
        __syncwarp();

      const int ray = tile * kRayTile + warp * kWarpRays + lane;
      if (k == 0) {
        double* const buf = wbuf + rb * kRayBufDoubles;
        if (ray < p.n_rays) {
          const double* so = region_o(buf) + o_m + 3 * lane;
          const double* sd = region_d(buf) + d_m + 3 * lane;
          r.ox = so[0];
          r.oy = so[1];
          r.oz = so[2];
          r.dx = sd[0];
          r.dy = sd[1];
          r.dz = sd[2];
          r.tmin = region_mint(buf)[mint_m + lane];
          r.t = nextafter(region_maxt(buf)[maxt_m + lane], CUDART_INF);
        } else {  // past the end: a ray that hits nothing
          r.ox = r.oy = r.oz = r.dx = r.dy = 0.0;
          r.dz = 1.0;
          r.tmin = 0.0;
          r.t = -1.0;
        }
        r.i = -1;
        r.u = r.v = 0.0;
      }

      if (kRing) {
        const int first = k * kRingTris;
        sweep<kAnyHit>(r, tbuf + (step & 1) * kRingTris * kTriDoubles,
                       first, min(kRingTris, p.n_tris - first));
      } else {
        sweep<kAnyHit>(r, tbuf, 0, p.n_tris);
      }

      if (k + 1 == n_tri_tiles && ray < p.n_rays) {
        p.t_out[ray] = r.i < 0 ? CUDART_INF : r.t;
        if (!kAnyHit) {   // any hit writes t alone
          p.i_out[ray] = r.i;
          p.u_out[ray] = r.u;
          p.v_out[ray] = r.v;
        }
      }
      if (kRing)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  cp_async_wait_all();
}

using KernelFn = void (*)(const Params);

KernelFn kernel_for(bool any_hit, bool ring) {
  if (any_hit)
    return ring ? mt_kernel_f64<true, true> : mt_kernel_f64<true, false>;
  return ring ? mt_kernel_f64<false, true> : mt_kernel_f64<false, false>;
}

constexpr int64_t kMaxRows = (int64_t{1} << 31) / 3 - 1;

// How one launch runs, as mnt_intersect_geometry_f64 reports it: one
// int32 field each, in this order (GEOMETRY_FIELDS in
// ops/cuda/intersect_cuda.py, as for csrc/intersect.cu).
struct Geometry {
  int32_t grid;         // blocks
  int32_t smem_bytes;   // dynamic shared memory a block
  int32_t ring;         // the triangles stream through the ring
  int32_t ray_tile;     // rays a block takes at a time
};

// The launch of N rays against T triangles on the current device: the
// whole triangle set in shared memory up to kWholeMaxTris and the ring
// above it; as many blocks as are resident on all SMs at once, never more
// than ray tiles. Each thread keeps its last answer for each of any_hit's
// values, by device, N and T; a new answer sets the kernel's
// shared-memory limit on that device and asks for its occupancy and the
// SM count.
cudaError_t launch_geometry(int n_rays, int n_tris, bool any_hit,
                            Geometry* out) {
  struct Last {
    int device = -1, n_rays = -1, n_tris = -1;
    Geometry g{};
  };
  thread_local Last last[2];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Last& c = last[any_hit];
  if (c.device != device || c.n_rays != n_rays || c.n_tris != n_tris) {
    const bool ring = n_tris > kWholeMaxTris;
    const KernelFn fn = kernel_for(any_hit, ring);
    const int smem = smem_bytes_for(ring, n_tris);
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes_for(ring, kWholeMaxTris));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          kThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = (n_rays + kRayTile - 1) / kRayTile;
    int grid = sms * per_sm;
    if (grid > tiles) grid = tiles;
    if (grid < 1) grid = 1;
    c = Last{device, n_rays, n_tris,
             Geometry{grid, smem, ring ? 1 : 0, kRayTile}};
  }
  *out = c.g;
  return cudaSuccess;
}

}  // namespace

// C entry points for ctypes (ARGTYPES_F64 in ops/cuda/intersect_cuda.py;
// a CPU test holds the two to each other). Each returns 0 or a
// cudaError_t.

// The launch the kernel makes for N rays and T triangles on the current
// device, into the Geometry at `out`.
extern "C" int mnt_intersect_geometry_f64(int n_rays, int n_tris,
                                          int any_hit, void* out) {
  if (n_rays < 0 || n_tris < 0 || n_rays > kMaxRows || n_tris > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_geometry(n_rays, n_tris, any_hit != 0,
                                          static_cast<Geometry*>(out)));
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

// Launch the sweep on the current device. Counts the kernel cannot take
// are refused with cudaErrorInvalidValue. Returns cudaGetLastError() after
// the launch.
extern "C" int mnt_intersect_tris_f64(const void* packed) {
  const LaunchArgs& a = *static_cast<const LaunchArgs*>(packed);
  if (a.n_rays == 0) return 0;
  if (a.n_rays < 0 || a.n_tris < 0 || a.n_rays > kMaxRows ||
      a.n_tris > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  const cudaError_t err =
      launch_geometry(static_cast<int>(a.n_rays), static_cast<int>(a.n_tris),
                      a.any_hit != 0, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const KernelFn fn = kernel_for(a.any_hit != 0, g.ring != 0);
  const Params p{ptr<const double>(a.v0),   ptr<const double>(a.e1),
                 ptr<const double>(a.e2),   ptr<const double>(a.o),
                 ptr<const double>(a.d),    ptr<const double>(a.mint),
                 ptr<const double>(a.maxt), ptr<double>(a.t_out),
                 ptr<int>(a.i_out),         ptr<double>(a.u_out),
                 ptr<double>(a.v_out),      static_cast<int>(a.n_tris),
                 static_cast<int>(a.n_rays)};
  void* args[] = {const_cast<Params*>(&p)};
  const cudaError_t launched = cudaLaunchKernel(
      reinterpret_cast<const void*>(fn), dim3(static_cast<unsigned>(g.grid)),
      dim3(kThreads), args, static_cast<size_t>(g.smem_bytes),
      ptr<CUstream_st>(a.stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
