// lol_instanced_render / lol_instanced_fwd on Hopper: the fused forward
// render of an instanced scene (10k+ spheres and a few planes), one thread
// per ray.
//
// Replaces `loltracer_tpu/render/pallas_train.py: _instanced_fwd_kernel`
// with residuals off (the Pallas call named `lol_instanced_render`) and on
// (`lol_instanced_fwd`). The pixel body is csrc/fused_fwd.cuh's
// `render_pixel`; this file supplies the instanced `Scene`, the run walk
// below, and the kernel that launches it. K5, K5r, K6, K7 and K9 search
// through csrc/grid_scene.cuh's `GridScene` (a cell grid, this walk its
// fallback); the walk alone is their check entry and the search of K3i /
// K4i. With residuals, the IFT denominator is the
// winner's normal . rd from `dist_bwd` (pallas_train.py:947-967), and the
// image stays bitwise the residuals-off kernel's.
//
// The scene's distance at p is, as in the plain version (render/sdf.py
// `_make_instanced_sdf`): the min over spheres of |p - c| - r, under a step
// clamp cut at max(clamp, distance to the sphere set's AABB), then merged
// with the planes by a strict `<`. The march, the material lookup and the
// normal taps take the primary clamp (Cfg::has_clamp, Cfg::clamp), the
// shadow marches the shadow clamp (Cfg::has_shadow_clamp, ...).
//
// The search is exact and two-level. The spheres are Morton-sorted into runs
// of kGroup (render/instanced_pack.py), each with a bounding ball: every
// member's distance is >= |p - ctr| - R, and the least member distance is
// <= |p - ctr| + S. The running bound `best` starts at the cut (at +inf when
// exact, and then a first pass over the balls' S gives an upper bound u);
// a run is evaluated when its lower bound is <= min(best, u) (non-strict: a
// one-sphere run has R == -S up to the margins), sphere by sphere with the
// plain version's expression. A skipped run's spheres are all > best, so the
// min is the plain version's exactly; min is order-free, and the build uses
// --fmad=false, so the two agree bitwise. `sdf_mat` tracks the winner's
// original SoA index too, and a tie goes to the smaller one (first-wins,
// as the plain version's blockwise argmin).
//
// What bounds it on this card: FP32 and SFU issue and divergence, as K1.
// One evaluation costs a pass over the ~160 ball tests (in shared memory,
// loaded once per block) plus the visited runs' spheres (read as float4
// through the read-only path; within a warp the 8x4 neighbouring rays visit
// mostly the same runs, so those loads are broadcasts). The TPU kernel's
// windows, best-first pick loop, MXU bound expansion, scratch gathers and
// shadow segment cull are TPU layout answers, value-exact all; none is
// carried over (the last two are perf items in ROADMAP.md).
//
// The adjoint `dist_bwd` (the training backward, csrc/instanced_bwd.cuh)
// has the signature of the generated compiled `Scene::dist_bwd`, so that
// `render_pixel` and `pixel_bwd` run on this Scene unchanged. It is the
// gradient of the primary-clamp distance as K6 defines it
// (pallas_train.py `_compose_track`, `_RecordingDist`): the winner's unit
// normal when a sphere wins, 0 when the cut wins (raw > cut: the cut is
// frozen), (0, 1, 0) when a plane wins (strict <). The sphere term goes to
// a RecordSink, one slot per call per pixel, for the deterministic scatter.
//
// Self names a struct that derives from this one and brings its own search
// (csrc/grid_scene.cuh's GridScene: `dist_under` and `winner` over a cell
// grid, this run walk its fallback): `dist`, `shadow_dist`, `sdf_mat` and
// `dist_bwd` call Self's. With Self = void they call this struct's own.
//
// The device functions also compile as host C++ (tests/test_torch_instanced_host.py);
// the kernel and its launch sit under __CUDACC__.

#include <climits>

namespace lol {

// The sphere tables of render/instanced_pack.py, on the device.
struct InstancedTables {
  const float4* __restrict__ spheres;  // [num_spheres] x y z r, Morton-sorted
  const int2* __restrict__ ids;        // [num_spheres + planes] (SoA index, material)
  const float4* __restrict__ groups;   // [num_groups][2] (cx cy cz R) (S 0 0 0)
  const float* __restrict__ bbox;      // [6] lo, hi of the spheres' surfaces
  int num_spheres;
  int num_groups;
};

// The sphere-table records of one pixel's SDF adjoint calls: slot s of
// pixel p is entry s * stride + p of rows (the winning sorted row, -1 for
// none) and vals (d/d(x, y, z, r) of that row). Each dist_bwd<true> call
// takes the next slot; close() marks the slots no call took.
struct RecordSink {
  int* __restrict__ rows;
  float4* __restrict__ vals;
  size_t stride;
  size_t pix;
  int site;

  __device__ __forceinline__ void put(int row, float gx, float gy, float gz, float gr) {
    const size_t i = (size_t)site++ * stride + pix;
    rows[i] = row;
    if (row >= 0) {
      float4 v;
      v.x = gx;
      v.y = gy;
      v.z = gz;
      v.w = gr;
      vals[i] = v;
    }
  }

  __device__ __forceinline__ void close(int sites) {
    for (; site < sites; ++site) rows[(size_t)site * stride + pix] = -1;
  }
};

template <class Self, class Base>
struct SelfOr {
  using type = Self;
};
template <class Base>
struct SelfOr<void, Base> {
  using type = Base;
};

// L: the generated layout (offsets into the packed small-field buffer and
// kGroup); C: the generated Cfg with the two clamps; Self: see above.
template <class L, class C, class Self = void>
struct InstancedScene {
  static constexpr int kNumLights = L::kNumLights;
  static constexpr int kNumMaterials = L::kNumMaterials;
  static constexpr int kNumFields = L::kNumFields;
  static constexpr int kMatShininess = L::kMatShininess;
  static constexpr int kMatDiffuse = L::kMatDiffuse;
  static constexpr int kMatSpecular = L::kMatSpecular;
  static constexpr int kMatAmbient = L::kMatAmbient;
  static constexpr int kAmbientColor = L::kAmbientColor;
  static constexpr int kLightPoint = L::kLightPoint;
  static constexpr int kLightDiffuse = L::kLightDiffuse;
  static constexpr int kLightSpecular = L::kLightSpecular;
  static constexpr int kNumPlanes = L::kNumPlanes;
  static constexpr int kGroup = L::kGroup;
  static constexpr bool kStats = false;  // a GridScene may count its searches
  using Derived = typename SelfOr<Self, InstancedScene>::type;

  const float* P;
  InstancedTables tab;
  const float4* grp;  // the group table, staged in shared memory
  RecordSink* sink;   // where dist_bwd<true> records; none in the forward
  float plane_y[kNumPlanes > 0 ? kNumPlanes : 1];

  __device__ __forceinline__ InstancedScene(const float* __restrict__ P_,
                                            const InstancedTables& t,
                                            const float4* groups,
                                            RecordSink* records = nullptr)
      : P(P_), tab(t), grp(groups), sink(records) {
#pragma unroll
    for (int k = 0; k < kNumPlanes; ++k) plane_y[k] = __ldg(P + L::kPlaneY + k);
  }

  __device__ __forceinline__ const Derived& self() const {
    return static_cast<const Derived&>(*this);
  }

  // the distance from p to the spheres' AABB
  __device__ __forceinline__ float box_dist(float px, float py, float pz) const {
    const float* b = tab.bbox;
    const float qx = jmax(jmax(__ldg(b) - px, px - __ldg(b + 3)), 0.f);
    const float qy = jmax(jmax(__ldg(b + 1) - py, py - __ldg(b + 4)), 0.f);
    const float qz = jmax(jmax(__ldg(b + 2) - pz, pz - __ldg(b + 5)), 0.f);
    const float s = (qx * qx + qy * qy) + qz * qz;
    return s > 0.f ? sqrtf(s) : 0.f;
  }

  // max(clamp, distance from p to the spheres' AABB) (render/sdf.py bbox_cut)
  __device__ __forceinline__ float cut(float px, float py, float pz, float clamp) const {
    return jmax(box_dist(px, py, pz), clamp);
  }

  // min over runs of |p - ctr| + S: >= the least sphere distance
  __device__ __forceinline__ float upper(float px, float py, float pz) const {
    float u = INFINITY;
    for (int g = 0; g < tab.num_groups; ++g) {
      const float4 b = grp[2 * g];
      const float dx = px - b.x, dy = py - b.y, dz = pz - b.z;
      const float v = sqrtf((dx * dx + dy * dy) + dz * dz) + grp[2 * g + 1].x;
      if (v < u) u = v;
    }
    return u;
  }

  __device__ __forceinline__ int run_end(int g) const {
    const int e = g * kGroup + kGroup;
    return e < tab.num_spheres ? e : tab.num_spheres;
  }

  // Whether run g can hold a sphere at distance <= gate.
  __device__ __forceinline__ bool visit(int g, float px, float py, float pz,
                                        float gate) const {
    const float4 b = grp[2 * g];
    const float dx = px - b.x, dy = py - b.y, dz = pz - b.z;
    const float thr = gate + b.w;
    return thr > 0.f && (dx * dx + dy * dy) + dz * dz <= thr * thr;
  }

  __device__ __forceinline__ float sphere_dist(int j, float px, float py, float pz) const {
    const float4 s = __ldg(tab.spheres + j);
    const float dx = px - s.x, dy = py - s.y, dz = pz - s.z;
    return sqrtf((dx * dx + dy * dy) + dz * dz) - s.w;
  }

  // min(best, every sphere distance at p) by the run walk from the bound
  // best (with kUpper, best is INFINITY and the balls' upper bound gates)
  template <bool kUpper>
  __device__ __forceinline__ float walk(float px, float py, float pz, float best) const {
    const float u = kUpper ? upper(px, py, pz) : INFINITY;
    for (int g = 0; g < tab.num_groups; ++g) {
      if (!visit(g, px, py, pz, u < best ? u : best)) continue;
      const int end = run_end(g);
      for (int j = g * kGroup; j < end; ++j) {
        const float d = sphere_dist(j, px, py, pz);
        if (d < best) best = d;
      }
    }
    return best;
  }

  // min(best, the planes' distances at p)
  __device__ __forceinline__ float planes(float py, float best) const {
#pragma unroll
    for (int k = 0; k < kNumPlanes; ++k) {
      const float dp = py - plane_y[k];
      if (dp < best) best = dp;
    }
    return best;
  }

  // min(min over spheres, cut) and the planes, for one clamp
  template <bool kHasClamp>
  __device__ __forceinline__ float dist_under(float px, float py, float pz,
                                              float clamp) const {
    return planes(py, walk<!kHasClamp>(px, py, pz,
                                       kHasClamp ? cut(px, py, pz, clamp) : INFINITY));
  }

  __device__ __forceinline__ float dist(float px, float py, float pz) const {
    return self().template dist_under<C::has_clamp>(px, py, pz, C::clamp);
  }

  __device__ __forceinline__ float shadow_dist(float px, float py, float pz) const {
    return self().template dist_under<C::has_shadow_clamp>(px, py, pz, C::shadow_clamp);
  }

  // The first-wins argmin over the spheres at distance <= best (best on
  // entry: a bound, INFINITY for none): its sorted row, -1 if no sphere is
  // that near, with best set to its distance. A tie goes to the smaller
  // SoA index.
  __device__ __forceinline__ int winner(float px, float py, float pz, float& best) const {
    int best_idx = INT_MAX, best_row = -1;
    const float u = best < INFINITY ? INFINITY : upper(px, py, pz);
    for (int g = 0; g < tab.num_groups; ++g) {
      if (!visit(g, px, py, pz, u < best ? u : best)) continue;
      const int end = run_end(g);
      for (int j = g * kGroup; j < end; ++j) {
        const float d = sphere_dist(j, px, py, pz);
        if (d <= best) {
          const int idx = __ldg(&tab.ids[j].x);
          if (d < best || idx < best_idx) {
            best = d;
            best_idx = idx;
            best_row = j;
          }
        }
      }
    }
    return best_row;
  }

  // (material, distance): the material of the UNCLAMPED first-wins argmin
  // over spheres, the distance under the primary clamp, then the planes by
  // a strict `<` against that clamped distance (render/sdf.py).
  __device__ __forceinline__ int sdf_mat(float px, float py, float pz,
                                         float& dmin) const {
    float best = INFINITY;
    const int best_row = self().winner(px, py, pz, best);
    int mat = best_row >= 0 ? __ldg(&tab.ids[best_row].y) : 0;
    float d = best;
    if (C::has_clamp) d = jmin(d, cut(px, py, pz, C::clamp));
    for (int k = 0; k < kNumPlanes; ++k) {
      const float dp = py - plane_y[k];
      if (dp < d) {
        d = dp;
        mat = __ldg(&tab.ids[tab.num_spheres + k].y);
      }
    }
    dmin = d;
    return mat;
  }

  // The primary-clamp distance at p and, for its cotangent gd, the point
  // gradient (gx, gy, gz); with kAccum, -gd to the winning plane's plane_y
  // in gP and the winning sphere's term (-gd n, -gd) for (x, y, z, r) to
  // the sink (row -1 when no sphere wins or gd is 0). Under a clamp the
  // search starts at the cut, so a sphere wins only at raw <= cut.
  template <bool kAccum>
  __device__ __forceinline__ float dist_bwd(float px, float py, float pz, float gd,
                                            float& gx, float& gy, float& gz,
                                            float* __restrict__ gP) const {
    float d = C::has_clamp ? cut(px, py, pz, C::clamp) : INFINITY;
    const int row = self().winner(px, py, pz, d);
    int plane = -1;
#pragma unroll
    for (int k = 0; k < kNumPlanes; ++k) {
      const float dp = py - plane_y[k];
      if (dp < d) {
        d = dp;
        plane = k;
      }
    }
    gx = 0.f;
    gy = 0.f;
    gz = 0.f;
    int rec = -1;
    if (plane >= 0) {
      gy = gd;
      if constexpr (kAccum) {
#pragma unroll
        for (int k = 0; k < kNumPlanes; ++k)
          if (k == plane) gP[L::kPlaneY + k] -= gd;
      }
    } else if (row >= 0) {
      const float4 s = __ldg(tab.spheres + row);
      const float dx = px - s.x, dy = py - s.y, dz = pz - s.z;
      const float sc = gd / sqrtf((dx * dx + dy * dy) + dz * dz);
      gx = sc * dx;
      gy = sc * dy;
      gz = sc * dz;
      rec = row;
    }
    if constexpr (kAccum) {
      if (sink) sink->put(gd != 0.f ? rec : -1, -gx, -gy, -gz, -gd);
    }
    return d;
  }
};

// Threads per block: 8 x 16, so that a warp is an 8 x 4 tile of pixels
// whose rays stay close and visit mostly the same runs.
constexpr int kInstBlockX = 8;
constexpr int kInstBlockY = 16;

#ifdef __CUDACC__
// Index: what the Scene's search takes beyond the tables (GridScene's cell
// grid; nothing for the run walk).
template <class Cfg, class Scene, class... Index>
__global__ void __launch_bounds__(kInstBlockX * kInstBlockY)
    instanced_fwd_kernel(const float* __restrict__ cam_in,
                         const float* __restrict__ P, InstancedTables tab,
                         float* __restrict__ img, float* __restrict__ res,
                         int height, int full_height, int width, Index... index) {
  extern __shared__ float4 s_groups[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * tab.num_groups; i += blockDim.x * blockDim.y)
    s_groups[i] = tab.groups[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  float cam[kCamSize];
#pragma unroll
  for (int i = 0; i < kCamSize; ++i) cam[i] = __ldg(cam_in + i);
  const Scene scn(P, tab, s_groups, index...);
  // rows y of the launch are image rows cam[15] + y of full_height; the
  // residual planes are the launch's rows
  render_pixel<Cfg, Scene>(cam, scn, P, x, y, full_height, width, img, res,
                           (size_t)height * width);
  if constexpr (Scene::kStats) scn.flush();
}

template <class Cfg, class Scene, class... Index>
int launch_instanced_fwd(const float* cam, const float* fields,
                         const InstancedTables& tab, float* img, float* res,
                         int height, int full_height, int width,
                         cudaStream_t stream, Index... index) {
  const int smem = 2 * tab.num_groups * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        instanced_fwd_kernel<Cfg, Scene, Index...>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kInstBlockX, kInstBlockY);
  const dim3 grid((width + kInstBlockX - 1) / kInstBlockX,
                  (height + kInstBlockY - 1) / kInstBlockY);
  instanced_fwd_kernel<Cfg, Scene, Index...>
      <<<grid, block, smem, stream>>>(cam, fields, tab, img, res, height, full_height,
                                      width, index...);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
