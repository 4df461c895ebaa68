// lol_render_fused / lol_train_fwd on Hopper: the fused forward render, one
// thread per ray.
//
// Replaces `loltracer_tpu/render/pallas_train.py: _train_fwd_kernel`, with
// residuals off (the Pallas call named `lol_render_fused`) and on
// (`lol_train_fwd`). Per pixel it runs the camera ray, the sphere-trace
// march (with the closest-approach tracking of soft-coverage AA when
// Cfg::antialias), the material at the last query point, per light the
// shadow-origin offset and the soft-shadow march, tetrahedron normals,
// Phong shading, the AA blend and gamma. Output is [H, W, 3] f32.
//
// With Cfg::with_residuals it also writes the frozen numbers the backward
// (csrc/fused_bwd.cuh) re-attaches to, planar [4 + 2L, H, W] as JAX lays
// them out: t_sh, hit (1/0), material, the IFT denominator (the SDF's
// derivative along the ray at the marched t, from the generated adjoint
// Scene::dist_bwd, clamped away from zero) and per light the penumbra
// minimum res and its first-wins argmin t*. All of it sits under
// `if constexpr`, so the residuals-off instantiation does the same
// arithmetic in the same order and its image is bitwise the same.
//
// What bounds it on this card: FP32 and SFU issue (sqrt and divide in every
// SDF evaluation, up to 256 march steps plus 128 shadow steps per light)
// and warp divergence, not bytes: it reads ~100 scene floats once per
// thread and writes 12 B per ray. The TPU kernel marched (64, 128) tiles
// until the tile's worst lane finished; here each thread leaves its loop
// when its own ray is done, so a warp waits only for its own worst ray, and
// finished warps free their slots for others. A warp is a tile of 8 x 4
// pixels (tile_pixel), whose rays and shadow rays stay closer together than
// a row of 32's. Like the TPU kernel, it skips the shadow march of a ray
// that the Scene's segment bound (the generated Scene::segment_lit, under
// Cfg::shadow_cull) proves lit: the longest shadow marches walk all the
// way to the light, and the skipped lane's res = 1, t* = 0 are what its
// march would give.
//
// This file is not compiled on its own: render/cuda_scene.py emits, after
// it, the per-structure `Cfg` and `Scene` types (the straight-line SDF of
// the scene's structure, reading the scene's numbers from one packed f32
// buffer at generated offsets) and the extern "C" entry point. For
// instanced scenes the `Scene` is csrc/instanced_scene.cuh's traversal,
// and `lol_instanced_render` / `lol_instanced_fwd` launch render_pixel
// from there. The march and shadow loops (`march_ray`, `shadow_ray`) are
// also the value march kernels' (csrc/march.cuh), as the JAX package's
// `march_loop` / `shadow_loop` serve its fused and value kernels alike.
// render_pixel is a march half (`march_pixel`: camera ray, march, material,
// coverage) and a shade half (`shade_pixel`: normals, Phong with each
// light's shadow, blend, gamma); the regrouped instanced forward
// (csrc/regroup.cuh) runs the two halves in kernels of their own with the
// shadow marches between them.
//
// Arithmetic matches the plain PyTorch version op for op: the build passes
// --fmad=false, sums run ((x + y) + z), vectors are normalized by dividing
// by sqrtf, and min/max/clamp propagate NaN like torch.minimum/maximum.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <type_traits>

namespace lol {

// torch.minimum / torch.maximum semantics: NaN in either operand wins.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// Polynomial smooth-min, guarded at k == 0 (render/sdf.py smooth_min).
__device__ __forceinline__ float smooth_min(float a, float b, float k) {
  const bool zero_k = k == 0.f;
  const float safe_k = zero_k ? 1.f : k;
  float h = jclip(0.5f + 0.5f * (b - a) / safe_k, 0.f, 1.f);
  if (zero_k) h = (b > a) ? 1.f : 0.f;
  return (b + (a - b) * h) - k * h * (1.f - h);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// v / sqrt(max(|v|^2, 1e-30)) (render/vecmath.py normalize).
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = sqrtf(jmax(dot3(x, y, z, x, y, z), 1e-30f));
  x = x / n;
  y = y / n;
  z = z / n;
}

// Slack of the shadow segment cull's bound (the JAX package's
// pallas_scene.BOUND_MARGIN; render/shading.py BOUND_MARGIN): it absorbs the
// float32 rounding of the bound's short chains.
constexpr float kBoundMargin = 0.0625f;

// Distance from the point c to the segment so + t l, t in [0, T]
// (pallas_scene.ScalarScene._node_seg_bound's segdist; render/shading.py):
// the generated Scene::segment_lit bounds each sphere and box with it.
__device__ __forceinline__ float seg_dist(float cx, float cy, float cz, float sox, float soy,
                                          float soz, float lx, float ly, float lz, float T) {
  const float dx = cx - sox, dy = cy - soy, dz = cz - soz;
  const float proj = dx * lx + dy * ly + dz * lz;
  const float tcl = jclip(proj, 0.f, T);
  const float ex = dx - tcl * lx, ey = dy - tcl * ly, ez = dz - tcl * lz;
  return sqrtf(ex * ex + ey * ey + ez * ez);
}

// Whether render_pixel skips the shadow marches that the Scene's segment
// bound proves lit: Cfg::shadow_cull (cfg.shadow_cull, emitted for compiled
// structures) and Scene::kHasSegmentBound (the generated compiled Scene
// when its structure allows the bound). InstancedScene and GridScene have
// no such bound, so K5 / K5r / K9 march every shadow ray.
template <class Cfg, class Scene, class = void>
struct SegmentCull : std::false_type {};
template <class Cfg, class Scene>
struct SegmentCull<Cfg, Scene,
                   std::void_t<decltype(Cfg::shadow_cull), decltype(Scene::kHasSegmentBound)>>
    : std::integral_constant<bool, Cfg::shadow_cull && Scene::kHasSegmentBound> {};

// Camera pack layout (render/camera.py camera_pack):
// ro(3) right(3) up(3) fwd(3) half_w half_h pixel_rad row0.
constexpr int kCamSize = 16;

// Launch rows of a row table (render/camera.py launch_rows): the training
// kernels of compiled structures take one absolute image row per 8 launch
// rows, the instanced ones per 16 (a patch row, pallas_march.py P_H).
constexpr int kTrainRowBlock = 8;
constexpr int kPatchRowBlock = 16;

// The image rows of a launch: launch row y is image row cam[15] + y, or,
// under a row table (the row-sharded training step of parallel/sharded.py,
// whose shards own blocks of rows dealt over the image), tab[y / block] +
// y % block. Every term is a small exact integer in float32, so a table
// row0 + block * k gives the rows of cam[15] = row0 bitwise.
struct RowMap {
  const float* tab = nullptr;
  int block = 1;
};

__device__ __forceinline__ float image_row(const float* cam, int y, RowMap rows) {
  return rows.tab ? __ldg(rows.tab + y / rows.block) + (float)(y % rows.block)
                  : cam[15] + (float)y;
}

// Guard of the IFT denominator (loltracer_tpu/render/march.py _MIN_DEN).
constexpr float kMinDen = 1e-2f;

// The sphere-trace march of one ray from o along unit d (march.py march):
// the final t, the t of the last SDF evaluation, and with kTrackAA the
// angular closest approach min d/t over steps at t > 0 (first wins) and its
// t. The `break` is the plain loop's done-freezing for this ray. K1 and K5
// call it with kTrackAA = Cfg::antialias, the value march kernel K3
// (csrc/march.cuh) always tracks.
template <class Cfg, bool kTrackAA, class Scene>
__device__ __forceinline__ void march_ray(const Scene& scn, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float& t,
                                          float& t_query, float& s_min, float& t_close) {
  t = 0.f;
  t_query = 0.f;
  s_min = INFINITY;
  t_close = 0.f;
  for (int step = 0; step < Cfg::max_steps; ++step) {
    const float d = scn.dist(ox + t * dx, oy + t * dy, oz + t * dz);
    const float new_t = t + d;
    if (kTrackAA) {
      const float s = d / (t > 0.f ? t : 1.f);
      if (t > 0.f && s < s_min) {
        s_min = s;
        t_close = t;
      }
    }
    t_query = t;
    t = new_t;
    if (d < Cfg::epsilon || new_t > Cfg::max_dist) break;
  }
}

// The soft-shadow march of one ray (shading.py shadow_march) from the
// already offset origin so along the unit light direction l, up to
// max_dist: returns the penumbra minimum res and sets t_star to its
// first-wins argmin (`val < res`, NaN never wins). The first step has
// t == 0 and gives +/-inf; res < -1 is a hard shadow. Instanced scenes
// march shadows under their own step clamp (Scene::shadow_dist); a
// compiled Scene's shadow_dist is its dist. K1 and K5 (which drop t_star
// without residuals) and K4 call it.
template <class Cfg, class Scene>
__device__ __forceinline__ float shadow_ray(const Scene& scn, float sox, float soy, float soz,
                                            float lx, float ly, float lz, float max_dist,
                                            float& t_star) {
  float res = 1.f, ts = 0.f;
  t_star = 0.f;
  for (int step = 0; step < Cfg::shadow_steps; ++step) {
    const float d = scn.shadow_dist(sox + ts * lx, soy + ts * ly, soz + ts * lz);
    const float val =
        ts > 0.f ? Cfg::shadow_w * d / ts : (d < 0.f ? -INFINITY : INFINITY);
    if (val < res) t_star = ts;
    res = jmin(res, val);
    ts = ts + d;
    if (res < -1.f || ts > max_dist) break;
  }
  return res;
}

// The march half of one pixel's work: its camera ray, the march, and the
// shading distance, material and AA coverage that the shade half reads.
// render_pixel (K1, K5) runs both halves in one thread; the regrouped
// instanced forward (csrc/regroup.cuh) runs this half in lol_rg_march and
// the shade half in lol_rg_shade, over planes in between.
struct PixelMarch {
  float ox, oy, oz, dx, dy, dz;  // the camera ray
  float t_sh;                    // the shading distance
  float alpha;                   // AA coverage: 1 on a hit and without AA
  float den;                     // the IFT denominator (with residuals only)
  int mat;                       // material at the last query point
  bool hit;
};

// The camera ray of pixel (x, y) of a launch over an image `height` rows
// tall, whose launch row y is image row image_row(cam, y, rows)
// (camera.rays_from_rows).
__device__ __forceinline__ void camera_ray(const float* cam, int x, int y, int height,
                                           int width, PixelMarch& m, RowMap rows = {}) {
  m.ox = cam[0];
  m.oy = cam[1];
  m.oz = cam[2];
  const float vx = ((float)x + 0.5f) / (float)width * 2.f - 1.f;
  const float vy = 1.f - (image_row(cam, y, rows) + 0.5f) / (float)height * 2.f;
  const float sx = vx * cam[12], sy = vy * cam[13];
  m.dx = cam[3] * sx + cam[6] * sy + cam[9];
  m.dy = cam[4] * sx + cam[7] * sy + cam[10];
  m.dz = cam[5] * sx + cam[8] * sy + cam[11];
  normalize3(m.dx, m.dy, m.dz);
}

// Soft coverage of a miss from the SDF value f_close at its closest
// approach tc (march.py intersect_aa): 0 where it never tracked one.
__device__ __forceinline__ float coverage(const float* cam, float f_close, float tc) {
  const float s = f_close / (tc > 0.f ? tc : 1.f);
  return tc > 0.f ? jclip(1.f - s / cam[14], 0.f, 1.f) : 0.f;
}

template <class Cfg, class Scene>
__device__ __forceinline__ PixelMarch march_pixel(const float* cam, const Scene& scn, int x,
                                                  int y, int height, int width,
                                                  RowMap rows = {}) {
  PixelMarch m;
  camera_ray(cam, x, y, height, width, m, rows);
  const float ox = m.ox, oy = m.oy, oz = m.oz, dx = m.dx, dy = m.dy, dz = m.dz;

  // --- march (march.py march) -------------------------------------------
  float t, t_query, s_min, t_close;
  march_ray<Cfg, Cfg::antialias>(scn, ox, oy, oz, dx, dy, dz, t, t_query, s_min, t_close);
  m.hit = t < Cfg::max_dist;
  m.alpha = 1.f;
  if constexpr (Cfg::with_residuals) {
    // IFT denominator: d/dt f(ro + t rd) at the marched t = grad f . rd,
    // taken before the material lookup as the single-function body took
    // it (after it, K5r ran slower on the H100)
    float gx, gy, gz;
    scn.template dist_bwd<false>(ox + t * dx, oy + t * dy, oz + t * dz, 1.f, gx, gy, gz,
                                 nullptr);
    m.den = dot3(gx, gy, gz, dx, dy, dz);
    if (fabsf(m.den) < kMinDen) m.den = m.den < 0.f ? -kMinDen : kMinDen;
  }

  // --- shading distance, material, coverage (march.py intersect_aa) -----
  if (Cfg::antialias) {
    const float tc = m.hit ? t_query : t_close;
    float f_close;
    m.mat = scn.sdf_mat(ox + tc * dx, oy + tc * dy, oz + tc * dz, f_close);
    if (!m.hit) m.alpha = coverage(cam, f_close, tc);
    m.t_sh = m.hit ? t : tc;
  } else {
    float unused;
    m.mat = scn.sdf_mat(ox + t_query * dx, oy + t_query * dy, oz + t_query * dz, unused);
    if (!m.hit) m.mat = 0;
    m.t_sh = t;
  }
  return m;
}

// The shadow ray toward light l from the shading point p (shading.py
// phong): the unit direction l, the offset origin so and the distance from
// p to the light.
template <class Cfg, class Scene>
__device__ __forceinline__ void light_ray(const float* __restrict__ P, int l, float px,
                                          float py, float pz, float& lx, float& ly, float& lz,
                                          float& sox, float& soy, float& soz,
                                          float& light_dist) {
  const float* lp = P + Scene::kLightPoint + 3 * l;
  const float tlx = __ldg(lp) - px, tly = __ldg(lp + 1) - py, tlz = __ldg(lp + 2) - pz;
  light_dist = sqrtf(dot3(tlx, tly, tlz, tlx, tly, tlz));
  lx = tlx;
  ly = tly;
  lz = tlz;
  normalize3(lx, ly, lz);
  sox = px + lx * Cfg::shadow_offset;
  soy = py + ly * Cfg::shadow_offset;
  soz = pz + lz * Cfg::shadow_offset;
}

// The shade half of one pixel's work, from its march half m: tetrahedron
// normals, Phong with light l's penumbra res = shadow_of(l, sox, soy, soz,
// lx, ly, lz, light_dist), the AA blend and gamma, into pixel (x, y) of
// img [.., width, 3]. Its address is taken after the light loop, as the
// single-function body took it: a pointer live across the shadow marches
// made K5 slower on the H100 (two more live registers in a kernel that
// spills).
template <class Cfg, class Scene, class ShadowOf>
__device__ __forceinline__ void shade_pixel(const float* cam, const Scene& scn,
                                            const float* __restrict__ P, const PixelMarch& m,
                                            float* __restrict__ img, int x, int y, int width,
                                            const ShadowOf& shadow_of) {
  const float t_sh = m.t_sh;
  const int mat = m.mat;
  const float px = m.ox + t_sh * m.dx, py = m.oy + t_sh * m.dy, pz = m.oz + t_sh * m.dz;

  // --- tetrahedron normal (shading.py get_normal) -----------------------
  const float h = t_sh * Cfg::normal_h_scale;
  float nx = 0.f, ny = 0.f, nz = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // taps (1,-1,-1), (-1,-1,1), (-1,1,-1), (1,1,1)
    const float kx = (k == 0 || k == 3) ? 1.f : -1.f;
    const float ky = (k >= 2) ? 1.f : -1.f;
    const float kz = (k == 1 || k == 3) ? 1.f : -1.f;
    const float d = scn.dist(px + kx * h, py + ky * h, pz + kz * h);
    nx = nx + kx * d;
    ny = ny + ky * d;
    nz = nz + kz * d;
  }
  normalize3(nx, ny, nz);

  // --- Phong with per-light soft shadows (shading.py shade) -------------
  const float shin = __ldg(P + Scene::kMatShininess + mat);
  float dif[3], spec[3], amb[3], col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dif[c] = __ldg(P + Scene::kMatDiffuse + 3 * mat + c);
    spec[c] = __ldg(P + Scene::kMatSpecular + 3 * mat + c);
    amb[c] = __ldg(P + Scene::kMatAmbient + 3 * mat + c);
    col[c] = 0.f;
  }
  float cx = cam[0] - px, cy = cam[1] - py, cz = cam[2] - pz;
  normalize3(cx, cy, cz);

#pragma unroll
  for (int l = 0; l < Scene::kNumLights; ++l) {
    float lx, ly, lz, sox, soy, soz, light_dist;
    light_ray<Cfg, Scene>(P, l, px, py, pz, lx, ly, lz, sox, soy, soz, light_dist);
    const float shadow = jmax(shadow_of(l, sox, soy, soz, lx, ly, lz, light_dist), 0.f);

    const float ndl = dot3(nx, ny, nz, lx, ly, lz);
    const float diffuse_incidence = jclip(ndl, 0.f, 1.f);
    const float w_diff = shadow * diffuse_incidence;
    const float two_ldn = 2.f * dot3(lx, ly, lz, nx, ny, nz);
    const float rx = nx * two_ldn - lx, ry = ny * two_ldn - ly,
                rz = nz * two_ldn - lz;
    const float base = jclip(dot3(rx, ry, rz, cx, cy, cz), 0.f, 1.f);
    const float powv = base > 0.f ? powf(base, shin) : (shin == 0.f ? 1.f : 0.f);
    const float w_spec = shadow * (diffuse_incidence * powv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[c] = col[c] + __ldg(P + Scene::kLightDiffuse + 3 * l + c) * w_diff * dif[c];
      col[c] = col[c] + __ldg(P + Scene::kLightSpecular + 3 * l + c) * w_spec * spec[c];
    }
  }

  float* out = img + ((size_t)y * width + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ambient = __ldg(P + Scene::kAmbientColor + c);
    float v = jclip(col[c] + ambient * amb[c], 0.f, 1.f);
    if (Cfg::antialias) {
      // blend toward the background (material 0 ambient) in linear space
      const float bg = jclip(ambient * __ldg(P + Scene::kMatAmbient + c), 0.f, 1.f);
      v = m.alpha * v + (1.f - m.alpha) * bg;
    }
    out[c] = v > 0.f ? powf(v, Cfg::gamma) : 0.f;
  }
}

// One pixel (x, y) of the image: the march half, then the shade half with
// each light's shadow march run here; with Cfg::with_residuals also its
// residual planes (res_out points at plane 0, pixel (0, 0); planes are
// `plane` floats apart: the launch's rows times W).
template <class Cfg, class Scene>
__device__ __forceinline__ void render_pixel(const float* cam, const Scene& scn,
                                             const float* __restrict__ P, int x,
                                             int y, int height, int width,
                                             float* __restrict__ img,
                                             float* __restrict__ res_out,
                                             size_t plane, RowMap rows = {}) {
  [[maybe_unused]] float* const rp =
      Cfg::with_residuals ? res_out + ((size_t)y * width + x) : nullptr;
  const PixelMarch m = march_pixel<Cfg>(cam, scn, x, y, height, width, rows);

  if constexpr (Cfg::with_residuals) {
    rp[3 * plane] = m.den;
    rp[0] = m.t_sh;
    rp[plane] = m.hit ? 1.f : 0.f;
    rp[2 * plane] = (float)m.mat;
  }

  // soft-shadow march (shading.py soft_shadow); a ray the segment bound
  // proves lit keeps res = 1 and t* = 0, what its march gives it (the JAX
  // kernel's init_done lanes)
  const auto shadow_of = [&](int l, float sox, float soy, float soz, float lx, float ly,
                             float lz, float light_dist) {
    if constexpr (SegmentCull<Cfg, Scene>::value) {
      if (scn.segment_lit(sox, soy, soz, lx, ly, lz, light_dist)) {
        if constexpr (Cfg::with_residuals) {
          rp[(4 + 2 * l) * plane] = 1.f;
          rp[(5 + 2 * l) * plane] = 0.f;
        }
        return 1.f;
      }
    }
    float t_star;
    const float res = shadow_ray<Cfg>(scn, sox, soy, soz, lx, ly, lz, light_dist, t_star);
    if constexpr (Cfg::with_residuals) {
      rp[(4 + 2 * l) * plane] = res;
      rp[(5 + 2 * l) * plane] = t_star;
    }
    return res;
  };
  shade_pixel<Cfg>(cam, scn, P, m, img, x, y, width, shadow_of);
}

// A block is 256 threads over 32 x 8 pixels; each warp of it takes a tile
// of kTileW x (32 / kTileW) pixels: kTileW = 32 is a row of 32, 8 a tile of
// 8 x 4 (K5's warp). kFwdTileW is the shape the entries launch.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kFwdTileW = 8;

// Pixel (x, y) of this thread: warp w of the block takes tile (w % (32 /
// kTileW), w / (32 / kTileW)) of the block's 32 x 8 pixels, lane i pixel
// (i % kTileW, i / kTileW) of that tile.
template <int kTileW>
__device__ __forceinline__ void tile_pixel(int bx, int by, int tid, int& x, int& y) {
  static_assert(32 % kTileW == 0 && kBlockX % kTileW == 0 && kBlockY * kTileW % 32 == 0,
                "the block's warps must tile its 32 x 8 pixels");
  static_assert(kTrainRowBlock % (32 / kTileW) == 0 && kTrainRowBlock % kBlockY == 0,
                "a warp tile and a block must not straddle two blocks of a row table");
  constexpr int kTileH = 32 / kTileW, kTilesX = kBlockX / kTileW;
  const int lane = tid & 31, warp = tid >> 5;
  x = bx * kBlockX + (warp % kTilesX) * kTileW + lane % kTileW;
  y = by * kBlockY + (warp / kTilesX) * kTileH + lane / kTileW;
}

#ifdef __CUDACC__
template <class Cfg, class Scene, int kTileW>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    fused_fwd_kernel(const float* __restrict__ cam_in,
                     const float* __restrict__ P, float* __restrict__ img,
                     float* __restrict__ res, int height, int full_height, int width,
                     const float* __restrict__ rowtab) {
  int x, y;
  tile_pixel<kTileW>(blockIdx.x, blockIdx.y, threadIdx.y * blockDim.x + threadIdx.x, x, y);
  if (x >= width || y >= height) return;

  float cam[kCamSize];
#pragma unroll
  for (int i = 0; i < kCamSize; ++i) cam[i] = __ldg(cam_in + i);
  const Scene scn(P);
  // the launch's `height` rows are rows of an image `full_height` tall; the
  // residual planes are the launch's rows
  render_pixel<Cfg, Scene>(cam, scn, P, x, y, full_height, width, img, res,
                           (size_t)height * width, RowMap{rowtab, kTrainRowBlock});
}

// rowtab: nullptr (launch row y is image row cam[15] + y) or one image row
// per kTrainRowBlock launch rows (RowMap).
template <class Cfg, class Scene, int kTileW = kFwdTileW>
int launch_fused_fwd(const float* cam, const float* fields, float* img,
                     float* res, int height, int full_height, int width,
                     const float* rowtab, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  fused_fwd_kernel<Cfg, Scene, kTileW>
      <<<grid, block, 0, stream>>>(cam, fields, img, res, height, full_height, width, rowtab);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
