// lol_train_bwd on Hopper: the backward of the fused training render.
//
// Replaces `loltracer_tpu/render/pallas_train.py: _train_bwd_kernel` (the
// Pallas call `lol_train_bwd`). It never marches: per pixel it re-runs the
// differentiable re-attachment `_shade_from_frozen` (pallas_train.py:190-343)
// at the residuals lol_train_fwd saved — one SDF evaluation at the shading
// distance (IFT numerator on hits, coverage alpha on AA misses), four normal
// taps, one evaluation per light at the penumbra argmin t* — and runs its
// reverse pass, written out by hand here, into per-thread accumulators for
// the 16 camera-pack scalars and every scalar of the packed field buffer.
// The TPU kernel takes `jax.vjp` inside the kernel; the SDF's adjoint is
// generated per structure as `Scene::dist_bwd` (render/cuda_scene.py).
//
// Gradient semantics are JAX's: stop-gradients at the frozen miss point, the
// frozen t_sh of AA misses and the frozen t*; the Danskin term only for
// interior penumbra minima (t* > 0, 0 < res0 < 1); pow and gamma
// differentiated only at positive bases; the material gradient only to the
// pixel's own material, plus material 0's ambient through the AA blend.
//
// The TPU kernel sums over a sequential grid. Here blocks run in no order,
// so the sum is deterministic by construction instead: each thread adds its
// pixels' gradients, in the order of its tiles, into its own column of a
// [slot][thread] array in shared memory; each block reduces its 128 threads
// in a fixed order (warp shuffles, then its 4 warps through shared memory)
// into one row of partials [blocks, 16 + fields]; and a second launch
// (lol_train_bwd_reduce) sums each column over the blocks in a fixed order.
// The grid is a fixed number of blocks (at most kBwdMaxBlocks) striding over
// 32 x 4 pixel tiles, so a block reduces once and the reduce reads a few
// hundred rows. No float atomics: two launches give bitwise equal gradients.
//
// What bounds it on this card: FP32 and SFU issue of 1 + 4 + L SDF
// evaluations, each forward plus reverse, with IEEE sqrt and divides in
// each, per pixel, and the latency of those chains at few warps a SM. The
// 16 + fields accumulators a thread (92 for scene4) held in registers
// spilled at 255 registers with 8 warps a SM. In shared memory, [slot]
// [thread], an update is a load and a store (a warp's lanes touch 32
// consecutive words: no bank conflict), and with the taps' loops rolled the
// rest fits 128 registers without spills: 4 blocks of 4 warps a SM, the
// most the accumulators' 47 KB a block allow for scene4. Bytes are small:
// (4 + 2L + 3) floats read per pixel and 4 * (16 + fields) bytes written
// per block.
//
// Not compiled on its own: render/cuda_scene.py emits it after
// csrc/fused_fwd.cuh and before the generated Cfg and Scene.

namespace lol {

// --- adjoint helpers used by the generated Scene::dist_bwd ----------------

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// torch.minimum / torch.maximum: the smaller (larger) operand takes the
// cotangent; a tie splits it in half.
__device__ __forceinline__ void min_bwd(float a, float b, float g, float& ga,
                                        float& gb) {
  ga = a < b ? g : (a == b ? 0.5f * g : 0.f);
  gb = b < a ? g : (a == b ? 0.5f * g : 0.f);
}
__device__ __forceinline__ void max_bwd(float a, float b, float g, float& ga,
                                        float& gb) {
  ga = a > b ? g : (a == b ? 0.5f * g : 0.f);
  gb = b > a ? g : (a == b ? 0.5f * g : 0.f);
}

// d/dv of clip(v, 0, 1) = min(max(v, 0), 1) as jnp.clip and torch.minimum /
// maximum differentiate it: 1 inside, 1/2 on a bound (the tie of max or min
// splits the cotangent), 0 outside. A bound is hit exactly where a clipped
// product of constants is 0, e.g. the AA background of a black material 0.
__device__ __forceinline__ float clip01_grad(float v) {
  return (v > 0.f && v < 1.f) ? 1.f : ((v == 0.f || v == 1.f) ? 0.5f : 0.f);
}

// Reverse of smooth_min(a, b, k) (csrc/fused_fwd.cuh); the clamp of h
// differentiates as clip01_grad.
__device__ __forceinline__ void smooth_min_bwd(float a, float b, float k,
                                               float g, float& ga, float& gb,
                                               float& gk) {
  const bool zero_k = k == 0.f;
  const float safe_k = zero_k ? 1.f : k;
  const float u = 0.5f + 0.5f * (b - a) / safe_k;
  float h = jclip(u, 0.f, 1.f);
  if (zero_k) h = (b > a) ? 1.f : 0.f;
  // r = (b + (a - b) h) - k h (1 - h)
  ga = g * h;
  gb = g * (1.f - h);
  gk = -(g * (h * (1.f - h)));
  const float du = zero_k ? 0.f : clip01_grad(u);
  if (du != 0.f) {
    const float gh = g * ((a - b) - k * (1.f - 2.f * h)) * du;
    const float gu = gh * 0.5f / safe_k;
    ga = ga - gu;
    gb = gb + gu;
    gk = gk - gh * (0.5f * (b - a)) / (k * k);
  }
}

// Reverse of a box's inside term min(max(qx, max(qy, qz)), 0), added to gq.
__device__ __forceinline__ void box_inside_bwd(float qx, float qy, float qz,
                                               float g, float (&gq)[3]) {
  const float myz = jmax(qy, qz);
  const float m = jmax(qx, myz);
  float gm, g0, gyz, gx, gy, gz;
  min_bwd(m, 0.f, g, gm, g0);
  max_bwd(qx, myz, gm, gx, gyz);
  max_bwd(qy, qz, gyz, gy, gz);
  gq[0] += gx;
  gq[1] += gy;
  gq[2] += gz;
}

// Reverse of normalize3: the cotangent (gx, gy, gz) of v / |v| taken to v,
// added to (ox, oy, oz). Below the 1e-30 clamp the norm is a constant.
__device__ __forceinline__ void normalize3_bwd(float x, float y, float z,
                                               float gx, float gy, float gz,
                                               float& ox, float& oy,
                                               float& oz) {
  const float n2 = dot3(x, y, z, x, y, z);
  const float n = sqrtf(jmax(n2, 1e-30f));
  float px = gx, py = gy, pz = gz;
  if (n2 > 1e-30f) {
    const float ux = x / n, uy = y / n, uz = z / n;
    const float gu = dot3(gx, gy, gz, ux, uy, uz);
    px = gx - ux * gu;
    py = gy - uy * gu;
    pz = gz - uz * gu;
  }
  ox += px / n;
  oy += py / n;
  oz += pz / n;
}

// --- one pixel: recompute _shade_from_frozen, then its reverse -------------

// acc[0..15] takes d/dcam, acc[16 + i] d/dfields[i]: a float array of the
// thread's own (K6), or K2's StridedAcc over shared memory. r points at the
// pixel's residual plane 0 (planes H*W apart); ct at its 3 cotangents.
// kRolled keeps the two loops over the normal taps rolled (K2: one copy of
// the taps' SDF and SDF adjoint in the code, and no spill at its 128
// registers); K6 unrolls them.
template <class Cfg, class Scene, bool kRolled = false, class Acc>
__device__ __forceinline__ void pixel_bwd(const float* cam, const Scene& scn,
                                          const float* __restrict__ P, int x,
                                          int y, int height, int width,
                                          const float* __restrict__ r,
                                          size_t plane,
                                          const float* __restrict__ ct,
                                          Acc acc, RowMap rows = {}) {
  constexpr int L = Scene::kNumLights;
  constexpr int M = Scene::kNumMaterials;
  const auto gP = acc + kCamSize;

  const float t_sh = __ldg(r);
  const bool hit = __ldg(r + plane) > 0.5f;
  const float mat_f = __ldg(r + 2 * plane);
  const float den = __ldg(r + 3 * plane);
  int mat = 0;  // pallas_train msel: ids outside 1..M-1 select material 0
#pragma unroll
  for (int m = 1; m < M; ++m)
    if (mat_f == (float)m) mat = m;

  // --- forward ------------------------------------------------------------
  const float ox = cam[0], oy = cam[1], oz = cam[2];
  const float vx = ((float)x + 0.5f) / (float)width * 2.f - 1.f;
  const float vy = 1.f - (image_row(cam, y, rows) + 0.5f) / (float)height * 2.f;
  const float sx = vx * cam[12], sy = vy * cam[13];
  const float rx = cam[3] * sx + cam[6] * sy + cam[9];
  const float ry = cam[4] * sx + cam[7] * sy + cam[10];
  const float rz = cam[5] * sx + cam[8] * sy + cam[11];
  float dx = rx, dy = ry, dz = rz;
  normalize3(dx, dy, dz);

  // value of t_shade: the re-attachment adds (corr - sg(corr)) == 0
  const float px = ox + t_sh * dx, py = oy + t_sh * dy, pz = oz + t_sh * dz;
  float alpha = 1.f, s_aa = 0.f, safe_tc = 1.f;
  float g_alpha_pre = 0.f;  // d alpha / d (1 - s / pixel_rad)
  if (Cfg::antialias && !hit) {
    const float f_at = scn.dist(px, py, pz);
    safe_tc = t_sh > 0.f ? t_sh : 1.f;
    s_aa = f_at / safe_tc;
    const float pre = 1.f - s_aa / cam[14];
    alpha = t_sh > 0.f ? jclip(pre, 0.f, 1.f) : 0.f;
    g_alpha_pre = t_sh > 0.f ? clip01_grad(pre) : 0.f;
  }

  const float h = t_sh * Cfg::normal_h_scale;
  float nrx = 0.f, nry = 0.f, nrz = 0.f;
#pragma unroll(kRolled ? 1 : 4)
  for (int k = 0; k < 4; ++k) {
    const float kx = (k == 0 || k == 3) ? 1.f : -1.f;
    const float ky = (k >= 2) ? 1.f : -1.f;
    const float kz = (k == 1 || k == 3) ? 1.f : -1.f;
    const float d = scn.dist(px + kx * h, py + ky * h, pz + kz * h);
    nrx = nrx + kx * d;
    nry = nry + ky * d;
    nrz = nrz + kz * d;
  }
  float nx = nrx, ny = nry, nz = nrz;
  normalize3(nx, ny, nz);

  const float shin = __ldg(P + Scene::kMatShininess + mat);
  float dif[3], spec[3], amb[3], col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dif[c] = __ldg(P + Scene::kMatDiffuse + 3 * mat + c);
    spec[c] = __ldg(P + Scene::kMatSpecular + 3 * mat + c);
    amb[c] = __ldg(P + Scene::kMatAmbient + 3 * mat + c);
    col[c] = 0.f;
  }
  const float crx = cam[0] - px, cry = cam[1] - py, crz = cam[2] - pz;
  float cx = crx, cy = cry, cz = crz;
  normalize3(cx, cy, cz);

  // per-light values; the shadow's value is the frozen res0
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float* lp = P + Scene::kLightPoint + 3 * l;
    float lx = __ldg(lp) - px, ly = __ldg(lp + 1) - py, lz = __ldg(lp + 2) - pz;
    normalize3(lx, ly, lz);
    const float shadow = jmax(__ldg(r + (4 + 2 * l) * plane), 0.f);
    const float ndl = dot3(nx, ny, nz, lx, ly, lz);
    const float di = jclip(ndl, 0.f, 1.f);
    const float w_diff = shadow * di;
    const float two_ldn = 2.f * dot3(lx, ly, lz, nx, ny, nz);
    const float base = jclip(dot3(nx * two_ldn - lx, ny * two_ldn - ly,
                                  nz * two_ldn - lz, cx, cy, cz),
                             0.f, 1.f);
    const float powv = base > 0.f ? powf(base, shin) : (shin == 0.f ? 1.f : 0.f);
    const float w_spec = shadow * (di * powv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[c] = col[c] + __ldg(P + Scene::kLightDiffuse + 3 * l + c) * w_diff * dif[c];
      col[c] = col[c] + __ldg(P + Scene::kLightSpecular + 3 * l + c) * w_spec * spec[c];
    }
  }

  // --- reverse: gamma, AA blend, clamp, ambient -----------------------------
  float g_col[3], g_amb[3], g_alpha = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ambc = __ldg(P + Scene::kAmbientColor + c);
    const float pre = col[c] + ambc * amb[c];
    const float v = jclip(pre, 0.f, 1.f);
    float blended = v, bg = 0.f;
    if (Cfg::antialias) {
      bg = jclip(ambc * __ldg(P + Scene::kMatAmbient + c), 0.f, 1.f);
      blended = alpha * v + (1.f - alpha) * bg;
    }
    // out = exp(gamma log c) for c > 0, else 0
    const float g_bl =
        blended > 0.f
            ? __ldg(ct + c) * (Cfg::gamma * powf(blended, Cfg::gamma) / blended)
            : 0.f;
    float g_v = g_bl;
    if (Cfg::antialias) {
      g_alpha += g_bl * (v - bg);
      g_v = g_bl * alpha;
      const float g_bg = g_bl * (1.f - alpha);
      const float m0 = __ldg(P + Scene::kMatAmbient + c);
      const float g_bgp = g_bg * clip01_grad(ambc * m0);
      gP[Scene::kAmbientColor + c] += g_bgp * m0;
      gP[Scene::kMatAmbient + c] += g_bgp * ambc;
    }
    const float g_pre = g_v * clip01_grad(pre);
    g_col[c] = g_pre;
    gP[Scene::kAmbientColor + c] += g_pre * amb[c];
    g_amb[c] = g_pre * ambc;
  }

  // --- reverse: per light (values recomputed) -------------------------------
  float g_px = 0.f, g_py = 0.f, g_pz = 0.f;
  float g_nx = 0.f, g_ny = 0.f, g_nz = 0.f;
  float g_cx = 0.f, g_cy = 0.f, g_cz = 0.f;
  float g_shin = 0.f, g_dif[3] = {0.f, 0.f, 0.f}, g_spec[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float* lp = P + Scene::kLightPoint + 3 * l;
    const float tlx = __ldg(lp) - px, tly = __ldg(lp + 1) - py,
                tlz = __ldg(lp + 2) - pz;
    float lx = tlx, ly = tly, lz = tlz;
    normalize3(lx, ly, lz);
    const float res0 = __ldg(r + (4 + 2 * l) * plane);
    const float t_star = __ldg(r + (5 + 2 * l) * plane);
    const float shadow = jmax(res0, 0.f);
    const float ndl = dot3(nx, ny, nz, lx, ly, lz);
    const float di = jclip(ndl, 0.f, 1.f);
    const float w_diff = shadow * di;
    const float two_ldn = 2.f * dot3(lx, ly, lz, nx, ny, nz);
    const float fx = nx * two_ldn - lx, fy = ny * two_ldn - ly,
                fz = nz * two_ldn - lz;
    const float base_pre = dot3(fx, fy, fz, cx, cy, cz);
    const float base = jclip(base_pre, 0.f, 1.f);
    const float powv = base > 0.f ? powf(base, shin) : (shin == 0.f ? 1.f : 0.f);
    const float w_spec = shadow * (di * powv);

    float g_wd = 0.f, g_ws = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ldc = __ldg(P + Scene::kLightDiffuse + 3 * l + c);
      const float lsc = __ldg(P + Scene::kLightSpecular + 3 * l + c);
      g_wd += g_col[c] * ldc * dif[c];
      g_ws += g_col[c] * lsc * spec[c];
      gP[Scene::kLightDiffuse + 3 * l + c] += g_col[c] * w_diff * dif[c];
      gP[Scene::kLightSpecular + 3 * l + c] += g_col[c] * w_spec * spec[c];
      g_dif[c] += g_col[c] * ldc * w_diff;
      g_spec[c] += g_col[c] * lsc * w_spec;
    }
    // w_spec = shadow (di powv), w_diff = shadow di
    const float g_shadow = g_ws * (di * powv) + g_wd * di;
    const float g_di = g_ws * shadow * powv + g_wd * shadow;
    const float g_pow = g_ws * shadow * di;
    float g_base = 0.f;
    if (base > 0.f) {  // powv = exp(shin log base)
      g_shin += g_pow * powv * logf(base);
      g_base = g_pow * powv * shin / base;
    }
    float g_lx = 0.f, g_ly = 0.f, g_lz = 0.f;
    g_base = g_base * clip01_grad(base_pre);
    if (g_base != 0.f) {
      // base = f . c,  f = n two_ldn - l,  two_ldn = 2 (l . n)
      g_cx += g_base * fx;
      g_cy += g_base * fy;
      g_cz += g_base * fz;
      const float gfx = g_base * cx, gfy = g_base * cy, gfz = g_base * cz;
      const float g_two = dot3(gfx, gfy, gfz, nx, ny, nz);
      g_nx += gfx * two_ldn + 2.f * g_two * lx;
      g_ny += gfy * two_ldn + 2.f * g_two * ly;
      g_nz += gfz * two_ldn + 2.f * g_two * lz;
      g_lx += 2.f * g_two * nx - gfx;
      g_ly += 2.f * g_two * ny - gfy;
      g_lz += 2.f * g_two * nz - gfz;
    }
    const float g_ndl = g_di * clip01_grad(ndl);  // di = clip(n . l)
    g_nx += g_ndl * lx;
    g_ny += g_ndl * ly;
    g_nz += g_ndl * lz;
    g_lx += g_ndl * nx;
    g_ly += g_ndl * ny;
    g_lz += g_ndl * nz;
    // Danskin re-attachment: res = res0 + (val - sg(val)), val = w d(q) / t*
    // with q = p + l (offset + t*); shadow = max(res, 0)
    if (t_star > 0.f && res0 > 0.f && res0 < 1.f && g_shadow != 0.f) {
      const float sox = px + lx * Cfg::shadow_offset;
      const float soy = py + ly * Cfg::shadow_offset;
      const float soz = pz + lz * Cfg::shadow_offset;
      float gqx, gqy, gqz;
      scn.template dist_bwd<true>(sox + t_star * lx, soy + t_star * ly,
                                  soz + t_star * lz,
                                  g_shadow * Cfg::shadow_w / t_star, gqx, gqy,
                                  gqz, gP);
      g_px += gqx;
      g_py += gqy;
      g_pz += gqz;
      g_lx += gqx * t_star + gqx * Cfg::shadow_offset;
      g_ly += gqy * t_star + gqy * Cfg::shadow_offset;
      g_lz += gqz * t_star + gqz * Cfg::shadow_offset;
    }
    float g_tlx = 0.f, g_tly = 0.f, g_tlz = 0.f;
    normalize3_bwd(tlx, tly, tlz, g_lx, g_ly, g_lz, g_tlx, g_tly, g_tlz);
    gP[Scene::kLightPoint + 3 * l] += g_tlx;
    gP[Scene::kLightPoint + 3 * l + 1] += g_tly;
    gP[Scene::kLightPoint + 3 * l + 2] += g_tlz;
    g_px -= g_tlx;
    g_py -= g_tly;
    g_pz -= g_tlz;
  }

  // --- reverse: material (only the pixel's own) -----------------------------
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m == mat) {
      gP[Scene::kMatShininess + m] += g_shin;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gP[Scene::kMatDiffuse + 3 * m + c] += g_dif[c];
        gP[Scene::kMatSpecular + 3 * m + c] += g_spec[c];
        gP[Scene::kMatAmbient + 3 * m + c] += g_amb[c];
      }
    }
  }

  // --- reverse: camera direction, normal, taps --------------------------------
  float g_crx = 0.f, g_cry = 0.f, g_crz = 0.f;
  normalize3_bwd(crx, cry, crz, g_cx, g_cy, g_cz, g_crx, g_cry, g_crz);
  acc[0] += g_crx;
  acc[1] += g_cry;
  acc[2] += g_crz;
  g_px -= g_crx;
  g_py -= g_cry;
  g_pz -= g_crz;

  float g_nrx = 0.f, g_nry = 0.f, g_nrz = 0.f;
  normalize3_bwd(nrx, nry, nrz, g_nx, g_ny, g_nz, g_nrx, g_nry, g_nrz);
  float g_h = 0.f;
#pragma unroll(kRolled ? 1 : 4)
  for (int k = 0; k < 4; ++k) {
    const float kx = (k == 0 || k == 3) ? 1.f : -1.f;
    const float ky = (k >= 2) ? 1.f : -1.f;
    const float kz = (k == 1 || k == 3) ? 1.f : -1.f;
    const float g_d = kx * g_nrx + ky * g_nry + kz * g_nrz;
    float gqx, gqy, gqz;
    scn.template dist_bwd<true>(px + kx * h, py + ky * h, pz + kz * h, g_d, gqx,
                                gqy, gqz, gP);
    g_px += gqx;
    g_py += gqy;
    g_pz += gqz;
    g_h += kx * gqx + ky * gqy + kz * gqz;
  }

  // --- reverse: p = o + t_shade d, t_shade = t_sh + (corr - sg(corr)) -------
  float g_t = g_h * Cfg::normal_h_scale + dot3(g_px, g_py, g_pz, dx, dy, dz);
  acc[0] += g_px;
  acc[1] += g_py;
  acc[2] += g_pz;
  float g_dx = g_px * t_sh, g_dy = g_py * t_sh, g_dz = g_pz * t_sh;

  // f_at = dist(o + t_sh d): the IFT numerator on hits (corr = -f_at / den),
  // the coverage numerator on AA misses (point frozen, s = f_at / t_sh)
  float g_fat = 0.f;
  if (hit) {
    g_fat = -g_t / den;
  } else if (Cfg::antialias && g_alpha_pre != 0.f) {
    g_alpha = g_alpha * g_alpha_pre;
    const float g_s = -g_alpha / cam[14];
    acc[14] += g_alpha * (s_aa / cam[14]) / cam[14];
    g_fat = g_s / safe_tc;
  }
  if (g_fat != 0.f) {
    float gqx, gqy, gqz;
    scn.template dist_bwd<true>(px, py, pz, g_fat, gqx, gqy, gqz, gP);
    if (hit) {
      acc[0] += gqx;
      acc[1] += gqy;
      acc[2] += gqz;
      g_dx += gqx * t_sh;
      g_dy += gqy * t_sh;
      g_dz += gqz * t_sh;
    }
  }

  // --- reverse: the ray --------------------------------------------------------
  float g_rx = 0.f, g_ry = 0.f, g_rz = 0.f;
  normalize3_bwd(rx, ry, rz, g_dx, g_dy, g_dz, g_rx, g_ry, g_rz);
  acc[3] += g_rx * sx;
  acc[4] += g_ry * sx;
  acc[5] += g_rz * sx;
  acc[6] += g_rx * sy;
  acc[7] += g_ry * sy;
  acc[8] += g_rz * sy;
  acc[9] += g_rx;
  acc[10] += g_ry;
  acc[11] += g_rz;
  const float g_sx = dot3(g_rx, g_ry, g_rz, cam[3], cam[4], cam[5]);
  const float g_sy = dot3(g_rx, g_ry, g_rz, cam[6], cam[7], cam[8]);
  acc[12] += g_sx * vx;
  acc[13] += g_sy * vy;
  // vy = 1 - ((row0 + y) + 0.5) / H * 2; under a row table the row is the
  // table's and cam[15] has no cotangent (JAX's kernels read no cam[15])
  if (!rows.tab) acc[15] += -(g_sy * cam[13]) / (float)height * 2.f;
}

// --- lol_train_bwd: accumulators in shared memory, a few blocks a SM ------

// One thread's accumulator slots, a column of a [slot][thread] array in
// shared memory: slot k of thread t sits at k * kStride + t, so a warp
// touching one slot hits 32 consecutive words (no bank conflict), and each
// thread reads and writes only its own column (no atomics). pixel_bwd and
// the generated Scene::dist_bwd index it with constant slots, as a float
// array.
template <int kStride>
struct StridedAcc {
  float* col;
  __device__ __forceinline__ float& operator[](int slot) const { return col[slot * kStride]; }
  __device__ __forceinline__ StridedAcc operator+(int slots) const {
    return {col + slots * kStride};
  }
};

// A block is 128 threads, one pixel each of a 32 x 4 tile (a warp a row),
// and walks the tiles b, b + B, b + 2B, ... of the image (B blocks, at
// most kBwdMaxBlocks: four a SM of the H100's 132, a fixed number, so the
// order of the sums is the same on any card). Its partial sums are
// reduced once, after its last tile.
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdTileW = 32;
constexpr int kBwdTileH = kBwdThreads / kBwdTileW;
constexpr int kBwdMaxBlocks = 528;
constexpr int kBwdMinBlocks = 4;  // resident blocks a SM that ptxas must allow
static_assert(kTrainRowBlock % kBwdTileH == 0,
              "a tile must not straddle two blocks of a row table");

__host__ __device__ inline int bwd_num_tiles(int height, int width) {
  return ((width + kBwdTileW - 1) / kBwdTileW) * ((height + kBwdTileH - 1) / kBwdTileH);
}

__host__ __device__ inline int bwd_num_blocks(int height, int width) {
  const int tiles = bwd_num_tiles(height, width);
  return tiles < kBwdMaxBlocks ? tiles : kBwdMaxBlocks;
}

// Thread `tid` of block `block` of `blocks`: pixel_bwd of its pixel of each
// of the block's tiles, in order, into acc. The launch's `height` rows are
// rows of an image `full_height` tall (RowMap `rows`).
template <class Cfg, class Scene, class Acc>
__device__ __forceinline__ void bwd_pixels(const float* cam, const Scene& scn,
                                           const float* __restrict__ P,
                                           const float* __restrict__ res,
                                           const float* __restrict__ ct, int block, int blocks,
                                           int tid, int height, int full_height, int width,
                                           Acc acc, RowMap rows) {
  const int tiles_x = (width + kBwdTileW - 1) / kBwdTileW;
  const int tiles = bwd_num_tiles(height, width);
  const size_t plane = (size_t)height * width;
  for (int tile = block; tile < tiles; tile += blocks) {
    const int x = (tile % tiles_x) * kBwdTileW + tid % kBwdTileW;
    const int y = (tile / tiles_x) * kBwdTileH + tid / kBwdTileW;
    if (x < width && y < height) {
      const size_t pix = (size_t)y * width + x;
      pixel_bwd<Cfg, Scene, true>(cam, scn, P, x, y, full_height, width, res + pix, plane,
                                  ct + 3 * pix, acc, rows);
    }
  }
}

// Thread `tid` of block `block`: its accumulators (the column at col of
// the block's [slot][thread] array, zeroed here) over its pixels; on
// return the column holds every slot's sum.
template <class Cfg, class Scene>
__device__ __forceinline__ void bwd_thread(const float* cam, const Scene& scn,
                                           const float* __restrict__ P,
                                           const float* __restrict__ res,
                                           const float* __restrict__ ct, int block, int blocks,
                                           int tid, int height, int full_height, int width,
                                           float* col, RowMap rows = {}) {
  constexpr int N = kCamSize + Scene::kNumFields;
  for (int j = 0; j < N; ++j) col[j * kBwdThreads] = 0.f;
  bwd_pixels<Cfg, Scene>(cam, scn, P, res, ct, block, blocks, tid, height, full_height, width,
                         StridedAcc<kBwdThreads>{col}, rows);
}

// Shared memory of one lol_train_bwd block's accumulators.
template <class Scene>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (kCamSize + Scene::kNumFields) * kBwdThreads;
}

#ifdef __CUDACC__
// Sum of v over the warp, lane 0 holding it; the same shuffle tree every
// time, so the order of the additions is fixed.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of acc[0..N) over its kThreads threads, in a fixed order
// (warp shuffles, then the warps in order through shared memory), written
// to the block's row of partials [num_blocks, N]. Every thread calls it.
template <int N, int kThreads, class Acc>
__device__ __forceinline__ void block_partials(const Acc& acc,
                                               float* __restrict__ partials) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_part[kWarps][N];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) warp_part[warp][j] = v;
  }
  __syncthreads();
  float* row = partials + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * N;
  for (int j = tid; j < N; j += kThreads) {
    float s = warp_part[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_part[w][j];
    row[j] = s;
  }
}

template <class Cfg, class Scene>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    fused_bwd_kernel(const float* __restrict__ cam_in,
                     const float* __restrict__ P, const float* __restrict__ res,
                     const float* __restrict__ ct, float* __restrict__ partials,
                     int height, int full_height, int width, const float* __restrict__ rowtab) {
  constexpr int N = kCamSize + Scene::kNumFields;
  extern __shared__ float acc_cols[];  // [N][kBwdThreads]
  __shared__ float cam[kCamSize];
  const int tid = threadIdx.x;
  if (tid < kCamSize) cam[tid] = __ldg(cam_in + tid);
  __syncthreads();
  const Scene scn(P);
  bwd_thread<Cfg, Scene>(cam, scn, P, res, ct, blockIdx.x, gridDim.x, tid, height,
                         full_height, width, acc_cols + tid, RowMap{rowtab, kTrainRowBlock});
  block_partials<N, kBwdThreads>(StridedAcc<kBwdThreads>{acc_cols + tid}, partials);
}

// grads[j] = sum over blocks of partials[:, j]: one block per column, each
// thread a fixed stride of rows, then the fixed shuffle tree.
__global__ void __launch_bounds__(kBwdThreads)
    bwd_reduce_kernel(const float* __restrict__ partials, int num_blocks, int n,
                      float* __restrict__ grads) {
  __shared__ float warp_part[kBwdWarps];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < num_blocks; b += kBwdThreads)
    s += partials[(size_t)b * n + j];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warp_part[0];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) total += warp_part[w];
    grads[j] = total;
  }
}

// rowtab: nullptr or one image row per kTrainRowBlock launch rows (RowMap).
template <class Cfg, class Scene>
int launch_fused_bwd(const float* cam, const float* fields, const float* res,
                     const float* ct, float* partials, int height, int full_height, int width,
                     const float* rowtab, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<Scene>();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_bwd_kernel<Cfg, Scene>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_bwd_kernel<Cfg, Scene><<<bwd_num_blocks(height, width), kBwdThreads, smem, stream>>>(
      cam, fields, res, ct, partials, height, full_height, width, rowtab);
  return (int)cudaGetLastError();
}

// lol_train_bwd's resident blocks a SM (the occupancy calculator, at its
// shared memory), or -1 on an error.
template <class Cfg, class Scene>
int bwd_blocks_per_sm() {
  constexpr size_t smem = bwd_smem_bytes<Scene>();
  int n = 0;
  if (cudaFuncSetAttribute(fused_bwd_kernel<Cfg, Scene>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_bwd_kernel<Cfg, Scene>,
                                                    kBwdThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

template <class Scene>
int launch_bwd_reduce(const float* partials, int num_blocks, float* grads,
                      cudaStream_t stream) {
  constexpr int N = kCamSize + Scene::kNumFields;
  bwd_reduce_kernel<<<N, kBwdThreads, 0, stream>>>(partials, num_blocks, N,
                                                   grads);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace lol
