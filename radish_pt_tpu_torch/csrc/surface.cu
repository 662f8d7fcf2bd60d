// The closest hit's surface for Hopper (sm_90a): from a wavefront's winners
// in lane order, every lane's hit position and shading normal, its material
// after texture and normal maps, and, in the bounce loops, the hit's
// accounting (the env map seen by an escaped ray and an emissive hit, each
// MIS-weighted, into the path's accumulator), in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this as XLA code
// (radish_pt_tpu/scene/device_scene.py's surface recovery and
// getTexturedMaterial, radish_pt_tpu/render/pathtrace.py's hit accounting),
// and the port ran it as ~200 eager torch operations over the whole
// wavefront (radish_pt_tpu_torch/scene/device_scene.py::surface_info_from_t
// or surface_info, then get_textured_material, then
// render/pathtrace.py::_shade_hit; render/pathtrace.py::surface_plain,
// which stays the plain version).  Per lane, in the plain version's order:
//   * the winner's row of the triangle table (clamped into range: a miss
//     reads row 0, as the plain gather does);
//   * the surface, in one of two forms (a template argument): from the
//     winner id (the sweep engines, which return no barycentrics): the
//     exact t from the triangle's plane, clamped to [0, 1e8], then the
//     barycentrics by the edge basis, the position v0 + e1 bx + e2 by; or
//     from the engine's barycentrics (dense, bvh, brute): the position by
//     interpolation; either way the interpolated, normalized normal, the
//     uv and the material id (-1 on a miss);
//   * the material of the id clamped into range: type, base colour,
//     metallic, roughness, ior; on a scene with texture maps (a template
//     argument) the procedural colour, the bilinear colour, metallic and
//     roughness maps and the normal map through the shading frame;
//   * with the accounting (a template argument: none; the primaries'
//     constants, throughput 1 after a delta sample with nothing
//     accumulated; a bounce's path state): a live lane that missed adds
//     the env map's radiance (on a scene with one, a template argument)
//     times throughput, weighted by the power heuristic against the env
//     sampler's pdf (1 after a delta sample), and dies; a live lane on an
//     emissive material adds its radiance times throughput, weighted
//     against NEE's area-light pdf from the previous vertex (1 after a
//     delta sample), where a single-sided light faces the ray, and dies.
// Every lane computes what the plain version computes (dead lanes and
// misses too), each operation rounded on its own (csrc/shading.cuh), so
// every output equals the plain version's bit for bit.
//
// Bound on the card: bytes.  A lane reads the winner (4 B), the ray (24 B;
// barycentrics, 8 B, and the direction alone in the interpolating form,
// which reads it only with the accounting) and, in a bounce, the path
// state (acc, active, throughput, pdf, delta, previous vertex: 42 B), and
// writes position, normal, the five material fields and the material id
// (56 B), and with the accounting acc and active (13 B); each triangle a
// wavefront hits is read once (100 B, the rest of its reads from the cache).
// At 800x800 a bounce is ~89 MB, 0.027 ms at 3.35 TB/s (render/surface.py
// ``bytes_moved``).  One thread a lane, 256-thread blocks, each input read
// once and each output written once, every intermediate in registers; the
// triangle rows and the material tables through the read-only cache.  The
// launch is on the caller's stream and reads nothing from the host, so a
// CUDA graph captures it; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

extern "C" {

// The launch's arguments, field for field radish_pt_tpu_torch/render/surface.py's
// SurfaceArgs.
struct SurfaceArgs {
  // the lanes: the winner [N] (int32, -1 a miss), the ray's origin and
  // direction [N, 3], the engine's barycentrics [N, 2] (NULL: the surface
  // is recovered from the winner id)
  const int* prim;
  const float* ray_o;
  const float* ray_d;
  const float* bary;
  int n;
  // the accounting: 0 none, 1 the primaries', 2 a bounce's, whose path
  // state is the accumulator [N, 3], active [N] (bool), throughput [N, 3],
  // the BSDF sample's pdf [N] and delta flag [N] (bool), the previous
  // vertex [N, 3]
  int account;
  const float* acc;
  const unsigned char* active;
  const float* throughput;
  const float* pdf;
  const unsigned char* delta;
  const float* prev_pos;
  // the triangles' attributes [T, 25] (v0 v1 v2 | n0 n1 n2 | uv0 uv1 uv2 |
  // material id)
  const float* tri_attr;
  int n_tris;
  // the material tables [M] ([M, 3] the base colour); ``textured``: some
  // material has a texture map (image or procedural)
  const int* mat_type;
  const float* mat_base_color;
  const float* mat_metallic;
  const float* mat_roughness;
  const float* mat_ior;
  const int* mat_color_map;
  const int* mat_normal_map;
  const int* mat_metallic_map;
  const int* mat_roughness_map;
  int n_mats;
  int textured;
  // the texture atlas [P, 3] and each texture's offset, width and height
  // [K]
  const float* tex_data;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  int n_tex;
  // the lights: the env map's texture id, single-sided emitters, 1 / sum
  // of power (0-d)
  int has_env;
  int env_tex;
  int single_sided;
  const float* sum_light_power_inv;
  // outputs: position and shading normal [N, 3], the material's type,
  // base colour [N, 3], metallic, roughness, ior, the material id; with
  // the accounting the accumulator [N, 3] and active [N]
  float* pos;
  float* norm;
  int* mtype;
  float* base_color;
  float* metallic;
  float* roughness;
  float* ior;
  int* mat_id;
  float* acc_out;
  unsigned char* active_out;
};

}  // extern "C"

namespace {

using namespace shading;

constexpr int kBlock = 256;
constexpr int kRow = 25;  // floats a row of the triangle table
constexpr int kNullTexture = -1;
constexpr int kProceduralTexture = -2;
constexpr int kMatLight = 4;
constexpr int kAccountNone = 0;
constexpr int kAccountPrimary = 1;
constexpr int kAccountBounce = 2;

__device__ __forceinline__ V3 ldg3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }

// torch.remainder of int32 (the sign of the divisor), wrapping as int32 does
__device__ __forceinline__ int imod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r = (int)((unsigned)r + (unsigned)b);
  return r;
}

// device_scene.py::_texture_bilinear: texture ``tex`` at (u, v), wrapping
__device__ __forceinline__ V3 bilinear(const SurfaceArgs& a, int tex, float u, float v) {
  const int w = __ldg(a.tex_width + tex);
  const int h = __ldg(a.tex_height + tex);
  const int off = __ldg(a.tex_offset + tex);
  const float fx = sub(mul(u, __int2float_rn(w)), 0.5f);
  const float fy = sub(mul(v, __int2float_rn(h)), 0.5f);
  const int ix = (int)floorf(fx);
  const int iy = (int)floorf(fy);
  const float tx = sub(fx, __int2float_rn(ix));
  const float ty = sub(fy, __int2float_rn(iy));
  auto wrap = [](int i, int n) { return imod((int)((unsigned)imod(i, n) + (unsigned)n), n); };
  const int x0 = wrap(ix, w), x1 = wrap((int)((unsigned)ix + 1u), w);
  const int y0 = wrap(iy, h), y1 = wrap((int)((unsigned)iy + 1u), h);
  auto texel = [&](int y, int x) {
    const int k = (int)((unsigned)off + (unsigned)y * (unsigned)w + (unsigned)x);
    return ldg3(a.tex_data + 3 * (size_t)(long long)k);
  };
  const V3 c00 = texel(y0, x0), c10 = texel(y0, x1), c01 = texel(y1, x0), c11 = texel(y1, x1);
  const float sx = sub(1.0f, tx), sy = sub(1.0f, ty);
  const V3 cx0 = vadd(vscale(c00, sx), vscale(c10, tx));
  const V3 cx1 = vadd(vscale(c01, sx), vscale(c11, tx));
  return vadd(vscale(cx0, sy), vscale(cx1, ty));
}

// device_scene.py::procedural_texture at (u, v): one grey level
__device__ __forceinline__ float procedural(float u, float v) {
  const long long cx = (long long)(int)mul(u, 1024.0f);
  const long long cy = (long long)(int)mul(v, 1024.0f);
  const uint32_t h1 = utilhash((uint32_t)(unsigned long long)(cx * 1024 + cy));
  const uint32_t h2 = utilhash(h1);
  const float two_pi = (float)(2.0 * kPi);
  const float f = mul(add(sinf(add(mul(mul(u, 10.0f), two_pi), mul(unit(h1), two_pi))), 1.0f), 0.5f);
  const float g = mul(add(sinf(add(mul(mul(v, 10.0f), two_pi), mul(unit(h2), two_pi))), 1.0f), 0.5f);
  return mul(f, g);
}

// device_scene.py::env_radiance: the env map at direction ``d`` through
// utils/math.py::to_plane (the azimuth wrapped by torch.remainder, fmod's
// remainder moved to the divisor's sign)
__device__ __forceinline__ V3 env_radiance(const SurfaceArgs& a, V3 d) {
  float u = add(mul(mul(atan2f(d.z, d.x), (float)kInvPi), 0.5f), 1.0f);
  float r = fmodf(u, 1.0f);
  if (r != 0.0f && r < 0.0f) r = add(r, 1.0f);
  u = r;
  const float len = sqrt0(add(mul(d.x, d.x), mul(d.z, d.z)));
  const float v = mul(atan2f(len, d.y), (float)kInvPi);
  return bilinear(a, a.env_tex, u, v);
}

// utils/math.py::power_heuristic
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float f2 = mul(f, f);
  return div(f2, add(f2, mul(g, g)));
}

template <bool kBary, int kAccount, bool kTex, bool kEnv>
__global__ void __launch_bounds__(kBlock) surface_kernel(const SurfaceArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;

  // ---- the surface from the winner's row ----
  const int prim = a.prim[i];
  const float* row = a.tri_attr + (size_t)min(max(prim, 0), a.n_tris - 1) * kRow;
  const V3 v0 = ldg3(row + 0), v1 = ldg3(row + 3), v2 = ldg3(row + 6);
  V3 d = {0.0f, 0.0f, 0.0f};
  if (!kBary || kAccount != kAccountNone) d = v3(a.ray_d + 3 * (size_t)i);
  float bx, by;
  V3 pos;
  if (kBary) {
    bx = a.bary[2 * (size_t)i];
    by = a.bary[2 * (size_t)i + 1];
  } else {
    // surface_info_from_t: t from the triangle's plane, the barycentrics
    // by the edge basis
    const V3 o = v3(a.ray_o + 3 * (size_t)i);
    const V3 e1 = vsub(v1, v0), e2 = vsub(v2, v0);
    const V3 gn = cross(e1, e2);
    const float denom = dot(d, gn);
    float t = div(dot(vsub(v0, o), gn), fabsf(denom) > (float)1e-30 ? denom : (float)1e-30);
    if (!isnan(t)) t = fminf(fmaxf(t, 0.0f), (float)1e8);
    const V3 p = vsub(vadd(o, vscale(d, t)), v0);
    const float d11 = dot(e1, e1), d12 = dot(e1, e2), d22 = dot(e2, e2);
    const float p1 = dot(p, e1), p2 = dot(p, e2);
    const float inv = rcp(clamp_min(sub(mul(d11, d22), mul(d12, d12)), (float)1e-30));
    bx = mul(sub(mul(d22, p1), mul(d12, p2)), inv);
    by = mul(sub(mul(d11, p2), mul(d12, p1)), inv);
    pos = vadd(vadd(v0, vscale(e1, bx)), vscale(e2, by));
  }
  const float bw = sub(sub(1.0f, bx), by);
  if (kBary) pos = vadd(vadd(vscale(v1, bx), vscale(v2, by)), vscale(v0, bw));
  V3 n = normalize(vadd(vadd(vscale(ldg3(row + 12), bx), vscale(ldg3(row + 15), by)),
                        vscale(ldg3(row + 9), bw)));
  const int mat_id = prim >= 0 ? (int)__ldg(row + 24) : -1;

  // ---- the material (get_textured_material) ----
  const int mid = min(max(mat_id, 0), a.n_mats - 1);
  const int mtype = __ldg(a.mat_type + mid);
  V3 base = ldg3(a.mat_base_color + 3 * (size_t)mid);
  float metallic = __ldg(a.mat_metallic + mid);
  float roughness = __ldg(a.mat_roughness + mid);
  if (kTex) {
    const float u = add(add(mul(__ldg(row + 20), bx), mul(__ldg(row + 22), by)),
                        mul(__ldg(row + 18), bw));
    const float v = add(add(mul(__ldg(row + 21), bx), mul(__ldg(row + 23), by)),
                        mul(__ldg(row + 19), bw));
    const bool has_tex = a.n_tex > 0;
    const int cmap = __ldg(a.mat_color_map + mid);
    if (cmap == kProceduralTexture) {
      const float p = procedural(u, v);
      base = {p, p, p};
    } else if (cmap > kNullTexture && has_tex) {
      base = bilinear(a, cmap, u, v);
    }
    if (has_tex) {
      const int mmap = __ldg(a.mat_metallic_map + mid);
      if (mmap > kNullTexture) metallic = bilinear(a, mmap, u, v).x;
      const int rmap = __ldg(a.mat_roughness_map + mid);
      if (rmap > kNullTexture) roughness = bilinear(a, rmap, u, v).x;
      const int nmap = __ldg(a.mat_normal_map + mid);
      if (nmap > kNullTexture) {
        const V3 local = normalize(vsub(bilinear(a, nmap, u, v), V3{0.5f, 0.5f, 0.5f}));
        n = normalize(to_world(local_frame(n), n, local.x, local.y, local.z));
      }
    }
  }
  store3(a.pos + 3 * (size_t)i, pos);
  store3(a.norm + 3 * (size_t)i, n);
  a.mtype[i] = mtype;
  store3(a.base_color + 3 * (size_t)i, base);
  a.metallic[i] = metallic;
  a.roughness[i] = roughness;
  a.ior[i] = __ldg(a.mat_ior + mid);
  a.mat_id[i] = mat_id;
  if (kAccount == kAccountNone) return;

  // ---- the hit's accounting (_shade_hit) ----
  const bool bounce = kAccount == kAccountBounce;
  V3 acc = bounce ? v3(a.acc + 3 * (size_t)i) : V3{0.0f, 0.0f, 0.0f};
  bool active = bounce ? a.active[i] != 0 : true;
  const V3 thr = bounce ? v3(a.throughput + 3 * (size_t)i) : V3{1.0f, 1.0f, 1.0f};
  const bool delta = bounce ? a.delta[i] != 0 : true;
  const float pdf = bounce ? a.pdf[i] : 1.0f;
  const float slpi = *a.sum_light_power_inv;
  const bool miss = active && prim == -1;
  if (kEnv) {
    // the env map, MIS-weighted against the env sampler
    V3 term = {0.0f, 0.0f, 0.0f};
    if (miss) {
      const V3 env = env_radiance(a, d);
      float w = 1.0f;
      if (!delta) {
        const float env_pdf = mul(mul(mul(mul(mul(luminance(env), slpi),
                                                  __int2float_rn(__ldg(a.tex_width + a.env_tex))),
                                              __int2float_rn(__ldg(a.tex_height + a.env_tex))),
                                          (float)(kInvPi * kInvPi)), 0.5f);
        w = power_heuristic(pdf, env_pdf);
      }
      term = vscale(vmul(env, thr), w);
    }
    acc = vadd(acc, term);
  }
  active = active && !miss;
  // an emissive hit, MIS-weighted against NEE's light sampler
  const bool hit_light = active && mtype == kMatLight;
  V3 term = {0.0f, 0.0f, 0.0f};
  if (hit_light && (!a.single_sided || dot(n, d) < 0.0f)) {
    float w = 1.0f;
    if (!delta) {
      // area_light_hit_pdf(base, prev_pos, pos, n)
      const float pdf_area = mul(mul(luminance(base), (float)(2.0 * kPi)), slpi);
      const V3 yx = vsub(v3(a.prev_pos + 3 * (size_t)i), pos);
      const float light_pdf = div(mul(pdf_area, dot(yx, yx)),
                                  clamp_min(fabsf(dot(n, normalize(yx))), (float)1e-12));
      w = power_heuristic(pdf, light_pdf);
    }
    term = vscale(vmul(base, thr), w);
  }
  store3(a.acc_out + 3 * (size_t)i, vadd(acc, term));
  a.active_out[i] = active && !hit_light;
}

template <bool kBary, int kAccount, bool kTex, bool kEnv>
void launch(const SurfaceArgs& a, cudaStream_t s) {
  surface_kernel<kBary, kAccount, kTex, kEnv><<<(a.n + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
}

// the scene's forms: texture maps, and with the accounting the env map
template <bool kBary, int kAccount>
void launch_scene(const SurfaceArgs& a, cudaStream_t s) {
  if constexpr (kAccount == kAccountNone) {
    if (a.textured) launch<kBary, kAccount, true, false>(a, s);
    else launch<kBary, kAccount, false, false>(a, s);
  } else if (a.textured) {
    if (a.has_env) launch<kBary, kAccount, true, true>(a, s);
    else launch<kBary, kAccount, true, false>(a, s);
  } else {
    if (a.has_env) launch<kBary, kAccount, false, true>(a, s);
    else launch<kBary, kAccount, false, false>(a, s);
  }
}

template <bool kBary>
void launch_account(const SurfaceArgs& a, cudaStream_t s) {
  if (a.account == kAccountPrimary) launch_scene<kBary, kAccountPrimary>(a, s);
  else if (a.account == kAccountBounce) launch_scene<kBary, kAccountBounce>(a, s);
  else launch_scene<kBary, kAccountNone>(a, s);
}

}  // namespace

extern "C" {

// Launches the surface of args->n lanes on ``stream``; returns
// cudaGetLastError().  With no lane nothing is launched.
int surface_shade(const SurfaceArgs* args, void* stream) {
  const SurfaceArgs& a = *args;
  if (a.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.bary != nullptr) {
    launch_account<true>(a, s);
  } else {
    launch_account<false>(a, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
