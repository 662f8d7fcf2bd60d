// ReSTIR's candidate RIS for Hopper (sm_90a): every lane draws
// reservoir_size light samples without visibility, weighs each by its
// target function over its pdf and keeps one in a weighted reservoir, in one
// launch.
//
// Replaces no Pallas kernel: the JAX package runs this loop as XLA code
// (radish_pt_tpu/render/restir.py, the candidate loop of restir_direct),
// and the port ran it as ~256 eager torch operations a candidate over the
// whole wavefront (radish_pt_tpu_torch/render/restir.py::ris_plain, which
// stays the plain version).  Each candidate is, per lane:
//   * 5 draws of the sampler (sampling/rng.py): Sobol, table[clamp(ptr)] ^
//     scramble; or, without a table, the hash mode, utilhash(scramble ^
//     salt(ptr)); then scramble = utilhash(scramble), ptr + 1;
//   * the light pick (sampling/alias.py::alias_sample), then
//     device_scene.py::sample_direct_light_no_vis: a uniform point of the
//     area light's triangle, its normal, radiance, distance and direction,
//     the pdf (luminance x 2 pi x 1 / sum of power, area to solid angle),
//     the single-sided facing test; or the env map's texel (its own alias
//     pick, the texel's centre through to_sphere, dist 1e6, the env pdf);
//   * bsdf/materials.py::bsdf_eval with a white base colour (the
//     demodulated material restir_candidates shades with): Lambertian,
//     MetallicWorkflow (GGX, Schlick Fresnel), every other type 0;
//   * p_hat = li * f * sat_dot(n, wi), w = |p_hat| / max(pdf, 1e-12), zero
//     unless finite with pdf > 0, and the update: weight += w, the
//     candidate taken where rand * weight < w.
//
// The arithmetic is the plain version's, operation for operation, each
// rounded on its own (csrc/shading.cuh, which csrc/vertex.cu shares: the
// sampler, the alias pick, the light sample, the GGX terms).
//
// Bound on the card: operations.  A candidate is ~250 operations a lane
// (~110 of them the integer hashing), ~70 bytes read and ~45 written a lane
// in all: at 800x800 and 32 candidates, 5.1e9 operations, 0.15 ms at the
// f32 instruction rate (33.5 T/s), against ~0.02 ms of device memory.  The
// design keeps the work in registers and out of device memory: one thread
// a lane, 256-thread blocks; the reservoir, the lane's position, normal,
// view direction and the material's per-lane constants stay in registers
// across the candidates; the lane's inputs are read once and its reservoir
// and sampler state written once.  What every lane shares sits in shared
// memory, staged once a block: the draws' 5 x reservoir_size Sobol words
// (read through the device pointer, so a CUDA graph replays each frame's
// looper) or hash salts, and, when there are at most RIS_SMEM_LIGHTS area
// lights, each light's vertices, normal (computed once a block, with the
// plain version's operations) and radiance, and the light alias table.
// More lights are read through the read-only cache and their normal
// computed per sample.  The env map's texels and alias table are read from
// device memory (L2-resident).  The launch is on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

#ifndef RIS_SMEM_LIGHTS
#define RIS_SMEM_LIGHTS 128  // area lights staged in shared memory a block
#endif

extern "C" {

// The launch's arguments, field for field radish_pt_tpu_torch/render/ris.py's
// RisArgs.
struct RisArgs {
  // the lanes: shading position, normal and view direction [N, 3], the
  // material's type, metallic and roughness [N], the sampler's scramble [N]
  const float* pos;
  const float* norm;
  const float* wo;
  const int* mtype;
  const float* metallic;
  const float* roughness;
  const long long* scramble;
  int n;
  int reservoir_size;
  // the sampler's dimension pointer (0-d), the Sobol table (NULL: hash mode)
  // and its length
  const long long* ptr;
  const long long* sobol;
  long long sobol_len;
  // area lights: triangle vertices [T, 3, 3], the lights' triangle ids and
  // radiance [L, 3], the light alias table [n_alias], 1 / sum of power (0-d)
  const float* tri_v;
  const int* light_prim;
  const float* light_radiance;
  const float* light_prob;
  const int* light_alias;
  const float* sum_light_power_inv;
  int n_area;
  int n_alias;
  int has_env;
  int single_sided;
  // material types present: MAT_LAMBERTIAN, MAT_METALLIC_WORKFLOW
  int lambertian;
  int metallic_lobe;
  // the env map: its alias table over texels, the texture atlas, its id
  const float* env_prob;
  const int* env_alias;
  const float* tex_data;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  int n_env;
  int env_tex;
  // the reservoir and the advanced scramble
  float* li;
  float* wi;
  float* dist;
  float* num;
  float* weight;
  long long* scramble_out;
};

}  // extern "C"

namespace {

using namespace shading;

constexpr int kBlock = 256;
constexpr int kLightRec = 16;  // v0 v1 v2 normal radiance, one float of padding

// what a lane's MetallicWorkflow lobe holds across its candidates (the
// per-lane operands of _metallic_eval with a white base colour)
struct Metal {
  Ggx g;
  float f0, one_minus_f0, diffuse;
};

__device__ __forceinline__ Metal metal_lane(float metallic, float roughness, V3 n, V3 wo) {
  Metal m;
  m.g = ggx_lane(roughness, n, wo);
  m.f0 = add((float)0.08, mul(sub(1.0f, (float)0.08), metallic));
  m.one_minus_f0 = sub(1.0f, m.f0);
  m.diffuse = mul(lambert(1.0f), sub(1.0f, metallic));
  return m;
}

// _metallic_eval (one value: the white base colour makes the three
// channels equal)
__device__ __forceinline__ float metal_eval(const Metal& m, V3 n, V3 wo, V3 wi) {
  const GgxEval e = ggx_eval(m.g, n, wo, wi);
  const float f = add(m.f0, mul(m.one_minus_f0, e.t));
  const float out = add(mul(m.diffuse, sub(1.0f, f)), mul(e.spec, f));
  return e.zero ? 0.0f : out;
}

__device__ __forceinline__ Light light_from_smem(const float* rec) {
  return {v3(rec), v3(rec + 3), v3(rec + 6), v3(rec + 9), v3(rec + 12)};
}

template <bool kHash, bool kSharedLights>
__global__ void __launch_bounds__(kBlock) ris_candidates_kernel(const RisArgs a) {
  extern __shared__ float smem[];
  const int draws = 5 * a.reservoir_size;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // a draw's Sobol word or hash salt
  float* lights = smem + ((draws + 3) & ~3);
  const float* prob = a.light_prob;
  const int* alias = a.light_alias;

  // ---- what every lane shares, staged once a block ----
  const long long ptr = *a.ptr;
  for (int j = threadIdx.x; j < draws; j += kBlock) {
    words[j] = draw_word<kHash>(ptr + j, a.sobol, a.sobol_len);
  }
  if (kSharedLights) {
    for (int l = threadIdx.x; l < a.n_area; l += kBlock) {
      const Light L = light_from_scene(a.tri_v, a.light_prim, a.light_radiance, l);
      float* rec = lights + l * kLightRec;
      const V3 parts[5] = {L.v0, L.v1, L.v2, L.normal, L.radiance};
      for (int k = 0; k < 5; ++k) {
        rec[3 * k] = parts[k].x;
        rec[3 * k + 1] = parts[k].y;
        rec[3 * k + 2] = parts[k].z;
      }
    }
    float* sprob = lights + a.n_area * kLightRec;
    int* salias = reinterpret_cast<int*>(sprob + a.n_alias);
    for (int j = threadIdx.x; j < a.n_alias; j += kBlock) {
      sprob[j] = a.light_prob[j];
      salias[j] = a.light_alias[j];
    }
    prob = sprob;
    alias = salias;
  }
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;

  // ---- the lane ----
  const V3 pos = v3(a.pos + 3 * (size_t)i);
  const V3 n = v3(a.norm + 3 * (size_t)i);
  const V3 wo = v3(a.wo + 3 * (size_t)i);
  const int mtype = a.mtype[i];
  const bool lambertian = a.lambertian && mtype == kMatLambertian;
  const bool metal = a.metallic_lobe && mtype == kMatMetallic;
  Metal mt = {};
  if (metal) mt = metal_lane(a.metallic[i], a.roughness[i], n, wo);
  const Lights lights_in = lights_of(prob, alias, a.n_alias, a.n_area, a.has_env,
                                     a.single_sided, a.sum_light_power_inv, a.env_prob,
                                     a.env_alias, a.tex_data, a.tex_offset, a.tex_width,
                                     a.tex_height, a.n_env, a.env_tex);
  const auto light_at = [&](int l) {
    return kSharedLights ? light_from_smem(lights + l * kLightRec)
                         : light_from_scene(a.tri_v, a.light_prim, a.light_radiance, l);
  };
  uint32_t scr = (uint32_t)a.scramble[i];

  V3 r_li = {0.0f, 0.0f, 0.0f}, r_wi = {0.0f, 0.0f, 0.0f};
  float r_dist = 0.0f, r_num = 0.0f, r_weight = 0.0f;

  for (int c = 0; c < a.reservoir_size; ++c) {
    float r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) r[k] = draw<kHash>(words[5 * c + k], scr);

    // ---- one light sample without visibility ----
    const LightSample ls = sample_light(lights_in, light_at, pos, r);
    const V3 li = ls.li, wi = ls.wi;
    const float dist = ls.dist, pdf = ls.pdf;

    // ---- the BSDF, the target function and the weight ----
    const float f = metal ? metal_eval(mt, n, wo, wi) : lambertian ? lambert(1.0f) : 0.0f;
    const float sd = clamp_min(dot(n, wi), 0.0f);
    const V3 p_hat = vscale(vscale(li, f), sd);
    float w = div(length(p_hat), clamp_min(pdf, (float)1e-12));
    if (!(isfinite(w) && pdf > 0.0f)) w = 0.0f;

    // ---- the reservoir update: the candidate taken where rand * weight < w
    const float weight = add(r_weight, w);
    if (mul(r[4], weight) < w) {
      r_li = li;
      r_wi = wi;
      r_dist = dist;
    }
    r_num = add(r_num, 1.0f);
    r_weight = weight;
  }

  float* li_out = a.li + 3 * (size_t)i;
  float* wi_out = a.wi + 3 * (size_t)i;
  li_out[0] = r_li.x;
  li_out[1] = r_li.y;
  li_out[2] = r_li.z;
  wi_out[0] = r_wi.x;
  wi_out[1] = r_wi.y;
  wi_out[2] = r_wi.z;
  a.dist[i] = r_dist;
  a.num[i] = r_num;
  a.weight[i] = r_weight;
  a.scramble_out[i] = (long long)scr;
}

template <bool kHash, bool kSharedLights>
int launch(const RisArgs& a, cudaStream_t s) {
  const int draws = 5 * a.reservoir_size;
  size_t smem = sizeof(float) * ((draws + 3) & ~3);
  if (kSharedLights) smem += sizeof(float) * (a.n_area * kLightRec + 2 * a.n_alias);
  const int blocks = (a.n + kBlock - 1) / kBlock;
  ris_candidates_kernel<kHash, kSharedLights><<<blocks, kBlock, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the candidate RIS of args->n lanes on ``stream``; returns
// cudaGetLastError().  The wrapper keeps reservoir_size within the
// shared memory a block has without an opt-in (48 KB).
int ris_candidates(const RisArgs* args, void* stream) {
  const RisArgs& a = *args;
  if (a.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool hash = a.sobol == nullptr;
  const bool shared = a.n_area <= RIS_SMEM_LIGHTS;
  if (hash) return shared ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return shared ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

// the number of area lights a block stages in shared memory (RIS_SMEM_LIGHTS)
int ris_smem_lights() { return RIS_SMEM_LIGHTS; }

}  // extern "C"
