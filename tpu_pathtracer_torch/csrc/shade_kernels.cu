// Hand-written Hopper (sm_90a) kernels of the shading stage, which the JAX
// package leaves to XLA: the flat light-cluster pdf (K1), the hit record with
// its texture fetch (K2), and the sampling / BSDF chain of the bounce split
// around the light pdf (K3 before it, K4 after it).
//
// Built by tpu_pathtracer_torch/kernels.py like the other kernel libraries
// (nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, a plain C
// interface called through ctypes on PyTorch's current stream).
// --fmad=false rounds every product and every sum on its own, as the
// plain-torch twins' one-operation kernels round them.  sqrtf, '/' and powf
// are the IEEE / libdevice functions PyTorch's CUDA kernels call.  Each C
// entry returns the first CUDA error of its launch (0 when none).
//
// Three-term sums.  The twins' dot products and squared lengths are
// torch.sum over a last dimension of 3.  PyTorch's CUDA reduction gives
// such a row to two lanes of a warp (its block width is the largest power
// of two <= 3): one lane adds elements 0 and 2, the other holds element 1,
// and the warp's shuffle adds the two (ATen/native/cuda/Reduce.cuh:
// set_block_dimension, thread_reduce_impl, block_x_reduce).  sum3 is that
// order, (a0 + a2) + a1 (tests/test_torch_shade_kernels.py holds torch.sum
// to it on the card, contiguous and strided).  Each lane's partial starts
// from the reduction's identity, 0 + x, so PyTorch never returns -0: sum3
// adds a last + 0.0f, which turns -0 into +0 and leaves every other value.
//
// Other roundings of PyTorch's CUDA kernels that K3 and K4 copy.  A Python
// float operand is cast to float32 first (kPi becomes 3.14159274f); a
// division by one is a product with its float32 reciprocal (x / PI is
// x * (1.0f / (float)PI)), while 1.0 / x is torch.reciprocal, an IEEE
// divide; clamp_min and clamp return a NaN input unchanged and else take
// fmaxf / fminf, as ATen's clamp kernels do; x**5 is x * ((x*x) * (x*x)).
// cosf, sinf, atan2f, asinf, sqrtf and powf are the functions PyTorch's
// kernels call, none of their fast intrinsics.
//
// ---------------------------------------------------------------------------
// K1  light_pdf_flat_kernel
//   Replaces no Pallas kernel: tpu_pathtracer/ops/intersect.py:270
//   (light_pdf_sum_flat), fused by XLA inside the jitted render; the Pallas
//   kernel of the same quantity past 512 lights is B3.
//   Per ray: the all-hits light-mixture pdf over at most 4 clusters of cw
//   light triangles: where the ray passes a light's Woop test at
//   t >= min_dst, the term t^2 |d|^2 k / |q2|; summed over each cluster,
//   the cluster sums added in cluster order, times 1/count.
//   Bound on the H100: operations over the live lights (~65 lane operations
//   a (ray, light) pair, two of them IEEE divides); the bytes are 28 a ray
//   and the clusters' 26 KB.  The twin's time goes to 60 passes over
//   [R, 128] intermediates in device memory; here nothing but the [R]
//   result leaves the SM.
//   Design: one thread a ray, 256 rays a block.  A block first reads the
//   clusters' Woop columns and k (coalesced along the lanes) and keeps in
//   shared memory, in lane order, only the lights none of whose 12 Woop
//   values is NaN: a NaN makes one of t, beta, gamma NaN, the twin's test
//   fails there and the light adds exactly nothing (padding lanes carry NaN
//   rows and k = 0; the atrium's one cluster holds 6 live lights of 128).
//   Each thread then walks the live lights as shared-memory broadcasts.
//   The test and the term are the twin's op for op (stage.cuh woop_hit is
//   _contract_o / _contract_d's order), so a ray passes the same lights as
//   in the twin; the sum over a cluster runs in lane order, the twin's in
//   torch's reduction order, so the two may differ by rounding (on the
//   atrium's and the env field's rays they gave the same bits).  The twin
//   divides by the count as a Python scalar, which PyTorch's CUDA division
//   turns into a product with the scalar's float reciprocal (held so on the
//   card by the same test file); the kernel takes that reciprocal
//   (inv_count) and multiplies.
//
// K2  shade_gather_kernel
//   Replaces no Pallas kernel: tpu_pathtracer/models/pathtracer.py:196
//   (hit_info) with tpu_pathtracer/ops/texture.py:82 (sample_many), fused
//   by XLA inside the jitted render.
//   Per ray: the 48-float row of its triangle (verts, normals, uvs,
//   tangents, material, texture ids), the geometric normal and whether the
//   ray is inside, the smooth normal interpolated and turned to the
//   geometric side, the UV, and for each texture slot some material uses
//   (the launch's slot bits: color, emissive, metallic-roughness, normal)
//   the repeat-wrapped bilinear fetch from the atlas (four texels of the
//   flat pool [T, 4], or one 16-float row of the corner-quad pool [T, 16];
//   gamma 2.2 decoded on the RGB of the color and emissive slots; a 1x1
//   texture gives its raw texel), the normal map, the products with the
//   material's factors and the final flips.  Writes the record [R, 16]
//   (normal 3, shading normal 3, color 4, emission 3, metallic, roughness,
//   ior) and inside [R] (bool).
//   Bound on the H100: bytes.  A ray reads a 192-byte row and up to 16
//   texels and writes 65 bytes; its arithmetic is ~300 lane operations.
//   Design: one thread a ray, every intermediate in registers, so the
//   twin's ~170 device operations over [R, k] tensors are one pass.  Each
//   expression is the twin's op for op, so the record equals the twin's
//   bit for bit.  The slot bits and the pool's form are launch arguments,
//   the same for every ray, so no ray's rounding depends on a branch; a
//   missed ray (tri 0, beta = gamma = 0) gathers row 0 as the twin does.
//
// K3  shade_sample_kernel
//   Replaces no Pallas kernel: the first half of tpu_pathtracer/models/
//   pathtracer.py:308 (bounce_step) after hit_info, with ops/sampling.py and
//   the equirect lookup of ops/texture.py (env_radiance), fused by XLA.
//   Twin: models/pathtracer.shade_sample_plain.
//   Per ray: the environment radiance of a missed live ray (the gamma-2.2
//   bilinear tap at the direction's (u, v), K2's fetch) or bg_color, times
//   the throughput, added to the radiance; hit point o + t d; the alpha
//   Russian roulette (draw 0 against the record's alpha: passthrough or
//   shade); the emission of a shaded hit added; the new direction: the
//   VNDF sample where draw 1 <= vndf_factor, else the light-triangle
//   sample where draw 4 picks the light and the set has lights, else the
//   cosine sample.  Writes pos, new_dir, radiance [R, 3] and the flags
//   [R, 2] (shade, passthrough).
//   Design: one thread a ray, everything in registers.  Only the direction
//   chosen is computed, and the environment only for a missed live ray: the
//   twin computes every lobe on every lane and then selects, which gives
//   the same bits.  The scene's shape comes in as launch arguments (env map
//   id or -1, the light rows or null, the light count), the same for every
//   ray.
//
// K4  shade_finish_kernel
//   Replaces no Pallas kernel: the second half of the same bounce_step,
//   after the light pdf, with ops/bsdf.py.  Twin:
//   models/pathtracer.shade_finish_plain.
//   Per shaded ray: the VNDF pdf and the cosine pdf of the new direction,
//   the mixture with the light pdf (p_light, or none: a launch argument),
//   the MIS blend, the glTF metallic-roughness BRDF, the cosine term, the
//   kill test (a NaN direction, p < eps, or a throughput factor of length
//   0).  Per ray: the throughput, origin and direction of the next bounce,
//   moved (passthrough or continued) and the next bounce's sort hint (the
//   hit's chunk id).
//   Bound of K3 and K4 on the H100: bytes.  K3 reads ~160 bytes a ray (o,
//   d, throughput, radiance, 10 draws, t, the flags and the 64-byte record)
//   and writes 38; K4 reads ~120 and writes 41; each does a few hundred
//   lane operations.  The twins run ~400-500 device operations over [R]
//   and [R, 3] tensors between them.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kFlatThreads = 256;    // rays per light-pdf block
constexpr int kFlatLights = 512;     // clusters x lanes a block stages (4 x 128)
constexpr int kShadeThreads = 128;   // rays per shading block
constexpr int kRow = 48;             // floats of a shade_attrs row

__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return ((a0 + a2) + a1) + 0.0f;
}

__global__ void __launch_bounds__(kFlatThreads) light_pdf_flat_kernel(
    const float* __restrict__ origin,     // [R, 3]
    const float* __restrict__ direction,  // [R, 3]
    const float* __restrict__ woop,       // [C, 12, cw]
    const float* __restrict__ cluster_k,  // [C, cw]
    int n_rays, int n_clusters, int cw, float min_dst, float inv_count,
    float* __restrict__ out) {            // [R]
  __shared__ float4 sw[kFlatLights * 3];  // live lights' Woop rows (a, b, c)
  __shared__ float sk[kFlatLights];
  __shared__ uint32_t live[kFlatLights / 32];
  __shared__ int first[5];                // each cluster's first live light, then the end
  const int n = n_clusters * cw;          // a multiple of 32: a warp's lights share a word
  for (int base = 0; base < n; base += blockDim.x) {
    const int e = base + threadIdx.x;
    bool ok = e < n;
    if (ok) {
      const float* w = woop + (size_t)(e / cw) * 12 * cw + e % cw;
      for (int r = 0; r < 12; ++r) ok = ok && !isnan(w[(size_t)r * cw]);
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0 && e < n) live[e >> 5] = bits;
  }
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int e = base + threadIdx.x;
    if (e < n && ((live[e >> 5] >> (e & 31)) & 1u)) {
      int pos = __popc(live[e >> 5] & ((1u << (e & 31)) - 1u));
      for (int q = 0; q < (e >> 5); ++q) pos += __popc(live[q]);
      const int c = e / cw, j = e % cw;
      const float* w = woop + (size_t)c * 12 * cw + j;
      for (int r = 0; r < 3; ++r) {
        sw[pos * 3 + r] = make_float4(w[(size_t)(4 * r) * cw], w[(size_t)(4 * r + 1) * cw],
                                      w[(size_t)(4 * r + 2) * cw], w[(size_t)(4 * r + 3) * cw]);
      }
      sk[pos] = cluster_k[(size_t)c * cw + j];
    }
  }
  if (threadIdx.x <= n_clusters) {
    int pos = 0;
    for (int q = 0; q < (int)threadIdx.x * cw / 32; ++q) pos += __popc(live[q]);
    first[threadIdx.x] = pos;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float o0 = origin[3 * (size_t)i], o1 = origin[3 * (size_t)i + 1],
              o2 = origin[3 * (size_t)i + 2];
  const float d0 = direction[3 * (size_t)i], d1 = direction[3 * (size_t)i + 1],
              d2 = direction[3 * (size_t)i + 2];
  const float dd = sum3(d0 * d0, d1 * d1, d2 * d2);
  float total = 0.0f;
  for (int c = 0; c < n_clusters; ++c) {
    float csum = 0.0f;
    for (int e = first[c]; e < first[c + 1]; ++e) {
      float t, q2;
      if (tpt::woop_hit(sw[3 * e], sw[3 * e + 1], sw[3 * e + 2], o0, o1, o2, d0, d1, d2,
                        min_dst, &t, &q2)) {
        csum = csum + t * t * dd * sk[e] / fabsf(q2);
      }
    }
    total = total + csum;
  }
  out[i] = total * inv_count;
}

struct Atlas {
  const float4* texels;   // [T] texels (rgba)
  const float4* quad;     // [T, 4] corner quads (c00, c01, c10, c11), or null
  const int32_t* offset;  // [K]
  const int32_t* width;   // [K]
  const int32_t* height;  // [K]
};

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 cross3(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }

__device__ __forceinline__ Vec3 normalize3(Vec3 a) {
  const float len = sqrtf(dot3(a, a));
  return {a.x / len, a.y / len, a.z / len};
}

__device__ __forceinline__ Vec3 neg3(Vec3 a) { return {-a.x, -a.y, -a.z}; }

// triangle::interop over three vertex slices of a row: wa*a + beta*b + gamma*c.
__device__ __forceinline__ float interp(const float* r, int k, int width, float wa, float b,
                                        float g) {
  return (wa * r[k] + b * r[k + width]) + g * r[k + 2 * width];
}

__device__ __forceinline__ Vec3 interp3(const float* r, int base, float wa, float b, float g) {
  return {interp(r, base, 3, wa, b, g), interp(r, base + 1, 3, wa, b, g),
          interp(r, base + 2, 3, wa, b, g)};
}

// jnp.mod(x, 1.0): fmod, then + 1 where the remainder is negative.
__device__ __forceinline__ float mod1(float x) {
  const float m = fmodf(x, 1.0f);
  return (m != 0.0f && m < 0.0f) ? m + 1.0f : m;
}

__device__ __forceinline__ float wrap_repeat(float x) { return mod1(mod1(x) + 1.0f); }

__device__ __forceinline__ float4 decode(float4 c, bool gamma) {
  if (gamma) {
    c.x = powf(c.x, 2.2f);
    c.y = powf(c.y, 2.2f);
    c.z = powf(c.z, 2.2f);
  }
  return c;
}

__device__ __forceinline__ float lerp2(float dx, float dy, float c00, float c01, float c10,
                                       float c11) {
  return (1.0f - dx) * ((1.0f - dy) * c00 + dy * c01) + dx * ((1.0f - dy) * c10 + dy * c11);
}

// Texture::sample of texture ``id`` at the wrapped (u, v): repeat wrap,
// bilinear over the corners with mod_inc neighbours, each corner decoded
// before the lerp; a 1x1 texture returns its raw texel.
__device__ __forceinline__ float4 fetch(const Atlas& at, int id, float u, float v, bool gamma) {
  const int off = at.offset[id], w = at.width[id], h = at.height[id];
  const float tx = u * (float)w, ty = v * (float)h;
  const int px = min((int)tx, w - 1), py = min((int)ty, h - 1);
  const float dx = tx - (float)px, dy = ty - (float)py;
  const int px1 = px == w - 1 ? 0 : px + 1;
  const int py1 = py == h - 1 ? 0 : py + 1;
  float4 c00, c01, c10, c11;
  if (at.quad != nullptr) {
    const float4* q = at.quad + (size_t)(off + px + py * w) * 4;
    c00 = q[0];
    c01 = q[1];
    c10 = q[2];
    c11 = q[3];
  } else {
    c00 = at.texels[off + px + py * w];
    c01 = at.texels[off + px + py1 * w];
    c10 = at.texels[off + px1 + py * w];
    c11 = at.texels[off + px1 + py1 * w];
  }
  if (w * h == 1) return c00;
  c00 = decode(c00, gamma);
  c01 = decode(c01, gamma);
  c10 = decode(c10, gamma);
  c11 = decode(c11, gamma);
  return make_float4(lerp2(dx, dy, c00.x, c01.x, c10.x, c11.x),
                     lerp2(dx, dy, c00.y, c01.y, c10.y, c11.y),
                     lerp2(dx, dy, c00.z, c01.z, c10.z, c11.z),
                     lerp2(dx, dy, c00.w, c01.w, c10.w, c11.w));
}

__global__ void __launch_bounds__(kShadeThreads) shade_gather_kernel(
    const float* __restrict__ attrs,      // [N, 48]
    const int32_t* __restrict__ tri,      // [R]
    const float* __restrict__ beta,       // [R]
    const float* __restrict__ gamma,      // [R]
    const float* __restrict__ direction,  // [R, 3]
    Atlas atlas, int n_rays, int slots,
    float4* __restrict__ record,          // [R, 4] float4 = [R, 16]
    uint8_t* __restrict__ inside) {       // [R] bool
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float r[kRow];
  const float4* row = reinterpret_cast<const float4*>(attrs + (size_t)tri[i] * kRow);
#pragma unroll
  for (int q = 0; q < kRow / 4; ++q) {
    const float4 v = row[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
  const float b = beta[i], g = gamma[i];
  const Vec3 d = {direction[3 * (size_t)i], direction[3 * (size_t)i + 1],
                  direction[3 * (size_t)i + 2]};

  const Vec3 e1 = {r[3] - r[0], r[4] - r[1], r[5] - r[2]};
  const Vec3 e2 = {r[6] - r[0], r[7] - r[1], r[8] - r[2]};
  const Vec3 gn = normalize3(cross3(e1, e2));
  const bool in = dot3(gn, d) > 0.0f;
  const float wa = (1.0f - b) - g;
  Vec3 smooth = normalize3(interp3(r, 9, wa, b, g));
  if (dot3(gn, smooth) < 0.0f) smooth = neg3(smooth);

  Vec3 shading = smooth;
  float4 color = make_float4(r[33], r[34], r[35], r[36]);
  Vec3 emission = {r[37], r[38], r[39]};
  float metallic = r[40], roughness = r[41];
  if (slots != 0) {
    const float u = wrap_repeat(interp(r, 18, 2, wa, b, g));
    const float v = wrap_repeat(interp(r, 19, 2, wa, b, g));
    if (slots & 1) {
      const float4 f = fetch(atlas, (int)r[43], u, v, true);
      color = make_float4(color.x * f.x, color.y * f.y, color.z * f.z, color.w * f.w);
    }
    if (slots & 2) {
      const float4 f = fetch(atlas, (int)r[44], u, v, true);
      emission = {emission.x * f.x, emission.y * f.y, emission.z * f.z};
    }
    if (slots & 4) {
      const float4 f = fetch(atlas, (int)r[45], u, v, false);
      metallic = metallic * f.z;  // metallic from B, roughness from G
      roughness = roughness * f.y;
    }
    if (slots & 8) {
      const Vec3 tangent = normalize3(interp3(r, 24, wa, b, g));
      const Vec3 bitangent = cross3(smooth, tangent);
      const float4 f = fetch(atlas, (int)r[46], u, v, false);
      const Vec3 nl = normalize3({f.x * 2.0f - 1.0f, f.y * 2.0f - 1.0f, f.z * 2.0f - 1.0f});
      shading = normalize3({(nl.x * tangent.x + nl.y * bitangent.x) + nl.z * smooth.x,
                            (nl.x * tangent.y + nl.y * bitangent.y) + nl.z * smooth.y,
                            (nl.x * tangent.z + nl.y * bitangent.z) + nl.z * smooth.z});
    }
  }
  const Vec3 n = in ? neg3(gn) : gn;
  const Vec3 s = in ? neg3(shading) : shading;
  record[4 * (size_t)i] = make_float4(n.x, n.y, n.z, s.x);
  record[4 * (size_t)i + 1] = make_float4(s.y, s.z, color.x, color.y);
  record[4 * (size_t)i + 2] = make_float4(color.z, color.w, emission.x, emission.y);
  record[4 * (size_t)i + 3] = make_float4(emission.z, metallic, roughness, r[42]);
  inside[i] = in ? 1 : 0;
}


// ---------------------------------------------------------------------------
// K3 / K4: the sampling / BSDF chain.  Each helper is the twin's function of
// the same name (ops/sampling.py, ops/bsdf.py, ops/vecmath.py), op for op.

constexpr double kPi = 3.141592653589793;  // math.pi
constexpr float kPiF = (float)kPi;
constexpr float kTwoPiF = (float)(2.0 * kPi);
constexpr float kInvPiF = 1.0f / kPiF;   // x / math.pi on the card

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ Vec3 add3(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ Vec3 sub3(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ Vec3 mul3(Vec3 a, Vec3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ Vec3 scale3(float s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ Vec3 pick3(bool c, Vec3 a, Vec3 b) { return c ? a : b; }

__device__ __forceinline__ Vec3 load3(const float* p, int i) {
  return {p[3 * (size_t)i], p[3 * (size_t)i + 1], p[3 * (size_t)i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, Vec3 v) {
  p[3 * (size_t)i] = v.x;
  p[3 * (size_t)i + 1] = v.y;
  p[3 * (size_t)i + 2] = v.z;
}

// Uniform integer in [0, count) from a U[0,1) draw (pick_uniform).
__device__ __forceinline__ int pick_uniform(float u, int count) {
  const int idx = (int)floorf(u * (float)count);
  return min(max(idx, 0), max(count - 1, 0));
}

// VNDF_dist::choose_local_x.
__device__ __forceinline__ Vec3 choose_local_x(Vec3 n) {
  const float s = sum3(n.x, n.y, n.z);
  const bool use_x = fabsf(n.x) > 0.5f;
  const bool use_y = !use_x && fabsf(n.y) > 0.5f;
  const bool use_z = !(use_x || use_y);
  const float denom = use_x ? n.x : (use_y ? n.y : n.z);
  const float corr = s / denom;
  return normalize3({1.0f - corr * (use_x ? 1.0f : 0.0f), 1.0f - corr * (use_y ? 1.0f : 0.0f),
                     1.0f - corr * (use_z ? 1.0f : 0.0f)});
}

// reflect(normal, in_dir): in - (2 n) <in, n>.
__device__ __forceinline__ Vec3 reflect3(Vec3 n, Vec3 in) {
  const float k = dot3(in, n);
  return sub3(in, scale3(k, scale3(2.0f, n)));
}

// VNDF_dist::sample with the GGX alpha ``r`` (the clamped roughness squared).
__device__ __forceinline__ Vec3 vndf_sample(float r, Vec3 in, Vec3 n, float u1, float u2) {
  const Vec3 nx = choose_local_x(n);
  const Vec3 ny = cross3(n, nx);
  const Vec3 v = neg3(normalize3({dot3(nx, in), dot3(ny, in), dot3(n, in)}));
  const Vec3 vh = normalize3({r * v.x, r * v.y, 1.0f * v.z});
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  Vec3 t1 = {1.0f, 0.0f, 0.0f};
  if (lensq > 0.0f) {
    const float len = sqrtf(clamp_min(lensq, (float)1e-38));
    t1 = {-vh.y / len, vh.x / len, 0.0f / len};
  }
  const Vec3 t2 = cross3(vh, t1);
  const float rr = sqrtf(u1);
  const float phi = kTwoPiF * u2;
  const float c1 = rr * cosf(phi);
  float c2 = rr * sinf(phi);
  const float s = 0.5f * (vh.z + 1.0f);
  c2 = (1.0f - s) * sqrtf(clamp_min(1.0f - c1 * c1, 0.0f)) + s * c2;
  const float ch = sqrtf(clamp_min((1.0f - c1 * c1) - c2 * c2, 0.0f));
  const Vec3 nh = add3(add3(scale3(c1, t1), scale3(c2, t2)), scale3(ch, vh));
  const Vec3 ne = normalize3({r * nh.x, r * nh.y, clamp_min(nh.z, 0.0f)});
  const Vec3 res = normalize3(add3(add3(scale3(ne.x, nx), scale3(ne.y, ny)), scale3(ne.z, n)));
  return reflect3(res, in);
}

// cosine_dist::sample: norm(n + uniform sphere point).
__device__ __forceinline__ Vec3 cosine_sample(Vec3 n, float u_z, float u_phi) {
  const float z = u_z * 2.0f - 1.0f;
  const float co_z = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = kTwoPiF * u_phi;
  return normalize3(add3(n, {co_z * cosf(phi), co_z * sinf(phi), z}));
}

// triangle_dist::sample: a uniform point of the triangle (square fold), then
// the direction from x.
__device__ __forceinline__ Vec3 light_triangle_sample(Vec3 x, Vec3 a, Vec3 b, Vec3 c, float u,
                                                      float v) {
  const bool flip = (u + v) > 1.0f;
  const float uu = flip ? 1.0f - u : u;
  const float vv = flip ? 1.0f - v : v;
  const Vec3 p = add3(add3(a, scale3(vv, sub3(b, a))), scale3(uu, sub3(c, a)));
  return normalize3(sub3(p, x));
}

// VNDF_dist::pdf with the GGX alpha ``r``.
__device__ __forceinline__ float vndf_pdf(float r, Vec3 in, Vec3 n, Vec3 dir, float eps) {
  const Vec3 nx = choose_local_x(n);
  const Vec3 ny = cross3(n, nx);
  const Vec3 v = {-dot3(nx, in), -dot3(ny, in), -dot3(n, in)};
  const Vec3 nv = normalize3(sub3(dir, in));
  const Vec3 m = {dot3(nx, nv), dot3(ny, nv), dot3(n, nv)};
  const float vdn = dot3(v, m);
  const float r2 = r * r;
  const float lam = (sqrtf((v.x * v.x + v.y * v.y) * r2 / (v.z * v.z) + 1.0f) + -1.0f) * 0.5f;
  const float g1 = 1.0f / (lam + 1.0f);
  const float len_ns = (m.x * m.x + m.y * m.y) / (r * r) + m.z * m.z;
  const float dn = 1.0f / (kPiF * r * r * len_ns * len_ns);
  const float dv = g1 * vdn * dn / clamp_min(v.z, eps);
  const float res = dv / (4.0f * vdn);
  return vdn <= 0.0f ? 0.0f : res;
}

__device__ __forceinline__ float heaviside(float x) { return x > 0.0f ? 1.0f : 0.0f; }

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// pbr_brdf: the metallic lerp of the dielectric (Fresnel mix of Lambert and
// GGX) and the metallic (conductor Fresnel of GGX) BRDFs.
__device__ __forceinline__ Vec3 pbr_brdf(Vec3 in, Vec3 out, Vec3 n, Vec3 base, float metallic,
                                         float roughness, float ior, float min_roughness) {
  const float a = clamp_min(roughness, min_roughness);
  const float alpha = a * a;
  // specular_brdf
  const Vec3 h = normalize3(sub3(out, in));
  const float ndh = dot3(n, h);
  const float a2 = alpha * alpha;
  const float den = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float dist = a2 * heaviside(ndh) / (kPiF * (den * den));
  const float ndo = dot3(n, out);
  const float ndi = dot3(n, neg3(in));
  const float div1 = fabsf(ndo) + sqrtf(a2 + (1.0f - a2) * ndo * ndo);
  const float div2 = fabsf(ndi) + sqrtf(a2 + (1.0f - a2) * ndi * ndi);
  const float vis = heaviside(dot3(h, out)) * heaviside(dot3(h, neg3(in))) / (div1 * div2);
  const float spec = vis * dist;
  const float vdh = dot3(neg3(in), h);
  const float p5 = pow5(1.0f - fabsf(vdh));
  // fresnel_mix of diffuse_brdf and the specular lobe
  const float rr = (1.0f - ior) / (ior + 1.0f);
  const float f0 = rr * rr;
  const float fr = f0 + (1.0f - f0) * p5;
  const float b[3] = {base.x, base.y, base.z};
  float res[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dielectric = b[k] * kInvPiF * (1.0f - fr) + spec * fr;
    const float metal = spec * (b[k] + (1.0f - b[k]) * p5);  // conductor_fresnel
    res[k] = (metallic < 1.0f ? (1.0f - metallic) * dielectric : 0.0f) +
             (metallic > 0.0f ? metallic * metal : 0.0f);
  }
  return {res[0], res[1], res[2]};
}

// Scene::bg_at, the equirect lookup: the gamma-2.2 bilinear tap at the
// direction's (u, v), times bg_color.
__device__ __forceinline__ Vec3 env_radiance(const Atlas& at, int env_tex, const float* bg,
                                             Vec3 d) {
  const float u = 0.5f * atan2f(d.z, d.x) * kInvPiF + 0.5f;
  const float v = 0.5f - asinf(clamp(d.y, -1.0f, 1.0f)) * kInvPiF;
  const float4 c = fetch(at, env_tex, wrap_repeat(u), wrap_repeat(v), true);
  return {bg[0] * c.x, bg[1] * c.y, bg[2] * c.z};
}

// The record's fields (K2's layout): normal 0-2, shading normal 3-5, color
// 6-9, emission 10-12, metallic 13, roughness 14, ior 15.
struct Record {
  Vec3 normal, shading;
  float4 color;
  Vec3 emission;
  float metallic, roughness, ior;
};

__device__ __forceinline__ Record load_record(const float4* rec, int i) {
  const float4 a = rec[4 * (size_t)i], b = rec[4 * (size_t)i + 1], c = rec[4 * (size_t)i + 2],
               e = rec[4 * (size_t)i + 3];
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, make_float4(b.z, b.w, c.x, c.y), {c.z, c.w, e.x},
          e.y, e.z, e.w};
}

__global__ void __launch_bounds__(kShadeThreads) shade_sample_kernel(
    const float* __restrict__ origin,      // [R, 3]
    const float* __restrict__ direction,   // [R, 3]
    const float* __restrict__ throughput,  // [R, 3]
    const float* __restrict__ radiance,    // [R, 3]
    const uint8_t* __restrict__ alive,     // [R] bool
    const float* __restrict__ draws,       // [10, R]
    const float* __restrict__ t_hit,       // [R]
    const uint8_t* __restrict__ hit,       // [R] bool
    const float4* __restrict__ record,     // [R, 16]
    const float* __restrict__ light_verts, // [L, 9], or null: no light rows
    int n_lights, const float* __restrict__ bg_color, Atlas atlas, int env_tex, float vf,
    float min_roughness, int n_rays,
    float* __restrict__ pos_out,           // [R, 3]
    float* __restrict__ dir_out,           // [R, 3]
    float* __restrict__ radiance_out,      // [R, 3]
    uint8_t* __restrict__ flags) {         // [R, 2] bool: shade, passthrough
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const size_t n = (size_t)n_rays;
  const Vec3 o = load3(origin, i), d = load3(direction, i), thr = load3(throughput, i);
  Vec3 rad = load3(radiance, i);
  const bool live_in = alive[i] != 0, is_hit = hit[i] != 0;
  const Record rc = load_record(record, i);

  Vec3 add = {0.0f, 0.0f, 0.0f};
  if (live_in && !is_hit) {
    const Vec3 env = env_tex >= 0 ? env_radiance(atlas, env_tex, bg_color, d)
                                  : Vec3{bg_color[0], bg_color[1], bg_color[2]};
    add = mul3(thr, env);
  }
  rad = add3(rad, add);

  const bool live = live_in && is_hit;
  const float t = t_hit[i];
  const Vec3 pos = add3(o, scale3(t, d));
  const bool alpha_pass = draws[i] > rc.color.w;
  const bool passthrough = live && alpha_pass;
  const bool shade = live && !alpha_pass;
  rad = add3(rad, shade ? mul3(thr, rc.emission) : Vec3{0.0f, 0.0f, 0.0f});

  Vec3 new_dir;
  if (draws[n + i] <= vf) {
    const float a = clamp_min(rc.roughness, min_roughness);
    new_dir = vndf_sample(a * a, d, rc.shading, draws[2 * n + i], draws[3 * n + i]);
  } else {
    bool pick_light = false;
    int li = 0;
    if (light_verts != nullptr) {
      pick_light = pick_uniform(draws[4 * n + i], 2) == 1 && n_lights > 0;
      li = pick_uniform(draws[7 * n + i], n_lights);
    }
    if (pick_light) {
      const float* lv = light_verts + (size_t)li * 9;
      new_dir = light_triangle_sample(pos, {lv[0], lv[1], lv[2]}, {lv[3], lv[4], lv[5]},
                                      {lv[6], lv[7], lv[8]}, draws[8 * n + i], draws[9 * n + i]);
    } else {
      new_dir = cosine_sample(rc.normal, draws[5 * n + i], draws[6 * n + i]);
    }
  }
  store3(pos_out, i, pos);
  store3(dir_out, i, new_dir);
  store3(radiance_out, i, rad);
  flags[2 * (size_t)i] = shade ? 1 : 0;
  flags[2 * (size_t)i + 1] = passthrough ? 1 : 0;
}

__global__ void __launch_bounds__(kShadeThreads) shade_finish_kernel(
    const float* __restrict__ origin,      // [R, 3]
    const float* __restrict__ direction,   // [R, 3]
    const float* __restrict__ throughput,  // [R, 3]
    const int32_t* __restrict__ tri,       // [R]
    const float4* __restrict__ record,     // [R, 16]
    const float* __restrict__ pos,         // [R, 3]
    const float* __restrict__ new_dir,     // [R, 3]
    const uint8_t* __restrict__ flags,     // [R, 2] bool: shade, passthrough
    const float* __restrict__ p_light,     // [R], or null: the cosine lobe alone
    float vf, float one_minus_vf, float eps, float min_roughness, int chunk_tris, int n_rays,
    float* __restrict__ origin_out,        // [R, 3]
    float* __restrict__ direction_out,     // [R, 3]
    float* __restrict__ throughput_out,    // [R, 3]
    uint8_t* __restrict__ moved_out,       // [R] bool
    int32_t* __restrict__ hint_out) {      // [R]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const bool shade = flags[2 * (size_t)i] != 0, passthrough = flags[2 * (size_t)i + 1] != 0;
  const Vec3 d = load3(direction, i), nd = load3(new_dir, i);
  Vec3 thr = load3(throughput, i);
  bool cont = false;
  if (shade) {
    const Record rc = load_record(record, i);
    const float a = clamp_min(rc.roughness, min_roughness);
    const float p_vndf = vndf_pdf(a * a, d, rc.shading, nd, eps);
    const float p_cos = clamp_min(dot3(rc.normal, nd) * kInvPiF, 0.0f);
    const float p_mix = p_light != nullptr ? (p_cos + p_light[i]) * 0.5f : p_cos;
    const float p = vf * p_vndf + one_minus_vf * p_mix;
    const Vec3 f = pbr_brdf(d, nd, rc.shading, {rc.color.x, rc.color.y, rc.color.z},
                            rc.metallic, rc.roughness, rc.ior, min_roughness);
    const float cos_term = clamp_min(dot3(nd, rc.shading), 0.0f);
    const float q = cos_term / p;
    const Vec3 scl = {f.x * q, f.y * q, f.z * q};
    const bool kill = isnan(nd.x) || isnan(nd.y) || isnan(nd.z) || p < eps ||
                      dot3(scl, scl) == 0.0f;
    cont = !kill;
    if (cont) thr = mul3(thr, scl);
  }
  const bool moved = passthrough || cont;
  const int32_t tr = tri[i];
  int32_t chunk = tr / chunk_tris;  // floor division, as torch.div(..., "floor")
  if ((tr % chunk_tris != 0) && ((tr < 0) != (chunk_tris < 0))) chunk -= 1;
  store3(origin_out, i, moved ? load3(pos, i) : load3(origin, i));
  store3(direction_out, i, cont ? nd : d);
  store3(throughput_out, i, thr);
  moved_out[i] = moved ? 1 : 0;
  hint_out[i] = moved ? chunk : -1;
}

}  // namespace

extern "C" int tpt_light_pdf_flat(
    const void* origin, const void* direction, const void* woop, const void* cluster_k,
    int n_rays, int n_clusters, int cw, float min_dst, float inv_count, void* out,
    void* stream) {
  if (n_rays == 0) return 0;
  light_pdf_flat_kernel<<<(n_rays + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)woop,
      (const float*)cluster_k, n_rays, n_clusters, cw, min_dst, inv_count, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_shade_gather(
    const void* attrs, const void* tri, const void* beta, const void* gamma,
    const void* direction, const void* texels, const void* quad, const void* offset,
    const void* width, const void* height, int n_rays, int slots, void* record, void* inside,
    void* stream) {
  if (n_rays == 0) return 0;
  const Atlas atlas = {(const float4*)texels, (const float4*)quad, (const int32_t*)offset,
                       (const int32_t*)width, (const int32_t*)height};
  shade_gather_kernel<<<(n_rays + kShadeThreads - 1) / kShadeThreads, kShadeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)attrs, (const int32_t*)tri, (const float*)beta, (const float*)gamma,
      (const float*)direction, atlas, n_rays, slots, (float4*)record, (uint8_t*)inside);
  return (int)cudaGetLastError();
}

extern "C" int tpt_shade_sample(
    const void* origin, const void* direction, const void* throughput, const void* radiance,
    const void* alive, const void* draws, const void* t_hit, const void* hit, const void* record,
    const void* light_verts, int n_lights, const void* bg_color, const void* texels,
    const void* quad, const void* offset, const void* width, const void* height, int env_tex,
    float vf, float min_roughness, int n_rays, void* pos, void* new_dir, void* radiance_out,
    void* flags, void* stream) {
  if (n_rays == 0) return 0;
  const Atlas atlas = {(const float4*)texels, (const float4*)quad, (const int32_t*)offset,
                       (const int32_t*)width, (const int32_t*)height};
  shade_sample_kernel<<<(n_rays + kShadeThreads - 1) / kShadeThreads, kShadeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)throughput,
      (const float*)radiance, (const uint8_t*)alive, (const float*)draws, (const float*)t_hit,
      (const uint8_t*)hit, (const float4*)record, (const float*)light_verts, n_lights,
      (const float*)bg_color, atlas, env_tex, vf, min_roughness, n_rays, (float*)pos,
      (float*)new_dir, (float*)radiance_out, (uint8_t*)flags);
  return (int)cudaGetLastError();
}

extern "C" int tpt_shade_finish(
    const void* origin, const void* direction, const void* throughput, const void* tri,
    const void* record, const void* pos, const void* new_dir, const void* flags,
    const void* p_light, float vf, float one_minus_vf, float eps, float min_roughness,
    int chunk_tris, int n_rays, void* origin_out, void* direction_out, void* throughput_out,
    void* moved, void* hint, void* stream) {
  if (n_rays == 0) return 0;
  shade_finish_kernel<<<(n_rays + kShadeThreads - 1) / kShadeThreads, kShadeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)throughput,
      (const int32_t*)tri, (const float4*)record, (const float*)pos, (const float*)new_dir,
      (const uint8_t*)flags, (const float*)p_light, vf, one_minus_vf, eps, min_roughness,
      chunk_tris, n_rays, (float*)origin_out, (float*)direction_out, (float*)throughput_out,
      (uint8_t*)moved, (int32_t*)hint);
  return (int)cudaGetLastError();
}
