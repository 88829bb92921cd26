// Hand-written Hopper (sm_90a) kernels of two functions of the shading stage
// that the JAX package leaves to XLA: the flat light-cluster pdf (K1) and the
// hit record with its texture fetch (K2).
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
// to it on the card, contiguous and strided).
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

__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return (a0 + a2) + a1; }

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
