// K1: present — Reinhard tonemap + clamp + uint8 quantize.
//
// Replaces mrt_tpu/kernels/present.py:tonemap_quantize (the Pallas _kernel).
// out = trunc(clamp(c / (1 + c), 0, 1) * 255 + 0.5) per channel, written as
// uint8 directly (the TPU kernel emitted int32 on 128-lane rows and narrowed
// outside; here there is no padding and no int32 detour).
//
// Bound: bytes. Each pixel reads 12 B and writes 3 B, with a handful of
// flops. The design keeps to one read and one write per element: each
// thread handles four consecutive floats (one 16-byte load, one 4-byte
// store) over a grid-stride loop; a scalar tail covers n % 4.
// Built with -fmad=false so `tone * 255 + 0.5` rounds twice, like the plain
// PyTorch version and the JAX fallback.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned char quantize(float c) {
    float tone = c / (1.0f + c);
    tone = fminf(fmaxf(tone, 0.0f), 1.0f);
    return (unsigned char)(tone * 255.0f + 0.5f);
}

__global__ void present_kernel(const float* __restrict__ in, unsigned char* __restrict__ out,
                               long long n) {
    long long n4 = n / 4;
    long long stride = (long long)gridDim.x * blockDim.x;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    uchar4* out4 = reinterpret_cast<uchar4*>(out);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
        float4 c = __ldg(in4 + i);
        out4[i] = make_uchar4(quantize(c.x), quantize(c.y), quantize(c.z), quantize(c.w));
    }
    for (long long i = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        out[i] = quantize(in[i]);
    }
}

extern "C" int mrt_present(const void* in, void* out, long long n, void* stream) {
    if (n <= 0) return 0;
    const int block = 256;
    long long blocks = (n / 4 + block - 1) / block;
    if (blocks < 1) blocks = 1;
    if (blocks > 4096) blocks = 4096;
    present_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
        (const float*)in, (unsigned char*)out, n);
    return (int)cudaGetLastError();
}
