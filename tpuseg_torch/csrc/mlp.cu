// E1: MedNeXt's block MLP as one kernel (no Pallas counterpart: the net is
// the port's alone). For a bf16 NCDHW tensor a (N, ci, D, H, W), the
// module's float32 1x1x1 convs conv2 (e, ci) and conv3 (co, e) with their
// biases b2 (e) and b3 (co), and an optional bf16 residual R of the
// output's shape:
//
//   y[n, o, v] = bf16(sum_j W3[o, j] g[j] + b3[o] (+ R[n, o, v])),
//   g[j] = bf16(GELU(sum_c W2[j, c] a[n, c, v] + b2[j]))
//
// W2 and W3 are the weights rounded to bf16 (the tensor-core operands), the
// biases float32, every sum float32, GELU the exact erf form (erff in
// float32, as torch's F.gelu). The expanded value g is rounded once (it is
// the second product's operand), the output once, and g never leaves the
// chip: before this kernel the block ran five passes (a matmul, a broadcast
// bias add, F.gelu, a matmul, a bias add) and a residual add, each reading
// and writing the e-wide tensor in device memory.
//
// What bounds it. Bytes at the 128^3 level (32 -> 96 -> 32: 12,288 FLOP
// against 192 bytes a voxel, 64 FLOP a byte, under the card's ridge of
// ~295), the tensor cores deeper (level 4, 512 -> 4096 -> 512 on 8^3: ~3000
// FLOP a byte), and at every level the GELU: erff for each of the ~1.1e11
// expanded values of a stack, ~30 instructions each with the bias, the
// products and the packing, issued on the CUDA cores (on an H100 ~0.94e12
// a second at three CTAs an SM, ~1.0e12 at full occupancy, measured alone):
// ~110 ms a stack, above the tensor cores' 35 and the bytes' 49. So the
// design keeps the CUDA cores on the GELU and the rest off them:
//
// * A CTA is one warpgroup; it walks 64-voxel tiles of one sample (wgmma's
//   M side; tiles do not straddle samples) as a persistent CTA, one to four
//   CTAs an SM as registers and shared memory allow, so one CTA's products
//   and loads overlap another's GELU. Per tile and e-chunk of EC:
//   G1 = X (64 x ci, shared memory) x W2c^T (EC x ci) on wgmma into float32
//   registers; bias and GELU in registers, packed to bf16 pairs, which are
//   G2's A operand as they lie (the accumulator of an m64nEC product is the
//   register A fragment of m64k16 products, FlashAttention-3's P.V reuse);
//   G2 = g x W3c^T accumulates the tile's co outputs in float32 over the
//   chunks in a fixed order.
// * X is staged MN-major (wgmma's transposed A): [ci / 8][8 voxel groups]
//   [8 channels][8 voxels], so each 16 bytes is 8 voxels of one channel, as
//   NCDHW lies: 16-byte cp.async copies straight from device memory with no
//   register transpose, the next tile's issued as soon as the last G1 of a
//   tile has read the buffer. W2c and W3c are K-major (their rows are the
//   modules' weight rows), packed once a call by fused_mlp_pack_kernel into
//   the stage layout, so a stage is two contiguous runs, each one bulk copy
//   by the copy engine (issued by one thread, completing on the stage's
//   mbarrier) in flight during the previous chunk's GELU and G2: per-thread
//   16-byte copies held the deep levels to ~24 GB/s of weights an SM
//   (level 4 and up 3 ran 30% slower so). Where e is one or two chunks (the
//   blocks of 96, 128 and 192 at 128^3 and 64^3) the weights are copied
//   once a CTA and stay.
// * co wider than 256 (level 4 and the last down block, 512) would need 256
//   accumulators a thread: the output channels split into slices of 256,
//   a unit of work each, G1 and the GELU computed again for each slice
//   (those levels hold ~1% of the expanded values). No split of the e sum
//   across CTAs and no atomics: the same input gives the same bits.
// * The epilogue adds b3 and R (staged beside the tile by cp.async, a unit
//   ahead) to the float32 sums, rounds once, writes the bf16 tile through
//   shared memory and stores it as 16-byte rows of NCDHW.
// * A tensor whose channel rows are not 16-byte aligned (the up blocks'
//   (2S - 1)^3 volumes) is staged and stored by 2-byte accesses, the
//   ragged last tile of each sample predicated.
//
// Launch errors come back as the entry point's return value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace tpuseg {
namespace {

constexpr int kThreads = mma::kWarpgroup;  // one warpgroup a CTA
constexpr int kTile = 64;                  // voxels a tile: wgmma's M
constexpr int kStages = 2;                 // weight stages
constexpr int kYPitch = 72;   // bf16 a staged output row: 144 bytes, so the
                              // rows an accumulator store touches fall in
                              // distinct banks
constexpr int kMaxNco = 256;  // output channels of a unit
// torch's GELU constant: M_SQRT1_2 in float32
constexpr float kAlpha = 0.70710678118654752440f;

// wgmma, 64 x N x 16, float32 sums. wgmma_ss: A (MN-major) and B (K-major)
// in shared memory through descriptors; wgmma_rs: A from four registers of
// bf16 pairs, B in shared memory. scale_d 0 starts a sum without zeroing
// the accumulators first (an instruction that wrote them between products
// would serialize the chain).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The weight stages arrive by bulk copies (the copy engine, one thread
// issuing) on one mbarrier a stage: expect the stage's bytes, copy, wait
// for the phase. A stage that never lands traps rather than hangs.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// keeps the compiler from moving accesses to wgmma's register operands
// across the asynchronous products that read them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}
__device__ __forceinline__ float bf16_value(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// What a call computes. wp: the packed weights (fused_mlp_pack_kernel). r
// may be null. V: voxels of a sample; tiles: 64-voxel tiles of a sample;
// units: tiles x N x co slices; vec: every channel row 16-byte aligned and
// whole tiles (V a multiple of 64, a, r, y 16-byte aligned).
struct Mlp {
  const __nv_bfloat16* a;
  const __nv_bfloat16* wp;
  const float* b2;
  const float* b3;
  const __nv_bfloat16* r;
  __nv_bfloat16* y;
  int N, e, co, V, tiles, units, vec;
};

// minimum CTAs an SM for the register budget: 1 where the tile's co
// accumulators are 128 a thread
template <int NCO>
struct MinCtas {
  static constexpr int value = NCO >= 256 ? 1 : NCO >= 128 ? 2 : 4;
};

// One tiling: CI input channels, NCO output channels of a unit, EC expanded
// channels a chunk. Shared memory: X [CI / 8][8][8][8] bf16, the staged
// output tile [NCO][kYPitch], two weight stages of W2c [CI / 8][EC][8] and
// W3c [EC / 8][NCO][8], an mbarrier a stage.
template <int CI, int NCO, int EC>
struct Body {
  static_assert(CI % 16 == 0 && EC % 16 == 0 && NCO % 8 == 0, "shapes");
  static constexpr int kXBytes = CI * kTile * 2;
  static constexpr int kYBytes = NCO * kYPitch * 2;
  static constexpr int kW2Bytes = EC * CI * 2;
  static constexpr int kW3Bytes = NCO * EC * 2;
  static constexpr int kStage = kW2Bytes + kW3Bytes;
  static constexpr int kSmem =
      kXBytes + kYBytes + kStages * kStage + 8 * kStages;
  static_assert(kSmem <= mma::kMaxSmem, "shared memory");
  static_assert(kStages == 2, "the step's stage is k & 1");

  Mlp p;
  int chunks, slices, per_slice;
  bool resident;

  __device__ explicit Body(const Mlp& m) : p(m) {
    chunks = p.e / EC;
    slices = p.co / NCO;
    per_slice = p.N * p.tiles;
    resident = chunks <= kStages && slices == 1;
  }

  struct Unit {
    int cs, n, t, m0, rows;
  };
  // units run tile fastest, then sample, then co slice; rows: voxels of
  // the tile in the sample, 64 but at its end
  __device__ Unit unit(int u) const {
    Unit g;
    g.cs = u / per_slice;
    u -= g.cs * per_slice;
    g.n = u / p.tiles;
    g.t = u - g.n * p.tiles;
    return place(g);
  }
  // the unit `by` units after g, dividing only where it wraps a sample
  __device__ Unit after(Unit g, int by) const {
    g.t += by;
    if (g.t >= p.tiles) {
      const int q = g.t / p.tiles;
      g.t -= q * p.tiles;
      g.n += q;
      if (g.n >= p.N) {
        const int q2 = g.n / p.N;
        g.n -= q2 * p.N;
        g.cs += q2;
      }
    }
    return place(g);
  }
  __device__ Unit place(Unit g) const {
    g.m0 = g.t * kTile;
    g.rows = min(kTile, p.V - g.m0);
    return g;
  }

  // chunk c of slice cs into the stage at st, completing on bar: W2c then
  // W3c, two contiguous runs of the packed weights. One thread.
  __device__ void weights(int cs, int c, uint32_t st, uint32_t bar) const {
    const uint4* w2 = reinterpret_cast<const uint4*>(p.wp) +
                      static_cast<int64_t>(c) * (kW2Bytes / 16);
    const uint4* w3 = reinterpret_cast<const uint4*>(p.wp) +
                      static_cast<int64_t>(p.e) * CI / 8 +
                      static_cast<int64_t>(cs * chunks + c) * (kW3Bytes / 16);
    mbar_expect(bar, kStage);
    bulk_copy(st, w2, kW2Bytes, bar);
    bulk_copy(st + kW2Bytes, w3, kW3Bytes, bar);
  }

  // The tile's input into xs, MN-major: word w = (kb * 8 + mb) * 8 + k8
  // holds voxels m0 + 8 mb .. + 7 of channel 8 kb + k8. vec: eight lanes
  // take the eight channels of a core matrix (128 contiguous bytes of
  // shared memory), four voxel groups a warp (64 contiguous bytes a channel
  // row), 16 bytes a cp.async. Else a lane packs a word from eight 2-byte
  // loads, zero past the sample's end.
  __device__ void stage_x(const Unit& g, unsigned char* xs, uint32_t xs_addr,
                          int tid) const {
    const __nv_bfloat16* src =
        p.a + static_cast<int64_t>(g.n) * CI * p.V + g.m0;
    if (p.vec) {
#pragma unroll 4
      for (int w = tid; w < CI * 8; w += kThreads) {
        const int k = (w & 7) + 8 * (w >> 6), mb = (w >> 3) & 7;
        cp_async16(xs_addr + 16 * w,
                   src + static_cast<int64_t>(k) * p.V + 8 * mb);
      }
      return;
    }
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 2
    for (int w0 = tid; w0 < CI * 8; w0 += kThreads) {
      // eight lanes take the eight voxel groups of a channel: a warp's load
      // spans four channel rows of 128 bytes
      const int w = (w0 & ~63) | ((w0 & 7) << 3) | ((w0 >> 3) & 7);
      const int k = (w & 7) + 8 * (w >> 6), m = 8 * ((w >> 3) & 7);
      const unsigned short* q = s16 + static_cast<int64_t>(k) * p.V + m;
      unsigned short v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = m + j < g.rows ? __ldg(q + j) : 0;
      reinterpret_cast<uint4*>(xs)[w] =
          make_uint4(v[0] | (static_cast<uint32_t>(v[1]) << 16),
                     v[2] | (static_cast<uint32_t>(v[3]) << 16),
                     v[4] | (static_cast<uint32_t>(v[5]) << 16),
                     v[6] | (static_cast<uint32_t>(v[7]) << 16));
    }
  }

  // The tile's residual rows into ys [NCO][kYPitch]
  __device__ void stage_r(const Unit& g, unsigned short* ys, uint32_t ys_addr,
                          int tid) const {
    const __nv_bfloat16* src =
        p.r + (static_cast<int64_t>(g.n) * p.co + g.cs * NCO) * p.V + g.m0;
    if (p.vec) {
#pragma unroll 4
      for (int w = tid; w < NCO * 8; w += kThreads) {
        const int o = w >> 3, v = w & 7;
        cp_async16(ys_addr + 2 * (o * kYPitch + 8 * v),
                   src + static_cast<int64_t>(o) * p.V + 8 * v);
      }
      return;
    }
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 4
    for (int i = tid; i < NCO * kTile; i += kThreads) {
      const int o = i >> 6, m = i & 63;
      ys[o * kYPitch + m] =
          m < g.rows ? __ldg(s16 + static_cast<int64_t>(o) * p.V + m) : 0;
    }
  }

  // G1: h = X x W2c^T over the ci / 16 depth steps, h overwritten
  __device__ static void g1(float (&h)[EC / 2], uint32_t xs_addr,
                            uint32_t st) {
    const uint64_t da = mma::desc_at(mma::desc_strides(8 * 128, 128), xs_addr);
    const uint64_t db = mma::desc_at(mma::desc_strides(EC * 16, 128), st);
#pragma unroll
    for (int s = 0; s < CI / 16; ++s)
      wgmma_ss(h, da + s * (2 * 8 * 128 / 16), db + s * (2 * EC * 16 / 16),
               s > 0);
  }

  // GELU(h + b2) of chunk c, packed: accumulator i of the m64nEC product
  // holds row 16 warp + lane / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
  // 2 (lane & 3) + (i & 1), which is where the register A fragment of the
  // m64k16 product over columns 16 s .. 16 s + 15 wants it: a[s][0] rows r,
  // columns 2q, 2q + 1; a[s][1] rows r + 8; a[s][2], a[s][3] columns + 8.
  __device__ void gelu(const float (&h)[EC / 2], uint32_t (&a)[EC / 16][4],
                       int c, int lane) const {
    const float* b2 = p.b2 + c * EC + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < EC / 8; ++j) {
      const float b0 = __ldg(b2 + 8 * j), b1 = __ldg(b2 + 8 * j + 1);
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        a[j >> 1][2 * (j & 1) + (e >> 1)] =
            mma::pack_pair(gelu_erf(h[4 * j + e] + b0),
                           gelu_erf(h[4 * j + e + 1] + b1));
    }
  }

  // G2: y += g x W3c^T over the EC / 16 depth steps; y overwritten at the
  // first step of a unit's first chunk
  __device__ static void g2(float (&y)[NCO / 2],
                            const uint32_t (&a)[EC / 16][4], uint32_t st,
                            int accumulate) {
    const uint64_t db =
        mma::desc_at(mma::desc_strides(NCO * 16, 128), st + kW2Bytes);
#pragma unroll
    for (int s = 0; s < EC / 16; ++s)
      wgmma_rs(y, a[s], db + s * (2 * NCO * 16 / 16), s > 0 || accumulate);
  }

  // y + b3 (+ R) rounded once into ys, then ys stored as the output rows
  __device__ void epilogue(const float (&y)[NCO / 2], const Unit& g,
                           unsigned short* ys, int tid, int warp,
                           int lane) const {
    // accumulator i: channel 8 (i >> 2) + 2 (lane & 3) + (i & 1), voxel
    // 16 warp + lane / 4 + 8 ((i >> 1) & 1)
    const float* b3 = p.b3 + g.cs * NCO + 2 * (lane & 3);
    unsigned short* yt =
        ys + 2 * (lane & 3) * kYPitch + 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NCO / 2; i += 2) {
      unsigned short* y0 = yt + 8 * (i >> 2) * kYPitch + 8 * ((i >> 1) & 1);
      float v0 = y[i] + __ldg(b3 + 8 * (i >> 2));
      float v1 = y[i + 1] + __ldg(b3 + 8 * (i >> 2) + 1);
      if (p.r) {
        v0 += bf16_value(y0[0]);
        v1 += bf16_value(y0[kYPitch]);
      }
      y0[0] = bf16_bits(v0);
      y0[kYPitch] = bf16_bits(v1);
    }
    __syncthreads();
    __nv_bfloat16* dst =
        p.y + (static_cast<int64_t>(g.n) * p.co + g.cs * NCO) * p.V + g.m0;
    if (p.vec) {
#pragma unroll 4
      for (int w = tid; w < NCO * 8; w += kThreads) {
        const int o = w >> 3, v = w & 7;
        *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(o) * p.V +
                                  8 * v) =
            *reinterpret_cast<const uint4*>(ys + o * kYPitch + 8 * v);
      }
    } else {
      unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll 4
      for (int i = tid; i < NCO * kTile; i += kThreads) {
        const int o = i >> 6, m = i & 63;
        if (m < g.rows)
          d16[static_cast<int64_t>(o) * p.V + m] = ys[o * kYPitch + m];
      }
    }
    __syncthreads();
  }
};

// The kernel. CTA b takes units b, b + gridDim.x, ...; step k is chunk
// k % chunks of its (k / chunks)-th unit, in stage k % 2 (stage c where the
// weights stay: chunks <= 2, one slice), whose weights were fetched a step
// ahead by bulk copies on the stage's mbarrier (its (k / 2)-th phase). The
// input and the residual are staged by cp.async a unit ahead, in groups
// committed in a fixed pattern: the prologue commits the first unit's
// input, then its residual; every step one group, the next unit's input
// after the unit's last G1 (else nothing); every unit's end the next
// unit's residual (else nothing). So a unit's first step and its epilogue
// each wait for all but the newest group.
template <int CI, int NCO, int EC>
__global__ void __launch_bounds__(kThreads, MinCtas<NCO>::value)
    fused_mlp_kernel(Mlp p) {
  using B = Body<CI, NCO, EC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const B body(p);
  if (static_cast<int>(blockIdx.x) >= p.units) return;
  const int units = (p.units - 1 - blockIdx.x) / gridDim.x + 1;
  const int steps = units * body.chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* xs = smem;
  unsigned short* ys = reinterpret_cast<unsigned short*>(smem + B::kXBytes);
  const uint32_t xs_addr = mma::smem_addr(smem);
  const uint32_t ys_addr = xs_addr + B::kXBytes;
  const uint32_t ring = ys_addr + B::kYBytes;
  const uint32_t bars = ring + kStages * B::kStage;
  // the weights of chunk c of slice cs into a stage, by thread 0
  auto fetch = [&](int stage, int cs, int c) {
    if (tid == 0)
      body.weights(cs, c, ring + stage * B::kStage, bars + 8 * stage);
  };

  if (tid == 0) {
    for (int j = 0; j < kStages; ++j) mbar_init(bars + 8 * j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  typename B::Unit g = body.unit(blockIdx.x);
  body.stage_x(g, xs, xs_addr, tid);
  cp_async_commit();
  for (int c = 0; c < (body.resident ? body.chunks : 1); ++c)
    fetch(c, g.cs, c);
  if (p.r) body.stage_r(g, ys, ys_addr, tid);
  cp_async_commit();

  float h[EC / 2];
  float y[NCO / 2];
  uint32_t a[EC / 16][4];
  int k = 0;
  for (int i = 0; i < units; ++i) {
    const typename B::Unit next = body.after(g, gridDim.x);
    for (int c = 0; c < body.chunks; ++c, ++k) {
      if (c == 0) {
        cp_async_wait<1>();  // this unit's input
        mma::proxy_fence();
      }
      const int stage = body.resident ? c : k & 1;
      mbar_wait(bars + 8 * stage, body.resident ? 0 : (k >> 1) & 1);
      __syncthreads();
      const uint32_t st = ring + stage * B::kStage;
      mma::fence();
      B::g1(h, xs_addr, st);
      mma::commit();
      mma::wait_all();     // G1 and the previous step's G2 done
      mma::fence_acc(h);
      mma::fence_acc(y);
      fence_regs(a);
      __syncthreads();     // ... in every warp: X and the other stage free
      if (c + 1 == body.chunks && i + 1 < units)
        body.stage_x(next, xs, xs_addr, tid);
      cp_async_commit();
      if (!body.resident && k + 1 < steps) {
        if (c + 1 < body.chunks)
          fetch(stage ^ 1, g.cs, c + 1);
        else
          fetch(stage ^ 1, next.cs, 0);
      }
      body.gelu(h, a, c, lane);
      mma::fence();
      B::g2(y, a, st, c > 0);
      mma::commit();
    }
    mma::wait_all();
    mma::fence_acc(y);
    fence_regs(a);
    cp_async_wait<1>();  // this unit's residual
    __syncthreads();
    body.epilogue(y, g, ys, tid, warp, lane);
    if (p.r && i + 1 < units) body.stage_r(next, ys, ys_addr, tid);
    cp_async_commit();
    g = next;
  }
  cp_async_wait<0>();
}

// wp = W2 as [e / ec][ci / 8][ec][8] (chunk j: rows j ec ..) then W3 as
// [co / nco][e / ec][ec / 8][nco][8] (slice s, chunk j), bf16, from the
// module's float32 w2 (e, ci) and w3 (co, e): one 16-byte word a thread,
// read as two float4 of a weight row.
__global__ void fused_mlp_pack_kernel(const float* __restrict__ w2,
                                      const float* __restrict__ w3,
                                      __nv_bfloat16* __restrict__ wp, int ci,
                                      int e, int co, int ec, int nco) {
  const int64_t n2 = static_cast<int64_t>(e) * ci / 8;
  const int64_t n3 = static_cast<int64_t>(co) * e / 8;
  const int chunks = e / ec;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n2 + n3; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float* src;
    if (i < n2) {
      const int64_t per = static_cast<int64_t>(ec) * ci / 8;
      const int64_t j = i / per, rem = i - j * per;
      const int kg = static_cast<int>(rem / ec);
      const int64_t row = j * ec + rem % ec;
      src = w2 + row * ci + 8 * kg;
    } else {
      const int64_t i3 = i - n2;
      const int64_t per = static_cast<int64_t>(nco) * ec / 8;
      const int64_t blk = i3 / per, rem = i3 - blk * per;
      const int s = static_cast<int>(blk / chunks);
      const int j = static_cast<int>(blk % chunks);
      const int kg = static_cast<int>(rem / nco);
      const int o = static_cast<int>(rem % nco);
      src = w3 + static_cast<int64_t>(s * nco + o) * e + j * ec + 8 * kg;
    }
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
    reinterpret_cast<uint4*>(wp)[i] =
        make_uint4(mma::pack_pair(lo.x, lo.y), mma::pack_pair(lo.z, lo.w),
                   mma::pack_pair(hi.x, hi.y), mma::pack_pair(hi.z, hi.w));
  }
}

template <int CI, int NCO, int EC>
int launch(const Mlp& p, cudaStream_t stream) {
  using B = Body<CI, NCO, EC>;
  auto kernel = fused_mlp_kernel<CI, NCO, EC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent CTAs: as many as the card holds at once, at most a unit each
  static int resident_ctas = 0;
  if (resident_ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, B::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident_ctas = sms * per_sm;
  }
  kernel<<<min(p.units, resident_ctas), kThreads, B::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpuseg

// y = the block MLP of a (module comment), bf16 NCDHW, contiguous: a (N,
// ci, V), r (N, co, V) or null, y (N, co, V); w2 (e, ci) and w3 (co, e)
// the module's float32 weights, b2 (e) and b3 (co) its float32 biases; wp
// scratch of e * ci + co * e bf16 for the packed weights. (ci, nco, ec): a
// tiling built below (ops/mlp.py's TILINGS); e a multiple of ec, co of
// nco. Two launches: the packing, then the MLP.
extern "C" int tpuseg_fused_mlp(const void* a, const void* w2, const void* b2,
                                const void* w3, const void* b3, const void* r,
                                void* wp, void* y, int N, int ci, int e,
                                int co, int V, int ec, int nco,
                                void* stream) {
  using namespace tpuseg;
  if (N < 1 || V < 1 || ec < 16 || e % ec != 0 || nco < 8 ||
      nco > kMaxNco || co % nco != 0 || !a || !w2 || !b2 || !w3 || !b3 ||
      !wp || !y)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (V + kTile - 1) / kTile;
  const int64_t units = static_cast<int64_t>(tiles) * N * (co / nco);
  if (units >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t words =
      (static_cast<int64_t>(e) * ci + static_cast<int64_t>(co) * e) / 8;
  const int64_t blocks = (words + 255) / 256;
  fused_mlp_pack_kernel<<<static_cast<int>(blocks < 2048 ? blocks : 2048),
                          256, 0, s>>>(
      static_cast<const float*>(w2), static_cast<const float*>(w3),
      static_cast<__nv_bfloat16*>(wp), ci, e, co, ec, nco);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const Mlp p{static_cast<const __nv_bfloat16*>(a),
              static_cast<const __nv_bfloat16*>(wp),
              static_cast<const float*>(b2),
              static_cast<const float*>(b3),
              static_cast<const __nv_bfloat16*>(r),
              static_cast<__nv_bfloat16*>(y),
              N, e, co, V, tiles, static_cast<int>(units),
              V % kTile == 0 && aligned(a) && aligned(y) &&
                  (r == nullptr || aligned(r))};
#define TPUSEG_MLP_TILING(CI, NCO, EC) \
  if (ci == CI && nco == NCO && ec == EC) return launch<CI, NCO, EC>(p, s);
  TPUSEG_MLP_TILING(32, 32, 96)    // level 0 blocks
  TPUSEG_MLP_TILING(64, 32, 96)    // up 0
  TPUSEG_MLP_TILING(32, 64, 64)    // down 0
  TPUSEG_MLP_TILING(64, 64, 64)    // level 1 blocks
  TPUSEG_MLP_TILING(128, 64, 64)   // up 1
  TPUSEG_MLP_TILING(64, 128, 64)   // down 1
  TPUSEG_MLP_TILING(128, 128, 64)  // level 2 blocks
  TPUSEG_MLP_TILING(256, 128, 64)  // up 2
  TPUSEG_MLP_TILING(128, 256, 64)  // down 2
  TPUSEG_MLP_TILING(256, 256, 64)  // level 3 blocks, down 3 (two slices)
  TPUSEG_MLP_TILING(512, 256, 32)  // level 4 blocks (two slices), up 3
#undef TPUSEG_MLP_TILING
  return static_cast<int>(cudaErrorInvalidValue);
}
