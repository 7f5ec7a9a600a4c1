// The streamed bf16 attention body of the whole-encoder tower, its only user
// (csrc/encoder_tower.cu, above the staged body's 320 tokens):
// softmax(q k^T d^-1/2) v for 64 query rows of one (frame, head). 4 warps of
// 16 rows; K and V stream through shared memory in blocks of 64 keys,
// double-buffered with cp.async (46 KB). Each key block takes S = Q K^T on
// mma.sync m16n8k16 (bf16, f32 accumulate, Q's fragments kept in
// registers), then an online softmax in f32 registers (a running maximum
// and sum, O rescaled by exp(m_old - m_new)); P = exp(l - m) is cast to
// bf16 unnormalised and multiplied into V (the S fragments are the PV A
// fragments as they are), and O is multiplied by 1 / sum once, at the end:
// the TPU kernels' rounding point. The body runs on a group of THREADS
// threads, either half of the tower's 256-thread blocks, each half with its
// own shared memory and its own named barrier, so the two halves walk their
// work items independently. Its helpers (ldmatrix, mma_bf16) serve
// attention_s8_tile.cuh as well; pack_bf16 and the quad reductions are
// common.cuh's.
#pragma once

#include "common.cuh"

namespace attn_stream {

constexpr int D = 64;
constexpr int LDS = D + 8;        // shared-memory row pitch (bf16): 144 bytes
constexpr int WARPS = 4;          // each warp owns 16 query rows
constexpr int BQ = 16 * WARPS;    // query rows of a block
constexpr int BKEYS = 64;         // keys of a streamed block
constexpr int THREADS = 32 * WARPS;
// Q, then two stages of K and V
constexpr int SMEM_BYTES = (BQ + 2 * 2 * BKEYS) * LDS * 2;

// Four 8x8 b16 matrices from shared memory; lane i gives the row address
// of matrix i / 8, row i % 8 (the PTX fragment layouts of mma.m16n8k16).
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) x b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The caller's group of THREADS threads (one half of a 256-thread block):
// its index in the block and the thread's index within it.
__device__ __forceinline__ int group() { return threadIdx.x / THREADS; }
__device__ __forceinline__ int group_tid() { return threadIdx.x % THREADS; }

// Barrier of the caller's group only: named barrier 1 + group (0 is
// __syncthreads').
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group()), "n"(THREADS) : "memory");
}

// Rows r0 .. r0 + rows - 1 of x (pitch ld, head column h0) into shared rows
// of LDS; rows at or past `valid` are zero-filled. All THREADS threads of
// the group.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ x, size_t row0,
                                           int rows, int valid, int ld, int h0) {
  for (int c = group_tid(); c < rows * 8; c += THREADS) {
    const int r = c / 8, cc = (c % 8) * 8;
    const bool ok = r < valid;
    cp_async16(&dst[r * LDS + cc], x + (row0 + (ok ? r : 0)) * (size_t)ld + h0 + cc, ok);
  }
}

// Query rows q0 .. q0 + 63 of (frame, head). Row r of frame f, head h of x
// lies at x + (f * tokens + r) * ld + h * 64; out is (frames * tokens,
// heads * 64), f32 when OUT_F32, else bf16. smem holds SMEM_BYTES for the
// group; the caller separates successive items with group_sync().
template <bool OUT_F32>
__device__ __forceinline__ void tile(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, int ld, void* __restrict__ out,
                                     int tokens, int heads, float scale, int frame, int head,
                                     int q0, unsigned char* smem) {
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + BQ * LDS;   // stage s: K at KVs + 2 s BKEYS LDS, V after it
  const int warp = group_tid() / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group and column pair
  const size_t frame_row = (size_t)frame * tokens;
  const int h0 = head * D;
  const int nkb = (tokens + BKEYS - 1) / BKEYS;

  auto load_kv = [&](int kb, int stage) {
    const int k0 = kb * BKEYS;
    bf16* Ks = KVs + stage * 2 * BKEYS * LDS;
    stage_rows(Ks, k, frame_row + k0, BKEYS, tokens - k0, ld, h0);
    stage_rows(Ks + BKEYS * LDS, v, frame_row + k0, BKEYS, tokens - k0, ld, h0);
  };

  stage_rows(Qs, q, frame_row + q0, BQ, tokens - q0, ld, h0);
  load_kv(0, 0);
  cp_async_commit();

  unsigned qa[D / 16][4];               // this warp's 16 query rows, as A fragments
  float o[D / 8][4];                    // O (16 x 64), C fragments
  float m[2] = {-INFINITY, -INFINITY};  // running maxima of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of their running sums
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    if (kb + 1 < nkb) load_kv(kb + 1, (kb + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // block kb (and Q) have landed
    group_sync();
    if (kb == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ldmatrix_x4(qa[kc], &Qs[(warp * 16 + lane % 16) * LDS + kc * 16 + (lane / 16) * 8]);
    }
    const bf16* Ks = KVs + (kb & 1) * 2 * BKEYS * LDS;
    const bf16* Vs = Ks + BKEYS * LDS;

    // S = Q K^T: 8 column tiles of 8 keys, f32
    float s[BKEYS / 8][4];
#pragma unroll
    for (int j = 0; j < BKEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; kc += 2) {
        unsigned b[4];   // dims kc*16 .. +15 in b[0..1], (kc+1)*16 .. in b[2..3]
        ldmatrix_x4(b, &Ks[(j * 8 + lane % 8) * LDS + kc * 16 + (lane / 8) * 8]);
        mma_bf16(s[j], qa[kc], b);
        mma_bf16(s[j], qa[kc + 1], b + 2);
      }
    }

    // online softmax: logits * scale in f32, keys past `tokens` at -inf
    const int key0 = kb * BKEYS + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + (e & 1) < tokens;
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mx[r]));   // finite: key kb*64 is real
      alpha[r] = expf(m[r] - mnew);                       // 0 on the first block
      m[r] = mnew;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BKEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += bf16(P) V: the S tiles 2kc, 2kc + 1 are the A fragment of keys
    // kc*16 .. +15
#pragma unroll
    for (int kc = 0; kc < BKEYS / 16; ++kc) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        unsigned b[4];   // dims dn*8 .. +7 in b[0..1], (dn+1)*8 .. in b[2..3]
        ldmatrix_x4_trans(
            b, &Vs[(kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDS + dn * 8 + (lane / 16) * 8]);
        mma_bf16(o[dn], pa, b);
        mma_bf16(o[dn + 1], pa, b + 2);
      }
    }
    group_sync();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // O * (1 / sum), rows g and g + 8 of this warp's tile
  const int width = heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.0f / quad_sum(l[r]);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= tokens) continue;
    const size_t at = (frame_row + row) * (size_t)width + h0 + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = o[j][2 * r] * inv, b = o[j][2 * r + 1] * inv;
      if (OUT_F32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at + j * 8) = make_float2(a, b);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at + j * 8) =
            __floats2bfloat162_rn(a, b);
    }
  }
}

}  // namespace attn_stream
