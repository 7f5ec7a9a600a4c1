// The int8 MLP's c_fc product with its rows quantised in the epilogue: int8
// x int8 -> int32, the W8A8 dequant, the bias and QuickGELU in f32, then
// per-row absmax int8 values and f32 row scales. The f32 (M, N) intermediate
// never reaches device memory. One persistent, warp-specialised sm_90a
// kernel (TMA loads, wgmma products, a thread-block cluster a row panel).
//
// Replaces: in dfd_clip_tpu/ops/pallas_attention.py, `mid = _w8a8_dot(...)
// + bias; mid = QuickGELU(mid); mq, m_s = _quant_rows(mid)` inside the int8
// _make_mlp_block_kernel (:1253-1262, fused_encoder_mlp_block's TPU kernel,
// :1326) and the int8 _make_full_block_kernel (:1053-1062,
// fused_encoder_block's, :1212), where the intermediate stays in VMEM.
//
// Bound on an H100: tensor-core operations. 2 M N K int8 operations at 1979
// TOP/s against M K + N K bytes of operands and M N int8 values out at 3.35
// TB/s: 0.783 ms of operations and 0.28 ms of bytes at ViT-L/14@336px's
// c_fc (M = 184,640, K = 1024, N = 4096). The f32 output that
// gemm_s8 + quant_rows write and read back is 3.0 GB there.
//
// Design:
// - A row's scale needs the row's maximum over all N columns, which no
//   single CTA's registers hold. So a cluster of CTAs takes a 64-row panel
//   of the output at a time, CTA `rank` its 2 WN columns from rank x 2 WN,
//   its two consumer warpgroups WN each (wgmma m64nWNk32 s32.s8.s8, WN / 2
//   int32 accumulators a thread). WN is 256, or 192 where that gives a
//   cluster of a power of two, which packs the card's GPCs better: 8 CTAs
//   at N = 4096 (WN 256) and at 3072 (WN 192; 256 would need 6, and fewer
//   6-CTA clusters fit at once). ops/_cuda.py:quant_geometry chooses. The
//   grid is the co-resident cluster count; the clusters walk the row panels
//   with a static stride.
// - One producer thread a CTA fills a ring of 3 stages: the CTA's own 2 WN
//   weight rows (the weight stored (N, K), two TMA boxes of WN rows x 128
//   bytes of K) and A's 64 rows x 128 bytes, which every CTA of the cluster
//   needs: up to four CTAs each load a quarter of it into all of them (TMA
//   multicast). Each consumer warp releases a stage in every CTA of the
//   cluster, since the multicast writes into all of them; 72 KB a stage at
//   WN 256.
// - Epilogue, after the tile's last product has been waited for (a
//   non-wgmma read or write of an accumulator while a product is in flight
//   makes ptxas serialise every wgmma of the kernel): S8Op's epilogue
//   (csrc/gemm_ops.cuh: acc * (a_s / 127) * (w_s / 127) + bias, QuickGELU,
//   the f32 form's own instructions, so `mid` is the same f32 value bit for
//   bit) written back over the accumulators' registers, and each row's
//   maximum |mid| over the thread's columns, then its quad (shuffles), then
//   both consumer warpgroups (shared memory, a named barrier). Each consumer
//   warp sends 8 rows' maxima to every CTA of the cluster (st.shared::cluster
//   into a slot a rank, double-buffered by tile) and arrives on that CTA's
//   exchange mbarrier with release at cluster scope; each waits on its own
//   with acquire, and takes the maximum over the ranks.
// - The quantiser is csrc/quant_rows.cu's: s = max|mid| + 1e-8 and 127 / s
//   (row_ops::quant_consts, IEEE divisions), then the product, the clip and
//   round half to even, here as an add of 1.5 x 2^23 whose low byte is the
//   value (q8_bits: the same integer as quant8's rintf and cast). The int
//   <-> float conversions share one pipe with the exponential and the
//   reciprocal at an eighth of the FMA rate, and five of them a value bound
//   this epilogue; the add leaves three. So the values and scales equal
//   gemm_s8's f32 QuickGELU form followed by quant_rows bit for bit. A quad
//   transposes its int8 values (two byte permutes and two shuffles a
//   32-column piece) so that each lane stores 8 neighbouring values, a quad
//   one 32-byte sector of a row; rank 0's first consumer writes the 64 row
//   scales. Rows past M read zeros (TMA), store nothing, and only meet their
//   own maximum.
// - Shared memory at WN 256: the ring 216 KB, the tile's bias and w_scale /
//   127, the partial maxima and the exchange slots: 226 KB of the 227 KB a
//   block may have; so the epilogue has no staging tile and the column
//   operands one buffer (a warp fetches the next tile's only after every
//   local warp is past the exchange, hence past its reads).
#include "gemm_ops.cuh"
#include "rows.cuh"

namespace {

using namespace hgemm;

constexpr int QM = 64;                      // output rows of a tile (a row panel)
constexpr int MAX_CLUSTER = 8;              // portable cluster size
constexpr int QSTAGES = 3;
constexpr int QA_BYTES = QM * KBYTES;       // 8 KB
constexpr int PART_BYTES = NCONS * QM * 4;  // each consumer's row maxima
constexpr int XCH_BYTES = 2 * MAX_CLUSTER * QM * 4;       // two tiles' slots, a rank each
constexpr int BAR_BYTES = (2 * QSTAGES + 2) * 8;          // full, empty, exchange
constexpr int XCH_BARRIER = 3;   // named barrier of both consumer warpgroups (1, 2: each one's)

// Shared memory at consumer width WN.
template <int WN>
struct QLayout {
  static constexpr int QN = NCONS * WN;                   // output columns of a CTA
  static constexpr int STAGE_BYTES = QA_BYTES + QN * KBYTES;
  static constexpr int COL_OFF = QSTAGES * STAGE_BYTES;
  static constexpr int COL_BYTES = NCONS * 2 * WN * 4;    // bias and w_scale / 127
  static constexpr int PART_OFF = COL_OFF + COL_BYTES;
  static constexpr int XCH_OFF = PART_OFF + PART_BYTES;
  static constexpr int BAR_OFF = XCH_OFF + XCH_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + BAR_BYTES + 1024;   // + the base's alignment
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");
};

struct QuantParams {
  S8Op::Params p;    // out.m, out.n; a_scale, w_scale, bias
  int8_t* q;         // (M, N) int8 at row pitch ldq
  float* s;          // (M,) f32 row scales
  int ldq;
  int units;         // row panels
  int ktiles;        // 128-byte steps of K
  int loaders;       // CTAs that load A, rows / loaders each
};

template <int WN>
struct QSmem {
  using L = QLayout<WN>;
  uint32_t base;        // shared address of the data, 1024-byte aligned
  unsigned char* ptr;   // the same, generic
  __device__ uint32_t a(int s) const { return base + s * L::STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + QA_BYTES; }
  __device__ uint32_t full(int s) const { return base + L::BAR_OFF + 8u * s; }
  __device__ uint32_t empty(int s) const { return full(QSTAGES + s); }
  __device__ uint32_t xfull(int buf) const { return full(2 * QSTAGES + buf); }
  __device__ float* cols(int c) const {
    return reinterpret_cast<float*>(ptr + L::COL_OFF) + c * 2 * WN;
  }
  __device__ float* part() const { return reinterpret_cast<float*>(ptr + L::PART_OFF); }
  __device__ uint32_t xch(int buf) const {
    return base + L::XCH_OFF + buf * MAX_CLUSTER * QM * 4;
  }
  __device__ const float* xch_ptr(int buf) const {
    return reinterpret_cast<const float*>(ptr + L::XCH_OFF) + buf * MAX_CLUSTER * QM;
  }
};

// d (64 x 192) (+)= A (64 x 32, K-major) x B (32 x 192, K-major) int8 from
// shared memory, one instruction; `accumulate` 0 overwrites d (the
// m64n256k32 and m64n64k32 forms are gemm_hopper.cuh's, declared here too
// so that this overload does not hide them).
using hgemm::wgmma_s8;
__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      " %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A stage's products for a consumer of width WN: four k32 steps, 32 bytes
// along both operands' swizzled rows (S8Op::mma's, at any width).
template <int WN>
__device__ __forceinline__ void mma_s8(int (&acc)[WN / 2], uint32_t a, uint32_t b, int kt) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kt | kk);
}

// Arrive on a barrier of a CTA of the cluster (a map_rank address), this
// thread's earlier writes visible at cluster scope to whoever acquires it.
__device__ __forceinline__ void mbar_arrive_release_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// mbar_wait with acquire at cluster scope: the writes of every CTA that
// arrived with release are visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (unsigned n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == WATCHDOG) __trap();
  }
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// The int8 values of one row over four 8-column groups: this lane's x0 =
// [g0 | g1], x1 = [g2 | g3] (16 bits a group: its columns 2t, 2t + 1) ->
// the 8 values of group t, in column order. A 4 x 4 transpose of 16-bit
// pieces over the quad: two exchanges, each of the pieces whose column bit
// differs from the lane's.
__device__ __forceinline__ uint2 quad_transpose(uint32_t x0, uint32_t x1, int t) {
  const bool odd = t & 1, upper = t & 2;
  const uint32_t even_cols = __byte_perm(x0, x1, 0x5410);   // [g0 | g2]
  const uint32_t odd_cols = __byte_perm(x0, x1, 0x7632);    // [g1 | g3]
  const uint32_t keep = odd ? odd_cols : even_cols;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? even_cols : odd_cols, 1);
  // keep: this lane's pieces of groups c0 = t & 1 and c0 + 2; got: lane t ^ 1's
  const uint32_t lo = __byte_perm(keep, got, 0x5410);   // group c0: [lane t | lane t ^ 1]
  const uint32_t hi = __byte_perm(keep, got, 0x7632);   // group c0 + 2
  const uint32_t kept = upper ? hi : lo;                // group t: lanes t, t ^ 1
  const uint32_t got2 = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, 2);   // lanes t ^ 2, t ^ 3
  uint32_t first = upper ? got2 : kept, second = upper ? kept : got2;
  if (odd) {   // [lane 1 | lane 0], [lane 3 | lane 2]
    first = __byte_perm(first, 0, 0x1032);
    second = __byte_perm(second, 0, 0x1032);
  }
  return make_uint2(first, second);
}

// quant8 (csrc/common.cuh) without its two conversions: the clip first,
// then an add of 1.5 x 2^23, which rounds half to even as rintf does (the
// sum's unit is 1 and 1.5 x 2^23 is even); the low byte of the sum's bits is
// the int8 value. Clipping before or after rounding to an integer gives the
// same integer, and a NaN clips to -127 either way.
__device__ __forceinline__ uint32_t q8_bits(float v, float mul) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(__fmul_rn(v, mul), -127.0f), 127.0f), 12582912.0f));
}

// The int8 values of accumulators at and at + 1 (two neighbouring columns of
// a row) and of at + 4 and at + 5 (the same columns of the next 8-column
// group) as four bytes, in that order.
template <int N>
__device__ __forceinline__ uint32_t pack4(const int (&acc)[N], int at, float mul) {
  const uint32_t lo = __byte_perm(q8_bits(__int_as_float(acc[at]), mul),
                                  q8_bits(__int_as_float(acc[at + 1]), mul), 0x0040);
  const uint32_t hi = __byte_perm(q8_bits(__int_as_float(acc[at + 4]), mul),
                                  q8_bits(__int_as_float(acc[at + 5]), mul), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// The TMA thread: the CTA's weight rows and its share of A, a stage a K
// step, for every row panel of the cluster's walk; then it waits until
// every CTA's consumers have released the last stages, so that no arrival
// finds this CTA gone.
template <int WN>
__device__ __forceinline__ void produce_rows(const QSmem<WN>& sm, const QuantParams& qp,
                                             const CUtensorMap* ma, const CUtensorMap* mb,
                                             int rank, int cl, int unit0, int step) {
  const int rows = QM / qp.loaders;
  const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
  int n = 0;
  for (int u = unit0; u < qp.units; u += step) {
    for (int kt = 0; kt < qp.ktiles; ++kt, ++n) {
      const int s = n % QSTAGES;
      mbar_wait(sm.empty(s), ((n / QSTAGES) & 1) ^ 1);
      mbar_expect_tx(sm.full(s), QLayout<WN>::STAGE_BYTES);
      if (rank < qp.loaders) {
        const uint32_t dst = sm.a(s) + rank * rows * KBYTES;
        if (cl > 1)
          tma_load_multicast(dst, ma, sm.full(s), kt * KBYTES, u * QM + rank * rows, mask);
        else
          tma_load(dst, ma, sm.full(s), kt * KBYTES, u * QM);
      }
#pragma unroll
      for (int h = 0; h < NCONS; ++h)
        tma_load(sm.b(s) + h * WN * KBYTES, mb, sm.full(s), kt * KBYTES,
                 (rank * NCONS + h) * WN);
    }
  }
  for (int i = 0; i < QSTAGES; ++i)
    mbar_wait(sm.empty((n + i) % QSTAGES), (((n + i) / QSTAGES) & 1) ^ 1);
}

// Consumer c: columns (rank x 2 + c) x WN .. + WN - 1 of each row panel.
template <int WN>
__device__ __forceinline__ void consume_rows(const QSmem<WN>& sm, const QuantParams& qp, int c,
                                             int rank, int cl, int unit0, int step) {
  constexpr int PER = SLICE / 2;   // accumulators a lane holds in a slice
  const S8Op::Params& p = qp.p;
  const int m = p.out.m;
  int acc[WN / 2];
  const int tid = threadIdx.x % 128;
  const int wq = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;   // accumulator row group and column pair
  const int warp = c * 4 + wq;             // this warp sends the maxima of rows 8 warp ..
  float* cols = sm.cols(c);
  float* part = sm.part();
  int n = 0;   // stages consumed
  for (int u = unit0, i = 0; u < qp.units; u += step, ++i) {
    const int m0 = u * QM, n0 = (rank * NCONS + c) * WN;
    for (int q = tid; q < 2 * WN / 4; q += 128)
      cp_async16(cols + q * 4, S8Op::col_src(p, q / (WN / 4)) + n0 + q % (WN / 4) * 4, true);
    cp_async_commit();
    const int row0 = m0 + wq * 16 + gr;   // rows row0 and row0 + 8
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      scale[h] = row0 + 8 * h < m ? S8Op::row_scale(p, row0 + 8 * h) : 0.f;

    for (int kt = 0; kt < qp.ktiles; ++kt, ++n) {
      const int s = n % QSTAGES;
      mbar_wait(sm.full(s), (n / QSTAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      mma_s8<WN>(acc, sm.a(s), sm.b(s) + c * WN * KBYTES, kt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // released in every CTA of the cluster: the multicast writes into all
      __syncwarp();
      if (lane < cl) mbar_arrive_cluster(map_rank(sm.empty(s), lane));
    }
    cp_async_wait<0>();
    for (int q = tid; q < 2 * WN / 4; q += 128)
      if (q >= WN / 4) S8Op::prepare_col1(cols + q * 4);
    named_barrier(1 + c, 128);   // the tile's column operands are in

    // mid = QuickGELU(dequant + bias), a slice at a time, over the
    // accumulators' registers; the rows' maxima over this thread's columns
    // (value i of a slice: pair jj = i / 4, row h = i / 2 % 2, column e = i % 2)
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int sl = 0; sl < WN / SLICE; ++sl) {
      int x[PER];
      float b[PER], wc[PER], ar[PER], r[PER], v[PER];
#pragma unroll
      for (int jj = 0; jj < SLICE / 8; ++jj) {
        const int col = sl * SLICE + 8 * jj + 2 * t;
        const float2 c0 = *reinterpret_cast<const float2*>(cols + col);
        const float2 c1 = *reinterpret_cast<const float2*>(cols + WN + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * jj + e;
          x[k] = acc[sl * PER + k];
          b[k] = e & 1 ? c0.y : c0.x;
          wc[k] = e & 1 ? c1.y : c1.x;
          ar[k] = scale[e / 2];
          r[k] = 0.f;
        }
      }
      S8Op::apply<kFormGelu>(p, x, b, wc, ar, r, v);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        acc[sl * PER + k] = __float_as_int(v[k]);
        amax[k / 2 % 2] = fmaxf(amax[k / 2 % 2], fabsf(v[k]));
      }
    }

    // the rows' maxima across the quad, both consumers and the cluster
    const int buf = i & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      amax[h] = quad_max(amax[h]);
      if (t == 0) part[c * QM + wq * 16 + gr + 8 * h] = amax[h];
    }
    named_barrier(XCH_BARRIER, 256);
    if (lane < cl) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = fmaxf(part[8 * warp + k], part[QM + 8 * warp + k]);
      const uint32_t dst = map_rank(sm.xch(buf) + (rank * QM + 8 * warp) * 4, lane);
      st_cluster4(dst, v[0], v[1], v[2], v[3]);
      st_cluster4(dst + 16, v[4], v[5], v[6], v[7]);
      mbar_arrive_release_cluster(map_rank(sm.xfull(buf), lane));
    }
    mbar_wait_cluster(sm.xfull(buf), (i >> 1) & 1);
    const float* slots = sm.xch_ptr(buf);
    float2 sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = 0.f;
      for (int d = 0; d < cl; ++d) mx = fmaxf(mx, slots[d * QM + wq * 16 + gr + 8 * h]);
      sc[h] = row_ops::quant_consts(mx, false);
    }

    // quantise, 32 columns of a row at a time: 8 values a lane, 32 bytes a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      int8_t* dst = qp.q + (size_t)row * qp.ldq + n0 + 8 * t;
#pragma unroll
      for (int jq = 0; jq < WN / 32; ++jq) {
        // groups 4 jq .. 4 jq + 3 of row h (group j's values at 4 j + 2 h, + 1)
        const int at = 16 * jq + 2 * h;
        const uint2 out = quad_transpose(pack4(acc, at, sc[h].y), pack4(acc, at + 8, sc[h].y), t);
        if (row < m) *reinterpret_cast<uint2*>(dst + 32 * jq) = out;
      }
      if (rank == 0 && c == 0 && t == 0 && row < m) qp.s[row] = sc[h].x;
    }
  }
}

template <int WN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_s8_quant_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, const QuantParams qp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const QSmem<WN> sm{aligned, smem_raw + (aligned - raw)};
  const int rank = static_cast<int>(cluster_rank());
  uint32_t ncta;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ncta));
  const int cl = static_cast<int>(ncta);
  if (threadIdx.x == 0) {
    for (int s = 0; s < QSTAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 4 * NCONS * cl);   // each consumer warp of the cluster
    }
    for (int b = 0; b < 2; ++b) mbar_init(sm.xfull(b), 4 * NCONS * cl);
    mbar_fence_init();
  }
  cluster_sync();   // every CTA's barriers exist before any is written to
  const int unit0 = cluster_id(), step = cluster_count();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce_rows(sm, qp, &map_a, &map_b, rank, cl, unit0, step);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume_rows(sm, qp, threadIdx.x / 128 - 1, rank, cl, unit0, step);
  }
}

// One launch at consumer width WN over the N / (2 WN) CTA clusters; the
// kernel's attribute and its co-resident cluster count for each cluster
// size are read once. -1 when no cluster can be resident.
template <int WN>
int launch_quant(const CUtensorMap& ma, const CUtensorMap& mb, const QuantParams& qp, int cl,
                 void* stream) {
  auto kernel = gemm_s8_quant_kernel<WN>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = QLayout<WN>::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int clusters_of[MAX_CLUSTER + 1] = {};
  if (clusters_of[cl] == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           QLayout<WN>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(sms / cl * cl);
    int most = 0;
    err = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (most < 1) return -1;
    clusters_of[cl] = most;
  }
  const int grid = qp.units < clusters_of[cl] ? qp.units : clusters_of[cl];
  cfg.gridDim = dim3(static_cast<unsigned>(grid * cl));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ma, mb, qp);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// q (M, N) int8 at row pitch ldq, s (M,) f32 = _quant_rows(QuickGELU(A[M,K]
// int8 @ B[N,K]^T int8 dequantised with a_scale (M,) and w_scale (N,), +
// bias (N,))), in CTAs of tile_n = 2 WN columns (512 or 384; the wrapper's
// quant_geometry chooses), N = tile_n x the cluster size, 1 to 8; K % 64 ==
// 0; 16-byte aligned bases and int8 leading dimensions multiples of 16.
// Returns the launch's cudaGetLastError(), or -1 when no cluster of N /
// tile_n CTAs can be resident on this card.
extern "C" int dfd_gemm_s8_quant(const void* A, int lda, const float* a_scale, const void* B,
                                 int ldb, const float* w_scale, const float* bias, void* Q,
                                 int ldq, float* S, int M, int N, int K, int tile_n,
                                 void* stream) {
  if (M < 1 || K < 1 || (tile_n != 512 && tile_n != 384) || N % tile_n || N / tile_n < 1 ||
      N / tile_n > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cl = N / tile_n;
  const int loaders = cl >= 4 ? 4 : cl >= 2 ? 2 : 1;
  alignas(64) CUtensorMap ma, mb;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, K, M, lda, KBYTES, QM / loaders) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, B, K, N, ldb, KBYTES, tile_n / NCONS))
    return static_cast<int>(cudaErrorInvalidValue);
  QuantParams qp{};
  qp.p.out.m = M;
  qp.p.out.n = N;
  qp.p.out.flags = S8Op::kGelu;
  qp.p.a_scale = a_scale;
  qp.p.w_scale = w_scale;
  qp.p.bias = bias;
  qp.q = static_cast<int8_t*>(Q);
  qp.s = S;
  qp.ldq = ldq;
  qp.units = (M + QM - 1) / QM;
  qp.ktiles = (K + KBYTES - 1) / KBYTES;
  qp.loaders = loaders;
  return tile_n == 512 ? launch_quant<256>(ma, mb, qp, cl, stream)
                       : launch_quant<192>(ma, mb, qp, cl, stream);
}
