// Banded Smith-Waterman-Gotoh with path statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// swiftortho_tpu/ops/banded_sw_pallas.py::sw_align_batch_pallas (_kernel).
// It computes what that kernel, the plain PyTorch version
// (swiftortho_tpu_torch/ops/banded_sw.py::sw_align_batch) and the C++
// host kernel (swiftortho_tpu_torch/native/banded_sw.cpp) compute, bit for
// bit: band half-width 16, BLOSUM62 through a byte->code map, pseudo-affine
// gaps (go = -11; ge = -1 only when the predecessor won in the same gap
// direction), tie order M > I > D, per-cell path statistics instead of a
// traceback, best cell strictly greater with ties to the smallest (i, j)
// in row-major order, border runs counting ceil(m/2) gap openings.
//
// Geometry.  The band has 16 slots e per parity class:
//   class 0, odd anti-diagonal  a = 2t+1: cell (i, j) = (t+8-e, t-7+e)
//   class 1, even anti-diagonal a = 2t+2: cell (i, j) = (t+9-e, t-7+e)
// so the 32 diagonals d = j-i in [-16, 15] are covered and one step t
// advances two anti-diagonals.  Neighbours: class 0 takes left from its
// own class-1 cell of step t-1, up from slot e+1's class-1 cell of step
// t-1, diag from its own class-0 cell of step t-1; class 1 takes left from
// slot e-1's class-0 cell of this step, up from its own class-0 cell of
// this step, diag from its own class-1 cell of step t-1.
//
// Lanes.  LPP lanes hold one pair and each lane owns K = 16/LPP
// consecutive slots, so neighbours inside a lane stay in registers and
// only the two lane-edge cells of a step cross lanes (one __shfl_down for
// class 0's up, one __shfl_up for class 1's left).  The K cells of one
// class are independent: K-fold instruction-level parallelism on top of
// the warps in flight.  Three kernels are built: full statistics at 4
// lanes, score-only at 4 lanes, and score-only at 8 lanes for batches
// under 8,192 pairs.  A sweep of 4, 8 and 16 lanes on an H100 (700 W,
// L = 400, B from 4,096 to 131,072) chose them: 4 lanes were fastest for
// full statistics at every B (tied with 8 at 4,096) and for score-only
// from 8,192 on; at B = 4,096 score-only 8 lanes beat 4 by 11-13%, as 4
// lanes leave under four warps an SM there.  16 lanes were slowest
// everywhere (more crossings, no ILP).
//
// State.  Scores travel coded as 4*h + a direction code (3 M, 2 I, 1 D,
// 0 a path starts here), so one max over the coded candidates yields the
// score and the direction with the tie order M > I > D > start.  A cell
// carries h4 = 4h (its diagonal neighbour's M base), hI = the coded I
// candidate it hands its right neighbour, 4*(h + (tr == DASH ? ge : go))
// + 2, and hD = the coded D candidate it hands the cell below, and, with
// STATS, three packed words as in the TPU kernel: T = (sti*2^14 + stj)
// << 2 | op bits (bit 1: an I-run was opened, bit 0: a D-run), A =
// idy*2^14 + aln, G = mis*2^14 + gap.  A lane-edge crossing moves four
// words (hI or hD, T, A, G); score-only moves one.
//
// Scoring.  Each pair's two rows are staged into a 128-byte ring per
// sequence in shared memory by cp.async (4-byte copies, zero-filled past
// the length), 32 positions at a time, two chunks ahead of the wavefront;
// rows that are not 4-byte aligned are staged by plain loads in the same
// schedule.  Step t reads s0[t-8 .. t+7] and s1[t-8 .. t+8]: a lane reads
// one new byte of each sequence per step (the others slide over from the
// neighbouring slot) and maps it to its BLOSUM62 code once; a cell's coded
// score 4*sub + 3 is one shared-memory load of the 32x32 code table.  All
// of this is done one step ahead, off the dependent chain of the cells.
//
// Recurrence.  W = max(M, I, D, 0) over coded values is one DPX add-max
// (__viaddmax_s32: diag.h4 + sub4 against the left's hI) and one DPX
// max-relu (__vimax_s32_relu against the up's hD); h4 = W & ~3, and hI,
// hD are W plus a per-direction offset picked by one sign-extending byte
// permute (prmt) each.  With STATS the direction picks the winner's
// packed words, stepped by one add each.  (__vibmax_s32, the DPX max
// that also returns which side won, compiles to a compare and a select
// on sm_90a, which is what the coding avoids.)
//
// Borders.  Cells on row 0 and column 0 exist only in the first 9 steps,
// so steps t < 16 run a general cell that substitutes the border values
// (and the out-of-band d = 16 / -17 neighbours); from t = 16 on no cell
// ever reads a cell outside the matrix except past its far end, which no
// computed cell reads, so cells are computed unconditionally.
//
// Best.  Inside one slot the cells arrive in row-major order, so each
// slot keeps its own best as one key, h << 14 | (16383 - (2t + class)):
// a larger key is a higher score or an earlier cell at the same score
// (one max score-only; one compare and four selects with STATS).  From
// step 16 on cells past the far end take part too: they read a
// zero-filled byte, which scores -4 against anything, so they never beat
// the cells they come from.  The slots of a lane and then the lanes of a
// pair are merged at the end by (max score, min i*8192+j).
//
// What bounds it on an H100: integer instructions per cell (no bytes to
// speak of, no tensor core applies).  PERF.md has the count, the bound
// and the measured share, and the per-cell SASS instruction counts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (swiftortho_tpu_torch/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BAND = 16;                  // slots per parity class
constexpr int NBYTE = 256;                // byte -> code map entries
constexpr int NCODE = 32;                 // code-space table is NCODE x NCODE
constexpr int PACK = 1 << 14;             // statistics packing base
constexpr int RING = 128;                 // staged bytes per sequence
constexpr int CHUNK = 32;                 // positions per staged chunk
constexpr int PROLOGUE = 16;              // steps that may touch a border
constexpr int KEY_POS = (1 << 14) - 1;    // 2t + class <= 16383
// score-only batches of fewer pairs than this run at 8 lanes per pair,
// everything else at 4 (see the header)
constexpr int FEW_LANES_MIN_PAIRS = 8192;
constexpr unsigned FULL = 0xffffffffu;

// Scores travel as 4*score + a direction code (3 M, 2 I, 1 D, 0 start),
// so one max over the coded candidates breaks ties as M > I > D > start.
struct Cell {
    int h4;                     // 4 * score (the diagonal neighbour's M)
    int hi4, hd4;               // the coded I / D candidate it hands on
    int t, a, g;                // packed start|op bits, idy|aln, mis|gap
};

__device__ __forceinline__ Cell empty_cell(int go) {
    return Cell{0, 4 * go + 2, 4 * go + 1, 0, 0, 0};
}

// A cell that is not computed, in the first steps: row 0 carries the
// I-chain statistics and column 0 the D-chain ones (an m-long border run
// counts ceil(m/2) gap openings, with the op bit set after an odd m); any
// other cell is empty.
template <bool STATS>
__device__ __forceinline__ Cell border_cell(int i, int j, int l0, int l1,
                                            int go) {
    Cell c = empty_cell(go);
    if (STATS) {
        int m = 0;
        if (i == 0 && j >= 0 && j <= l0) {
            m = j;
            if (j & 1) c.t = 2;
        } else if (j == 0 && i > 0 && i <= l1) {
            m = i;
            if (i & 1) c.t = 1;
        }
        c.a = m;
        c.g = m * PACK + ((m + 1) >> 1);
    }
    return c;
}

// adj for the coded I candidate (code 2, extends in direction 2) or D
// candidate (code 1, extends in direction 1) of a cell with direction tr:
// 4*(h + (tr == code ? ge : go)) + code - (4h + tr), a signed byte in byte
// tr of the word.
__host__ __device__ __forceinline__ int adj_value(int code, int tr, int go,
                                                  int ge) {
    return 4 * (tr == code ? ge : go) + code - tr;
}

__host__ __device__ __forceinline__ unsigned adj_word(int code, int go,
                                                      int ge) {
    unsigned w = 0;
    for (int tr = 0; tr < 4; ++tr)
        w |= ((unsigned)adj_value(code, tr, go, ge) & 0xffu) << (8 * tr);
    return w;
}

__host__ __forceinline__ bool adj_fits(int go, int ge) {
    for (int tr = 0; tr < 4; ++tr)
        for (int code = 1; code <= 2; ++code) {
            const int v = adj_value(code, tr, go, ge);
            if (v < -128 || v > 127) return false;
        }
    return true;
}

// The coded I and D candidates a cell hands on: W + adj[direction].  sel
// picks byte tr and sign-extends it (prmt: a selector nibble with its top
// bit set replicates the sign of the byte it names).
__device__ __forceinline__ int handed(int W, unsigned sel, unsigned adj) {
    int v;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(v) : "r"(adj), "r"(sel));
    return W + v;
}

// One cell from its left, up and diagonal neighbours.  sub4 is 4 * the
// substitution score + 3 (the M code); eqp is PACK where the two bytes
// are equal, else 0; star_t the T word of a path that starts here.
template <bool STATS>
__device__ __forceinline__ Cell dp_cell(const Cell& lf, const Cell& up,
                                        const Cell& dg, int sub4, int eqp,
                                        int star_t, unsigned adj_i,
                                        unsigned adj_d) {
    // W = max(M, I, D, 0) over coded values: DPX add-max, then max-relu
    const int W = __vimax_s32_relu(__viaddmax_s32(dg.h4, sub4, lf.hi4),
                                   up.hd4);
    const int tr = W & 3;
    // byte tr, then three nibbles "byte tr, sign-extended"
    const unsigned sel = (unsigned)tr * 0x1111u + 0x8880u;
    Cell c;
    c.h4 = W & ~3;
    c.hi4 = handed(W, sel, adj_i);
    c.hd4 = handed(W, sel, adj_d);
    if (STATS) {
        const bool pos = tr != 0, is_m = tr == 3, is_i = tr == 2;
        const int ts = is_m ? dg.t : (is_i ? lf.t : up.t);
        const int as = is_m ? dg.a : (is_i ? lf.a : up.a);
        const int gs = is_m ? dg.g : (is_i ? lf.g : up.g);
        // a gap move opens a run unless its source opened one in the same
        // direction (op resets on continuation: an m-column run counts
        // ceil(m/2) openings, the reference's quirk)
        const int oi = (~lf.t >> 1) & 1;
        const int od = ~up.t & 1;
        const int og = is_i ? oi : od;
        const int bits = is_m ? 0 : (is_i ? (oi << 1) : od);
        c.t = pos ? ((ts & ~3) | bits) : star_t;
        c.a = pos ? as + (is_m ? eqp + 1 : 1) : 0;
        c.g = pos ? gs + (is_m ? PACK - eqp : PACK + og) : 0;
    }
    return c;
}

template <bool STATS>
__device__ __forceinline__ Cell shfl_down_up(const Cell& c, int lpp) {
    // the fields a class-0 cell reads from its up neighbour
    Cell r;
    r.h4 = 0; r.hi4 = 0;
    r.hd4 = __shfl_down_sync(FULL, c.hd4, 1, lpp);
    if (STATS) {
        r.t = __shfl_down_sync(FULL, c.t, 1, lpp);
        r.a = __shfl_down_sync(FULL, c.a, 1, lpp);
        r.g = __shfl_down_sync(FULL, c.g, 1, lpp);
    } else {
        r.t = r.a = r.g = 0;
    }
    return r;
}

template <bool STATS>
__device__ __forceinline__ Cell shfl_up_left(const Cell& c, int lpp) {
    // the fields a class-1 cell reads from its left neighbour
    Cell r;
    r.h4 = 0; r.hd4 = 0;
    r.hi4 = __shfl_up_sync(FULL, c.hi4, 1, lpp);
    if (STATS) {
        r.t = __shfl_up_sync(FULL, c.t, 1, lpp);
        r.a = __shfl_up_sync(FULL, c.a, 1, lpp);
        r.g = __shfl_up_sync(FULL, c.g, 1, lpp);
    } else {
        r.t = r.a = r.g = 0;
    }
    return r;
}

// Stage chunk q (positions [32q, 32q+32)) of both rows of this lane's pair
// into the rings: 16 four-byte words shared by the pair's lanes.
template <int LPP>
__device__ __forceinline__ void stage(int q, int lp, bool aligned,
                                      const uint8_t* s0, const uint8_t* s1,
                                      int l0, int l1, uint8_t* r0,
                                      uint8_t* r1) {
#pragma unroll
    for (int r = 0; r < 16 / LPP; ++r) {
        const int w = lp + r * LPP;
        const int seq = w >> 3;
        const int pos = q * CHUNK + 4 * (w & 7);
        const uint8_t* row = seq ? s1 : s0;
        const int len = seq ? l1 : l0;
        uint8_t* dst = (seq ? r1 : r0) + (pos & (RING - 1));
        if (aligned) {
            // bytes past the length are zero-filled (n = 0: read nothing)
            const int n = min(max(len - pos, 0), 4);
            const unsigned sa =
                static_cast<unsigned>(__cvta_generic_to_shared(dst));
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                         :: "r"(sa), "l"(n ? row + pos : row), "r"(n));
        } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                dst[b] = pos + b < len ? row[pos + b] : 0;
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// What a lane carries from step to step.
template <int K>
struct Lane {
    int c0c[K], c0b[K];         // s0 code * 4 and byte of each slot
    int c1c[K], c1b[K];         // s1 code * 4 * NCODE and byte, class 1
    int cxc, cxb;               // the same for class 0 of the last slot
    int sub0[K], sub1[K];       // the next step's coded substitution scores
    int eq0[K], eq1[K];         // and byte matches (STATS)
    Cell c0[K], c1[K];          // class-0 / class-1 cells of the last step
    // per-slot best: key = h << 14 | (KEY_POS - (2t + class)), so a
    // larger key is a higher score or, at equal score, an earlier cell
    int bk[K], bt[K], ba[K], bg[K];
};

// The slot's running best: strictly greater, which inside one slot means
// ties go to the earlier, i.e. smaller (i, j), cell.  From step PROLOGUE
// on every cell takes part: a cell past the far end of its pair reads at
// least one zero-filled byte (BLOSUM62 -4 against anything), so its score
// is 0 or below the best of the cells it comes from, and never wins.
template <bool STATS, int K>
__device__ __forceinline__ void best(Lane<K>& L, int k, bool in, int key,
                                     const Cell& c) {
    if (!STATS) {
        if (in) L.bk[k] = max(L.bk[k], key);
    } else if (in && key > L.bk[k]) {
        L.bk[k] = key; L.bt[k] = c.t; L.ba[k] = c.a; L.bg[k] = c.g;
    }
}

// The table entry at a byte offset (codes are kept as byte offsets: s0's
// code * 4, s1's code * 4 * NCODE, so a lookup is one add).
__device__ __forceinline__ int sub_at(const int* s_sub, int off) {
    return *reinterpret_cast<const int*>(
        reinterpret_cast<const char*>(s_sub) + off);
}

// The codes of step t (slide one slot, read the two new bytes) and from
// them the step's substitution scores, coded (sub4) and, with STATS, the
// byte matches (PACK or 0).  Called one step ahead, so the shared-memory
// loads stay off the dependent chain of the cells.
template <bool STATS, int LPP>
__device__ __forceinline__ void next_scores(Lane<BAND / LPP>& L, int t,
                                            int e0, const uint8_t* r0,
                                            const uint8_t* r1,
                                            const int* s_code,
                                            const int* s_sub) {
    constexpr int K = BAND / LPP;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
        L.c0c[k] = L.c0c[k + 1]; L.c0b[k] = L.c0b[k + 1];
    }
    {
        const int b = r0[(t - 8 + e0 + K - 1) & (RING - 1)];
        L.c0c[K - 1] = s_code[b] * 4; L.c0b[K - 1] = b;
    }
    L.cxc = L.c1c[K - 1]; L.cxb = L.c1b[K - 1];
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
        L.c1c[k] = L.c1c[k - 1]; L.c1b[k] = L.c1b[k - 1];
    }
    {
        const int b = r1[(t + 8 - e0) & (RING - 1)];
        L.c1c[0] = s_code[b] * (4 * NCODE); L.c1b[0] = b;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        // class 0 reads s1 at slot k+1's class-1 position (cx past the end)
        const int kn = k < K - 1 ? k + 1 : k;
        const int s1c = k < K - 1 ? L.c1c[kn] : L.cxc;
        const int s1b = k < K - 1 ? L.c1b[kn] : L.cxb;
        L.sub0[k] = sub_at(s_sub, s1c + L.c0c[k]);
        L.sub1[k] = sub_at(s_sub, L.c1c[k] + L.c0c[k]);
        if (STATS) {
            L.eq0[k] = s1b == L.c0b[k] ? PACK : 0;
            L.eq1[k] = L.c1b[k] == L.c0b[k] ? PACK : 0;
        }
    }
}

// One step t: both classes of the lane's K slots.  GEN: a step that may
// touch row 0, column 0 or an out-of-band border cell (t < PROLOGUE).
template <bool STATS, int LPP, bool GEN>
__device__ __forceinline__ void sw_step(Lane<BAND / LPP>& L, int t, int lp,
                                        int l0, int l1, const uint8_t* r0,
                                        const uint8_t* r1, const int* s_code,
                                        const int* s_sub, int go,
                                        unsigned adj_i, unsigned adj_d) {
    constexpr int K = BAND / LPP;
    const int e0 = lp * K;
    int sub0[K], sub1[K], eq0[K], eq1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        sub0[k] = L.sub0[k]; sub1[k] = L.sub1[k];
        eq0[k] = L.eq0[k]; eq1[k] = L.eq1[k];
    }
    next_scores<STATS, LPP>(L, t + 1, e0, r0, r1, s_code, s_sub);

    const int key0 = KEY_POS - 2 * t;       // class 0; class 1 is one less

    // class 0: cell (t+8-e, t-7+e)
    Cell upx = shfl_down_up<STATS>(L.c1[0], LPP);
    if (lp == LPP - 1)
        upx = GEN ? border_cell<STATS>(t - 8, t + 8, l0, l1, go)
                  : empty_cell(go);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = e0 + k;
        const int i = t + 8 - e, j = t - 7 + e;
        const int kn = k < K - 1 ? k + 1 : k;    // the next slot, if any
        const int star = STATS ? (i * PACK + j) << 2 : 0;
        Cell nc = dp_cell<STATS>(L.c1[k], k < K - 1 ? L.c1[kn] : upx,
                                 L.c0[k], sub0[k], eq0[k], star, adj_i,
                                 adj_d);
        const bool in = !GEN || (i >= 1 && j >= 1 && i <= l1 && j <= l0);
        if (!in) nc = border_cell<STATS>(i, j, l0, l1, go);
        best<STATS>(L, k, in, (nc.h4 << 12) + key0, nc);
        L.c0[k] = nc;
    }

    // class 1: cell (t+9-e, t-7+e)
    Cell lfx = shfl_up_left<STATS>(L.c0[K - 1], LPP);
    if (lp == 0)
        lfx = GEN ? border_cell<STATS>(t + 9, t - 8, l0, l1, go)
                  : empty_cell(go);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = e0 + k;
        const int i = t + 9 - e, j = t - 7 + e;
        const int star = STATS ? (i * PACK + j) << 2 : 0;
        const int kp = k > 0 ? k - 1 : k;       // the previous slot, if any
        Cell nc = dp_cell<STATS>(k > 0 ? L.c0[kp] : lfx, L.c0[k], L.c1[k],
                                 sub1[k], eq1[k], star, adj_i, adj_d);
        const bool in = !GEN || (i >= 1 && j >= 1 && i <= l1 && j <= l0);
        if (!in) nc = border_cell<STATS>(i, j, l0, l1, go);
        best<STATS>(L, k, in, (nc.h4 << 12) + key0 - 1, nc);
        L.c1[k] = nc;
    }
}

template <bool STATS, int LPP>
__global__ void __launch_bounds__(THREADS)
banded_sw_kernel(const uint8_t* __restrict__ tok0,
                 const uint8_t* __restrict__ tok1,
                 const int32_t* __restrict__ len0,
                 const int32_t* __restrict__ len1,
                 int B, int pad0, int pad1,
                 const int32_t* __restrict__ table, int go, int ge,
                 bool aligned, int32_t* __restrict__ out) {
    constexpr int K = BAND / LPP;             // slots per lane
    constexpr int PAIRS = THREADS / LPP;      // pairs per block
    __shared__ int s_code[NBYTE];
    __shared__ int s_sub[NCODE * NCODE];
    __shared__ unsigned s_adj[2];
    __shared__ __align__(16) uint8_t s_ring[PAIRS][2][RING];
    for (int x = threadIdx.x; x < NBYTE + NCODE * NCODE; x += THREADS) {
        const int v = table[x];
        if (x < NBYTE) s_code[x] = v;
        else s_sub[x - NBYTE] = 4 * v + 3;     // the coded M increment
    }
    if (threadIdx.x == 0) {
        s_adj[0] = adj_word(2, go, ge);
        s_adj[1] = adj_word(1, go, ge);
    }
    __syncthreads();

    const int lp = threadIdx.x % LPP;
    const int slot_pair = threadIdx.x / LPP;
    const int64_t pair = (int64_t)blockIdx.x * PAIRS + slot_pair;
    const bool valid = pair < B;
    // lengths are clamped to the padded widths; a missing pair is empty
    const int l0 = valid ? min(max(len0[pair], 0), pad0) : 0;
    const int l1 = valid ? min(max(len1[pair], 0), pad1) : 0;
    const uint8_t* s0 = valid ? tok0 + pair * pad0 : tok0;
    const uint8_t* s1 = valid ? tok1 + pair * pad1 : tok1;
    uint8_t* r0 = s_ring[slot_pair][0];
    uint8_t* r1 = s_ring[slot_pair][1];
    const int nsteps = __reduce_max_sync(FULL, (l0 + l1) / 2 + 1);
    const int e0 = lp * K;                    // this lane's first slot
    // read back per thread: the hand-off words live in ordinary registers
    const unsigned adj_i = s_adj[0], adj_d = s_adj[1];

    stage<LPP>(0, lp, aligned, s0, s1, l0, l1, r0, r1);
    stage<LPP>(1, lp, aligned, s0, s1, l0, l1, r0, r1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();

    // the slots' codes and bytes as of step -1: slot e reads s0[t-8+e] and,
    // for class 1, s1[t+8-e]; class 0 reads s1[t+7-e], which is slot e+1's
    // class-1 position (cx for the last slot: the previous step's
    // c1[K-1]).  Negative positions hold what the ring holds; they feed
    // only cells that are not computed.
    Lane<K> L;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = e0 + k;
        const int b0 = r0[(-9 + e) & (RING - 1)];
        const int b1 = r1[(7 - e) & (RING - 1)];
        L.c0c[k] = s_code[b0] * 4; L.c0b[k] = b0;
        L.c1c[k] = s_code[b1] * (4 * NCODE); L.c1b[k] = b1;
        L.c0[k] = L.c1[k] = empty_cell(go);
        L.bk[k] = KEY_POS;                    // score 0, nothing found
        L.bt[k] = L.ba[k] = L.bg[k] = 0;
        L.eq0[k] = L.eq1[k] = 0;
    }
    {
        const int b1 = r1[(7 - e0 - K) & (RING - 1)];
        L.cxc = s_code[b1] * (4 * NCODE); L.cxb = b1;
    }
    next_scores<STATS, LPP>(L, 0, e0, r0, r1, s_code, s_sub);

    for (int t0 = 0; t0 < nsteps; t0 += CHUNK) {
        // chunk q+2 goes to the ring slot of chunk q-2, read last in the
        // first steps of chunk q-1: every lane of the warp is past them
        __syncwarp();
        stage<LPP>(t0 / CHUNK + 2, lp, aligned, s0, s1, l0, l1, r0, r1);
        asm volatile("cp.async.wait_group 1;\n" ::);
        __syncwarp();
        const int tend = min(t0 + CHUNK, nsteps);
        int t = t0;
        for (; t < min(tend, PROLOGUE); ++t)
            sw_step<STATS, LPP, true>(L, t, lp, l0, l1, r0, r1, s_code,
                                      s_sub, go, adj_i, adj_d);
        for (; t < tend; ++t)
            sw_step<STATS, LPP, false>(L, t, lp, l0, l1, r0, r1, s_code,
                                       s_sub, go, adj_i, adj_d);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);

    // merge the lane's slots, then the pair's lanes: max score, then the
    // smallest i*8192+j (unique among positive scores)
    int mh = 0, mij = 0, mt = 0, ma = 0, mg = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int e = e0 + k;
        const int h = L.bk[k] >> 14;
        const int at = KEY_POS - (L.bk[k] & KEY_POS);   // 2t + class
        const int t = at >> 1, cls = at & 1;
        const int ij = (t + 8 + cls - e) * 8192 + (t - 7 + e);
        if (h > mh || (h == mh && h > 0 && ij < mij)) {
            mh = h; mij = ij;
            mt = L.bt[k]; ma = L.ba[k]; mg = L.bg[k];
        }
    }
#pragma unroll
    for (int off = LPP / 2; off > 0; off >>= 1) {
        const int oh = __shfl_xor_sync(FULL, mh, off, LPP);
        const int oij = __shfl_xor_sync(FULL, mij, off, LPP);
        int ot = 0, oa = 0, og = 0;
        if (STATS) {
            ot = __shfl_xor_sync(FULL, mt, off, LPP);
            oa = __shfl_xor_sync(FULL, ma, off, LPP);
            og = __shfl_xor_sync(FULL, mg, off, LPP);
        }
        if (oh > mh || (oh == mh && oij < mij)) {
            mh = oh; mij = oij; mt = ot; ma = oa; mg = og;
        }
    }
    if (valid && lp == 0) {
        const int64_t n = B;
        out[0 * n + pair] = mh;
        out[1 * n + pair] = mij >> 13;
        out[2 * n + pair] = mij & 8191;
        out[3 * n + pair] = STATS ? mt >> 16 : 0;
        out[4 * n + pair] = STATS ? (mt >> 2) & (PACK - 1) : 0;
        out[5 * n + pair] = STATS ? ma >> 14 : 0;
        out[6 * n + pair] = STATS ? ma & (PACK - 1) : 0;
        out[7 * n + pair] = STATS ? mg >> 14 : 0;
        out[8 * n + pair] = STATS ? mg & (PACK - 1) : 0;
    }
}

template <bool STATS, int LPP>
void launch(const uint8_t* t0, const uint8_t* t1, const int32_t* n0,
            const int32_t* n1, int B, int pad0, int pad1, const int32_t* tb,
            int go, int ge, bool aligned, int32_t* o, cudaStream_t s) {
    constexpr int PAIRS = THREADS / LPP;
    const dim3 grid((unsigned)((B + PAIRS - 1) / PAIRS));
    banded_sw_kernel<STATS, LPP><<<grid, THREADS, 0, s>>>(
        t0, t1, n0, n1, B, pad0, pad1, tb, go, ge, aligned, o);
}

}  // namespace

extern "C" {

// The lanes per pair swt_banded_sw runs a batch of B pairs at.
int swt_lanes_for(int B, int score_only) {
    return score_only && B < FEW_LANES_MIN_PAIRS ? 8 : 4;
}

// Align B pairs on `stream`.  tok0 (B, pad0) / tok1 (B, pad1) uint8
// row-major, len0/len1 (B,) int32, table int32[256 + 32*32] (byte->code
// map, then the code-space BLOSUM62), out (9, B) int32.  Allocates
// nothing and does not synchronise; returns cudaGetLastError().
int swt_banded_sw(const void* tok0, const void* tok1, const void* len0,
                  const void* len1, int B, int pad0, int pad1,
                  const void* table, int go, int ge, int score_only,
                  void* out, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (!adj_fits(go, ge)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* t0 = static_cast<const uint8_t*>(tok0);
    const auto* t1 = static_cast<const uint8_t*>(tok1);
    const auto* n0 = static_cast<const int32_t*>(len0);
    const auto* n1 = static_cast<const int32_t*>(len1);
    const auto* tb = static_cast<const int32_t*>(table);
    auto* o = static_cast<int32_t*>(out);
    // cp.async copies 4-byte words: every row must start 4-byte aligned
    const bool aligned = reinterpret_cast<uintptr_t>(t0) % 4 == 0
                         && reinterpret_cast<uintptr_t>(t1) % 4 == 0
                         && pad0 % 4 == 0 && pad1 % 4 == 0;
    if (!score_only)
        launch<true, 4>(t0, t1, n0, n1, B, pad0, pad1, tb, go, ge, aligned,
                        o, s);
    else if (swt_lanes_for(B, 1) == 4)
        launch<false, 4>(t0, t1, n0, n1, B, pad0, pad1, tb, go, ge, aligned,
                         o, s);
    else
        launch<false, 8>(t0, t1, n0, n1, B, pad0, pad1, tb, go, ge, aligned,
                         o, s);
    return (int)cudaGetLastError();
}

const char* swt_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
