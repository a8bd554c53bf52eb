// The rank and scan steps of greedy class-aware NMS as a parallel
// suppression bitmask, shared by csrc/nms.cu (axis-aligned boxes) and
// csrc/nms_rotated.cu (rotated boxes): the two differ only in the mask step
// between these two.
//
// The greedy rounds (D rounds of masked argmax, lowest index on ties ->
// record the winner when its score is > 0 -> zero the winner and every
// same-class candidate it suppresses) are a scan: in the order (score
// descending, index ascending) over the live candidates (score > 0), a
// candidate is kept unless an earlier kept one of its class suppresses it,
// and the scan stops at D kept.
//
//   1. rank, a memset and two launches (grid: candidate blocks x spans of
//      256 x images, then candidate blocks x images): each live candidate
//      counts the live candidates that precede it in the scan order, a span
//      per block, the spans' counts summed in integer atomics (exact and
//      deterministic, no sort); then it writes itself to order[rank].
//      The NaN rule is one flag an image: where any score is NaN the greedy
//      rounds record nothing (their argmax lands on the NaN, which is not
//      > 0, and it is never zeroed), so the order launch sets that image's
//      live count to 0 and the later steps record nothing either.
//   2. mask (in the including file): bit (i, j) of the image's [N,
//      ceil(N/64)] 64-bit mask, i ranked before j, set iff the candidate of
//      rank i suppresses that of rank j. Tiles past the live count exit.
//   3. scan (one warp per image), a 64-rank chunk (one mask word) at a
//      time: `removed` (shared memory) holds, for every later word, the OR
//      of the rows of the ranks kept so far. Within chunk c the warp keeps
//      the first open rank and ORs its diagonal word (row r, word c) into
//      the chunk's removed word, again and again (a shuffle and a find-
//      first-set a kept rank, no memory access); then it ORs the later
//      words of the rows it kept in chunk c into `removed`, all of those
//      loads in flight at once. So the dependent chain waits on global
//      memory about once a chunk that keeps a rank, not once a kept rank;
//      the next chunk's diagonal words are loaded a chunk ahead. It stops
//      at D kept or at the end. The outputs are gathered from the noted
//      ranks after the loop, all lanes at once.
//
// Scratch, one 8-byte aligned allocation by the wrapper of batch * (n *
// words * 8 + 4 * (2 * n + 2 + ndet)) bytes (words = ceil(n / 64)): the
// mask [batch, n, words], then int32 rank [batch, n], nlive [batch] and the
// NaN flags [batch] (zeroed by rank_step), order [batch, n] and the kept
// ranks [batch, ndet].
//
// The kernels are templates on the box width (4 axis-aligned, 6 rotated)
// so that a profile tells the two NMS kernels apart by name.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxCandidates = 16384;  // 256 mask words in the scan's smem
constexpr int kRankThreads = 128;
constexpr int kRankSpan = 256;         // preceding candidates a block counts
constexpr int kTile = 64;              // ranks per mask word
constexpr int kMaxWords = kMaxCandidates / kTile;
constexpr int kOrBatch = 8;            // row loads a lane keeps in flight

// rank[j] += the live candidates i in this block's span of kRankSpan that
// precede j in the scan order (higher score, or equal and lower index); the
// spans' partial counts meet in integer atomics, so the rank is exact. The
// blocks of the first span also count the live candidates and flag a NaN.
template <int kBox>
__global__ void __launch_bounds__(kRankThreads)
    nms_count_kernel(const float* __restrict__ scores, int n,
                     int* __restrict__ rank, int* __restrict__ nlive,
                     int* __restrict__ nan_seen) {
  __shared__ float span[kRankSpan];
  const int b = blockIdx.z;
  const int j = blockIdx.x * kRankThreads + threadIdx.x;
  const int i0 = blockIdx.y * kRankSpan;
  scores += (long long)b * n;
  for (int t = threadIdx.x; t < kRankSpan; t += kRankThreads) {
    span[t] = i0 + t < n ? scores[i0 + t] : 0.f;  // 0 never precedes
  }
  __syncthreads();
  const float sj = j < n ? scores[j] : 0.f;
  if (isnan(sj) && blockIdx.y == 0) nan_seen[b] = 1;
  if (!(sj > 0.f)) return;  // not live (NaN included)
  int count = 0;
  for (int t = 0; t < kRankSpan; ++t) {
    const float si = span[t];
    count += (si > sj) | ((si == sj) & (i0 + t < j));
  }
  if (count) atomicAdd(rank + (long long)b * n + j, count);
  if (blockIdx.y == 0) atomicAdd(nlive + b, 1);
}

// order[rank[j]] = j for the live candidates; an image with a NaN score
// gets a live count of 0 (written once, by the first thread of its first
// block: the mask and scan launches read it after this launch).
template <int kBox>
__global__ void __launch_bounds__(kRankThreads)
    nms_order_kernel(const float* __restrict__ scores, int n,
                     const int* __restrict__ rank, int* __restrict__ nlive,
                     const int* __restrict__ nan_seen,
                     int* __restrict__ order) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kRankThreads + threadIdx.x;
  if (nan_seen[b]) {
    if (j == 0) nlive[b] = 0;
    return;
  }
  if (j >= n || !(scores[(long long)b * n + j] > 0.f)) return;
  order[(long long)b * n + rank[(long long)b * n + j]] = j;
}

// The diagonal words of chunk c a lane holds: rows c * 64 + lane and
// c * 64 + 32 + lane, word c (0 past the live ranks).
__device__ __forceinline__ void load_diagonal(
    const unsigned long long* __restrict__ mask, int c, int live, int words,
    int lane, unsigned long long* lo, unsigned long long* hi) {
  const int r = c * kTile + lane;
  *lo = r < live ? mask[(long long)r * words + c] : 0ull;
  *hi = r + 32 < live ? mask[(long long)(r + 32) * words + c] : 0ull;
}

template <int kBox>
__global__ void __launch_bounds__(32)
    nms_scan_kernel(const float* __restrict__ scores,
                    const float* __restrict__ boxes,
                    const float* __restrict__ classes,
                    const int* __restrict__ order,
                    const int* __restrict__ nlive,
                    const unsigned long long* __restrict__ mask, int n,
                    int words, int ndet, int* __restrict__ kept,
                    float* __restrict__ out_s, float* __restrict__ out_b,
                    float* __restrict__ out_c) {
  __shared__ unsigned long long removed[kMaxWords];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int live = nlive[b];
  const int live_words = (live + kTile - 1) / kTile;
  scores += (long long)b * n;
  boxes += (long long)b * n * kBox;
  classes += (long long)b * n;
  order += (long long)b * n;
  mask += (long long)b * n * words;
  kept += (long long)b * ndet;
  out_s += (long long)b * ndet;
  out_b += (long long)b * ndet * kBox;
  out_c += (long long)b * ndet;
  for (int w = lane; w < live_words; w += 32) removed[w] = 0ull;
  __syncwarp();

  int d = 0;
  unsigned long long lo, hi;
  if (live_words) load_diagonal(mask, 0, live, words, lane, &lo, &hi);
  for (int c = 0; c < live_words && d < ndet; ++c) {  // uniform
    const unsigned long long cur_lo = lo, cur_hi = hi;
    if (c + 1 < live_words) {
      load_diagonal(mask, c + 1, live, words, lane, &lo, &hi);
    }
    // ranks past the live count read as removed
    const int in_chunk = min(kTile, live - c * kTile);
    unsigned long long rem = removed[c];
    if (in_chunk < kTile) rem |= ~0ull << in_chunk;
    unsigned long long keep = 0ull;
    while (~rem && d < ndet) {  // uniform: rem is the same in every lane
      const int r = __ffsll(static_cast<long long>(~rem)) - 1;
      keep |= 1ull << r;
      if (lane == 0) kept[d] = c * kTile + r;
      ++d;
      rem |= (1ull << r) |
             __shfl_sync(0xffffffffu, r < 32 ? cur_lo : cur_hi, r & 31);
    }
    if (!keep || d >= ndet) continue;
    // the later words of the kept rows, kOrBatch loads in flight a lane
    for (int w = c + 1 + lane; w < live_words; w += 32) {
      unsigned long long acc = 0ull;
      for (unsigned long long todo = keep; todo;) {
        unsigned long long v[kOrBatch];
#pragma unroll
        for (int u = 0; u < kOrBatch; ++u) {
          v[u] = 0ull;
          if (todo) {
            const int r = __ffsll(static_cast<long long>(todo)) - 1;
            todo &= todo - 1ull;
            v[u] = mask[(long long)(c * kTile + r) * words + w];
          }
        }
#pragma unroll
        for (int u = 0; u < kOrBatch; ++u) acc |= v[u];
      }
      removed[w] |= acc;
    }
    __syncwarp();
  }
  __syncwarp();

  for (int r = lane; r < ndet; r += 32) {
    if (r < d) {
      const int k = order[kept[r]];
      out_s[r] = scores[k];
      for (int c = 0; c < kBox; ++c) out_b[r * kBox + c] = boxes[k * kBox + c];
      out_c[r] = classes[k];
    } else {  // rounds that recorded nothing stay zero
      out_s[r] = 0.f;
      for (int c = 0; c < kBox; ++c) out_b[r * kBox + c] = 0.f;
      out_c[r] = 0.f;
    }
  }
}

// The scratch cut into its parts (layout above).
struct NmsScratch {
  unsigned long long* mask;
  int* rank;
  int* nlive;
  int* nan_seen;
  int* order;
  int* kept;
  int words;
};

inline NmsScratch nms_scratch(void* scratch, int batch, int n) {
  NmsScratch s;
  s.words = (n + kTile - 1) / kTile;
  s.mask = static_cast<unsigned long long*>(scratch);
  s.rank = reinterpret_cast<int*>(s.mask + (long long)batch * n * s.words);
  s.nlive = s.rank + (long long)batch * n;
  s.nan_seen = s.nlive + batch;
  s.order = s.nan_seen + batch;
  s.kept = s.order + (long long)batch * n;
  return s;
}

// Step 1: zero the counts, rank the live candidates, write the order.
template <int kBox>
cudaError_t nms_rank_step(const float* scores, int batch, int n,
                          const NmsScratch& s, cudaStream_t st) {
  const cudaError_t err = cudaMemsetAsync(
      s.rank, 0, sizeof(int) * ((long long)batch * n + 2 * batch), st);
  if (err != cudaSuccess) return err;
  const int cand_blocks = (n + kRankThreads - 1) / kRankThreads;
  nms_count_kernel<kBox>
      <<<dim3(cand_blocks, (n + kRankSpan - 1) / kRankSpan, batch),
         kRankThreads, 0, st>>>(scores, n, s.rank, s.nlive, s.nan_seen);
  nms_order_kernel<kBox><<<dim3(cand_blocks, batch), kRankThreads, 0, st>>>(
      scores, n, s.rank, s.nlive, s.nan_seen, s.order);
  return cudaGetLastError();
}

// Step 3: the scan and the gather of the outputs.
template <int kBox>
cudaError_t nms_scan_step(const float* scores, const float* boxes,
                          const float* classes, int batch, int n, int ndet,
                          const NmsScratch& s, float* out_s, float* out_b,
                          float* out_c, cudaStream_t st) {
  nms_scan_kernel<kBox><<<batch, 32, 0, st>>>(
      scores, boxes, classes, s.order, s.nlive, s.mask, n, s.words, ndet,
      s.kept, out_s, out_b, out_c);
  return cudaGetLastError();
}

}  // namespace
