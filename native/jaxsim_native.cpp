// jaxsim_native — host-side runtime accelerators for gpusimilarity_jax.
//
// The reference implements its load path natively (parallel qUncompress on a
// QThreadPool + char* string vectors, gpusim.cpp:48-85,202-236). This is the
// JAX rebuild's native equivalent, exposed as a plain C ABI consumed from
// Python via ctypes:
//   * parallel zlib decompression of qCompress-framed chunks
//   * one-pass parsing of writeString record streams into an offset table
//     (backs the zero-copy StringTable that replaces per-string heap char*s)
//   * packed-row popcounts, OR-folding, and row->planar transposition
//
// Build: make -C native   (produces libjaxsim_native.so)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

inline uint32_t read_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int hardware_threads(int requested) {
    if (requested > 0) return requested;
    unsigned n = std::thread::hardware_concurrency();
    return n == 0 ? 1 : static_cast<int>(n);
}

template <typename F>
void parallel_for(long n, int n_threads, F&& fn) {
    n_threads = hardware_threads(n_threads);
    if (n_threads <= 1 || n < 2) {
        for (long i = 0; i < n; ++i) fn(i);
        return;
    }
    // hand out BLOCKS of indices per atomic acquisition: one contended
    // fetch_add per ~128-byte row would serialize row-granular kernels
    // (popcount/fold) at hundreds of millions of rows
    long grain = n / (static_cast<long>(n_threads) * 64);
    if (grain < 1) grain = 1;
    if (grain > 8192) grain = 8192;
    std::atomic<long> next(0);
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        threads.emplace_back([&] {
            for (;;) {
                long lo = next.fetch_add(grain);
                if (lo >= n) return;
                long hi = lo + grain < n ? lo + grain : n;
                for (long i = lo; i < hi; ++i) fn(i);
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Decompress n qCompress-framed chunks (4-byte BE uncompressed size + zlib
// stream) into caller-allocated buffers. dst_lens[i] must equal the framed
// size. Returns 0 on success, or 1-based index of the first failing chunk.
int tsn_decompress_chunks(const uint8_t** srcs, const long* src_lens,
                          uint8_t** dsts, const long* dst_lens, long n,
                          int n_threads) {
    std::atomic<long> failed(0);
    parallel_for(n, n_threads, [&](long i) {
        if (failed.load(std::memory_order_relaxed)) return;
        if (src_lens[i] < 4) { failed.store(i + 1); return; }
        uint32_t expected = read_be32(srcs[i]);
        if (static_cast<long>(expected) != dst_lens[i]) { failed.store(i + 1); return; }
        uLongf out_len = static_cast<uLongf>(dst_lens[i]);
        int rc = uncompress(dsts[i], &out_len, srcs[i] + 4,
                            static_cast<uLong>(src_lens[i] - 4));
        if (rc != Z_OK || static_cast<long>(out_len) != dst_lens[i]) {
            failed.store(i + 1);
        }
    });
    return static_cast<int>(failed.load());
}

// Parse a stream of Qt writeString records (uint32 BE length INCLUDING a
// trailing NUL, then bytes, then NUL; 0xFFFFFFFF = null string -> empty).
// Writes (start, end) byte offsets of each string's payload into offsets
// (2 entries per string). Returns the number of strings, or -1 on malformed
// input, or -2 if max_strings would be exceeded.
long tsn_parse_string_records(const uint8_t* buf, long len, int64_t* offsets,
                              long max_strings) {
    long pos = 0, count = 0;
    while (pos < len) {
        if (pos + 4 > len) return -1;
        uint32_t rec = read_be32(buf + pos);
        pos += 4;
        if (count >= max_strings) return -2;
        if (rec == 0xFFFFFFFFu || rec == 0) {  // null -> empty string
            offsets[2 * count] = pos;
            offsets[2 * count + 1] = pos;
            ++count;
            continue;
        }
        if (pos + static_cast<long>(rec) > len) return -1;
        if (buf[pos + rec - 1] != 0) return -1;  // must be NUL-terminated
        offsets[2 * count] = pos;
        offsets[2 * count + 1] = pos + rec - 1;
        ++count;
        pos += rec;
    }
    return count;
}

// Per-row popcount of packed fingerprints: words is uint32[n_rows][w].
void tsn_popcount_rows(const uint32_t* words, long n_rows, int w,
                       int32_t* out, int n_threads) {
    const int w64 = w / 2;
    parallel_for(n_rows, n_threads, [&](long r) {
        const uint32_t* row = words + r * w;
        int32_t acc = 0;
        if (w64 * 2 == w) {
            const uint64_t* row64 = reinterpret_cast<const uint64_t*>(row);
            for (int i = 0; i < w64; ++i) acc += __builtin_popcountll(row64[i]);
        } else {
            for (int i = 0; i < w; ++i) acc += __builtin_popcount(row[i]);
        }
        out[r] = acc;
    });
}

// OR-fold packed rows by fold (must divide w): out is uint32[n_rows][w/fold].
void tsn_fold_rows(const uint32_t* words, long n_rows, int w, int fold,
                   uint32_t* out, int n_threads) {
    const int wf = w / fold;
    parallel_for(n_rows, n_threads, [&](long r) {
        const uint32_t* row = words + r * w;
        uint32_t* dst = out + r * wf;
        for (int j = 0; j < wf; ++j) {
            uint32_t acc = 0;
            for (int g = 0; g < fold; ++g) acc |= row[g * wf + j];
            dst[j] = acc;
        }
    });
}

// Transpose row-major packed rows to planar layout: uint32[n][w] -> [w][n_out]
// (n_out >= n; the tail columns are zero-filled padding).
void tsn_transpose_planar(const uint32_t* words, long n, int w, long n_out,
                          uint32_t* out, int n_threads) {
    // tile for cache friendliness
    const long TILE = 512;
    long n_tiles = (n + TILE - 1) / TILE;
    parallel_for(n_tiles, n_threads, [&](long t) {
        long r0 = t * TILE;
        long r1 = r0 + TILE < n ? r0 + TILE : n;
        for (int c = 0; c < w; ++c) {
            uint32_t* dst = out + static_cast<long>(c) * n_out;
            for (long r = r0; r < r1; ++r) dst[r] = words[r * w + c];
        }
    });
    // zero the padding tail once (single thread; it's small)
    for (int c = 0; c < w; ++c) {
        uint32_t* dst = out + static_cast<long>(c) * n_out;
        std::memset(dst + n, 0, sizeof(uint32_t) * (n_out - n));
    }
}

// Exact Tanimoto/Tversky re-scoring of candidate rows against one query
// (the folded-scan recovery path). rows: indices into words[n][w].
void tsn_rescore(const uint32_t* words, int w, const int64_t* rows,
                 long n_rows, const uint32_t* query, int query_pop,
                 double alpha, double beta, int tversky, float* out_scores) {
    for (long i = 0; i < n_rows; ++i) {
        const uint32_t* row = words + rows[i] * w;
        int common = 0, rpop = 0;
        for (int j = 0; j < w; ++j) {
            common += __builtin_popcount(row[j] & query[j]);
            rpop += __builtin_popcount(row[j]);
        }
        double denom;
        if (tversky) {
            denom = alpha * (query_pop - common) + beta * (rpop - common) + common;
        } else {
            denom = double(query_pop) + double(rpop) - double(common);
        }
        out_scores[i] = denom > 0 ? static_cast<float>(common / denom) : 0.0f;
    }
}

// ---- virtual benchmark libraries (utils/synth.py) --------------------------
// lowbias32 mixer; MUST stay op-for-op identical to synth._mix32 so host,
// device, and native materializations of a virtual library are bit-identical
// (pinned by tests/test_synth.py + test_native.py).
static inline uint32_t tsn_mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x7feb352dU;
    h ^= h >> 15;
    h *= 0x846ca68bU;
    return h ^ (h >> 16);
}

// Virtual clustered rows (see utils/synth.py::_virtual_words /
// _combine_words — the implementations MUST stay draw-for-draw identical).
// Per word w of row i (cluster c = i >> 8): draws a/b = mix32(h + {2w,
// 2w+1} * GOLD) over per-row/per-cluster bases combine as
//   core  = ca & ror7(ca) & ror15(ca) & cb & ror11(cb)   (~3.1%)
//   keep  = ra | ror13(ra)                                (75%)
//   indiv = rb & ror3 & ror6 & ror12 & ror17 & ror24(rb)  (~1.6%)
//   word  = (core & keep) | indiv                         (~4% density)
static inline uint32_t tsn_ror(uint32_t x, int r) {
    return (x >> r) | (x << (32 - r));
}

static inline uint32_t tsn_core_word(uint32_t ca, uint32_t cb) {
    return ca & tsn_ror(ca, 7) & tsn_ror(ca, 15) & cb & tsn_ror(cb, 11);
}

static inline uint32_t tsn_row_word(uint32_t core, uint32_t ra, uint32_t rb) {
    uint32_t keep = ra | tsn_ror(ra, 13);
    uint32_t indiv = rb & tsn_ror(rb, 3) & tsn_ror(rb, 6) & tsn_ror(rb, 12)
                     & tsn_ror(rb, 17) & tsn_ror(rb, 24);
    return (core & keep) | indiv;
}

namespace {
// Per-thread cluster-core cache: a cluster's 256 consecutive rows (and the
// index-sorted candidate sweeps of the rescore) reuse the 2-draw core.
struct CoreCache {
    std::vector<uint32_t> core;
    uint32_t cluster = 0;
    bool valid = false;

    const uint32_t* get(uint32_t c, int word_count, uint32_t s_clu,
                        const uint32_t* offp) {
        if (!valid || cluster != c ||
            core.size() != static_cast<size_t>(word_count)) {
            cluster = c;
            valid = true;
            core.resize(word_count);
            const uint32_t hc = tsn_mix32(c ^ s_clu);
            for (int w = 0; w < word_count; ++w)
                core[w] = tsn_core_word(tsn_mix32(hc + offp[2 * w]),
                                        tsn_mix32(hc + offp[2 * w + 1]));
        }
        return core.data();
    }
};
}  // namespace

// Fill out = uint32[n_rows][word_count] with virtual rows [row0, row0+n).
// Row indices must stay below 2^32 (uint32 counter).
void tsn_synth_fill(uint32_t* out, uint64_t row0, long n_rows, int word_count,
                    uint32_t seed, int n_threads) {
    const uint32_t gold = 0x9E3779B9U;
    const uint32_t s_row = seed * gold + 0x85EBCA6BU;
    const uint32_t s_clu = seed * gold + 0xC2B2AE35U;
    const int nd = word_count * 2;
    std::vector<uint32_t> off(nd);
    for (int j = 0; j < nd; ++j) off[j] = static_cast<uint32_t>(j) * gold;
    const uint32_t* offp = off.data();
    parallel_for(n_rows, n_threads, [&](long i) {
        thread_local CoreCache cache;
        const uint32_t iu = static_cast<uint32_t>(row0 + i);
        const uint32_t* core = cache.get(iu >> 8, word_count, s_clu, offp);
        const uint32_t hr = tsn_mix32(iu ^ s_row);
        uint32_t* row = out + i * word_count;
        for (int w = 0; w < word_count; ++w)
            row[w] = tsn_row_word(core[w], tsn_mix32(hr + offp[2 * w]),
                                  tsn_mix32(hr + offp[2 * w + 1]));
    });
}

// Exact re-score of virtual-library candidate rows against one query: the
// fold-bench's timed rescore path. Identical scoring to tsn_rescore but the
// candidate rows are recomputed from the mixer instead of read from RAM
// (rows should arrive index-sorted so the cluster-core cache hits).
void tsn_synth_rescore(const int64_t* rows, long n_rows,
                       const uint32_t* query, int word_count, uint32_t seed,
                       int query_pop, double alpha, double beta, int tversky,
                       float* out_scores) {
    const uint32_t gold = 0x9E3779B9U;
    const uint32_t s_row = seed * gold + 0x85EBCA6BU;
    const uint32_t s_clu = seed * gold + 0xC2B2AE35U;
    const int nd = word_count * 2;
    std::vector<uint32_t> off(nd);
    for (int j = 0; j < nd; ++j) off[j] = static_cast<uint32_t>(j) * gold;
    const uint32_t* offp = off.data();
    CoreCache cache;
    for (long i = 0; i < n_rows; ++i) {
        const uint32_t iu = static_cast<uint32_t>(rows[i]);
        const uint32_t* core = cache.get(iu >> 8, word_count, s_clu, offp);
        const uint32_t hr = tsn_mix32(iu ^ s_row);
        int common = 0, rpop = 0;
        for (int w = 0; w < word_count; ++w) {
            uint32_t word = tsn_row_word(
                core[w], tsn_mix32(hr + offp[2 * w]),
                tsn_mix32(hr + offp[2 * w + 1]));
            common += __builtin_popcount(word & query[w]);
            rpop += __builtin_popcount(word);
        }
        double denom;
        if (tversky) {
            denom = alpha * (query_pop - common) + beta * (rpop - common) + common;
        } else {
            denom = double(query_pop) + double(rpop) - double(common);
        }
        out_scores[i] = denom > 0 ? static_cast<float>(common / denom) : 0.0f;
    }
}

int tsn_version() { return 3; }

}  // extern "C"
