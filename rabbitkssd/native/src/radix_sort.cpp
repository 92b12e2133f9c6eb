// Multithreaded stable LSD radix sort + counting-sort partition for the
// inverted-index build (engine/dist_engine.py _CsrIndex).
//
// The reference builds its inverted index with a dense per-slot
// vector<vector> scatter (reference sketch.cpp:971-1016); this
// build's sparse equivalent is one stable sort of all (hash, genome)
// pairs — np.argsort is the measured config-5 wall (~16 s per 38M pairs,
// single-threaded comparison sort).  These kernels run at memory speed:
// 16-bit digits, per-thread block histograms, block-ordered scatter
// (stable by construction: blocks are scanned in order and each digit's
// write cursor advances in block order).
//
// Threading contract: callers pass n_threads; ctypes releases the GIL.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// NB: an MADV_HUGEPAGE experiment on these buffers was tried and
// reverted — this container sets THP defrag=madvise, so advised
// faults pay synchronous compaction (from_hashes 14.5 s -> 25.2 s
// at 150M pairs).  Plain malloc + parallel first-touch wins here.

// Touch every page across threads so the fault cost is paid in
// parallel up front instead of serially inside the first counting
// pass (the config-5 index build measured ~13 s of page faults over
// ~6 GB of fresh buffers, round 3).
static void parallel_touch(void *p, size_t bytes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    char *c = static_cast<char *>(p);
    size_t chunk = (bytes + n_threads - 1) / n_threads;
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t) {
        size_t lo = size_t(t) * chunk;
        size_t hi = std::min(bytes, lo + chunk);
        if (lo >= hi) break;
        th.emplace_back([c, lo, hi] {
            for (size_t i = lo; i < hi; i += 4096) c[i] = 0;
        });
    }
    for (auto &x : th) x.join();
}

// Process-wide scratch arena: the sort's ping-pong buffers are pure
// scratch, so reusing them across build calls (strips, repeat runs in
// one process) skips both the malloc and the refault of multi-GB
// regions.  Slots are grabbed under a mutex; concurrent builds beyond
// the slot count fall back to plain malloc.
struct ArenaSlot {
    void *p = nullptr;
    size_t cap = 0;
    bool busy = false;
};
static ArenaSlot g_arena[4];
static std::mutex g_arena_mu;

struct Scratch {
    void *p = nullptr;
    int slot = -1;  // -1: owned malloc, free on release
};

static Scratch arena_get(size_t bytes, int n_threads) {
    {
        std::lock_guard<std::mutex> lk(g_arena_mu);
        for (int i = 0; i < 4; ++i) {
            if (g_arena[i].busy) continue;
            if (g_arena[i].cap >= bytes) {
                g_arena[i].busy = true;
                return {g_arena[i].p, i};
            }
        }
        // claim the first free slot for an upgrade
        for (int i = 0; i < 4; ++i) {
            if (!g_arena[i].busy) {
                free(g_arena[i].p);
                g_arena[i].p = nullptr;
                g_arena[i].cap = 0;
                void *p = malloc(bytes);
                if (!p) return {nullptr, -1};
                g_arena[i].p = p;
                g_arena[i].cap = bytes;
                g_arena[i].busy = true;
                // touch outside the lock? cheap enough to keep simple:
                // first-touch below, after release of the lock, would
                // race a concurrent upgrade of the same slot — the
                // slot is marked busy, so no other caller can touch it
                return {p, i};
            }
        }
    }
    return {malloc(bytes), -1};
}

static void arena_release(Scratch s) {
    if (s.slot < 0) {
        free(s.p);
        return;
    }
    std::lock_guard<std::mutex> lk(g_arena_mu);
    g_arena[s.slot].busy = false;
}

static Scratch big_scratch(size_t bytes, int n_threads) {
    Scratch s = arena_get(bytes, n_threads);
    if (s.p && s.slot >= 0)  // fresh or reused slot: ensure faulted
        parallel_touch(s.p, bytes, n_threads);
    return s;
}

constexpr int kDigitBits = 16;
constexpr int kRadix = 1 << kDigitBits;

struct Span {
    int64_t lo, hi;
};

static std::vector<Span> split(int64_t n, int t) {
    std::vector<Span> s(t);
    for (int i = 0; i < t; ++i)
        s[i] = {n * i / t, n * (i + 1) / t};
    return s;
}

// One stable counting-sort pass moving src -> dst by digit(key).
// KeyFn: element index -> digit in [0, radix).  MoveFn: (src_i, dst_i).
template <typename KeyFn, typename MoveFn>
static void counting_pass(int64_t n, int radix, int n_threads, KeyFn digit,
                          MoveFn move) {
    auto spans = split(n, n_threads);
    std::vector<std::vector<int64_t>> hist(
        n_threads, std::vector<int64_t>(radix, 0));
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                auto &h = hist[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    h[digit(i)]++;
            });
        for (auto &x : th) x.join();
    }
    // exclusive offsets in (digit, block) order
    int64_t run = 0;
    for (int d = 0; d < radix; ++d)
        for (int t = 0; t < n_threads; ++t) {
            int64_t c = hist[t][d];
            hist[t][d] = run;
            run += c;
        }
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                auto &h = hist[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    move(i, h[digit(i)]++);
            });
        for (auto &x : th) x.join();
    }
}

}  // namespace

// Stable radix sort of u64 keys by bits [lo_bit, hi_bit), 16 bits per
// pass.  Returns 0 if the sorted data ends in `keys`, 1 if in `tmp`
// (the caller owns both buffers and picks).  Bits outside the range are
// carried untouched — callers pack payloads into the low bits.
extern "C" int kssd_radix_sort_u64(uint64_t *keys, uint64_t *tmp, int64_t n,
                                   int lo_bit, int hi_bit, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    uint64_t *src = keys, *dst = tmp;
    int flip = 0;
    for (int shift = lo_bit; shift < hi_bit; shift += kDigitBits) {
        const int bits = hi_bit - shift < kDigitBits ? hi_bit - shift
                                                     : kDigitBits;
        const uint64_t mask = (uint64_t(1) << bits) - 1;
        counting_pass(
            n, int(mask) + 1, n_threads,
            [&](int64_t i) { return int((src[i] >> shift) & mask); },
            [&](int64_t i, int64_t o) { dst[o] = src[i]; });
        std::swap(src, dst);
        flip ^= 1;
    }
    return flip;
}

// Key-value variant: u64 keys sorted by bits [lo_bit, hi_bit) with a
// u64 payload permuted alongside (for 64-bit hash spaces whose keys
// have no spare low bits).  Same return contract as above, applying to
// both (keys, vals) vs (tkeys, tvals).
extern "C" int kssd_radix_sort_kv64(uint64_t *keys, uint64_t *vals,
                                    uint64_t *tkeys, uint64_t *tvals,
                                    int64_t n, int lo_bit, int hi_bit,
                                    int n_threads) {
    if (n_threads < 1) n_threads = 1;
    uint64_t *ks = keys, *kd = tkeys, *vs = vals, *vd = tvals;
    int flip = 0;
    for (int shift = lo_bit; shift < hi_bit; shift += kDigitBits) {
        const int bits = hi_bit - shift < kDigitBits ? hi_bit - shift
                                                     : kDigitBits;
        const uint64_t mask = (uint64_t(1) << bits) - 1;
        counting_pass(
            n, int(mask) + 1, n_threads,
            [&](int64_t i) { return int((ks[i] >> shift) & mask); },
            [&](int64_t i, int64_t o) {
                kd[o] = ks[i];
                vd[o] = vs[i];
            });
        std::swap(ks, kd);
        std::swap(vs, vd);
        flip ^= 1;
    }
    return flip;
}

// Full inverted-index build from concatenated per-genome hash arrays:
// pack (hash, gid) keys, stable radix sort by the hash bits, then
// unpack sorted hashes + gids while detecting hash-run boundaries and
// assigning each pair its vocabulary column id — everything the Python
// side previously did with ~6 numpy temporaries over the 150M-pair
// config-5 payload (the measured index-build wall after the sort
// itself went native).  Writes sh/sg/cols (all length n) and
// starts[0..nv), returns nv (the vocabulary size), or -1 on alloc
// failure.  Stability by hash keeps gids ascending within a run
// (genome-major input), the reference's posting-list order
// (/root/reference/src/sketch.cpp:894-1021).
extern "C" int64_t kssd_build_postings32(const uint32_t *hashes, int64_t n,
                                         const int64_t *sizes, int32_t G,
                                         int hash_bits, uint32_t *sh,
                                         int32_t *sg, int32_t *cols,
                                         int64_t *starts, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n == 0) return 0;
    // Fused pack+sort+unpack, ONE 8n scratch buffer: the first LSD
    // pass histograms its digit straight off the input hashes (the
    // genome id derived by walking the per-genome offsets) and
    // scatters packed (hash<<32 | gid) u64s into scratch; the final
    // pass scatters sh/sg directly into the caller's output arrays.
    // Compared to the previous pack -> 2-buffer ping-pong -> unpack
    // this halves the fresh-buffer footprint (16n -> 8n bytes: the
    // 1M-genome config-5 build faulted ~6 GB of scratch for a 1.2 GB
    // resident index on a host whose first-touch path runs at
    // 0.2-2.2 GB/s) and removes one full read+write pass.
    // hash_bits <= 28 at drlevel >= 3 (16^(half_k-drlevel) slots), so
    // 16-bit digits mean exactly two passes: input -> scratch -> out.
    Scratch stmp = big_scratch(size_t(n) * 8, n_threads);
    uint64_t *tmp = (uint64_t *)stmp.p;
    if (!tmp) {
        arena_release(stmp);
        return -1;
    }
    // genome offsets (prefix of sizes)
    std::vector<int64_t> off(size_t(G) + 1);
    off[0] = 0;
    for (int32_t g = 0; g < G; ++g) off[g + 1] = off[g] + sizes[g];
    auto spans = split(n, n_threads);

    const int pass1_bits = hash_bits < kDigitBits ? hash_bits : kDigitBits;
    const uint32_t mask1 = (uint32_t(1) << pass1_bits) - 1;
    // pass 1: stable counting sort by the hash's low digit, packing on
    // the fly.  Each thread walks its span in order, so the genome
    // cursor advances monotonically in both the histogram and scatter
    // loops.
    {
        std::vector<std::vector<int64_t>> hist(
            n_threads, std::vector<int64_t>(size_t(mask1) + 1, 0));
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                auto &h = hist[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    h[hashes[i] & mask1]++;
            });
        for (auto &x : th) x.join();
        int64_t run = 0;
        for (uint32_t d = 0; d <= mask1; ++d)
            for (int t = 0; t < n_threads; ++t) {
                int64_t c = hist[t][d];
                hist[t][d] = run;
                run += c;
            }
        th.clear();
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                auto &h = hist[t];
                int64_t lo = spans[t].lo;
                int32_t g = int32_t(std::upper_bound(off.begin(), off.end(),
                                                     lo) -
                                    off.begin()) -
                            1;
                for (int64_t i = lo; i < spans[t].hi; ++i) {
                    while (i >= off[g + 1]) ++g;
                    tmp[h[hashes[i] & mask1]++] =
                        (uint64_t(hashes[i]) << 32) | uint32_t(g);
                }
            });
        for (auto &x : th) x.join();
    }
    // remaining digit passes: all but the last ping-pong within tmp
    // would need a second buffer — hash_bits <= 32 means at most ONE
    // more pass, which scatters straight into (sh, sg)
    if (hash_bits > kDigitBits) {
        const int bits = hash_bits - kDigitBits;
        const uint64_t mask = (uint64_t(1) << bits) - 1;
        const int shift = 32 + kDigitBits;
        counting_pass(
            n, int(mask) + 1, n_threads,
            [&](int64_t i) { return int((tmp[i] >> shift) & mask); },
            [&](int64_t i, int64_t o) {
                sh[o] = uint32_t(tmp[i] >> 32);
                sg[o] = int32_t(uint32_t(tmp[i]));
            });
    } else {
        auto sp = split(n, n_threads);
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                for (int64_t i = sp[t].lo; i < sp[t].hi; ++i) {
                    sh[i] = uint32_t(tmp[i] >> 32);
                    sg[i] = int32_t(uint32_t(tmp[i]));
                }
            });
        for (auto &x : th) x.join();
    }
    arena_release(stmp);
    // pass A: boundary counts per span (reads the 4-byte sh, not the
    // 8-byte packed stream)
    std::vector<int64_t> nb(n_threads);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                int64_t c = 0;
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    if (i == 0 || sh[i] != sh[i - 1]) ++c;
                nb[t] = c;
            });
        for (auto &x : th) x.join();
    }
    int64_t nv = 0;
    std::vector<int64_t> vbase(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        vbase[t] = nv;
        nv += nb[t];
    }
    // pass B: starts + per-pair column ids
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                int64_t v = vbase[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i) {
                    if (i == 0 || sh[i] != sh[i - 1]) starts[v++] = i;
                    cols[i] = int32_t(v - 1);
                }
            });
        for (auto &x : th) x.join();
    }
    return nv;
}

// 64-bit hash variant (use64 sketches, no spare key bits): key/value
// sort with the gid as payload, then the same unpack/boundary pass.
extern "C" int64_t kssd_build_postings64(const uint64_t *hashes, int64_t n,
                                         const int64_t *sizes, int32_t G,
                                         int hash_bits, uint64_t *sh,
                                         int32_t *sg, int32_t *cols,
                                         int64_t *starts, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n == 0) return 0;
    Scratch sk_ = big_scratch(size_t(n) * 8, n_threads);
    Scratch sv_ = big_scratch(size_t(n) * 8, n_threads);
    Scratch stk = big_scratch(size_t(n) * 8, n_threads);
    Scratch stv = big_scratch(size_t(n) * 8, n_threads);
    uint64_t *keys = (uint64_t *)sk_.p;
    uint64_t *vals = (uint64_t *)sv_.p;
    uint64_t *tk = (uint64_t *)stk.p;
    uint64_t *tv = (uint64_t *)stv.p;
    if (!keys || !vals || !tk || !tv) {
        arena_release(sk_);
        arena_release(sv_);
        arena_release(stk);
        arena_release(stv);
        return -1;
    }
    std::vector<int64_t> off(size_t(G) + 1);
    off[0] = 0;
    for (int32_t g = 0; g < G; ++g) off[g + 1] = off[g] + sizes[g];
    auto spans = split(n, n_threads);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                int64_t lo = spans[t].lo, hi = spans[t].hi;
                int32_t g = int32_t(std::upper_bound(off.begin(), off.end(),
                                                     lo) -
                                    off.begin()) -
                            1;
                for (int64_t i = lo; i < hi; ++i) {
                    while (i >= off[g + 1]) ++g;
                    keys[i] = hashes[i];
                    vals[i] = uint64_t(uint32_t(g));
                }
            });
        for (auto &x : th) x.join();
    }
    int flip = kssd_radix_sort_kv64(keys, vals, tk, tv, n, 0, hash_bits,
                                    n_threads);
    const uint64_t *ks = flip ? tk : keys;
    const uint64_t *vs = flip ? tv : vals;
    std::vector<int64_t> nb(n_threads);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                int64_t c = 0;
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    if (i == 0 || ks[i] != ks[i - 1]) ++c;
                nb[t] = c;
            });
        for (auto &x : th) x.join();
    }
    int64_t nv = 0;
    std::vector<int64_t> vbase(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        vbase[t] = nv;
        nv += nb[t];
    }
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                int64_t v = vbase[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i) {
                    if (i == 0 || ks[i] != ks[i - 1]) starts[v++] = i;
                    sh[i] = ks[i];
                    sg[i] = int32_t(uint32_t(vs[i]));
                    cols[i] = int32_t(v - 1);
                }
            });
        for (auto &x : th) x.join();
    }
    arena_release(sk_);
    arena_release(sv_);
    arena_release(stk);
    arena_release(stv);
    return nv;
}

// Stable partition of (gid, col) pair lists by strip id gid / block —
// the blocked-distance strip grouping (dist_engine _CsrIndex.strip_runs)
// as ONE counting-sort pass (np.argsort re-sorts 150M pairs by a
// ~100-value key).  bounds[k] receives the exclusive prefix sum: strip
// k's pairs land at [bounds[k], bounds[k+1]).  n_strips must satisfy
// (max gid / block) < n_strips <= 65536.
extern "C" void kssd_partition_pairs(const int32_t *gids, const int32_t *cols,
                                     int64_t n, int32_t block,
                                     int32_t n_strips, int32_t *g_out,
                                     int32_t *c_out, int64_t *bounds,
                                     int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto spans = split(n, n_threads);
    std::vector<std::vector<int64_t>> hist(
        n_threads, std::vector<int64_t>(n_strips, 0));
    {
        std::vector<std::thread> th;
        for (int t = 0; t < n_threads; ++t)
            th.emplace_back([&, t] {
                auto &h = hist[t];
                for (int64_t i = spans[t].lo; i < spans[t].hi; ++i)
                    h[gids[i] / block]++;
            });
        for (auto &x : th) x.join();
    }
    int64_t run = 0;
    for (int32_t d = 0; d < n_strips; ++d) {
        bounds[d] = run;
        for (int t = 0; t < n_threads; ++t) {
            int64_t c = hist[t][d];
            hist[t][d] = run;
            run += c;
        }
    }
    bounds[n_strips] = run;
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t)
        th.emplace_back([&, t] {
            auto &h = hist[t];
            for (int64_t i = spans[t].lo; i < spans[t].hi; ++i) {
                int64_t o = h[gids[i] / block]++;
                g_out[o] = gids[i];
                c_out[o] = cols[i];
            }
        });
    for (auto &x : th) x.join();
}
