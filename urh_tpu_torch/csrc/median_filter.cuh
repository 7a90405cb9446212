// Per-element arithmetic of the forward-window median filter (B7).
//
// Shared by the CUDA kernel (median_filter.cu, built by nvcc) and by a host
// build (g++ with -D__host__= -D__device__=) in
// tests/test_torch_kernel_math.py, which holds the selections against
// np.sort and the plain version.
//
// The filter sorts in one total order of the float32 values, held by
// signed 32-bit keys: -inf < ... < -0.0 < +0.0 < ... < +inf < NaN.  Every
// NaN takes one key above +inf, as np.sort puts NaN last (and comes back as
// the canonical quiet NaN).  -0.0 sorts below +0.0: urh_tpu's two routes
// leave the sign of a zero median to their sort (np.sort) or their min/max
// network, and disagree with each other there.  Equal keys are equal
// values, so an order statistic is one key whatever the order of ties, and
// the kernel, its plain PyTorch version (which sorts the same keys) and
// any correct selection give the same bits.  The order is total, so a
// window kept sorted stays sorted on every input, NaN included.
#pragma once

#include <stdint.h>
#include <string.h>

#include <utility>

#define URH_MEDIAN_NAN_KEY ((int32_t)0x7FC00000)  // the key of every NaN
#define URH_MEDIAN_SIGN_FLIP ((int32_t)0x7FFFFFFF)
#define URH_MEDIAN_PAD_KEY ((int32_t)0x7FFFFFFF)  // above every key: a column past the row

// Windows of up to kUrhMedianMaxK keys live in registers, sorted (the
// window kernel); wider ones take the rank count.
constexpr int kUrhMedianMaxK = 16;
// The window kernel's shape: threads a block and T consecutive outputs a
// thread (at most K: the windows of a run share a core).
constexpr int kUrhMedianThreads = 128;
constexpr int kUrhMedianT = 5;

// outputs a thread of the window kernel for the window K
__host__ __device__ constexpr int urh_median_outputs(int k) {
    return k < kUrhMedianT ? k : kUrhMedianT;
}

// The key of v: its bits for a non-negative float, the bits with all but
// the sign flipped for a negative one (so that a larger magnitude is a
// smaller integer; bits >> 31 is all ones there), URH_MEDIAN_NAN_KEY for
// NaN.
__host__ __device__ inline int32_t urh_median_key(float v) {
    int32_t bits;
    memcpy(&bits, &v, sizeof bits);
    const int32_t key = bits ^ ((bits >> 31) & URH_MEDIAN_SIGN_FLIP);
    return v != v ? URH_MEDIAN_NAN_KEY : key;
}

// The float32 of a key (the inverse of urh_median_key but for NaN payloads).
__host__ __device__ inline float urh_median_value(int32_t key) {
    const int32_t bits = key ^ ((key >> 31) & URH_MEDIAN_SIGN_FLIP);
    float v;
    memcpy(&v, &bits, sizeof v);
    return v;
}

// The key at position m of the kk keys key(0) ... key(kk - 1) once sorted:
// the first key with fewer than m + 1 keys below it and more than m at or
// below it.  A rank count, kk * kk comparisons at most; key(i) is a
// callable, so the kernel reads shared memory or device memory through it.
template <typename Key>
__host__ __device__ inline int32_t urh_median_select(Key key, int kk, int m) {
    for (int j = 0; j < kk; ++j) {
        const int32_t v = key(j);
        int below = 0, at_or_below = 0;
        for (int i = 0; i < kk; ++i) {
            const int32_t u = key(i);
            below += u < v;
            at_or_below += u <= v;
        }
        if (below <= m && m < at_or_below) return v;
    }
    return key(0);  // not reached for 0 <= m < kk
}

// out[i] of one row of w values: the median of the window x[i, min(i + k,
// w)), the value at index kk / 2 of its kk sorted values (the upper median
// for an even kk, as urh_tpu takes it).  k >= 1.
__host__ __device__ inline float urh_median_at(const float* x, int64_t w, int64_t k,
                                               int64_t i) {
    const int kk = (int)(k < w - i ? k : w - i);
    return urh_median_value(
        urh_median_select([&](int j) { return urh_median_key(x[i + j]); }, kk, kk / 2));
}

// -- the window kernel's selection: K (the window) a compile-time constant,
// the window's keys in registers, every loop unrolled, no branch on a key.

__host__ __device__ inline int32_t urh_median_min(int32_t a, int32_t b) { return b < a ? b : a; }
__host__ __device__ inline int32_t urh_median_max(int32_t a, int32_t b) { return a < b ? b : a; }

// The compare-exchanges of Batcher's merge-exchange sorting network for n
// <= kUrhMedianMaxK keys, in order (Knuth, TAOCP vol. 3, 5.2.2, Algorithm
// M): 37 for 11 keys, 63 for 16, against n (n - 1) / 2 of a transposition
// network.  Evaluated by the compiler only.
struct UrhMedianNetwork {
    int count = 0;
    int lo[64] = {};
    int hi[64] = {};
};

constexpr UrhMedianNetwork urh_median_network(int n) {
    UrhMedianNetwork net{};
    int t = 0;
    while ((1 << t) < n) ++t;
    for (int p = t ? 1 << (t - 1) : 0; p > 0; p >>= 1) {
        int q = 1 << (t - 1), r = 0, d = p;
        while (d > 0) {
            for (int i = 0; i + d < n; ++i) {
                if ((i & p) == r) {
                    net.lo[net.count] = i;
                    net.hi[net.count] = i + d;
                    ++net.count;
                }
            }
            d = q - p;
            q >>= 1;
            r = p;
        }
    }
    return net;
}

template <int K>
struct UrhMedianSorter {
    static constexpr UrhMedianNetwork net = urh_median_network(K);

    template <int A, int B>
    __host__ __device__ static void exchange(int32_t (&w)[K]) {
        const int32_t lo = urh_median_min(w[A], w[B]);
        w[B] = urh_median_max(w[A], w[B]);
        w[A] = lo;
    }

    template <int... C>
    __host__ __device__ static void sort(int32_t (&w)[K], std::integer_sequence<int, C...>) {
        (exchange<net.lo[C], net.hi[C]>(w), ...);
    }
};

// Sort w ascending: Batcher's network, every index a compile-time constant,
// a min and a max an exchange.
template <int K>
__host__ __device__ inline void urh_median_sort(int32_t (&w)[K]) {
    UrhMedianSorter<K>::sort(w, std::make_integer_sequence<int, UrhMedianSorter<K>::net.count>{});
}

// The sorted window w with the key `out` (one of its keys) dropped and the
// key `in` inserted, sorted again.  Drop: from the first key >= out on
// (out itself), every key takes its successor's; a compare and a select a
// place.  Insert into the K - 1 keys a left: the new key at place j is
// max(a[j - 1], min(a[j], in)), with a[-1] = -inf and a[K - 1] = +inf; a
// min and a max a place.  4 (K - 1) operations in all.
template <int K>
__host__ __device__ inline void urh_median_slide(int32_t (&w)[K], int32_t out, int32_t in) {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) w[j] = w[j] >= out ? w[j + 1] : w[j];
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
        int32_t v = j + 1 < K ? urh_median_min(w[j], in) : in;
        w[j] = j > 0 ? urh_median_max(w[j - 1], v) : v;
    }
}

// w[m] for a place m known only at run time, by selects (an index into a
// register array would put the window in local memory).
template <int K>
__host__ __device__ inline int32_t urh_median_pick(const int32_t (&w)[K], int m) {
    int32_t v = w[0];
#pragma unroll
    for (int j = 1; j < K; ++j) v = j == m ? w[j] : v;
    return v;
}

// The run of T consecutive outputs where the row ends inside the run's
// windows: key(j) is the key of the column j places after the run's first
// output (URH_MEDIAN_PAD_KEY past the row's end), n >= 1 the row's columns
// from that output on, and put(j, key) takes output j of the run for j <
// min(T, n).  The first window is sorted once, then slid one column an
// output; the padding keys sort last, so the window's first kk = min(K, n -
// j) keys are the row's, and the place kk / 2 is picked by selects.
template <int K, int T, typename Key, typename Put>
__host__ __device__ inline void urh_median_run(Key key, int n, Put put) {
    int32_t w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = key(j);
    urh_median_sort(w);
    const int outputs = n < T ? n : T;
    for (int j = 0; j < outputs; ++j) {
        if (j) urh_median_slide(w, key(j - 1), key(j + K - 1));
        const int kk = n - j < K ? n - j : K;
        put(j, urh_median_pick(w, kk / 2));
    }
}

// T <= K consecutive full windows at once.  The K - T + 1 keys they all
// hold (columns T - 1 ... K - 1) are sorted once; output j sorts its own
// T - 1 keys (columns j ... T - 2 and K ... K + j - 1) and takes the place
// K / 2 of their union with that core: the q-th smallest (q = K / 2 + 1) of
// two sorted lists is the least, over the splits a + b = q, of the larger of
// the core's a-th and the extras' b-th smallest.
template <int K, int T, typename Key, typename Put>
__host__ __device__ inline void urh_median_core_run(Key key, Put put) {
    constexpr int C = K - T + 1, E = T > 1 ? T - 1 : 1, Q = K / 2 + 1;
    int32_t core[C];
#pragma unroll
    for (int c = 0; c < C; ++c) core[c] = key(T - 1 + c);
    urh_median_sort(core);
#pragma unroll
    for (int j = 0; j < T; ++j) {
        int32_t e[E];
#pragma unroll
        for (int b = 0; b + 1 < T; ++b)
            e[b] = b < T - 1 - j ? key(j + b) : key(K + b - (T - 1 - j));
        urh_median_sort(e);
        int32_t v = URH_MEDIAN_PAD_KEY;
#pragma unroll
        for (int b = 0; b < T; ++b) {  // b extras and a = Q - b core keys
            const int a = Q - b;
            if (a < 0 || a > C) continue;
            int32_t t;
            if (b == 0)
                t = core[a - 1];
            else if (a == 0)
                t = e[b - 1];
            else
                t = urh_median_max(core[a - 1], e[b - 1]);
            v = urh_median_min(v, t);
        }
        put(j, v);
    }
}

// A thread of the window kernel: its run of T outputs (urh_median_run's
// arguments), full windows by the shared core, the row's end by the
// sliding window.
template <int K, int T, typename Key, typename Put>
__host__ __device__ inline void urh_median_thread(Key key, int n, Put put) {
    if (n >= T + K - 1) return urh_median_core_run<K, T>(key, put);
    urh_median_run<K, T>(key, n, put);
}

// The window kernel's tile for the window K and T outputs a thread: a
// block of kUrhMedianThreads threads takes kOut consecutive outputs of one
// row and reads their kSpan columns, the K - 1 of the halo included, in
// kLoads rounds of one column a thread (column m * threads + t in round m),
// a round's loads all issued before any is staged.  The staged keys and the
// outputs sit in shared memory with one spare word after every T when T is
// even (at), so that a warp's threads, T words apart, meet 32 banks.  The
// kernel runs each step for its thread t; the host build of the tests runs
// them for every t in turn.  span: the row's columns the tile reads, at
// most kSpan.
template <int K, int T>
struct UrhMedianTile {
    static constexpr int kOut = kUrhMedianThreads * T;
    static constexpr int kSpan = kOut + K - 1;
    static constexpr int kLoads = (kSpan + kUrhMedianThreads - 1) / kUrhMedianThreads;
    static constexpr int kPad = T % 2 == 0 ? 1 : 0;
    __host__ __device__ static constexpr int at(int col) { return col + kPad * (col / T); }
    static constexpr int kKeys = at(kSpan - 1) + 1;  // words of staged keys
    static constexpr int kRes = at(kOut - 1) + 1;    // words of outputs

    // the span of a tile with `left` columns of the row from its first on
    __host__ __device__ static int span(int64_t left) {
        return left < kSpan ? (int)left : kSpan;
    }
    // round m's load of thread t from the tile's first column of the row
    __host__ __device__ static float load(const float* row, int m, int t, int span) {
        const int col = m * kUrhMedianThreads + t;
        return col < span ? row[col] : 0.0f;
    }
    // round m's value v of thread t as a key, padding past the row's end
    // (only the last round passes kSpan)
    __host__ __device__ static void stage(int32_t* keys, int m, int t, float v, int span) {
        const int col = m * kUrhMedianThreads + t;
        if (m + 1 < kLoads || col < kSpan)
            keys[at(col)] = col < span ? urh_median_key(v) : URH_MEDIAN_PAD_KEY;
    }
    // thread t's run of T outputs from the staged keys into res
    __host__ __device__ static void run(const int32_t* keys, int32_t* res, int t, int span) {
        const int first = t * T;
        if (first >= span) return;
        const int32_t* mine = keys + at(first);
        int32_t* mine_out = res + at(first);
        urh_median_thread<K, T>([&](int j) { return mine[j + kPad * (j / T)]; }, span - first,
                                [&](int j, int32_t key) { mine_out[j] = key; });
    }
    // round m < T of the copy out: thread t's column of the tile's outputs
    __host__ __device__ static void write(float* dst, const int32_t* res, int m, int t,
                                          int span) {
        const int col = m * kUrhMedianThreads + t;
        if (col < span) dst[col] = urh_median_value(res[at(col)]);
    }
};
