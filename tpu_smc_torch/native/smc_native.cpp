// Host runtime of tpu_smc_torch in C++ (loaded through ctypes), the
// counterpart of tpu_smc/native/smc_native.cpp: its three CSV formatters,
// byte for byte the same output; glibc's rand() and the reference's
// Box-Muller (the srand(42) wall table, SMC.c:477), bit for bit; and the
// reference-semantics CNA oracle (SMC.c:971-1045).
//
// The formatters They write the voxel ("local") rows, the position rows and
// the last_state row (SMC.c:158-189, 218-225; main.c:163-171), the host's
// slowest step after an ensemble run.
//
// tpu_smc formats every number with sprintf. Here the voxel rows' integers
// are written digit by digit, and a position v goes through
// q = rint(v * 1000) (the digits of sprintf's "%0.3f" whenever v * 1000 is
// farther than 1e-6 from a half-way point and below 2^31 in magnitude,
// where its float64 error is below 1.2e-7); the other positions, and
// last_state's "%0.12f", go through snprintf.
//
// Every write is bounded by the buffer: a formatter returns the bytes it
// wrote, or -1 when `cap` is too small (the caller retries larger).
//
// Build: g++ -O2 -shared -fPIC (tpu_smc_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

// Decimal digits of v at p; returns the end. Two digits per step from a
// table, in 32-bit arithmetic below 2^32 (the voxel counts of any run).
const char kPairs[] =
    "00010203040506070809101112131415161718192021222324252627282930313233"
    "34353637383940414243444546474849505152535455565758596061626364656667"
    "6869707172737475767778798081828384858687888990919293949596979899";

inline char *put_u64(char *p, uint64_t v) {
    char tmp[24];
    char *q = tmp + sizeof(tmp);
    while (v >= 0x100000000ull) {
        *--q = (char)('0' + v % 10);
        v /= 10;
    }
    uint32_t u = (uint32_t)v;
    while (u >= 100) {
        const uint32_t d = (u % 100) * 2;
        u /= 100;
        *--q = kPairs[d + 1];
        *--q = kPairs[d];
    }
    if (u >= 10) {
        *--q = kPairs[u * 2 + 1];
        *--q = kPairs[u * 2];
    } else {
        *--q = (char)('0' + u);
    }
    const int n = (int)(tmp + sizeof(tmp) - q);
    for (int k = 0; k < n; k++) p[k] = q[k];
    return p + n;
}

}  // namespace

extern "C" {

// Voxel rows "i, j, k, n, mu\n" for an [ncx, ncx, ncz] grid pair.
int64_t format_local_rows(const uint64_t *density, const uint64_t *mobility,
                          int ncx, int ncz, char *buf, int64_t cap) {
    char *p = buf;
    char *end = buf + cap;
    for (int i = 0; i < ncx; i++) {
        for (int j = 0; j < ncx; j++) {
            for (int k = 0; k < ncz; k++) {
                if (end - p < 80) return -1;  // 3 ints, 2 uint64, 9 chars
                int64_t v = (int64_t)i * ncx * ncz + (int64_t)j * ncz + k;
                p = put_u64(p, (uint64_t)i);
                *p++ = ',';
                *p++ = ' ';
                p = put_u64(p, (uint64_t)j);
                *p++ = ',';
                *p++ = ' ';
                p = put_u64(p, (uint64_t)k);
                *p++ = ',';
                *p++ = ' ';
                p = put_u64(p, density[v]);
                *p++ = ',';
                *p++ = ' ';
                p = put_u64(p, mobility[v]);
                *p++ = '\n';
            }
        }
    }
    return p - buf;
}

// Position row: "%0.3f," per value and a newline (SMC.c:162-164).
int64_t format_positions_row(const double *r, int64_t n3, char *buf,
                             int64_t cap) {
    char *p = buf;
    char *end = buf + cap;
    for (int64_t i = 0; i < n3; i++) {
        const double v = r[i];
        const double t = v * 1000.0;
        const double q = std::rint(t);
        if (std::fabs(t) < 2147483648.0
                && std::fabs(std::fabs(t - q) - 0.5) >= 1e-6) {
            if (end - p < 24) return -1;
            const uint64_t a = (uint64_t)std::fabs(q);
            if (std::signbit(v)) *p++ = '-';  // "-0.000" keeps its sign
            p = put_u64(p, a / 1000);
            const unsigned f = (unsigned)(a % 1000);
            *p++ = '.';
            *p++ = (char)('0' + f / 100);
            *p++ = (char)('0' + f / 10 % 10);
            *p++ = (char)('0' + f % 10);
            *p++ = ',';
        } else {
            int w = snprintf(p, end - p, "%0.3f,", v);
            if (w < 0 || w >= end - p) return -1;
            p += w;
        }
    }
    if (end - p < 1) return -1;
    *p++ = '\n';
    return p - buf;
}

// last_state row: "%0.12f," per value (main.c:169-170).
int64_t format_last_state(const double *r, int64_t n3, char *buf,
                          int64_t cap) {
    char *p = buf;
    char *end = buf + cap;
    for (int64_t i = 0; i < n3; i++) {
        int w = snprintf(p, end - p, "%0.12f,", r[i]);
        if (w < 0 || w >= end - p) return -1;
        p += w;
    }
    return p - buf;
}

// ----------------------------------------------------------------------
// glibc rand() (TYPE_3: degree 31, separation 3), the algorithm of
// tpu_smc_torch.rng.GlibcRandom: r[i] = r[i-31] + r[i-3] mod 2^32 after
// the 16807 LCG scramble and 310 discarded outputs, output >> 1.
// ----------------------------------------------------------------------

struct GlibcRng {
    uint32_t ring[31];
    int idx;  // position of the oldest element
};

static_assert(sizeof(GlibcRng) == 128, "layout");

void glibc_srand(GlibcRng *st, uint32_t seed) {
    if (seed == 0) seed = 1;
    int64_t r[344];
    r[0] = seed;
    for (int i = 1; i < 31; i++) {
        const int64_t hi = r[i - 1] / 127773;
        const int64_t lo = r[i - 1] % 127773;
        int64_t word = 16807 * lo - 2836 * hi;
        if (word < 0) word += 2147483647;
        r[i] = word;
    }
    for (int i = 31; i < 34; i++) r[i] = r[i - 31];
    for (int i = 34; i < 344; i++)
        r[i] = (uint32_t)((uint64_t)r[i - 31] + (uint64_t)r[i - 3]);
    for (int i = 0; i < 31; i++) st->ring[i] = (uint32_t)r[313 + i];
    st->idx = 0;
}

static inline uint32_t glibc_next(GlibcRng *st) {
    // ring[idx] is r[t-31]; r[t-3] is 28 ahead of it
    const uint32_t val = st->ring[st->idx] + st->ring[(st->idx + 28) % 31];
    st->ring[st->idx] = val;
    st->idx = (st->idx + 1) % 31;
    return val >> 1;
}

uint32_t glibc_rand(GlibcRng *st) { return glibc_next(st); }

void glibc_rand_fill(GlibcRng *st, uint32_t *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = glibc_next(st);
}

// vecBoxMuller (matematicose.c:183-193): pairs from rand()/(RAND_MAX+1),
// loop bound length/2 in integer arithmetic; the odd tail stays 0.0 (the
// reference's fresh allocation in practice).
void glibc_box_muller(GlibcRng *st, double sigma, int64_t length,
                      double *out) {
    const double denom = 2147483648.0;  // RAND_MAX + 1
    const int64_t iters = length / 2;
    for (int64_t i = 0; i < iters; i++) {
        const double x1 = glibc_next(st) / denom;
        const double x2 = glibc_next(st) / denom;
        out[2 * i] = sigma * std::sqrt(-2.0 * std::log(1.0 - x1))
                     * std::cos(2.0 * M_PI * x2);
        out[2 * i + 1] = sigma * std::sqrt(-2.0 * std::log(1.0 - x2))
                         * std::sin(2.0 * M_PI * x1);
    }
    if (length % 2) out[length - 1] = 0.0;
}

// ----------------------------------------------------------------------
// Reference-semantics CNA oracle (the aliased triangular index of
// SMC.c:971-1045): per pair (l, i < l) at index (l^2 - 3l + 2)/2 + i,
// [bonded, common neighbours, bonds among them (at most 64 recorded)].
// ----------------------------------------------------------------------

void cluster_analysis_ref(const double *r, int n, double box_l,
                          double cutoff, int32_t *lca /* [(n*n-n)/2 * 3] */) {
    const int64_t p = ((int64_t)n * n - n) / 2;
    std::vector<char> num1(p, 0);
    std::vector<int32_t> num2(p, 0), num3(p, 0);
    int64_t common_nn[64];
    const double cut2 = cutoff * cutoff;

    auto idx_raw = [](int64_t l, int64_t i) {
        return (l * l - 3 * l + 2) / 2 + i;
    };

    for (int l = 1; l < n; l++) {
        for (int i = 0; i < l; i++) {
            double dx = r[3 * l] - r[3 * i];
            dx -= box_l * std::rint(dx / box_l);
            double dy = r[3 * l + 1] - r[3 * i + 1];
            dy -= box_l * std::rint(dy / box_l);
            const double dz = r[3 * l + 2] - r[3 * i + 2];
            if (dx * dx + dy * dy + dz * dz < cut2) num1[idx_raw(l, i)] = 1;
        }
    }
    for (int l = 1; l < n; l++) {
        for (int i = 0; i < l; i++) {
            const int64_t idx = idx_raw(l, i);
            if (!num1[idx]) continue;
            for (int i2 = 0; i2 < l; i2++) {
                if (i2 == i) continue;
                const int64_t idx2 = idx - i + i2;
                const int64_t idx3 = ((int64_t)i2 * i2 - 3 * i2 + 2) / 2 + i;
                if (num1[idx2] && num1[idx3]) {
                    if (num2[idx] < 64) common_nn[num2[idx]] = i2;
                    num2[idx]++;
                }
            }
            if (num2[idx] > 1) {
                const int cnt = num2[idx] < 64 ? num2[idx] : 64;
                for (int m = 1; m < cnt; m++) {
                    const int64_t c = common_nn[m];
                    const int64_t idx2 =
                        (c * c - 3 * c + 2) / 2 + common_nn[m - 1];
                    if (num1[idx2]) num3[idx]++;
                }
            }
        }
    }
    for (int64_t q = 0; q < p; q++) {
        lca[3 * q] = num1[q] ? 1 : 0;
        lca[3 * q + 1] = num2[q];
        lca[3 * q + 2] = num3[q];
    }
}

}  // extern "C"
