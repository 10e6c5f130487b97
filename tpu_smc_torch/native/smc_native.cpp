// Host CSV formatters of tpu_smc_torch (C++, loaded through ctypes): the
// three formatters of tpu_smc/native/smc_native.cpp, byte for byte the
// same output. They write the voxel ("local") rows, the position rows and
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

}  // extern "C"
