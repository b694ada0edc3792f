// tpu_scheduler native packing shim.
//
// C++ implementation of the Kubernetes quantity grammar and batch request
// packing — the native-code equivalent of the reference's kube_quantity
// dependency (reference: src/util.rs:17-36 uses kube_quantity::ParsedQuantity
// for all resource arithmetic).  Python's parser (api/quantity.py) stays the
// semantic oracle; this shim must agree exactly (tests/test_native_ext.py
// fuzzes them against each other) and exists to take quantity parsing off
// the host hot path when packing large snapshots.
//
// Exact integer arithmetic: value = sign * mantissa * 10^dec_exp * 2^bin_exp,
// evaluated with __int128 saturating multiplies, then ceil-divided to the
// target unit (cpu -> millicores, memory -> bytes).  Results clamp to int64;
// the tensor layer clamps further to int32 (ops/pack.py).
//
// Build: `make -C native` -> libtpusched.so, loaded via ctypes
// (tpu_scheduler/ops/native_ext.py).

#include <cstdint>
#include <cstring>
#include <cctype>

namespace {

const __int128 I128_MAX_SENTINEL = (((__int128)1) << 126);  // saturation rail
const int64_t I64_MAX = INT64_MAX;

// Saturating non-negative __int128 multiply.
static __int128 mul_sat(__int128 a, __int128 b) {
    if (a == 0 || b == 0) return 0;
    if (a >= I128_MAX_SENTINEL / b) return I128_MAX_SENTINEL;
    return a * b;
}

static __int128 pow_sat(__int128 base, int exp) {
    __int128 r = 1;
    for (int i = 0; i < exp; i++) {
        r = mul_sat(r, base);
        if (r >= I128_MAX_SENTINEL) return I128_MAX_SENTINEL;
    }
    return r;
}

struct Parsed {
    bool ok;
    bool negative;
    unsigned __int128 mantissa;  // digits with the dot removed (saturating)
    int dec_exp;                 // power of ten (fraction digits + suffix/exponent)
    int bin_exp;                 // power of two (binary SI suffixes)
    bool inexact;                // saturation dropped digits: result is approximate
};

// Python's parse_quantity does s.strip(): allow any surrounding whitespace.
static bool at_end(const char* c) {
    while (isspace((unsigned char)*c)) c++;
    return *c == '\0';
}

// Grammar: sign? digits ('.' digits?)? (suffix | [eE] sign? digits)?
// suffix: n u m k M G T P E | Ki Mi Gi Ti Pi Ei       (api/quantity.py)
static Parsed parse(const char* s) {
    Parsed p = {false, false, 0, 0, 0, false};
    if (s == nullptr) return p;
    const char* c = s;
    while (isspace((unsigned char)*c)) c++;
    if (*c == '+') c++;
    else if (*c == '-') { p.negative = true; c++; }

    bool any_digit = false;
    bool saturated = false;
    int frac_digits = 0;
    bool in_frac = false;
    for (;; c++) {
        if (*c >= '0' && *c <= '9') {
            any_digit = true;
            if (!saturated) {
                // Overflow-safe: 10*m+d wraps mod 2^128 and can land back
                // above m, so a post-hoc `next < m` test misses wraps —
                // check against the ceiling before multiplying.
                const unsigned __int128 MAX_U128 = ~(unsigned __int128)0;
                unsigned d = (unsigned)(*c - '0');
                if (p.mantissa > (MAX_U128 - d) / 10) { saturated = true; p.inexact = true; }
                else p.mantissa = p.mantissa * 10 + d;
            }
            if (saturated && !in_frac) p.dec_exp++;  // keep magnitude
            if (in_frac && !saturated) frac_digits++;
        } else if (*c == '.') {
            if (in_frac) return p;  // two dots
            in_frac = true;
        } else {
            break;
        }
    }
    if (!any_digit) return p;
    p.dec_exp -= frac_digits;

    // Suffix / exponent.
    if (at_end(c)) { p.ok = true; return p; }
    if (*c == 'e' || *c == 'E') {
        // decimalExponent — but bare "E" (exa) has no digits after it.
        const char* d = c + 1;
        bool neg = false;
        if (*d == '+') d++;
        else if (*d == '-') { neg = true; d++; }
        if (*d >= '0' && *d <= '9') {
            int e = 0;
            for (; *d >= '0' && *d <= '9'; d++) {
                if (e < 1000) e = e * 10 + (*d - '0');
            }
            if (!at_end(d)) return p;
            p.dec_exp += neg ? -e : e;
            p.ok = true;
            return p;
        }
        if (*c == 'e') return p;  // lowercase 'e' with no digits: invalid
        // fall through: capital E is the exa suffix
    }

    char s0 = *c;
    char s1 = *(c + 1);
    if (s1 == 'i' && at_end(c + 2)) {
        switch (s0) {
            case 'K': p.bin_exp = 10; break;
            case 'M': p.bin_exp = 20; break;
            case 'G': p.bin_exp = 30; break;
            case 'T': p.bin_exp = 40; break;
            case 'P': p.bin_exp = 50; break;
            case 'E': p.bin_exp = 60; break;
            default: return p;
        }
        p.ok = true;
        return p;
    }
    if (!at_end(c + 1)) return p;
    switch (s0) {
        case 'n': p.dec_exp -= 9; break;
        case 'u': p.dec_exp -= 6; break;
        case 'm': p.dec_exp -= 3; break;
        case 'k': p.dec_exp += 3; break;
        case 'M': p.dec_exp += 6; break;
        case 'G': p.dec_exp += 9; break;
        case 'T': p.dec_exp += 12; break;
        case 'P': p.dec_exp += 15; break;
        case 'E': p.dec_exp += 18; break;
        default: return p;
    }
    p.ok = true;
    return p;
}

// ceil(value * scale) clamped to int64, where scale is 10^scale_exp10.
// cpu -> millicores: scale_exp10 = 3; memory -> bytes: scale_exp10 = 0.
static bool to_int_ceil(const Parsed& p, int scale_exp10, int64_t* out, bool* inexact) {
    if (!p.ok) return false;
    if (p.inexact && inexact) *inexact = true;
    int dec = p.dec_exp + scale_exp10;
    unsigned __int128 m = p.mantissa;
    if (m > (unsigned __int128)I128_MAX_SENTINEL) m = (unsigned __int128)I128_MAX_SENTINEL;
    __int128 num = (__int128)m;
    __int128 den = 1;
    if (dec >= 0) num = mul_sat(num, pow_sat(10, dec));
    else den = pow_sat(10, -dec);
    num = mul_sat(num, pow_sat(2, p.bin_exp > 0 ? p.bin_exp : 0));
    // Any rail hit in the scaling math means digits of precision were lost;
    // equality with the rail is conservatively treated as a hit (the caller
    // re-derives the exact value through the Python oracle).
    if (inexact && (num >= I128_MAX_SENTINEL || den >= I128_MAX_SENTINEL)) *inexact = true;

    __int128 q;
    if (p.negative) {
        // math.ceil of a negative value rounds toward zero: -floor(|x|).
        q = -(num / den);
    } else {
        q = (num + den - 1) / den;
    }
    if (q > (__int128)I64_MAX) q = I64_MAX;
    if (q < -(__int128)I64_MAX) q = -I64_MAX;
    *out = (int64_t)q;
    return true;
}

}  // namespace

extern "C" {

// Modes for batch_parse.
enum { MODE_CPU_MILLIS = 0, MODE_MEM_BYTES = 1 };

// Parse one quantity; returns 1 on success.
int tpusched_parse(const char* s, int mode, int64_t* out) {
    Parsed p = parse(s);
    if (!p.ok) return 0;
    return to_int_ceil(p, mode == MODE_CPU_MILLIS ? 3 : 0, out, nullptr) ? 1 : 0;
}

// Batch parse: returns -1 on full success, else the index of the first
// invalid quantity.  `strs` is an array of NUL-terminated UTF-8 strings.
// `inexact` (nullable, [n]) is set to 1 where saturation made the result
// approximate — the Python wrapper recomputes those via the exact oracle.
int64_t tpusched_batch_parse_ex(const char** strs, int64_t n, int mode, int64_t* out, unsigned char* inexact) {
    int scale = (mode == MODE_CPU_MILLIS) ? 3 : 0;
    for (int64_t i = 0; i < n; i++) {
        bool inx = false;
        Parsed p = parse(strs[i]);
        if (!p.ok || !to_int_ceil(p, scale, &out[i], &inx)) return i;
        if (inexact) inexact[i] = inx ? 1 : 0;
    }
    return -1;
}

int64_t tpusched_batch_parse(const char** strs, int64_t n, int mode, int64_t* out) {
    return tpusched_batch_parse_ex(strs, n, mode, out, nullptr);
}

// Batch pack of pod requests: given per-pod (cpu_str, mem_str) arrays,
// produce the int32 (millicores, KiB-ceil) rows of ops/pack.py, clamped to
// int32 — the tensor-packing fast path.  Returns -1 or first bad index.
int64_t tpusched_pack_requests_ex(const char** cpu_strs, const char** mem_strs, int64_t n, int32_t* out /* [n,2] */,
                                  unsigned char* inexact /* nullable, [n] */) {
    const int64_t I32_MAX = 2147483647LL;
    for (int64_t i = 0; i < n; i++) {
        int64_t cpu = 0, mem = 0;
        bool inx = false;
        if (cpu_strs[i] != nullptr) {
            Parsed p = parse(cpu_strs[i]);
            if (!p.ok || !to_int_ceil(p, 3, &cpu, &inx)) return i;
        }
        if (mem_strs[i] != nullptr) {
            Parsed p = parse(mem_strs[i]);
            if (!p.ok || !to_int_ceil(p, 0, &mem, &inx)) return i;
        }
        if (inexact) inexact[i] = inx ? 1 : 0;
        int64_t kib = (mem >= 0) ? (mem + 1023) / 1024 : mem / 1024;
        out[i * 2] = (int32_t)(cpu > I32_MAX ? I32_MAX : (cpu < -I32_MAX ? -I32_MAX : cpu));
        out[i * 2 + 1] = (int32_t)(kib > I32_MAX ? I32_MAX : (kib < -I32_MAX ? -I32_MAX : kib));
    }
    return -1;
}

int64_t tpusched_pack_requests(const char** cpu_strs, const char** mem_strs, int64_t n, int32_t* out /* [n,2] */) {
    return tpusched_pack_requests_ex(cpu_strs, mem_strs, n, out, nullptr);
}

}  // extern "C"
