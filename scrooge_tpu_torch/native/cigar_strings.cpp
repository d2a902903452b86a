// CIGAR strings and flat run lists from compacted packed runs.
//
// The port's copy of the functions of scrooge_tpu/native/cigar_strings.cpp
// that it calls. Runs are uint16 op << 12 | count, op in
// {0:'=', 1:'X', 2:'I', 3:'D'}, or uint8 op << 6 | count where tb_limit
// <= 63 bounds every count (ops/compact.py:compact_entries_u8), in a
// (cap, B) buffer with entry g of lane b at entries[g * B + b] (the layout
// ops/compact.py:compact_entries makes). This is host post-processing, the
// role of cigarlist_to_cigar in the reference (genasm_gpu.cu:881-888), and
// of get_alignment_score (cpu_baseline.cpp:694-725) for affine_scores.
//
// Built as a plain shared library and bound with ctypes (native/__init__.py).

#include <cstdint>

static const char OPS[4] = {'=', 'X', 'I', 'D'};

// A run of either layout: T is uint16_t (op << 12 | count) or uint8_t
// (op << 6 | count, count <= 63, where tb_limit <= 63: half the readback).
template <typename T>
struct Run {
    static constexpr int SHIFT = sizeof(T) == 1 ? 6 : 12;
    static uint32_t count(T e) { return e & ((1u << SHIFT) - 1); }
    static int op(T e) { return (e >> SHIFT) & 3; }
};

// out: B rows of out_stride chars; out_lens[b] = chars written for lane b.
// Returns 0 on success, -1 if any lane would overflow out_stride.
template <typename T>
static int format_runs(const T* entries, int64_t cap, int64_t B,
                       const int32_t* totals, char* out, int64_t out_stride,
                       int32_t* out_lens) {
    int rc = 0;
    for (int64_t b = 0; b < B; b++) {
        char* dst = out + b * out_stride;
        char* p = dst;
        char* end = dst + out_stride;
        int64_t t = totals[b];
        if (t > cap) t = cap;
        for (int64_t g = 0; g < t; g++) {
            T e = entries[g * B + b];
            uint32_t count = Run<T>::count(e);
            char op = OPS[Run<T>::op(e)];
            char digits[8];  // count <= 4095: at most 4 digits
            int nd = 0;
            if (count == 0) digits[nd++] = '0';
            while (count > 0) { digits[nd++] = (char)('0' + count % 10); count /= 10; }
            if (p + nd + 1 > end) { rc = -1; break; }
            while (nd > 0) *p++ = digits[--nd];
            *p++ = op;
        }
        out_lens[b] = (int32_t)(p - dst);
    }
    return rc;
}

// Lane-major extraction into one flat stream of uint16 runs: lane b's
// valid runs land contiguously at out[offs[b]..] (the return_packed
// layout), a uint8 run widened in the same strided walk.
template <typename T>
static void extract(const T* entries, int64_t cap, int64_t B,
                    const int32_t* totals, const int64_t* offs,
                    uint16_t* out) {
    for (int64_t b = 0; b < B; b++) {
        int64_t t = totals[b];
        if (t > cap) t = cap;
        uint16_t* dst = out + offs[b];
        const T* src = entries + b;
        for (int64_t g = 0; g < t; g++) {
            T e = src[g * B];
            dst[g] = (uint16_t)((Run<T>::op(e) << 12) | Run<T>::count(e));
        }
    }
}

extern "C" {

int format_cigars(const uint16_t* entries, int64_t cap, int64_t B,
                  const int32_t* totals, char* out, int64_t out_stride,
                  int32_t* out_lens) {
    return format_runs(entries, cap, B, totals, out, out_stride, out_lens);
}

int format_cigars8(const uint8_t* entries, int64_t cap, int64_t B,
                   const int32_t* totals, char* out, int64_t out_stride,
                   int32_t* out_lens) {
    return format_runs(entries, cap, B, totals, out, out_stride, out_lens);
}

void extract_runs(const uint16_t* entries, int64_t cap, int64_t B,
                  const int32_t* totals, const int64_t* offs,
                  uint16_t* out) {
    extract(entries, cap, B, totals, offs, out);
}

void extract_runs8(const uint8_t* entries, int64_t cap, int64_t B,
                   const int32_t* totals, const int64_t* offs,
                   uint16_t* out) {
    extract(entries, cap, B, totals, offs, out);
}

// Affine-gap score of each lane's uint16 runs: a match adds match a base,
// a mismatch subtracts mismatch a base, a gap run subtracts gap_open +
// gap_extend a base.
void affine_scores(const uint16_t* entries, int64_t cap, int64_t B,
                   const int32_t* totals, int32_t match, int32_t mismatch,
                   int32_t gap_open, int32_t gap_extend, int64_t* out) {
    for (int64_t b = 0; b < B; b++) {
        int64_t score = 0;
        int64_t t = totals[b];
        if (t > cap) t = cap;
        for (int64_t g = 0; g < t; g++) {
            uint16_t e = entries[g * B + b];
            int32_t count = Run<uint16_t>::count(e);
            switch (Run<uint16_t>::op(e)) {
                case 0: score += (int64_t)match * count; break;
                case 1: score -= (int64_t)mismatch * count; break;
                default: score -= gap_open + (int64_t)gap_extend * count;
            }
        }
        out[b] = score;
    }
}

}  // extern "C"
