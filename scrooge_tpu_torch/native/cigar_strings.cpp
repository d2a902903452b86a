// CIGAR strings and flat run lists from compacted packed runs.
//
// The port's copy of the two functions of scrooge_tpu/native/cigar_strings.cpp
// that it calls. Runs are uint16 op << 12 | count, op in
// {0:'=', 1:'X', 2:'I', 3:'D'}, in a (cap, B) buffer with entry g of lane b
// at entries[g * B + b] (the layout ops/compact.py:compact_entries makes).
// This is host post-processing, the role of cigarlist_to_cigar in the
// reference (genasm_gpu.cu:881-888).
//
// Built as a plain shared library and bound with ctypes (native/__init__.py).

#include <cstdint>

static const char OPS[4] = {'=', 'X', 'I', 'D'};

extern "C" {

// out: B rows of out_stride chars; out_lens[b] = chars written for lane b.
// Returns 0 on success, -1 if any lane would overflow out_stride.
int format_cigars(const uint16_t* entries, int64_t cap, int64_t B,
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
            uint16_t e = entries[g * B + b];
            uint32_t count = e & 0x0FFF;
            char op = OPS[(e >> 12) & 3];
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

// Lane-major extraction into one flat stream: lane b's valid runs land
// contiguously at out[offs[b]..] (the return_packed layout).
void extract_runs(const uint16_t* entries, int64_t cap, int64_t B,
                  const int32_t* totals, const int64_t* offs,
                  uint16_t* out) {
    for (int64_t b = 0; b < B; b++) {
        int64_t t = totals[b];
        if (t > cap) t = cap;
        uint16_t* dst = out + offs[b];
        const uint16_t* src = entries + b;
        for (int64_t g = 0; g < t; g++) dst[g] = src[g * B];
    }
}

}  // extern "C"
