// CPython extension: read encoding and CIGAR-token decoding on the host.
//
// The port's copy of the three functions of scrooge_tpu/native/scroogext.cpp
// that it calls:
// - encode_pack_into: ASCII reads straight out of the CPython str objects
//   (1-byte kind, no copies) to 2-bit codes, 16 per uint32 word, char k of
//   a word in bits [2k, 2k+2), with a SWAR/BMI2 inner loop;
// - format_tokens / tokens_to_runs: the device's CIGAR token stream (format
//   in ops/tokens.py) to CIGAR strings, built directly as PyUnicode
//   objects, or to flat packed uint16 runs.
//
// Roles in the reference: ascii_to_zero_based_string
// (genasm_cpu.cpp:462-493), the TwoBitArray packers (genasm_gpu.cu:640-685)
// and cigarlist_to_cigar (genasm_gpu.cu:881-888).
//
// Built with g++ against the Python headers and loaded with importlib
// (native/__init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint64_t M01 = 0x0101010101010101ULL;
constexpr uint64_t M80 = 0x8080808080808080ULL;
constexpr uint64_t M03 = 0x0303030303030303ULL;
constexpr uint64_t M20 = 0x2020202020202020ULL;

// per-byte equals-c detector: 0x80 set in every byte == c
static inline uint64_t eq_bytes(uint64_t x, uint8_t c) {
    uint64_t v = x ^ (M01 * c);
    return (v - M01) & ~v & M80;
}

// 8 ASCII bases -> 8 2-bit codes in the low bits of each byte:
// (c >> 1) & 3 maps A->0 C->1 G->3 T->2 in either case; x ^= (x >> 1) & 1
// per byte swaps 2 and 3 to the canonical A0 C1 G2 T3.
static inline uint64_t codes8(uint64_t w) {
    uint64_t x = (w >> 1) & M03;
    return x ^ ((x >> 1) & M01);
}

// every byte, lowercased, must be one of acgt
static inline bool valid8(uint64_t w) {
    uint64_t v = w | M20;
    uint64_t ok = eq_bytes(v, 'a') | eq_bytes(v, 'c') | eq_bytes(v, 'g') |
                  eq_bytes(v, 't');
    return ok == M80;
}

static inline uint16_t pack8(uint64_t codes) {
#if defined(__BMI2__)
    return (uint16_t)_pext_u64(codes, M03);
#else
    uint16_t out = 0;
    for (int k = 0; k < 8; k++)
        out |= (uint16_t)(((codes >> (8 * k)) & 3) << (2 * k));
    return out;
#endif
}

// Built once, under the C++11 guarantee that a function-local static is
// initialized by one thread while the others wait: shards of a mesh pack
// their reads on threads of their own, with the GIL released.
static const uint8_t* encode_lut() {
    static const std::array<uint8_t, 256> lut = [] {
        std::array<uint8_t, 256> t;
        t.fill(0xFF);
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
        return t;
    }();
    return lut.data();
}

// One row: n ASCII bytes -> ceil(n/16) uint32 words, the rest of the Pw
// words zero-filled. Returns -1 on success or the index of the first
// invalid byte.
static int64_t encode_pack_row(const uint8_t* src, int64_t n, uint32_t* dst,
                               int64_t Pw) {
    const uint8_t* lut = encode_lut();
    int64_t nw = (n + 15) / 16;
    if (nw > Pw) nw = Pw;
    int64_t w = 0;
    for (; w + 1 <= nw && (w + 1) * 16 <= n; w++) {
        uint64_t a, b;
        memcpy(&a, src + w * 16, 8);
        memcpy(&b, src + w * 16 + 8, 8);
        if (!(valid8(a) && valid8(b))) {
            for (int64_t k = w * 16; k < n; k++)
                if (lut[src[k]] == 0xFF) return k;
        }
        dst[w] = (uint32_t)pack8(codes8(a)) |
                 ((uint32_t)pack8(codes8(b)) << 16);
    }
    for (; w < nw; w++) {  // tail word, scalar
        uint32_t acc = 0;
        int64_t base = w * 16;
        int64_t hi = n - base < 16 ? n - base : 16;
        for (int64_t k = 0; k < hi; k++) {
            uint8_t code = lut[src[base + k]];
            if (code == 0xFF) return base + k;
            acc |= (uint32_t)code << (2 * k);
        }
        dst[w] = acc;
    }
    for (; w < Pw; w++) dst[w] = 0;
    return -1;
}

struct RowView {
    const uint8_t* data;
    int64_t len;
};

// 1-byte str buffers of a sequence of str. Returns 0, or -1 with a Python
// error set: a wide str necessarily holds a non-ACGT codepoint.
static int collect_rows(PyObject* seqs, std::vector<RowView>& rows) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seqs);
    rows.resize((size_t)n);
    PyObject** items = PySequence_Fast_ITEMS(seqs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* s = items[i];
        if (!PyUnicode_Check(s)) {
            PyErr_SetString(PyExc_TypeError, "sequences must be str");
            return -1;
        }
        if (PyUnicode_KIND(s) != PyUnicode_1BYTE_KIND) {
            // report the FIRST invalid char, which may be an ASCII one
            const void* data = PyUnicode_DATA(s);
            int kind = PyUnicode_KIND(s);
            Py_ssize_t len = PyUnicode_GET_LENGTH(s);
            const uint8_t* lut = encode_lut();
            for (Py_ssize_t k = 0; k < len; k++) {
                Py_UCS4 ch = PyUnicode_READ(kind, data, k);
                if (ch >= 256 || lut[ch] == 0xFF) {
                    PyObject* c = PyUnicode_FromOrdinal(ch);
                    PyErr_Format(PyExc_ValueError,
                                 "non-ACGT character in sequence: %R", c);
                    Py_XDECREF(c);
                    return -1;
                }
            }
            PyErr_SetString(PyExc_ValueError,
                            "non-ACGT character in sequence");
            return -1;
        }
        rows[(size_t)i].data = PyUnicode_1BYTE_DATA(s);
        rows[(size_t)i].len = (int64_t)PyUnicode_GET_LENGTH(s);
    }
    return 0;
}

// encode_pack_into(seqs: Sequence[str], Pw: int, out_addr: int) -> None
// out: rows x Pw uint32, allocated by the caller. ValueError on non-ACGT.
static PyObject* encode_pack_into(PyObject*, PyObject* args) {
    PyObject* seqs_obj;
    Py_ssize_t Pw;
    unsigned long long out_addr;
    if (!PyArg_ParseTuple(args, "OnK", &seqs_obj, &Pw, &out_addr))
        return nullptr;
    PyObject* fast = PySequence_Fast(seqs_obj, "seqs must be a sequence");
    if (!fast) return nullptr;
    std::vector<RowView> rows;
    if (collect_rows(fast, rows) != 0) {
        Py_DECREF(fast);
        return nullptr;
    }
    uint32_t* out = (uint32_t*)(uintptr_t)out_addr;
    int64_t bad_row = -1, bad_pos = -1;
    Py_BEGIN_ALLOW_THREADS  // the str buffers stay valid: `fast` holds refs
    for (size_t r = 0; r < rows.size(); r++) {
        int64_t bp = encode_pack_row(rows[r].data, rows[r].len,
                                     out + (int64_t)r * Pw, Pw);
        if (bp >= 0) {
            bad_row = (int64_t)r;
            bad_pos = bp;
            break;
        }
    }
    Py_END_ALLOW_THREADS
    if (bad_row >= 0) {
        PyObject* ch = PyUnicode_FromOrdinal(rows[(size_t)bad_row].data[bad_pos]);
        PyErr_Format(PyExc_ValueError, "non-ACGT character in sequence: %R", ch);
        Py_XDECREF(ch);
        Py_DECREF(fast);
        return nullptr;
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// CIGAR token stream (ops/tokens.py): one uint8 per token, tag = tok >> 5,
// val = tok & 31:
//   tag 0: a bare '='-run of length val (1..31)
//   tag 1/2/3 (X/I/D): an edit of that op, preceded by an '='-run of
//          length val (0..31; 0 = no preceding '=' run)
//   tag 4: extend the immediately preceding edit run by val (1..31)

static const char OPS[5] = {'=', 'X', 'I', 'D', '?'};

// Calls emit(op, count) for each run of one lane; toks points at the
// lane's first token (tokens are lane-major and contiguous).
template <typename Emit>
static inline void decode_lane(const uint8_t* toks, int64_t capT,
                               int64_t t, Emit&& emit) {
    if (t > capT) t = capT;
    int pend_op = -1;
    uint32_t pend_cnt = 0;
    for (int64_t g = 0; g < t; g++) {
        uint8_t tok = toks[g];
        uint32_t tag = tok >> 5, val = tok & 31;
        if (tag == 4) {
            pend_cnt += val;
            continue;
        }
        if (pend_op >= 0) {
            emit(pend_op, pend_cnt);
            pend_op = -1;
        }
        if (tag == 0) {
            emit(0, val);
        } else {
            if (val) emit(0, val);
            pend_op = (int)tag;
            pend_cnt = 1;
        }
    }
    if (pend_op >= 0) emit(pend_op, pend_cnt);
}

// format_tokens(tok_addr, capT, B, totals_addr) -> list[str]
// tokens: (B, capT) uint8 lane-major; totals: (B,) int32. Lanes are
// decoded a chunk at a time into one buffer with the GIL released, so the
// shard threads of a mesh format at once; only the str objects are made
// under the GIL. A chunk's buffer stays in cache.
static PyObject* format_tokens(PyObject*, PyObject* args) {
    constexpr Py_ssize_t CHUNK = 256;
    unsigned long long tok_addr, totals_addr;
    Py_ssize_t capT, B;
    if (!PyArg_ParseTuple(args, "KnnK", &tok_addr, &capT, &B, &totals_addr))
        return nullptr;
    const uint8_t* toks = (const uint8_t*)(uintptr_t)tok_addr;
    const int32_t* totals = (const int32_t*)(uintptr_t)totals_addr;
    PyObject* out = PyList_New(B);
    if (!out) return nullptr;
    std::vector<char> buf;
    size_t offs[CHUNK + 1];
    for (Py_ssize_t b0 = 0; b0 < B; b0 += CHUNK) {
        const Py_ssize_t n = std::min(CHUNK, B - b0);
        Py_BEGIN_ALLOW_THREADS
        buf.clear();
        for (Py_ssize_t k = 0; k < n; k++) {
            offs[k] = buf.size();
            decode_lane(toks + (b0 + k) * capT, capT, totals[b0 + k],
                        [&](int op, uint32_t cnt) {
                char digits[8];
                int nd = 0;
                if (cnt == 0) digits[nd++] = '0';
                while (cnt > 0) {
                    digits[nd++] = (char)('0' + cnt % 10);
                    cnt /= 10;
                }
                while (nd > 0) buf.push_back(digits[--nd]);
                buf.push_back(OPS[op]);
            });
        }
        offs[n] = buf.size();
        Py_END_ALLOW_THREADS
        for (Py_ssize_t k = 0; k < n; k++) {
            PyObject* s = PyUnicode_FromStringAndSize(
                buf.data() + offs[k], (Py_ssize_t)(offs[k + 1] - offs[k]));
            if (!s) {
                Py_DECREF(out);
                return nullptr;
            }
            PyList_SET_ITEM(out, b0 + k, s);
        }
    }
    return out;
}

// tokens_to_runs(tok_addr, capT, B, totals_addr, out_addr, counts_addr)
//   -> total_runs
// Packed uint16 runs (op << 12 | count), lane-contiguous in lane order.
// out holds >= 2 * sum(totals) entries (a token expands to at most 2
// runs); counts: (B,) int64 runs per lane.
static PyObject* tokens_to_runs(PyObject*, PyObject* args) {
    unsigned long long tok_addr, totals_addr, out_addr, counts_addr;
    Py_ssize_t capT, B;
    if (!PyArg_ParseTuple(args, "KnnKKK", &tok_addr, &capT, &B, &totals_addr,
                          &out_addr, &counts_addr))
        return nullptr;
    const uint8_t* toks = (const uint8_t*)(uintptr_t)tok_addr;
    const int32_t* totals = (const int32_t*)(uintptr_t)totals_addr;
    uint16_t* out = (uint16_t*)(uintptr_t)out_addr;
    int64_t* counts = (int64_t*)(uintptr_t)counts_addr;
    int64_t pos = 0;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t b = 0; b < B; b++) {
        int64_t start = pos;
        decode_lane(toks + b * capT, capT, totals[b],
                    [&](int op, uint32_t cnt) {
            out[pos++] = (uint16_t)(((uint32_t)op << 12) | (cnt & 0x0FFF));
        });
        counts[b] = pos - start;
    }
    Py_END_ALLOW_THREADS
    return PyLong_FromLongLong((long long)pos);
}

static PyMethodDef Methods[] = {
    {"encode_pack_into", encode_pack_into, METH_VARARGS,
     "ASCII -> 2-bit uint32-word rows straight from str objects."},
    {"format_tokens", format_tokens, METH_VARARGS,
     "CIGAR token stream (B, capT) -> list of CIGAR strings."},
    {"tokens_to_runs", tokens_to_runs, METH_VARARGS,
     "CIGAR token stream -> flat packed uint16 runs + per-lane counts."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT, "_scrooge_torch_ext",
                                    "scrooge_tpu_torch native host helpers",
                                    -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__scrooge_torch_ext(void) { return PyModule_Create(&Module); }
