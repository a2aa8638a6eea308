// ddnative — native host runtime for decompdiff_tpu_torch.
//
// The host hot paths of the port — batch padding/collation feeding the
// device loop, fixed-column PDB atom parsing, and covalent-radius bond
// perception — behind a plain C ABI consumed via ctypes
// (decompdiff_tpu_torch/native.py, whose numpy plain versions live in
// native_plain.py). A copy of decompdiff_tpu/native/ddnative.cpp; only
// this comment differs.
//
// Build (ops/_build.py, at first use, into build/ddnative-<hash>.so):
//   g++ -O3 -shared -fPIC -std=c++17 ddnative.cpp -o ddnative.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Padded collation: scatter per-sample ragged arrays into a padded batch.
// Sources are given as one contiguous concatenated buffer plus offsets.
// ---------------------------------------------------------------------------

// float32 features: concat [sum(n_i), F] -> out [B, N_pad, F]
void pad_f32(const float* src, const int64_t* counts, int64_t batch,
             int64_t n_pad, int64_t feat, float* out) {
    int64_t src_off = 0;
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = counts[b];
        std::memcpy(out + b * n_pad * feat, src + src_off * feat,
                    sizeof(float) * n * feat);
        src_off += n;
    }
}

// int32 features
void pad_i32(const int32_t* src, const int64_t* counts, int64_t batch,
             int64_t n_pad, int64_t feat, int32_t* out) {
    int64_t src_off = 0;
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = counts[b];
        std::memcpy(out + b * n_pad * feat, src + src_off * feat,
                    sizeof(int32_t) * n * feat);
        src_off += n;
    }
}

// boolean length masks: out [B, N_pad] with first counts[b] entries true
void length_mask(const int64_t* counts, int64_t batch, int64_t n_pad,
                 uint8_t* out) {
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = counts[b];
        std::memset(out + b * n_pad, 1, n);
        std::memset(out + b * n_pad + n, 0, n_pad - n);
    }
}

// dense square int32 matrices (bond tables): concat blocks -> [B, N_pad, N_pad]
void pad_square_i32(const int32_t* src, const int64_t* counts, int64_t batch,
                    int64_t n_pad, int32_t* out) {
    int64_t src_off = 0;
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = counts[b];
        int32_t* dst = out + b * n_pad * n_pad;
        for (int64_t i = 0; i < n; ++i) {
            std::memcpy(dst + i * n_pad, src + src_off + i * n,
                        sizeof(int32_t) * n);
        }
        src_off += n * n;
    }
}

// fc bond mask: [B, N_pad, N_pad], true where i != j and both < counts[b]
void bond_mask(const int64_t* counts, int64_t batch, int64_t n_pad,
               uint8_t* out) {
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = counts[b];
        uint8_t* dst = out + b * n_pad * n_pad;
        std::memset(dst, 0, n_pad * n_pad);
        for (int64_t i = 0; i < n; ++i) {
            std::memset(dst + i * n_pad, 1, n);
            dst[i * n_pad + i] = 0;
        }
    }
}

// ---------------------------------------------------------------------------
// Fixed-column PDB ATOM parsing (role: ref utils/data.py:89-115).
// Input: raw text buffer. Output arrays are caller-allocated with capacity
// max_atoms. Returns number of atoms parsed, or -1 on overflow.
// serial [n], pos [n,3], res_id [n]; names/resnames/elements as fixed-width
// char arrays (4, 3, 2 bytes per atom).
// ---------------------------------------------------------------------------

static inline float parse_f(const char* s, int len) {
    char buf[16];
    int m = len < 15 ? len : 15;
    std::memcpy(buf, s, m);
    buf[m] = 0;
    return std::strtof(buf, nullptr);
}

static inline int parse_i(const char* s, int len) {
    char buf[16];
    int m = len < 15 ? len : 15;
    std::memcpy(buf, s, m);
    buf[m] = 0;
    return std::atoi(buf);
}

int64_t parse_pdb_atoms(const char* text, int64_t text_len, int64_t max_atoms,
                        int32_t* serial, float* pos, int32_t* res_id,
                        char* atom_name, char* res_name, char* chain,
                        char* insert_id, char* element, char* segment,
                        int64_t* line_off, int32_t* line_len) {
    int64_t n = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', end - p));
        int64_t len = nl ? (nl - p) : (end - p);
        if (len > 0 && p[len - 1] == '\r') --len;  // CRLF, like splitlines()
        if (len >= 6 && std::strncmp(p, "ATOM", 4) == 0 &&
            (p[4] == ' ' || p[5] == ' ')) {
            if (len < 54) { p = nl ? nl + 1 : end; continue; }
            if (n >= max_atoms) return -1;
            serial[n] = parse_i(p + 6, 5);
            std::memcpy(atom_name + n * 4, p + 12, 4);
            std::memcpy(res_name + n * 3, p + 17, 3);
            chain[n] = p[21];
            res_id[n] = parse_i(p + 22, 4);
            insert_id[n] = p[26];
            pos[n * 3 + 0] = parse_f(p + 30, 8);
            pos[n * 3 + 1] = parse_f(p + 38, 8);
            pos[n * 3 + 2] = parse_f(p + 46, 8);
            if (len >= 78 && (p[76] != ' ' || p[77] != ' ')) {
                element[n * 2] = p[76];
                element[n * 2 + 1] = p[77];
            } else {
                // blank/absent element columns: same fallback as the python
                // parser (protein.py: line[13:14])
                element[n * 2] = ' ';
                element[n * 2 + 1] = p[13];
            }
            if (len >= 76) {
                std::memcpy(segment + n * 4, p + 72, 4);
            } else {
                std::memset(segment + n * 4, ' ', 4);
            }
            line_off[n] = p - text;
            line_len[n] = static_cast<int32_t>(len);
            ++n;
        } else if (len >= 6 && std::strncmp(p, "ENDMDL", 6) == 0) {
            break;
        }
        p = nl ? nl + 1 : end;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Covalent-radius bond perception (role: ref utils/reconstruct.py:76-193
// connect_the_dots). O(n^2) over atom pairs; returns bond count.
// ---------------------------------------------------------------------------

int64_t perceive_bonds(const double* pos, const double* radii, int64_t n,
                       double stretch, double min_d, int64_t max_bonds,
                       int32_t* bond_src, int32_t* bond_dst) {
    // double throughout: the numpy fallback computes f64 norms against f64
    // thresholds, and borderline covalent-cutoff pairs must not differ
    // between hosts with and without the compiled library
    int64_t m = 0;
    const double min_d2 = min_d * min_d;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i + 1; j < n; ++j) {
            const double dx = pos[i * 3] - pos[j * 3];
            const double dy = pos[i * 3 + 1] - pos[j * 3 + 1];
            const double dz = pos[i * 3 + 2] - pos[j * 3 + 2];
            const double d2 = dx * dx + dy * dy + dz * dz;
            const double cut = (radii[i] + radii[j]) * stretch;
            // lower bound inclusive: min_d=0 must admit coincident atoms,
            // matching the numpy candidate stage in ligan.connect_the_dots
            if (d2 < cut * cut && d2 >= min_d2) {
                if (m >= max_bonds) return -1;
                bond_src[m] = static_cast<int32_t>(i);
                bond_dst[m] = static_cast<int32_t>(j);
                ++m;
            }
        }
    }
    return m;
}

}  // extern "C"
