// Copy of masp_tpu/native/lc_eval.cpp, verbatim; the port builds it with g++ at first use and imports
// nothing of masp_tpu.
// Native R1CS linear-combination evaluation over the BLS12-381 scalar field.
//
// Replaces the prover's hottest host loop (per-constraint a/b/c evaluation,
// bellperson does this with rayon; SURVEY.md §3.1) with fixed-width 4x64-bit
// arithmetic: products accumulate into a 512-bit accumulator per row, reduced
// mod r by 2^256-folding. Exposed via a C ABI for ctypes.
//
// Build: see masp_tpu/native/build.py (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cstdlib>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// BLS12-381 scalar field modulus r (little-endian limbs)
static const u64 R_LIMBS[4] = {
    0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
    0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL,
};
// 2^256 mod r (little-endian limbs)
static const u64 T256_LIMBS[4] = {
    0x00000001fffffffeULL, 0x5884b7fa00034802ULL,
    0x998c4fefecbc4ff5ULL, 0x1824b159acc5056fULL,
};

struct U256 { u64 l[4]; };
struct U512 { u64 l[8]; };

static inline void mul_256x256(const u64 a[4], const u64 b[4], U512* out) {
    u64 r[8] = {0};
    for (int i = 0; i < 4; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a[i] * b[j] + r[i + j] + carry;
            r[i + j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        r[i + 4] += carry;
    }
    std::memcpy(out->l, r, sizeof(r));
}

static inline void add_512(U512* acc, const U512* x) {
    u128 carry = 0;
    for (int i = 0; i < 8; i++) {
        u128 cur = (u128)acc->l[i] + x->l[i] + (u64)carry;
        acc->l[i] = (u64)cur;
        carry = cur >> 64;
    }
    // accumulators never overflow 512 bits for < 2^128 terms of 510-bit
    // products with 2-bit headroom; rows are far shorter than that
}

static inline int ge_256(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline void sub_256(u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] - b[i] - (u64)borrow;
        a[i] = (u64)cur;
        borrow = (cur >> 64) & 1;
    }
}

// reduce a 512-bit accumulator mod r: fold hi via hi * (2^256 mod r) + lo
// until the high half vanishes, then conditional subtracts.
static void reduce_512(const U512* t, u64 out[4]) {
    u64 lo[4], hi[4];
    std::memcpy(lo, t->l, 32);
    std::memcpy(hi, t->l + 4, 32);
    while (hi[0] | hi[1] | hi[2] | hi[3]) {
        U512 folded;
        mul_256x256(hi, T256_LIMBS, &folded);
        // folded (512) + lo (256)
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 cur = (u128)folded.l[i] + lo[i] + (u64)carry;
            folded.l[i] = (u64)cur;
            carry = cur >> 64;
        }
        for (int i = 4; i < 8 && carry; i++) {
            u128 cur = (u128)folded.l[i] + (u64)carry;
            folded.l[i] = (u64)cur;
            carry = cur >> 64;
        }
        std::memcpy(lo, folded.l, 32);
        std::memcpy(hi, folded.l + 4, 32);
    }
    while (ge_256(lo, R_LIMBS)) sub_256(lo, R_LIMBS);
    std::memcpy(out, lo, 32);
}

extern "C" {

// rows in CSR form:
//   indptr:   (num_rows + 1) int64
//   var_idx:  (nnz) int64 — flat index into `assignment`
//   coeffs:   (nnz * 4) u64 — little-endian 4-limb field elements
//   assignment: (num_vars * 4) u64
//   out:      (num_rows * 4) u64
static void eval_rows_range(const int64_t* indptr, const int64_t* var_idx,
                            const u64* coeffs, const u64* assignment,
                            int64_t lo, int64_t hi, u64* out) {
    for (int64_t row = lo; row < hi; row++) {
        U512 acc;
        std::memset(&acc, 0, sizeof(acc));
        for (int64_t k = indptr[row]; k < indptr[row + 1]; k++) {
            U512 prod;
            mul_256x256(coeffs + 4 * k, assignment + 4 * var_idx[k], &prod);
            add_512(&acc, &prod);
        }
        reduce_512(&acc, out + 4 * row);
    }
}

void eval_lc_rows(const int64_t* indptr, const int64_t* var_idx,
                  const u64* coeffs, const u64* assignment,
                  int64_t num_rows, u64* out) {
    // rows are independent: shard across threads (the rayon analogue of
    // bellperson's parallel evaluation). MASP_NATIVE_THREADS caps it;
    // small row counts stay single-threaded.
    int nthreads = 1;
    if (num_rows >= 4096) {
        unsigned hw = std::thread::hardware_concurrency();
        nthreads = (int)std::min<unsigned>(hw ? hw : 1, 16);
        if (const char* env = std::getenv("MASP_NATIVE_THREADS")) {
            int v = std::atoi(env);
            if (v >= 1) nthreads = std::min(v, 64);
        }
    }
    if (nthreads <= 1) {
        eval_rows_range(indptr, var_idx, coeffs, assignment, 0, num_rows, out);
        return;
    }
    std::vector<std::thread> workers;
    int64_t chunk = (num_rows + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(num_rows, lo + chunk);
        if (lo >= hi) break;
        workers.emplace_back(eval_rows_range, indptr, var_idx, coeffs,
                             assignment, lo, hi, out);
    }
    for (auto& w : workers) w.join();
}

// canonical 4x64 LE -> 16x16-bit limb arrays (uint32 lanes), Montgomery
// conversion left to the device; helper for fast encode of big batches.
void u256_to_limbs16(const u64* values, int64_t n, uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const u64* v = values + 4 * i;
        for (int j = 0; j < 16; j++) {
            out[i * 16 + j] = (uint32_t)((v[j / 4] >> (16 * (j % 4))) & 0xFFFF);
        }
    }
}

}  // extern "C"
