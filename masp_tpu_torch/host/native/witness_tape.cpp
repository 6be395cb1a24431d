// Copy of masp_tpu/native/witness_tape.cpp, verbatim; the port builds it with g++ at first use and imports
// nothing of masp_tpu.
// Witness-tape interpreter over the BLS12-381 scalar field.
//
// Executes the flat opcode tape recorded by masp_tpu/r1cs/tape.py —
// the native replacement for per-proof Python gadget synthesis (the
// reference does this with bellperson's rayon-parallel witness closures,
// SURVEY.md §3.1). Values are canonical (non-Montgomery) 4x64-bit
// little-endian residues; MUL reduces a 512-bit product by 2^256-folding,
// INV is a binary extended GCD.
//
// Built into libmasp_native.so alongside lc_eval.cpp.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <dlfcn.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 R_LIMBS[4] = {
    0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
    0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL,
};
static const u64 T256_LIMBS[4] = {
    0x00000001fffffffeULL, 0x5884b7fa00034802ULL,
    0x998c4fefecbc4ff5ULL, 0x1824b159acc5056fULL,
};

namespace {

struct U512 { u64 l[8]; };

inline int ge_256(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

inline int is_zero(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

inline void sub_256_in(u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] - b[i] - (u64)borrow;
        a[i] = (u64)cur;
        borrow = (cur >> 64) & 1;
    }
}

inline void mul_256x256(const u64 a[4], const u64 b[4], U512* out) {
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

void reduce_512(const U512* t, u64 out[4]) {
    u64 lo[4], hi[4];
    std::memcpy(lo, t->l, 32);
    std::memcpy(hi, t->l + 4, 32);
    while (hi[0] | hi[1] | hi[2] | hi[3]) {
        U512 folded;
        mul_256x256(hi, T256_LIMBS, &folded);
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
    while (ge_256(lo, R_LIMBS)) sub_256_in(lo, R_LIMBS);
    std::memcpy(out, lo, 32);
}

inline void add_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
    u64 t[4];
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] + b[i] + (u64)carry;
        t[i] = (u64)cur;
        carry = cur >> 64;
    }
    if (carry || ge_256(t, R_LIMBS)) sub_256_in(t, R_LIMBS);
    std::memcpy(out, t, 32);
}

inline void sub_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
    u64 t[4];
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] - b[i] - (u64)borrow;
        t[i] = (u64)cur;
        borrow = (cur >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 cur = (u128)t[i] + R_LIMBS[i] + (u64)carry;
            t[i] = (u64)cur;
            carry = cur >> 64;
        }
    }
    std::memcpy(out, t, 32);
}

inline void mul_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
    U512 p;
    mul_256x256(a, b, &p);
    reduce_512(&p, out);
}

inline void neg_mod(const u64 a[4], u64 out[4]) {
    if (is_zero(a)) {
        std::memset(out, 0, 32);
        return;
    }
    u64 t[4];
    std::memcpy(t, R_LIMBS, 32);
    sub_256_in(t, a);
    std::memcpy(out, t, 32);
}

// --- binary extended GCD inversion (values < r, r prime) -------------------

inline void shr1_256(u64 a[4]) {
    for (int i = 0; i < 3; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
    a[3] >>= 1;
}

inline int is_even(const u64 a[4]) { return (a[0] & 1) == 0; }

inline void add_256_carry(u64 a[4], const u64 b[4], u64* carry_out) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)a[i] + b[i] + (u64)carry;
        a[i] = (u64)cur;
        carry = cur >> 64;
    }
    *carry_out = (u64)carry;
}

// halve a residue mod r: if odd, add r first (may carry into bit 256)
inline void halve_mod(u64 a[4]) {
    if (is_even(a)) {
        shr1_256(a);
    } else {
        u64 carry;
        add_256_carry(a, R_LIMBS, &carry);
        shr1_256(a);
        a[3] |= carry << 63;
    }
}

int inv_mod_binary(const u64 in[4], u64 out[4]) {
    if (is_zero(in)) return 1;  // error: zero inverse
    u64 u[4], v[4], b[4], c[4];
    std::memcpy(u, in, 32);
    std::memcpy(v, R_LIMBS, 32);
    std::memset(b, 0, 32); b[0] = 1;   // b = 1
    std::memset(c, 0, 32);             // c = 0
    // invariant: b * in = u (mod r), c * in = v (mod r)
    while (!is_zero(u)) {
        while (is_even(u)) { shr1_256(u); halve_mod(b); }
        while (is_even(v)) { shr1_256(v); halve_mod(c); }
        if (ge_256(u, v)) {
            sub_256_in(u, v);
            sub_mod(b, c, b);
        } else {
            sub_256_in(v, u);
            sub_mod(c, b, c);
        }
    }
    // v == gcd == 1, c * in == 1
    std::memcpy(out, c, 32);
    return 0;
}

// --- GMP-accelerated inversion ---------------------------------------------
// The single-bit binary GCD above costs ~26 us per call; a Spend witness
// tape holds ~8k inversions (the affine divisions of the in-circuit
// Pedersen/ECC gadget witnesses), ~0.15 s/proof of host tail. libgmp's
// Lehmer-optimized mpn_gcdext is ~10x faster. No GMP headers ship in this
// image, but the mpn ABI is stable (mp_limb_t = unsigned long on LP64), so
// we dlopen libgmp.so.10 and declare the one entry point ourselves;
// everything falls back to the binary GCD when GMP is absent or
// MASP_NO_GMP=1 is set.

typedef unsigned long gmp_limb;   // 64-bit on this platform
typedef long gmp_size;
typedef gmp_size (*gcdext_fn)(gmp_limb*, gmp_limb*, gmp_size*,
                              gmp_limb*, gmp_size, gmp_limb*, gmp_size);

static gcdext_fn p_gcdext = nullptr;
static std::once_flag gmp_once;

static void load_gmp() {
    if (const char* env = std::getenv("MASP_NO_GMP")) {
        if (env[0] == '1') return;
    }
    void* h = dlopen("libgmp.so.10", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libgmp.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    p_gcdext = (gcdext_fn)dlsym(h, "__gmpn_gcdext");  // mpn_gcdext's symbol
}

int inv_mod(const u64 in[4], u64 out[4]) {
    std::call_once(gmp_once, load_gmp);
    if (!p_gcdext) return inv_mod_binary(in, out);
    if (is_zero(in)) return 1;
    // mpn_gcdext(g, s, &sn, U, un, V, vn) computes g = gcd(U, V) and the
    // cofactor s with U*s ≡ g (mod V); it requires un >= vn and clobbers
    // U/V. Use U = in + r (so un >= vn even for small inputs; the inverse
    // of in+r mod r IS the inverse of in) and V = r.
    gmp_limb up[5], vp[4], gp[5], sp[6];
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 cur = (u128)in[i] + R_LIMBS[i] + (u64)carry;
        up[i] = (gmp_limb)cur;
        carry = cur >> 64;
    }
    up[4] = (gmp_limb)carry;
    gmp_size un = up[4] ? 5 : 4;
    std::memcpy(vp, R_LIMBS, 32);
    gmp_size sn = 0;
    gmp_size gn = p_gcdext(gp, sp, &sn, up, un, vp, 4);
    if (gn != 1 || gp[0] != 1) return 1;  // in ≡ 0 mod r (r is prime)
    // |s| < r/2 (GMP guarantee: |s| <= V/2g), so it fits 4 limbs
    u64 s[4] = {0, 0, 0, 0};
    gmp_size alen = sn < 0 ? -sn : sn;
    for (gmp_size i = 0; i < alen && i < 4; i++) s[i] = sp[i];
    if (sn < 0) {
        u64 t[4];
        std::memcpy(t, R_LIMBS, 32);
        sub_256_in(t, s);
        std::memcpy(out, t, 32);
    } else {
        std::memcpy(out, s, 32);
    }
    return 0;
}

}  // namespace

extern "C" {

// execute rows [lo, hi) of the tape; regs for operand registers must
// already be computed (sequential order, or level order for the leveled
// scheduler). Returns 0 or 1 + op_index of the first failure.
static int64_t exec_rows(const int64_t* ops, const u64* consts,
                         const u64* inputs, u64* regs,
                         int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
        const int64_t op = ops[3 * i], a = ops[3 * i + 1], b = ops[3 * i + 2];
        u64* out = regs + 4 * i;
        switch (op) {
            case 0:  // CONST
                std::memcpy(out, consts + 4 * a, 32);
                break;
            case 1:  // INPUT
                std::memcpy(out, inputs + 4 * a, 32);
                break;
            case 2:  // ADD
                add_mod(regs + 4 * a, regs + 4 * b, out);
                break;
            case 3:  // SUB
                sub_mod(regs + 4 * a, regs + 4 * b, out);
                break;
            case 4:  // MUL
                mul_mod(regs + 4 * a, regs + 4 * b, out);
                break;
            case 5:  // NEG
                neg_mod(regs + 4 * a, out);
                break;
            case 6:  // INV
                if (inv_mod(regs + 4 * a, out)) return i + 1;
                break;
            case 7: {  // SHR by immediate b
                const u64* x = regs + 4 * a;
                u64 t[4];
                std::memcpy(t, x, 32);
                int64_t k = b;
                int word = (int)(k / 64), bit = (int)(k % 64);
                for (int j = 0; j < 4; j++) {
                    u64 lo = (j + word < 4) ? t[j + word] : 0;
                    u64 hi = (j + word + 1 < 4) ? t[j + word + 1] : 0;
                    out[j] = bit ? ((lo >> bit) | (hi << (64 - bit))) : lo;
                }
                break;
            }
            case 8:  // XORW
                for (int j = 0; j < 4; j++)
                    out[j] = regs[4 * a + j] ^ regs[4 * b + j];
                break;
            case 9:  // ORW
                for (int j = 0; j < 4; j++)
                    out[j] = regs[4 * a + j] | regs[4 * b + j];
                break;
            case 10:  // ANDC (b = const index)
                for (int j = 0; j < 4; j++)
                    out[j] = regs[4 * a + j] & consts[4 * b + j];
                break;
            default:
                return i + 1;
        }
    }
    return 0;
}

// ops: (n, 3) int64 rows [opcode, a, b]; consts (k, 4) u64; inputs (m, 4)
// u64; regs_out (n, 4) u64 receives every register.
// Returns 0 on success, or 1 + op_index of the first zero-inverse.
int64_t replay_tape(const int64_t* ops, int64_t n, const u64* consts,
                    const u64* inputs, int64_t num_inputs, u64* regs) {
    (void)num_inputs;
    return exec_rows(ops, consts, inputs, regs, 0, n);
}

// dependency level per op (0 for CONST/INPUT; 1 + max(level of register
// operands) otherwise). Single O(n) pass; the register index of op i is i.
void compute_levels(const int64_t* ops, int64_t n, int32_t* levels) {
    for (int64_t i = 0; i < n; i++) {
        const int64_t op = ops[3 * i], a = ops[3 * i + 1], b = ops[3 * i + 2];
        int32_t lv = 0;
        switch (op) {
            case 0: case 1:  // CONST/INPUT: no register operands
                break;
            case 2: case 3: case 4: case 8: case 9:  // two registers
                lv = 1 + std::max(levels[a], levels[b]);
                break;
            default:  // NEG/INV/SHR/ANDC: register a only
                lv = 1 + levels[a];
                break;
        }
        levels[i] = lv;
    }
}

// level-scheduled replay: ops MUST be sorted by dependency level with
// operand registers renumbered to the sorted order (r1cs/tape.py
// Tape._leveled). offsets: (n_levels + 1) int64 row boundaries. Levels
// wider than min_par rows execute sharded across hardware threads — the
// rayon analogue for witness synthesis (reference: bellperson's parallel
// witness closures, SURVEY.md §3.1).
int64_t replay_tape_leveled(const int64_t* ops, int64_t n,
                            const int64_t* offsets, int64_t n_levels,
                            const u64* consts, const u64* inputs,
                            int64_t num_inputs, u64* regs,
                            int64_t min_par) {
    (void)num_inputs;
    int nthreads = 1;
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = (int)std::min<unsigned>(hw ? hw : 1, 16);
    if (const char* env = std::getenv("MASP_NATIVE_THREADS")) {
        int v = std::atoi(env);
        if (v >= 1) nthreads = std::min(v, 64);
    }
    if (min_par < 1) min_par = 4096;

    for (int64_t l = 0; l < n_levels; l++) {
        int64_t lo = offsets[l], hi = offsets[l + 1];
        if (nthreads <= 1 || hi - lo < min_par) {
            int64_t rc = exec_rows(ops, consts, inputs, regs, lo, hi);
            if (rc) return rc;
            continue;
        }
        std::atomic<int64_t> err(0);
        std::vector<std::thread> workers;
        int64_t chunk = (hi - lo + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; t++) {
            int64_t clo = lo + t * chunk;
            int64_t chi = std::min(hi, clo + chunk);
            if (clo >= chi) break;
            workers.emplace_back([&, clo, chi] {
                int64_t rc = exec_rows(ops, consts, inputs, regs, clo, chi);
                if (rc) {
                    int64_t expect = 0;
                    err.compare_exchange_strong(expect, rc);
                }
            });
        }
        for (auto& w : workers) w.join();
        if (err.load()) return err.load();
    }
    return 0;
}

// gather selected registers into a dense output (for assignment extraction)
void gather_regs(const u64* regs, const int64_t* idx, int64_t n, u64* out) {
    for (int64_t i = 0; i < n; i++)
        std::memcpy(out + 4 * i, regs + 4 * idx[i], 32);
}

}  // extern "C"
