#!/usr/bin/env python3
"""Smoke run of masp_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version at the main path's shapes,
runs the port's two measurement tools at full size (the kernel
microbenchmark and the tensor-core Montgomery experiment, whose int8 and
Montgomery kernels are held the same way first), then proves a Spend-shaped
Groth16 circuit three times in each MSM configuration (the projective scan
ladder, the default, then the batch-affine ladder), and then the real Spend,
Output and Convert circuits in the default configuration, each synthesised by
the port's copy of the host circuit stack from bench.py's seeded fixture
(phase "circuits"), and last a bundle of real Spend, Convert and Output jobs
through LocalTxProver.prove_jobs, the batch prover, at windows 1 and 2, on the
circuits' parameters (phase "batch", which also runs the bundle through
BatchValidator with the signature batches on the host and on the card). Every
proof is checked with the host pairing verifier, and against a toxic-waste
oracle or the single-proof path. Last, phase "jubjub" holds the three
Jubjub kernels (the Edwards add, the Pedersen fold, the Fr square root, the
last also on values of every 2-adic order) against their plain versions and
drives the Jubjub and Pedersen twins: a note-commitment tree of 2^16 leaves
through the default route, a RedJubjub batch of 256 signatures, an MSM of
2^10 points and the decompression of 4,096 encodings, each held against the
host; it logs the widths at which the path launches the add and the square
root, with their kernel time. Then phase "pairing" holds the device pairing
(ops/pairing.py: the Fq12 tower, the Miller loop and the final
exponentiation on the Fq product and inversion kernels) against its CPU run
and the host pairing, and times its product check; phase "batch" also runs
the bundle's Spend proofs through verify_proofs_batch with the device
pairing and with the host's, which must agree. Phase "tx", after "batch",
drives a wallet through the port's transaction builder on the circuits'
Parameters: ZIP-32 keys, a 1,024-note tree and a conversion tree built on the
card, a transaction of 2 Spends, 1 Convert and 3 Outputs through
LocalTxProver.prove_jobs, its validation (and rejection when altered), its
rebuild from stored build parameters, the decryption of its outputs, and a
scan of 512 compact outputs through the device decompression. Phase "mesh",
after "tx", drives the multi-device layer (parallel/mesh.py) on virtual
meshes whose every position is the card: the sharded NTT at m = 2^17, the
sharded sorted MSM of the real Spend's l and b_g2 queries (unsigned and
signed digits), the real Spend proved with signed digits on both ladders and
through create_proof_from_assembly(mesh=) on 4 positions, each proof equal
to the single-device one, the lane-private Pippenger, and the multichip dry
run. Phase "routes", after "mesh", proves the real Spend through each of the
prover's routes (the default; digits from the host, MASP_MSM_FROM_LIMBS=0;
the stacked G1 MSMs, MASP_MSM_STACK=1; the fused prove, MASP_MSM_FUSED=1; a
BGMW table for h at c = 12, MASP_MSM_BGMW_H=1; the lane-private Pippenger,
MASP_MSM=lanes), each proof verified and equal to the default one byte for
byte, with its spans, launches and time. Phase "bench", last, runs the
port's measurement entry points (masp_tpu_torch/tools/bench.py and the
twins of tools/bench_{batch,tx,mixed_batch,verify}.py) in-process on the
circuits' Parameters, each printing its JSON lines through
utils/benchlog.py: bench.py's single mode on the real Spend and a stream of
2-proof windows, bench_batch on Output, bench_tx, and bench_verify at B = 2
with the device pairing; --bench adds the 64-proof mixed bundle and
bench_verify at B = 8.

    python3 chip_smoke.py             # everything (one card)
    python3 chip_smoke.py --kernels   # build, the proof path's kernel checks and the tools only
    python3 chip_smoke.py --circuits  # build and the real circuits only
    python3 chip_smoke.py --batch     # build, the real circuits and the bundle
    python3 chip_smoke.py --tx        # build, the real circuits and the wallet's transaction
    python3 chip_smoke.py --mesh      # build, the real circuits and phase mesh
    python3 chip_smoke.py --routes    # build, the real circuits and phase routes
    python3 chip_smoke.py --bench     # build, the real circuits and phase bench (with the
                                      # mixed bundle and bench_verify at B = 8)
    python3 chip_smoke.py --jubjub    # build and phase jubjub only
    python3 chip_smoke.py --pairing   # build and phase pairing only
    python3 chip_smoke.py --profile   # also one profiled proof per configuration
                                      # and of the real Spend, and a profiled stretch of the pairing

The circuit is a seeded synthetic R1CS with the Spend circuit's shape
(8 inputs, 100,497 aux variables, 100,645 constraints, A/B/C non-zeros
262,108 / 101,876 / 209,066, densities 86,931 / 62,170, 68,418 boolean aux
variables): the prover's device work depends only on that shape. It is
satisfiable by construction: boolean wires (1 - b) b = 0, and-gates of bits,
and product gates x y = z over sparse linear combinations. Parameters come
from the port's generator with known toxic waste. It stays beside the real
circuits so that earlier runs' numbers remain comparable.

The real circuits are held against their pinned constraint and input counts
and structure digests; each gets parameters of its own from the generator,
one warm-up proof (its witness records the circuit's witness tape), then
three timed proofs of Spend and one each of Output and Convert, each from a
witness replayed by the native tape (host time, logged beside the proof's).

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
# Spend-shaped R1CS (counts of the Spend circuit with its input constraints)
N_INPUTS = 8
N_SEEDS = 50_337  # bits with (1 - b) b = 0: in A and in B
N_ANDS = 18_081  # bits as and-gates of two seed bits: in C only
N_FULL = 32_079  # full-width variables, each defined by one product gate
N_CHECKS = 133  # product gates over defined variables, no new variable
AND_IN_A = 17_763  # and-gate bits that later gates read in A
FULL_IN_A = 18_823
FULL_IN_B = 11_832
# mean terms of the product gates' linear combinations
K_A, K_B, K_C = 4.45, 1.0385, 5.93
SPEND = {"inputs": 8, "aux": 100_497, "constraints": 100_645, "nnz_a": 262_108,
         "nnz_b": 101_876, "nnz_c": 209_066, "a_density": 86_931,
         "b_density": 62_170, "bool_aux": 68_418, "bool_a": 68_100, "bool_b": 50_337}

# peak rates of one H100 SXM at its 700 W limit: HBM bandwidth (data sheet);
# 32-bit integer multiply-adds: 132 SMs x 64 INT32 lanes x 1.98 GHz boost;
# int8 tensor-core multiply-adds: the data sheet's dense 1,979 int8 TOPS / 2
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
INT8_MAC_PER_S = 989.5e12
# 32-bit operations of one divstep as csrc/mont_mul.cu's divsteps_30 writes
# it: the two masks (3), the masked updates of g, q, r (4 each) and of f, u,
# v (2 each), the swap mask (1), delta (3) and the three shifts
DIVSTEP_OPS = 28
L2_BYTES = 50 * 2**20  # the H100 SXM's L2 cache
PT_BYTES = 48 * 4  # a packed Jubjub point row

REPLACES = {
    "mont_mul_fr": "masp_tpu/kernels/field_kernels.py:350",
    "mont_mul_fq": "masp_tpu/kernels/field_kernels.py:350",
    # the Fermat chains of :350 launches that field_jax.mont_inv_small runs
    "mont_inv_fr": "masp_tpu/ops/field_jax.py:233",
    "mont_inv_fq": "masp_tpu/ops/field_jax.py:233",
    "g1_add": "masp_tpu/kernels/field_kernels.py:356",
    "g2_add": "masp_tpu/kernels/field_kernels.py:425",
    "g1_add01": "masp_tpu/kernels/field_kernels.py:372",
    "g2_add01": "masp_tpu/kernels/field_kernels.py:397",
    "affine_pre": "masp_tpu/kernels/field_kernels.py:257",
    "affine_post": "masp_tpu/kernels/field_kernels.py:299",
    # G2's affine level has no Pallas body: the JAX package composes it
    "affine_pre_g2": "masp_tpu/ops/msm_sorted.py:435",
    "affine_post_g2": "masp_tpu/ops/msm_sorted.py:435",
    "int8_dot": "tools/bench_kernel_micro.py:129",
    "int8_dot_loop": "tools/bench_kernel_micro.py:154",
    "mont_mul_mxu": "tools/exp_mxu_mont.py:191",
    # composed JAX programs without a Pallas body: the Edwards add, the
    # Pedersen fold's fori_loop and the square root's lax.scan
    "jubjub_add": "masp_tpu/ops/jubjub_jax.py:104",
    "pedersen_fold": "masp_tpu/ops/pedersen_jax.py:77",
    "fr_sqrt": "masp_tpu/ops/jubjub_jax.py:220",
}
SOURCE = {k: "masp_tpu_torch/csrc/" + src for k, src in (
    ("mont_mul_fr", "mont_mul.cu"), ("mont_mul_fq", "mont_mul.cu"),
    ("mont_inv_fr", "mont_mul.cu"), ("mont_inv_fq", "mont_mul.cu"),
    ("g1_add", "point_add.cu"), ("g2_add", "point_add.cu"),
    ("g1_add01", "point_add.cu"), ("g2_add01", "point_add.cu"),
    ("affine_pre", "affine.cu"), ("affine_post", "affine.cu"),
    ("affine_pre_g2", "affine.cu"), ("affine_post_g2", "affine.cu"),
    ("int8_dot", "int8_dot.cu"), ("int8_dot_loop", "int8_dot.cu"),
    ("mont_mul_mxu", "mont_mul_mxu.cu"), ("jubjub_add", "jubjub.cu"), ("pedersen_fold", "jubjub.cu"),
    ("fr_sqrt", "jubjub.cu"))}
# each kernel's entry function in ptxas's report: (source, a part of its
# mangled name)
ENTRY = {
    "mont_mul_fr": ("mont_mul", "mont_mul_kernelI2Fr"), "mont_mul_fq": ("mont_mul", "mont_mul_kernelI2Fq"),
    "mont_inv_fr": ("mont_mul", "mont_inv_kernelI2Fr"), "mont_inv_fq": ("mont_mul", "mont_inv_kernelI2Fq"),
    # group_add_kernel<E, LEAF>: the bool's mangling, Lb0E or Lb1E, tells the forms apart
    "g1_add": ("point_add", "group_add_kernelI2FeI2FqELb0E"), "g2_add": ("point_add", "group_add_kernelI4Fq2ELb0E"),
    "g1_add01": ("point_add", "group_add_kernelI2FeI2FqELb1E"), "g2_add01": ("point_add", "group_add_kernelI4Fq2ELb1E"),
    "affine_pre": ("affine", "affine_pre_kernelI2FeI2Fq"), "affine_post": ("affine", "affine_post_kernelI2FeI2Fq"),
    "affine_pre_g2": ("affine", "affine_pre_kernelI4Fq2E"), "affine_post_g2": ("affine", "affine_post_kernelI4Fq2E"),
    "int8_dot": ("int8_dot", "int8_dot_kernel"), "int8_dot_loop": ("int8_dot", "int8_dot_loop_kernel"),
    "mont_mul_mxu": ("mont_mul_mxu", "mont_mul_mxu_kernel"),
    "jubjub_add": ("jubjub", "jubjub_add_kernel"), "pedersen_fold": ("jubjub", "pedersen_fold_kernel"),
    "fr_sqrt": ("jubjub", "fr_sqrt_kernel"),
}
# the kernels each driven path must launch: the proof path (the affine
# configuration runs them all, the scan one all but the affine kernels), the
# two tools, and the Jubjub path (phase jubjub: the bulk Merkle tree, the
# RedJubjub batch, the MSM and the decompression), the one caller of the Fr
# inversion
TOOL_KERNELS = ["int8_dot", "int8_dot_loop", "mont_mul_mxu"]
EDWARDS_KERNELS = ["jubjub_add", "pedersen_fold", "fr_sqrt"]
JUBJUB_KERNELS = EDWARDS_KERNELS + ["mont_mul_fr", "mont_inv_fr"]
PROOF_KERNELS = [k for k in REPLACES if k not in TOOL_KERNELS + EDWARDS_KERNELS and k != "mont_inv_fr"]
# the kernels of the scan configuration, the default: every proof kernel but
# the affine ones
SCAN_KERNELS = [k for k in PROOF_KERNELS if not k.startswith("affine")]
# the real circuits: constraints before the input constraints, inputs with
# ONE, and the TestConstraintSystem digests that the JAX package's tests pin
# (tests/test_circuits.py); timed proofs of each after its warm-up
CIRCUITS = {
    "spend": (100_637, 8, "34e4a634c80e4e4c6250e63b7855532e60b36d1371d4d7b1163218b69f09eb3d"),
    "output": (31_205, 6, "93e445d7858e98c7138558df341f020aedfe75893535025587d64731e244276a"),
    "convert": (47_358, 4, "f74b47ef6e59081548f81f5806bd15b1f4a65d2e57681e6db2b8db7eef2ff814"),
}
CIRCUIT_PROOFS = {"spend": 3, "output": 1, "convert": 1}
# the bundle: jobs of each kind, the batch prover's windows (MASP_BATCH_WINDOW)
# it is proved at, its seed (tools/fixtures.jobs and prove_jobs' rng) and the
# transaction's signature hash
BATCH_JOBS = {"spend": 3, "convert": 2, "output": 3}
BATCH_WINDOWS = (1, 2)
BATCH_SEED = bytes(range(7, 23))
BATCH_SIGHASH = bytes(range(100, 132))
# threads a block of the G1 complete add, each measured in a build of its
# own: the measurement behind the size that point_add.cu keeps
G1_BLOCKS = (96, 192)
# lanes of the affine levels' kernel checks: level 0 of the h query (32
# windows x 2^17 points / 2) and of b_g2's full part (32 windows x 2^14
# points / 2); the G1 composite level at 2^19 lanes. The same widths are the
# scan ladder's widest leaf launches, where the leaf adds are checked and
# timed as well
AFFINE_LANES = {1: 1 << 21, 2: 1 << 18}
AFFINE_LEVEL_LANES = 1 << 19
# Fq products of 2 (2 W^2 + W) IMADs, W = 12
FQ_IMAD = 2 * (2 * 144 + 12)
# phase jubjub: the kernels' check and timing shapes (an add at the MSM
# ladder's scale; the fold at a Merkle node's 172 chunks), then the path:
# the note-commitment tree's leaves (device levels from 32,768 down to 64
# pairs), the RedJubjub batch, the MSM's points, the encodings decompressed
JUBJUB_ADD_PAIRS = 1 << 16
FR_SQRT_ROWS = 1 << 12
FOLD_CHUNKS, FOLD_HASHES = 172, 1 << 12
# the fold's check widths (the tree's device levels run from 32,768 down to
# 64 hashes) and the widths it is timed at
FOLD_WIDTHS = (1, 3, 32, 64, 1003, 1024, 4096, 32768)
FOLD_TIMED = (64, 1024, 4096, 32768)
# the build of jubjub.cu whose probe kernels hold one Fr product each
JUBJUB_PROBE = ("MASP_JUBJUB_PROBE",)
# the build of int8_dot.cu whose loop kernel records the SM of each CTA
INT8_PROBE = ("MASP_INT8_PROBE",)
# the products int8_dot_loop is held at besides R - 1 and R + 1 (R rep
# slices): none, one, the tools' k, and 4096 and 32768, where the tools'
# unsigned sums pass 2^31 and wrap
INT8_LOOP_KS = (0, 1, 8, 64, 4096, 32768)
JUBJUB_TREE_LEAVES = 1 << 16
JUBJUB_SIGS = 256
JUBJUB_MSM_POINTS = 1 << 10
JUBJUB_DECOMPRESS = 4096
# phase pairing: the pairs of the Miller loop and final exponentiation held
# against the host, and the kernels the device pairing runs (every tower
# product, and the Miller loop's batch inversions and f6inv's)
PAIRING_PAIRS = 4
PAIRING_KERNELS = ["mont_mul_fq", "mont_inv_fq"]
# square-and-multiply steps of the hard part profiled with --profile
PAIRING_PROFILE_BITS = 32
# phase tx: the wallet's note-commitment tree (device levels from 512 down
# to 64 pairs), its conversion tree (one device level), the compact outputs
# it scans (a wallet catching up over a few blocks), the XorShiftRng seeds
# of the build's rng, its build parameters and the validator, and the byte
# of the first spend's proof that the rejection check flips
TX_LEAVES = 1 << 10
TX_CONVERSIONS = 128
TX_SCAN = 512
TX_SEEDS = (b"chip_smoke tx rn", b"chip_smoke tx bp", b"chip_smoke tx vr")
TX_FLIP = 100
# phase mesh: the positions of the virtual meshes on the card (every position
# the card): the mesh proof's and the sharded MSMs', the sharded NTT's; the
# points of the lane-private Pippenger's check
# phase routes: the prover's routes, each with its variables (msm_flags
# derives the module constants from them as the reference does); the
# default first, whose proof the others must equal byte for byte
ROUTES = [("default", {}), ("host_digits", {"MASP_MSM_FROM_LIMBS": "0"}), ("stacked", {"MASP_MSM_STACK": "1"}),
          ("fused", {"MASP_MSM_FUSED": "1"}), ("bgmw_h", {"MASP_MSM_BGMW_H": "1", "MASP_MSM_BGMW_C": "12"}),
          ("lanes", {"MASP_MSM": "lanes"})]
# the kernels every route's proof must launch (the lanes route runs no leaf
# add: no split and no prefix ladder)
ROUTE_KERNELS = ["g1_add", "g2_add", "mont_mul_fr", "mont_mul_fq", "mont_inv_fq"]
MESH_POSITIONS = 4
MESH_NTT_POSITIONS = (4, 8)
MESH_PIPPENGER = 1 << 12
# the NTT stages (half-width h) at which the product's stage form is held and
# timed: one row a butterfly group, a narrow group and the widest stage of
# the 2^17-point transforms
STAGE_HS = (1, 1 << 4, 1 << 15)
# rows at which the product is latency-bound: the fetch's inversion trees
# and the Fq trees' narrow steps
NARROW_ROWS = (1, 32, 1024)
# phase bench: bench.py's iterations (single and stream) and batch, which
# bench_batch and bench_verify take too; under --bench the mixed bundle's
# iterations and bench_verify at the source's B and iterations
BENCH_ITERS = 3
BENCH_BATCH = 2
BENCH_MIXED_ITERS = 2
BENCH_VERIFY_FULL = 8
BENCH_VERIFY_ITERS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


# --- the Spend-shaped circuit ----------------------------------------------------

def spend_shaped_r1cs(seed: int):
    """(Assembly, witness ints, public inputs) of the synthetic circuit."""
    from masp_tpu_torch.groth16 import assembly_from_arrays
    from masp_tpu_torch.host.fields import SCALAR_MODULUS as R

    rng = random.Random(seed)
    consts = [1, 2, 3, 4, 8, 16, 256, 65536, 1 << 32, R - 1, R - 2, R - 4]
    aux0 = N_INPUTS
    seeds = list(range(aux0, aux0 + N_SEEDS))
    ands = list(range(seeds[-1] + 1, seeds[-1] + 1 + N_ANDS))
    fulls = list(range(ands[-1] + 1, ands[-1] + 1 + N_FULL))
    n_vars = fulls[-1] + 1
    z = [0] * n_vars
    z[0] = 1
    for s in seeds:
        z[s] = rng.getrandbits(1)
    rows = []  # (A, B, C) as lists of (var, coeff)
    for s in seeds:
        rows.append(([(0, 1), (s, R - 1)], [(s, 1)], []))
    for d in ands:
        x, y = rng.choice(seeds), rng.choice(seeds)
        z[d] = z[x] & z[y]
        rows.append(([(x, 1)], [(y, 1)], [(d, 1)]))

    # required first reads: each listed variable is read by one later gate
    need_a = [[] for _ in range(N_FULL + N_CHECKS)]
    need_b = [[] for _ in range(N_FULL + N_CHECKS)]
    for d in rng.sample(ands, AND_IN_A):
        need_a[rng.randrange(N_FULL)].append(d)
    for j in rng.sample(range(N_FULL - 1), FULL_IN_A):
        need_a[rng.randrange(j + 1, N_FULL)].append(fulls[j])
    for j in rng.sample(range(N_FULL - 1), FULL_IN_B):
        need_b[rng.randrange(j + 1, N_FULL)].append(fulls[j])
    need_b[0].append(0)  # ONE in B
    defined = seeds + ands

    def lc(required, k_mean, pool):
        k = max(len(required), int(k_mean) + (rng.random() < k_mean - int(k_mean)))
        return [(v, rng.choice(consts)) for v in required + [rng.choice(pool) for _ in range(k - len(required))]]

    def ev(terms):
        return sum(c * z[v] for v, c in terms) % R

    gates = []
    for g in range(N_FULL + N_CHECKS):
        A = lc(need_a[g], K_A, seeds)
        B = lc(need_b[g], K_B, seeds)
        if g < N_FULL:
            out = fulls[g]
            others = [(rng.choice(defined), rng.choice(consts)) for _ in range(int(K_C) - 1 + (rng.random() < K_C - int(K_C)))]
            cz = rng.choice(consts)
            z[out] = (ev(A) * ev(B) - ev(others)) * pow(cz, -1, R) % R
            C = [(out, cz)] + others
            defined.append(out)
            gates.append((A, B, C))
        else:  # a check gate repeats an earlier gate's A * B = C
            gates.append(gates[rng.randrange(N_FULL)])
    rows.extend(gates)
    # public inputs: in_i = bit * full
    publics = []
    for i in range(1, N_INPUTS):
        x, y = rng.choice(seeds), rng.choice(fulls[:FULL_IN_B])
        z[i] = z[x] * z[y] % R
        publics.append(z[i])
        rows.append(([(x, 1)], [(y, 1)], [(i, 1)]))
    for i in range(N_INPUTS):  # bellman's input constraints, last
        rows.append(([(i, 1)], [], []))

    indptr, var_idx, coeff_vals = [0], [], []
    for k in range(3):
        for r in rows:
            for v, c in r[k]:
                var_idx.append(v)
                coeff_vals.append(c)
            indptr.append(len(var_idx))
    uniq = sorted(set(coeff_vals))
    table = np.frombuffer(b"".join(c.to_bytes(32, "little") for c in uniq), dtype=np.uint64).reshape(-1, 4)
    pos = {c: i for i, c in enumerate(uniq)}
    coeffs = table[np.asarray([pos[c] for c in coeff_vals])]
    assignment = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in z), dtype=np.uint64).reshape(-1, 4)
    asm = assembly_from_arrays(N_INPUTS, indptr, var_idx, coeffs, assignment.copy())
    return asm, z, publics


def r1cs_counts(asm) -> dict:
    from masp_tpu_torch.groth16.generator import densities
    from masp_tpu_torch.groth16.prover import boolean_var_mask

    n = asm.num_constraints
    ip = asm.indptr
    ad, bd = densities(asm)
    mask = boolean_var_mask(asm)
    return {"inputs": asm.num_inputs, "aux": asm.num_vars - asm.num_inputs, "constraints": n,
            "nnz_a": int(ip[n] - ip[0]), "nnz_b": int(ip[2 * n] - ip[n]),
            "nnz_c": int(ip[3 * n] - ip[2 * n]), "a_density": int(ad.sum()),
            "b_density": int(bd.sum()), "bool_aux": int(mask[asm.num_inputs:].sum()),
            "bool_a": int(mask[ad].sum()), "bool_b": int(mask[bd].sum())}


def oracle_proof(u, v, w, z, tau, alpha, beta, delta, r, s, n_inputs):
    """The proof from the Fr scalars at tau, one host scalar mul per point:
    A = alpha + sum z_i u_i + r delta, B = beta + sum z_i v_i + s delta,
    C = (sum_aux z_i (beta u_i + alpha v_i + w_i) + h(tau) Z(tau)) / delta
        + s A + r B - r s delta, with h(tau) Z(tau) = (z.u)(z.v) - z.w."""
    from masp_tpu_torch.host.bls12_381 import G1, G2, R
    from masp_tpu_torch.host.structures import Proof

    zu = sum(a * b for a, b in zip(z, u)) % R
    zv = sum(a * b for a, b in zip(z, v)) % R
    zw = sum(a * b for a, b in zip(z, w)) % R
    aux = sum(z[i] * (beta * u[i] + alpha * v[i] + w[i]) for i in range(n_inputs, len(z))) % R
    a_s = (alpha + zu + r * delta) % R
    b_s = (beta + zv + s * delta) % R
    c_s = ((aux + zu * zv - zw) * pow(delta, -1, R) + s * a_s + r * b_s - r * s * delta) % R
    return Proof(a=G1.generator() * a_s, b=G2.generator() * b_s, c=G1.generator() * c_s)


# --- kernel phase ------------------------------------------------------------------

def _median_ms(fn, runs: int) -> float:
    """CUDA-event ms around one eager call of fn, median of ``runs`` after a
    warm-up call: the host's launch included whenever the kernel is shorter
    than it, and inputs that fit in L2 read from there."""
    import torch

    from masp_tpu_torch.tools.bench_kernel_micro import time_ms

    return time_ms(fn, torch.device("cuda"), runs)[0]


def _kernel_ms(fn, args, nbytes: int, launches: int = 10, from_hbm: bool = True) -> float:
    """Card time per call of fn(*args) with the launch cost taken out: the
    calls captured in one CUDA graph, replayed between CUDA events (median
    of 5 replays). With ``from_hbm``, consecutive calls read different
    copies of args, enough that a copy is read again only after twice the
    L2's bytes (``nbytes`` per call) have passed, so each call reads its
    inputs from HBM, as the byte bound assumes; at least ``launches``
    calls. Without it (a latency-bound kernel on a few rows) every call
    reads the same args."""
    import torch

    from masp_tpu_torch.tools.bench_kernel_micro import graph_of, time_ms

    copies = -(-2 * L2_BYTES // nbytes) if from_hbm else 1
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(copies - 1)]
    calls = max(launches, copies)
    outs = [None] * copies  # each copy's output stays alive: distinct buffers

    def run():
        for i in range(calls):
            outs[i % copies] = fn(*sets[i % copies])

    ms, _, _ = time_ms(graph_of(run), torch.device("cuda"), 5)
    return ms / calls


def _chain_ms(add, x, y, steps: int = 20) -> tuple[float, float]:
    """ms per launch of ``steps`` dependent adds acc = add(acc, y), as the
    bucket reduction chains run them: (eager, events around the chain, the
    host's launches included; in one CUDA graph, the card's time alone),
    medians of 5."""
    import torch

    from masp_tpu_torch.tools.bench_kernel_micro import graph_of, time_ms

    def run():
        acc = x
        for _ in range(steps):
            acc = add(acc, y)

    graph = time_ms(graph_of(run), torch.device("cuda"), 5)[0]
    return _median_ms(run, 5) / steps, graph / steps


def _imad_ms(imad: float) -> float:
    return 1e3 * imad / IMAD_PER_S


def _set_bound(r: dict) -> tuple[float, float]:
    """r["bound_ms"] and r["bound_by"] from r["bytes"] (each input read and
    each output written once) and r["ops_ms"]; returns both times."""
    bytes_ms, ops_ms = 1e3 * r["bytes"] / HBM_BYTES_PER_S, r["ops_ms"]
    r["bound_ms"] = max(bytes_ms, ops_ms)
    r["bound_by"] = "bytes" if bytes_ms > ops_ms else "operations"
    return bytes_ms, ops_ms


def _check_equal(name, got, want):
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).any(dim=-1).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"{name}: kernel differs from its plain version at lanes {bad}")
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _field_inputs(spec, n, rng, dev):
    """(n, L) Montgomery-form operands with 0, 1, N-1 and mont-1 among them."""
    import torch

    from masp_tpu_torch.ops import field as F

    edge = [0, 1, spec.modulus - 1, 2, spec.modulus - 2]
    xs = F.encode(spec, edge + [rng.randrange(spec.modulus) for _ in range(min(n, 4096) - len(edge))])
    reps = -(-n // xs.shape[0])
    a = np.tile(xs, (reps, 1))[:n]
    # raw limbs of 1 (so mont-1 comes out of to_mont) alongside the encodings
    a[5] = 0
    a[5, 0] = 1
    perm = np.random.default_rng(rng.randrange(1 << 30)).permutation(n)
    b = a[perm]
    b[: len(edge)] = F.encode(spec, [spec.modulus - 1, 0, spec.modulus - 1, 1, 1])
    return (torch.as_tensor(a.astype(np.int32), device=dev), torch.as_tensor(b.astype(np.int32), device=dev))


def _leaf_inputs(group, rows_np, n, dev):
    """(P, Q): affine-encoded operands (Z in {0, mont-1}) with
    identity+identity, P+P, P+(-P), identity+P and P+identity in the first
    lanes."""
    import torch

    from masp_tpu_torch.ops import msm_sorted as MS, weierstrass as W
    from masp_tpu_torch.ops.msm import identity_rows

    fops = W.G1Ops if group == 1 else W.G2Ops
    reps = -(-(n + 1) // rows_np.shape[0])
    base = torch.as_tensor(np.tile(rows_np, (reps, 1))[: n + 1], device=dev)
    P, Q = base[:n].clone(), base[1 : n + 1].clone()
    ident = identity_rows(fops, (1,), dev)[0]
    P[0], Q[0] = ident, ident
    Q[1] = P[1]
    Q[2] = MS._g_neg(fops, P[2:3])[0]
    P[3] = ident
    Q[4] = ident
    return P, Q


def _point_inputs(group, rows_np, n, dev):
    """(P, Q, Pp, Qp): _leaf_inputs and projective operands (general Z) with
    the same edge lanes."""
    import torch

    from masp_tpu_torch.kernels import point_add as PA
    from masp_tpu_torch.ops import msm_sorted as MS, weierstrass as W
    from masp_tpu_torch.ops.msm import identity_rows

    fops = W.G1Ops if group == 1 else W.G2Ops
    P, Q = _leaf_inputs(group, rows_np, n, dev)
    ident = identity_rows(fops, (1,), dev)[0]
    # projective operands: sums of affine points have general Z
    Pp = PA.point_add_plain(group, P, torch.roll(Q, 7, 0))
    Qp = PA.point_add_plain(group, torch.roll(P, 3, 0), Q)
    Pp[0], Qp[0] = ident, ident
    Qp[1] = Pp[1]
    Qp[2] = MS._g_neg(fops, Pp[2:3])[0]
    Pp[3] = ident
    Qp[4] = ident
    return P, Q, Pp, Qp


def kernel_phase(params, dev, rng, card: str) -> dict:
    """Every kernel instantiation against its plain version at the main
    path's shapes (and at a ragged count and on strided rows), bit for bit:
    the tolerance is exact equality, as for any integer arithmetic."""
    import torch

    from masp_tpu_torch.kernels import mont_mul as MK, point_add as PA
    from masp_tpu_torch.ops.field import FQ, FR

    out = {}
    W_ = {"fr": 8, "fq": 12}
    for name, spec, n in (("mont_mul_fr", FR, 3 << 17), ("mont_mul_fq", FQ, 1 << 16)):
        a, b = _field_inputs(spec, n, rng, dev)
        err = _check_equal(name, MK.mont_mul(spec, a, b), MK.mont_mul_plain(spec, a, b))
        ar, br = a[:1000 + 3], b[:1000 + 3]
        _check_equal(name + " (ragged)", MK.mont_mul(spec, ar, br), MK.mont_mul_plain(spec, ar, br))
        w, nbytes = W_[spec.name.lower()], 3 * n * spec.L * 4
        out[name] = {
            "n": n, "max_abs_err": err,
            "ms": _kernel_ms(lambda x, y: MK.mont_mul(spec, x, y), (a, b), nbytes),
            "eager_ms": _median_ms(lambda: MK.mont_mul(spec, a, b), 10),
            "plain_ms": _median_ms(lambda: MK.mont_mul_plain(spec, a, b), 3),
            "ops_ms": _imad_ms(n * 2 * (2 * w * w + w)), "bytes": nbytes,
            "forms": mont_mul_form_phase(spec, a, b, card),
            "narrow_ms": {},
        }
        for rows in NARROW_ROWS:  # latency-bound: the same inputs every call, from L2
            ms = _kernel_ms(lambda x, y: MK.mont_mul(spec, x, y), (a[:rows], b[:rows]), 3 * rows * spec.L * 4,
                            launches=20, from_hbm=False)
            out[name]["narrow_ms"][rows] = ms
        log(f"kernel {name} at narrow widths (rows: ms per launch in a CUDA graph, inputs in L2): "
            f"{json.dumps({r: round(t, 5) for r, t in out[name]['narrow_ms'].items()})} on {card}")
    for spec in (FR, FQ):
        out["mont_inv_" + spec.name.lower()] = inverse_kernel_phase(spec, dev, rng, card)
    for group, rows in ((1, params.h), (2, params.b_g2)):
        n = 1 << 16
        P, Q, Pp, Qp = _point_inputs(group, rows, n, dev)
        K = 3 * (24 if group == 1 else 48)
        per_mul = FQ_IMAD * (1 if group == 1 else 3)
        for leaf, (x, y) in ((True, (P, Q)), (False, (Pp, Qp))):
            name = f"g{group}_add01" if leaf else f"g{group}_add"
            pairs = torch.cat([x, y], dim=1)  # strided operands, as the MSM ladder passes them
            want = PA.point_add_plain(group, x, y, leaf)
            nbytes = 3 * n * K * 4

            def add(p, q, leaf=leaf):
                return PA.point_add(group, p, q, leaf)

            err = _check_equal(name, add(x, y), want)
            if leaf:  # the leaf form gives the complete formula's limbs
                _check_equal(name + " vs complete", add(x, y), PA.point_add(group, x, y, False))
            _check_equal(name + " (strided)", add(pairs[:, :K], pairs[:, K:]), want)
            for width in (1, 3, 17, 32, 128, 1003):  # the chains' widths and ragged counts, the edge lanes first
                _check_equal(f"{name} (width {width})", add(x[:width], y[:width]), want[:width])
                _check_equal(f"{name} (width {width}, strided)",
                             add(pairs[:width, :K], pairs[:width, K:]), want[:width])
            out[name] = {
                "n": n, "max_abs_err": err,
                "ms": _kernel_ms(add, (x, y), nbytes),
                "eager_ms": _median_ms(lambda: add(x, y), 10),
                "ops_ms": _imad_ms(n * per_mul * (9 if leaf else 12)), "bytes": nbytes,
            }
            if not leaf:  # the widths of bucket_reduce_horner's chains
                for width in (1, 32 if group == 2 else 4 * 32):
                    eager, graph = _chain_ms(add, x[:width], y[:width])
                    log(f"kernel {name} chain: {eager:.4f} ms per launch eager, {graph:.4f} ms in a CUDA graph "
                        f"at width {width} (20 dependent launches, median of 5) on {card}")
            if group == 1 and not leaf:
                g1_block_phase(x, y, want, nbytes, card)
            out[name]["plain_ms"] = _median_ms(lambda: PA.point_add_plain(group, x, y, leaf), 3)
            if leaf:
                out[name]["widest"] = leaf_widest_phase(group, rows, dev, card)
    out.update(affine_kernel_phase(params, dev, card))
    for name, r in out.items():
        # bytes of the int32 rows the kernel reads and writes; each row holds
        # 16-bit limbs, so the limbs' own payload is half of that
        bytes_ms, ops_ms = _set_bound(r)
        log(f"kernel {name}: n={r['n']} bit-identical to plain (tolerance: exact; max_abs_err "
            f"{r['max_abs_err']}); kernel {r['ms']:.4f} ms per launch in a CUDA graph, {r.get('inputs', 'inputs from HBM')} "
            f"({r['eager_ms']:.4f} ms eager, events around one call, median of 10), plain {r['plain_ms']:.3f} ms "
            f"(median of 3), bound {r['bound_ms']:.6f} ms ({r['bound_by']}; bytes {bytes_ms:.4f} ms "
            f"for int32 rows, {bytes_ms / 2:.4f} ms for the 16-bit payload; operations {ops_ms:.6f} ms) "
            f"on {card}")
    return out


def _product_bytes(spec, *views) -> int:
    """Bytes a product over these (..., L) operands must move: each
    operand's distinct rows read once (a broadcast operand's rows once, a
    strided one's only the rows it names), the result written once."""
    import torch

    def rows(t):
        return int(np.prod([s_ for s_, st in zip(t.shape[:-1], t.stride()[:-1]) if st != 0]))

    n = int(np.prod(torch.broadcast_shapes(*(v.shape for v in views))[:-1]))
    return 4 * spec.L * (sum(rows(v) for v in views) + n)


def _mont_mul_forms(spec, a, b) -> dict:
    """The product's operand forms on the main path, on the kernel phase's
    rows a and b: label -> (bases, views), views(*bases) taking the operands
    from the base tensors, so that a timed copy of the bases keeps the form
    (cloning a broadcast view would materialise it). Fr on 3 x 2^17 rows,
    three transforms of 2^17 points: an NTT stage at 3 x 2^16 products (the
    odd half of every butterfly group, twiddles b[:h] broadcast over the
    groups) at each h of STAGE_HS, the coset powers b[:2^17] broadcast over
    the transforms, a scalar in either order, and rows whose base and stride
    are not 16-byte aligned; Fq on 2^16 rows: a product-tree step's halves
    p[:h] and p[h:] of p = [a; b]."""
    import torch

    L, n = spec.L, a.shape[0]
    if spec.name == "Fq":
        return {"tree step": ((torch.cat([a, b]),), lambda p: (p[:n], p[n:]))}
    m = n // 3
    forms = {f"stage h={h}": ((a, b), lambda x, t, h=h: (x.view(3, m // (2 * h), 2, h, L)[..., 1, :, :], t[:h][None]))
             for h in STAGE_HS}
    forms["coset powers"] = ((a, b), lambda x, t: (x.view(3, m, L), t[:m]))
    forms["scalar"] = ((a, b), lambda x, t: (x, t[7]))
    forms["scalar first"] = ((a, b), lambda x, t: (t[7], x))
    wide = torch.cat([a[:, :1], a, a[:, :1]], dim=1)  # rows of L + 2 limbs
    forms["unaligned"] = ((wide, b), lambda x, t: (x[:, 1 : L + 1], t))
    return forms


def mont_mul_form_phase(spec, a, b, card: str) -> dict:
    """The product through F.mont_mul (the main path's entry) in each of
    _mont_mul_forms, bit for bit against mont_mul_plain on the
    materialised rows, and timed in a CUDA graph (inputs from HBM) with the
    bound of the bytes the form must move; where the tree copies an
    operand before the launch, the copy is in the time."""
    import torch

    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.ops import field as F

    name, L, w = "mont_mul_" + spec.name.lower(), spec.L, spec.L // 2
    out = {}
    for label, (bases, views) in _mont_mul_forms(spec, a, b).items():
        x, y = views(*bases)
        shape = torch.broadcast_shapes(x.shape, y.shape)
        want = MK.mont_mul_plain(spec, x.expand(shape).reshape(-1, L), y.expand(shape).reshape(-1, L))
        _check_equal(f"{name} ({label})", F.mont_mul(spec, x, y).reshape(-1, L), want)
        nbytes = _product_bytes(spec, x, y)
        r = {"rows": want.shape[0], "bytes": nbytes, "ops_ms": _imad_ms(want.shape[0] * 2 * (2 * w * w + w)),
             "ms": _kernel_ms(lambda *bs: F.mont_mul(spec, *views(*bs)), bases, nbytes)}
        _set_bound(r)
        out[label] = {k: r[k] for k in ("rows", "ms", "bound_ms")}
        log(f"kernel {name} ({label}): {r['rows']} products bit-identical to plain (tolerance: exact); "
            f"{r['ms']:.4f} ms per F.mont_mul in a CUDA graph, inputs from HBM, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes} B) on {card}")
    return out


def mont_mul_widths(asm, params, rs, dev) -> dict:
    """Every mont_mul_fr / mont_mul_fq launch of one proof on the current
    MSM configuration, by form: (field, shape, a's strides and storage
    offset mod 4, b's) -> launches; one proof with MK.mont_mul wrapped by a
    recorder (the launches still run and count)."""
    from collections import Counter

    from masp_tpu_torch.groth16 import create_proof_from_assembly
    from masp_tpu_torch.kernels import mont_mul as MK

    real = MK.mont_mul
    seen = Counter()

    def record(spec, a, b):
        seen[(spec.name, tuple(a.shape), tuple(a.stride()), a.storage_offset() % 4,
              tuple(b.stride()), b.storage_offset() % 4)] += 1
        return real(spec, a, b)

    MK.mont_mul = record
    try:
        create_proof_from_assembly(asm, params, *rs, device=dev)
    finally:
        MK.mont_mul = real
    return seen


def mont_mul_per_proof(seen, dev, card: str) -> dict:
    """Each field's product per proof from mont_mul_widths: launches and
    products, the kernel's time per proof (each form timed in a CUDA graph on
    operands of its shape and strides over random limbs, inputs from HBM
    where a launch moves 1 MiB or more, else from L2, times its launches),
    the per-proof bound (each operand's distinct rows once) and the bound of
    the same products as three full rows each."""
    import torch

    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.ops.field import FQ, FR

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def base(shape, stride, off):
        size = off + 1 + sum((s_ - 1) * st for s_, st in zip(shape, stride))
        return torch.randint(0, 1 << 16, (size,), dtype=torch.int32, device=dev, generator=gen)

    res = {}
    for spec in (FR, FQ):
        name, L, w = "mont_mul_" + spec.name.lower(), spec.L, spec.L // 2
        tot = {"launches": 0, "products": 0, "ms": 0.0, "bound_ms": 0.0, "bound_3rows_ms": 0.0}
        forms = []
        for key, count in sorted(((k, c) for k, c in seen.items() if k[0] == spec.name), key=lambda kc: str(kc[0])):
            _, shape, sa, oa, sb, ob = key
            n = int(np.prod(shape[:-1]))
            if n == 0:
                continue

            def fn(x, y, shape=shape, sa=sa, oa=oa, sb=sb, ob=ob):
                return MK.mont_mul(spec, torch.as_strided(x, shape, sa, oa), torch.as_strided(y, shape, sb, ob))

            x, y = base(shape, sa, oa), base(shape, sb, ob)
            nbytes = _product_bytes(spec, torch.as_strided(x, shape, sa, oa), torch.as_strided(y, shape, sb, ob))
            ms = _kernel_ms(fn, (x, y), nbytes, launches=20, from_hbm=nbytes >= 1 << 20)
            ops_ms = _imad_ms(n * 2 * (2 * w * w + w))
            tot["launches"] += count
            tot["products"] += count * n
            tot["ms"] += count * ms
            tot["bound_ms"] += count * max(1e3 * nbytes / HBM_BYTES_PER_S, ops_ms)
            tot["bound_3rows_ms"] += count * max(1e3 * 3 * n * L * 4 / HBM_BYTES_PER_S, ops_ms)
            forms.append(f"{count} x {list(shape)} a{list(sa)} b{list(sb)}: {ms:.4f}")
        res[name] = tot
        log(f"kernel {name} per proof: {tot['launches']} launches, {tot['products']} products; "
            f"{tot['ms']:.4f} ms of kernel time per proof (each form in a CUDA graph), bound {tot['bound_ms']:.4f} ms "
            f"(each operand's distinct rows once), {tot['bound_3rows_ms']:.4f} ms as three rows a product, on {card}")
        log(f"kernel {name} per proof by form (launches x shape, strides: ms per launch): {'; '.join(forms)}")
    return res


def leaf_widest_phase(group, rows_np, dev, card: str) -> dict:
    """The leaf add of ``group`` at the scan ladder's widest leaf launch
    (AFFINE_LANES: h's leaf level on G1, b_g2's on G2), bit for bit against
    its plain version (in chunks), contiguous and strided, and against the
    complete kernel; its time there in a CUDA graph, inputs from HBM."""
    import torch

    from masp_tpu_torch.kernels import point_add as PA

    n = AFFINE_LANES[group]
    name = f"g{group}_add01"
    P, Q = _leaf_inputs(group, rows_np, n, dev)
    K = P.shape[1]
    pairs = torch.cat([P, Q], dim=1)  # strided operands, as the ladder passes them

    def add(p, q):
        return PA.point_add(group, p, q, True)

    want = _chunked(lambda a, b: PA.point_add_plain(group, a, b, True), n, P, Q)
    _check_equal(f"{name} (width {n})", add(P, Q), want)
    _check_equal(f"{name} (width {n}, strided)", add(pairs[:, :K], pairs[:, K:]), want)
    _check_equal(f"{name} (width {n}) vs complete", PA.point_add(group, P, Q), want)
    ms = _kernel_ms(add, (P, Q), 3 * n * K * 4)
    log(f"kernel {name} at {n} pairs (the widest leaf launch): bit-identical to plain, contiguous and strided, "
        f"and to the complete kernel (tolerance: exact); {ms:.4f} ms per launch in a CUDA graph, inputs from HBM, "
        f"on {card}")
    return {"n": n, "ms": ms}


def leaf_widths(asm, params, rs, dev) -> dict:
    """The pairs of every leaf launch of one proof on the current MSM
    configuration, by kernel name: one proof with PA.point_add wrapped by a
    recorder (the launches still run and count)."""
    from masp_tpu_torch.groth16 import create_proof_from_assembly
    from masp_tpu_torch.kernels import point_add as PA

    real = PA.point_add
    widths = {"g1_add01": [], "g2_add01": []}

    def record(group, p, q, leaf01=False):
        if leaf01:
            widths[f"g{group}_add01"].append(p.shape[0])
        return real(group, p, q, leaf01)

    PA.point_add = record
    try:
        create_proof_from_assembly(asm, params, *rs, device=dev)
    finally:
        PA.point_add = real
    return widths


def leaf_per_proof(widths, params, dev, card: str) -> None:
    """Each leaf add's pairs per proof and its device time per proof: the
    kernel timed in a CUDA graph at every width the proof launched it at
    (inputs from HBM), summed over the proof's launches."""
    from masp_tpu_torch.kernels import point_add as PA

    for group, rows in ((1, params.h), (2, params.b_g2)):
        name = f"g{group}_add01"
        ws = widths[name]
        P, Q = _leaf_inputs(group, rows, max(ws), dev)
        ms = {w: _kernel_ms(lambda p, q: PA.point_add(group, p, q, True), (P[:w], Q[:w]), 3 * w * P.shape[1] * 4)
              for w in sorted(set(ws))}
        log(f"kernel {name} per proof: {len(ws)} launches, {sum(ws)} pairs (widths {ws}); "
            f"{sum(ms[w] for w in ws):.4f} ms of kernel time per proof (in a CUDA graph, inputs from HBM; "
            f"ms per launch by width: {json.dumps({w: round(t, 4) for w, t in ms.items()})}) on {card}")


def _g1_add_built_with(block: int):
    """The G1 complete add of point_add.cu built with ``block`` threads a
    block (MASP_G1_ADD_BLOCK), called through that library's own C entry:
    a measurement's build, so its launches are not counted."""
    import ctypes

    import torch

    from masp_tpu_torch.kernels import build

    fn = build.library("point_add", (f"MASP_G1_ADD_BLOCK={block}",)).masp_point_add
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def add(p, q):
        out = torch.empty((p.shape[0], p.shape[1]), dtype=torch.int32, device=p.device)
        err = fn(1, 0, p.data_ptr(), p.stride(0), q.data_ptr(), q.stride(0), out.data_ptr(), p.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"g1_add built with {block} threads a block: CUDA error {err}")
        return out

    return add


def g1_block_phase(x, y, want, nbytes: int, card: str) -> None:
    """The G1 complete add built with each of G1_BLOCKS threads a block, bit
    for bit against the plain version (all pairs, widths 1 and 128,
    strided), then timed at all pairs and in the bucket chains at widths 1
    and 128: the measurement behind the size point_add.cu keeps."""
    import re

    import torch

    from masp_tpu_torch.kernels import build

    src = (build.CSRC / "point_add.cu").read_text()
    kept = int(re.search(r"#define MASP_G1_ADD_BLOCK (\d+)", src).group(1))
    K = x.shape[1]
    pairs = torch.cat([x, y], dim=1)
    times = {}
    for block in G1_BLOCKS:
        add = _g1_add_built_with(block)
        for width in (x.shape[0], 1, 128):
            _check_equal(f"g1_add ({block} threads a block, width {width})", add(x[:width], y[:width]), want[:width])
            _check_equal(f"g1_add ({block} threads a block, width {width}, strided)",
                         add(pairs[:width, :K], pairs[:width, K:]), want[:width])
        ms = _kernel_ms(add, (x, y), nbytes)
        chains = [_chain_ms(add, x[:w], y[:w]) for w in (1, 128)]
        times[block] = f"{block}: {ms:.4f} ms at {x.shape[0]} pairs, chains {chains[0][1]:.4f} / {chains[1][1]:.4f} ms"
        log(f"kernel g1_add at {block} threads a block: bit-identical to plain; {ms:.4f} ms per launch in a "
            f"CUDA graph at {x.shape[0]} pairs (inputs from HBM); chains {chains[0][1]:.4f} / {chains[1][1]:.4f} "
            f"ms per launch in a CUDA graph, {chains[0][0]:.4f} / {chains[1][0]:.4f} ms eager, at widths 1 / 128 "
            f"on {card}")
    log(f"kernel g1_add block size: point_add.cu keeps {kept} threads a block (MASP_G1_ADD_BLOCK); threads a "
        f"block: {'; '.join(times.values())} (in a CUDA graph; chains at widths 1 / 128) on {card}")


def _divstep_ops(spec) -> int:
    """32-bit operations of one row of mont_inv_kernel<F>: per batch, 30
    divsteps of DIVSTEP_OPS each and 10 K + 2 32 x 32 -> 64-bit products
    at 2 IMADs each (4 K for t (f, g), 4 K + 2 K for t (d, e) + N (md,
    me), 2 by N^-1 mod 2^30), then one fe_mul by R^3 (2 (2 W^2 + W))."""
    from masp_tpu_torch.kernels import mont_mul as MK

    c, w = MK.divstep_constants(spec), spec.L // 2
    return c.batches * (MK.DIVSTEPS * DIVSTEP_OPS + 2 * (10 * c.limbs + 2)) + 2 * (2 * w * w + w)


def inverse_kernel_phase(spec, dev, rng, card: str) -> dict:
    """The inversion kernel of ``spec`` (Fr or Fq; the divstep GCD) bit for
    bit against its plain version and host ints at 1, 2, 3, 32 and 1003
    rows, and against the Fermat chain over the plain product at 32 (0, 1,
    N - 1, 2, N - 2, the raw 1 and mont-1 among the first rows), and 0 -> 0;
    then its time at the proof path's width, one row, and at 1003 rows,
    beside the eager chain of mont_mul launches that the kernel replaces.
    The bound counts the divstep kernel's own 32-bit operations
    (``_divstep_ops``), though one row's dependent chain bounds it
    (sass_report gives the chain's length)."""
    import torch

    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.ops import field as F

    name = "mont_inv_" + spec.name.lower()
    a, _ = _field_inputs(spec, 1003, rng, dev)
    n_mod = spec.modulus
    host = torch.as_tensor(F.encode(spec, [pow(x, n_mod - 2, n_mod) for x in F.decode(spec, a)]).astype(np.int32),
                           device=dev)
    err = 0.0
    for n in (1, 2, 3, 32, 1003):
        got = MK.mont_inv(spec, a[:n])
        err = max(err, _check_equal(f"{name} ({n} rows)", got, MK.mont_inv_plain(spec, a[:n])))
        _check_equal(f"{name} ({n} rows) against host pow(x, N - 2, N)", got, host[:n])
    _check_equal(f"{name} against the Fermat chain over the plain product (32 rows)", MK.mont_inv(spec, a[:32]),
                 MK.fermat_chain(spec, a[:32], lambda x, y: MK.mont_mul_plain(spec, x, y)))
    if F.decode(spec, MK.mont_inv(spec, a[:1])) != [0]:
        raise AssertionError(f"{name}: 0 does not map to 0")
    row = a[3:4]  # the Montgomery form of 2
    # the Fermat chain: the table, then 4 + 1 per lower nibble: 489 for Fq, 329 for Fr
    chain = 14 + 5 * (len(spec.inv_exp_nibbles) - 1)

    def old_chain():
        return MK.fermat_chain(spec, row, lambda x, y: F.mont_mul(spec, x, y))

    _check_equal(f"{name} vs the mont_mul chain", MK.mont_inv(spec, row), old_chain())

    def timed(rows):
        return _kernel_ms(lambda x: MK.mont_inv(spec, x), (rows,), 2 * rows.shape[0] * spec.L * 4, launches=20,
                          from_hbm=False)

    r = {
        "n": 1, "max_abs_err": err,
        "ms": timed(row),
        "eager_ms": _median_ms(lambda: MK.mont_inv(spec, row), 10),
        "plain_ms": _median_ms(lambda: MK.mont_inv_plain(spec, row), 3),
        "ops_ms": _imad_ms(_divstep_ops(spec)), "bytes": 2 * spec.L * 4,
        "inputs": "one row, latency-bound",
        "ms_1003": timed(a),
    }
    from masp_tpu_torch.kernels import build

    log(f"kernel {name}: ptxas {ptxas_report(build)[name]} (registers, shared bytes, spill)")
    log(f"kernel {name}: {r['ms']:.4f} ms per launch in a CUDA graph at 1 row ({r['ms_1003']:.4f} ms at 1003 "
        f"rows), {r['eager_ms']:.4f} ms eager; plain (the divstep GCD on Python ints at 1 row) {r['plain_ms']:.3f} "
        f"ms; operations {_divstep_ops(spec)} a row, {r['ops_ms']:.7f} ms at the INT32 rate; the "
        f"{chain}-launch eager mont_mul_{spec.name.lower()} chain: {_median_ms(old_chain, 3):.3f} ms (median of 3) "
        f"on {card}")
    return r


def _affine_inputs(rows_np, n, dev):
    """(P1, P2) affine rows [x | y | f] (n, 2k + 1) from encoded projective
    points (n, 3k), G1 or G2, with P+P, P+(-P), identity+P, P+identity,
    identity+identity, and a flagged lane over an unrelated point's
    coordinates in the first lanes."""
    import torch

    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops.field import FQ

    k = rows_np.shape[1] // 3
    reps = -(-(n + 7) // rows_np.shape[0])
    base = torch.as_tensor(np.tile(rows_np, (reps, 1))[: n + 7], device=dev)
    aff = torch.cat([base[:, : 2 * k], (base[:, 2 * k :] == 0).all(dim=1, keepdim=True).to(torch.int32)], dim=1)
    P1, P2 = aff[:n].clone(), aff[7 : n + 7].clone()
    ident = torch.zeros(2 * k + 1, dtype=torch.int32, device=dev)
    ident[k : k + FQ.L] = FQ.const("ONE_MONT", dev)
    ident[2 * k] = 1
    P2[0] = P1[0]
    P2[1] = P1[1]
    P2[1, k : 2 * k] = F.neg(FQ, P1[1, k : 2 * k].reshape(-1, FQ.L)).reshape(-1)
    P1[2] = ident
    P2[3] = ident
    P1[4], P2[4] = ident, ident
    P1[5, 2 * k] = 1  # the identity, over another point's coordinates
    return P1, P2


def _chunked(fn, n, *args, chunk=AFFINE_LEVEL_LANES):
    """fn over lane chunks of its (n, ...) arguments, outputs concatenated:
    the plain versions hold (chunk, 24, 24) int64 products per field
    product, which at 2^21 lanes would take ~20 GB at once."""
    import torch

    parts = [fn(*(a[i : i + chunk] for a in args)) for i in range(0, n, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def affine_instance_phase(group, rows_np, dev, card: str) -> dict:
    """affine_pre and affine_post of one group at its level-0 width, bit for
    bit against their plain versions: contiguous, strided (as the ladder
    passes them) and ragged (1003 lanes), with the edge lanes' case codes and
    identity flags."""
    import torch

    from masp_tpu_torch.kernels import affine as AK
    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops.field import FQ

    n = AFFINE_LANES[group]
    sfx = "" if group == 1 else "_g2"
    P1, P2 = _affine_inputs(rows_np, n, dev)
    row = P1.shape[1]
    pairs = torch.cat([P1, P2], dim=1)  # strided operands, as the ladder passes them
    S1, S2 = pairs[:, :row], pairs[:, row:]
    pre = AK.affine_pre(P1, P2)
    pre_plain = _chunked(AK.affine_pre_plain, n, P1, P2)
    err = max(_check_equal(f"affine_pre{sfx} {part}", got, want)
              for part, got, want in zip(("n", "norm", "code"), pre, pre_plain))
    codes = pre[2][:6].tolist()
    if codes != [8, 4, 1, 2, 3, 1]:
        raise AssertionError(f"affine_pre{sfx}: edge-lane case codes {codes}, want [8, 4, 1, 2, 3, 1]")
    for part, got, want in zip(("n", "norm", "code"), AK.affine_pre(S1, S2), pre):
        _check_equal(f"affine_pre{sfx} {part} (strided)", got, want)
    for part, got, want in zip(("n", "norm", "code"), AK.affine_pre(P1[:1003], P2[:1003]),
                               AK.affine_pre_plain(P1[:1003], P2[:1003])):
        _check_equal(f"affine_pre{sfx} {part} (ragged)", got, want)
    nn, norm, code = pre
    ninv = F.tree_batch_inv(FQ, norm)
    post = AK.affine_post(nn, ninv, P1, P2, code)
    post_err = _check_equal(f"affine_post{sfx}", post, _chunked(AK.affine_post_plain, n, nn, ninv, P1, P2, code))
    _check_equal(f"affine_post{sfx} (strided)", AK.affine_post(nn, ninv, S1, S2, code), post)
    _check_equal(f"affine_post{sfx} (ragged)", AK.affine_post(nn[:1003], ninv[:1003], P1[:1003], P2[:1003], code[:1003]),
                 AK.affine_post_plain(nn[:1003], ninv[:1003], P1[:1003], P2[:1003], code[:1003]))
    flags = post[:6, -1].tolist()
    if flags != [0, 1, 0, 0, 1, 0]:
        raise AssertionError(f"affine_post{sfx}: edge-lane identity flags {flags}, want [0, 1, 0, 0, 1, 0]")
    # Fq products the lanes need: pre squares x1 on doubling lanes (1 on
    # G1, 2 on G2) and forms the G2 norm (2); post runs on lanes that add
    # (code 0 or 8): lam, lam^2, y3 on G1, and d^-1, lam, lam^2, y3 (2 + 3
    # + 2 + 3) on G2
    dbl = int(((code & 8) != 0).sum())
    adds = int(((code & 7) == 0).sum())
    pre_products = dbl * group + (0 if group == 1 else 2 * n)
    post_products = adds * (3 if group == 1 else 10)
    k = (row - 1) // 2
    # rows 2 x row in, n (k), the norm (24) and the code out
    pre_bytes = n * 4 * (2 * row + k + FQ.L + 1)
    # n, the norm's inverse, 2 rows and the code in, one row out
    post_bytes = n * 4 * (k + FQ.L + 2 * row + 1 + row)
    log(f"affine{sfx} lanes at {n}: {dbl} doubling, {adds} adding, {n - adds - dbl} pass-through or identity")
    return {
        "affine_pre" + sfx: {
            "n": n, "max_abs_err": err,
            "ms": _kernel_ms(AK.affine_pre, (S1, S2), pre_bytes),
            "eager_ms": _median_ms(lambda: AK.affine_pre(S1, S2), 10),
            "plain_ms": _median_ms(lambda: _chunked(AK.affine_pre_plain, n, P1, P2), 3),
            "ops_ms": _imad_ms(pre_products * FQ_IMAD), "bytes": pre_bytes,
        },
        "affine_post" + sfx: {
            "n": n, "max_abs_err": post_err,
            "ms": _kernel_ms(AK.affine_post, (nn, ninv, S1, S2, code), post_bytes),
            "eager_ms": _median_ms(lambda: AK.affine_post(nn, ninv, S1, S2, code), 10),
            "plain_ms": _median_ms(lambda: _chunked(AK.affine_post_plain, n, nn, ninv, P1, P2, code), 3),
            "ops_ms": _imad_ms(post_products * FQ_IMAD), "bytes": post_bytes,
        },
    }


def affine_kernel_phase(params, dev, card: str) -> dict:
    """Both groups' affine_pre and affine_post (affine_instance_phase), the
    G1 composite affine_level at 2^19 lanes and one G2 level at b_g2's
    level-0 width, each bit for bit against its plain level; the levels'
    times and launches, and the root inverse's."""
    import torch

    from masp_tpu_torch.kernels import LAUNCHES, affine as AK
    from masp_tpu_torch.ops import field as F, msm_sorted as MS
    from masp_tpu_torch.ops.field import FQ

    out = {**affine_instance_phase(1, params.h, dev, card), **affine_instance_phase(2, params.b_g2, dev, card)}
    m = AFFINE_LEVEL_LANES
    P1, P2 = _affine_inputs(params.h, m, dev)
    pairs = torch.cat([P1, P2], dim=1)
    S1, S2 = pairs[:, : P1.shape[1]], pairs[:, P1.shape[1] :]
    _check_equal("affine_level", AK.affine_level(S1, S2), AK.affine_level_plain(P1, P2))
    log(f"kernel affine_level: {m} lanes bit-identical to affine_level_plain (tolerance: exact); "
        f"{_median_ms(lambda: AK.affine_level(S1, S2), 3):.3f} ms at {m} lanes (median of 3) on {card}")
    # one G2 level at the b_g2 full part's level-0 width (32 windows x 2^14
    # points): pre, the Fq tree over the norms, post
    g2 = torch.as_tensor(np.tile(params.b_g2, (-(-m // params.b_g2.shape[0]), 1))[:m], device=dev)
    g2 = torch.cat([g2[:, :96], (g2[:, 96:] == 0).all(dim=1, keepdim=True).to(torch.int32)], dim=1)
    got = MS._affine_halve(g2)
    _check_equal("G2 affine level", got, AK.affine_level_plain(g2[0::2], g2[1::2]))
    before = dict(LAUNCHES)
    MS._affine_halve(g2)
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    log(f"G2 affine level: {m // 2} pairs bit-identical to affine_level_plain (tolerance: exact); "
        f"{_median_ms(lambda: MS._affine_halve(g2), 3):.3f} ms (median of 3), launches {json.dumps(launches)} "
        f"on {card}")
    root = P1[8:9, :24].contiguous()
    before = dict(LAUNCHES)
    F.mont_inv_small(FQ, root)
    launches = {k: LAUNCHES[k] - before[k] for k in ("mont_mul_fq", "mont_inv_fq")}
    ms = _median_ms(lambda: F.mont_inv_small(FQ, root), 3)
    log(f"root inverse of one affine level (G1 and G2 alike, one Fq row): launches {json.dumps(launches)}, "
        f"{ms:.3f} ms (median of 3) on {card}")
    return out


def _int_mm_ms(x, w, want, nbytes):
    """torch._int_mm's time at the shape, timed as the kernels are (in a
    CUDA graph), the int8 kernels' yardstick (the port never calls it):
    (ms, None), or (None, why) when it refuses."""
    import torch

    try:
        got = torch._int_mm(x, w)
    except RuntimeError as e:
        return None, f"torch._int_mm refused {tuple(x.shape)} @ {tuple(w.shape)}: {e}".splitlines()[0]
    _check_equal("torch._int_mm (yardstick)", got, want)
    return _kernel_ms(torch._int_mm, (x, w), nbytes), None


def _int8_loop_sass() -> dict:
    """int8_dot_loop_kernel's static SASS (cuobjdump -sass): its tensor-core
    instructions by opcode. The int8 wgmma is IGMMA; an HGMMA with RZ
    operands is the compiler's own, none of the kernel's products. Fails
    without IGMMA, or with IMMA (mma.sync)."""
    from collections import Counter
    from pathlib import Path

    from masp_tpu_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        raise AssertionError(f"sass: no cuobjdump beside nvcc ({tool}): int8_dot_loop's wgmma not shown")
    text = subprocess.run([str(tool), "-sass", str(build.lib_path("int8_dot"))], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    found = [ins for f, ins in _sass_functions(text).items() if "int8_dot_loop_kernel" in f]
    if len(found) != 1:
        raise AssertionError(f"sass: {len(found)} functions of int8_dot.cu match int8_dot_loop_kernel")
    c = Counter(op for _, op, _ in found[0])
    r = {"instructions": sum(c.values()), **{op: c[op] for op in sorted(c) if "MMA" in op}}
    log(f"  sass int8_dot_loop_kernel: {r['instructions']} instructions (static); tensor-core instructions "
        f"{json.dumps({k: v for k, v in r.items() if 'MMA' in k})}")
    if not r.get("IGMMA") or r.get("IMMA"):
        raise AssertionError("sass: int8_dot_loop_kernel does not issue wgmma (IGMMA) alone")
    return r


def _int8_loop_sms(x, w, card: str) -> int:
    """The SMs that one launch of int8_dot_loop_kernel ran on at x @ w and
    64 products, from the INT8_PROBE build's record of each CTA's SM (that
    build's result checked too): each CTA must have an SM of its own. A
    measurement's build, called through its own C entry, so its launches
    are not counted."""
    import ctypes

    import torch

    from masp_tpu_torch.kernels import build
    from masp_tpu_torch.kernels import int8_dot as I8

    (M, K), N = x.shape, w.shape[1]
    lib = build.library("int8_dot", INT8_PROBE)
    fn = lib.masp_int8_dot_loop
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, 64, torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("int8_dot_loop (probe build): the launch failed")
    _check_equal("int8_dot_loop (probe build)", out, I8.int8_dot_loop_plain(x, w, 64))
    ctas = -(-M // I8.LOOP_TILE_M) * -(-N // I8.LOOP_TILE_N) * I8.CLUSTER
    sms = (ctypes.c_int * ctas)()
    if lib.masp_int8_dot_loop_smids(sms, ctas) != 0:
        raise RuntimeError("int8_dot_loop (probe build): the SM record could not be read")
    distinct = len(set(sms))
    log(f"kernel int8_dot_loop SMs (probe build): one launch at ({M},{K})@({K},{N}) ran {ctas} CTAs on {distinct} "
        f"distinct SMs (clusters of {I8.CLUSTER}), on {card}")
    if distinct != ctas:
        raise AssertionError(f"int8_dot_loop: {ctas} CTAs ran on {distinct} SMs; each must have one of its own")
    return distinct


def tools_phase(dev, rng, card) -> dict:
    """The tools' kernels against their plain versions, bit for bit (the
    tolerance is exact equality): int8_dot at the tools' (1024, 48) @ (48,
    96), on the full signed range, at a ragged (1003, 40) @ (40, 90) and
    (1003, 37) @ (37, 90), and at K = 1 and K = 64; int8_dot_loop at the
    same five shapes, each on the tools' unsigned and the full signed range,
    at k in INT8_LOOP_KS and R - 1, R + 1 (R rep slices), its SASS (wgmma
    alone) and the SMs of one launch (each CTA on its own);
    mont_mul_mxu against its plain version,
    mont_mul and mont_mul_plain at 2^17 reduced Fq rows with the edge lanes
    first (0, 1, q - 1, 2, q - 2 in Montgomery form and the raw 1) and at
    1003 rows (also as contiguous rows one int32 into their buffer, not
    16-byte aligned), and timed beside mont_mul_fq on the same rows. Then both tools' main at full size, with the launch counts
    zeroed just before and read just after: each of the three kernels must
    have launched there."""
    import torch

    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.kernels import int8_dot as I8, mont_mul as MK, mont_mul_mxu as MX
    from masp_tpu_torch.ops.field import FQ
    from masp_tpu_torch.tools import bench_kernel_micro, exp_mxu_mont

    nrng = np.random.default_rng(rng.randrange(1 << 30))
    M, K, N = bench_kernel_micro.DOT_SHAPE
    x = torch.as_tensor(nrng.integers(0, 127, (M, K), dtype=np.int8), device=dev)
    w = torch.as_tensor(nrng.integers(0, 127, (K, N), dtype=np.int8), device=dev)
    xs_np = nrng.integers(-128, 128, (M, K), dtype=np.int8)
    ws_np = nrng.integers(-128, 128, (K, N), dtype=np.int8)
    xs_np[0], ws_np[:, 0], xs_np[1], ws_np[:, 1] = -128, -128, 127, 127  # the range's ends meet
    xs, ws = torch.as_tensor(xs_np, device=dev), torch.as_tensor(ws_np, device=dev)
    plain = I8.int8_dot_plain(x, w)
    err = _check_equal("int8_dot", I8.int8_dot(x, w), plain)
    _check_equal("int8_dot (signed range)", I8.int8_dot(xs, ws), I8.int8_dot_plain(xs, ws))
    xr, wr = xs[:1003, :40].contiguous(), ws[:40, :90].contiguous()
    _check_equal("int8_dot (ragged 1003 x 40 x 90)", I8.int8_dot(xr, wr), I8.int8_dot_plain(xr, wr))
    # a depth that is not a multiple of 4 (the byte path for x), and the
    # least and the greatest depth the kernel takes, on the signed range
    x64 = torch.as_tensor(nrng.integers(-128, 128, (M, 64), dtype=np.int8), device=dev)
    w64 = torch.as_tensor(nrng.integers(-128, 128, (64, N), dtype=np.int8), device=dev)
    for label, (p, q) in (("ragged 1003 x 37 x 90", (xs[:1003, :37], ws[:37, :90])),
                          ("K = 1", (x64[:, :1], w64[:1])), ("K = 64", (x64, w64))):
        p, q = p.contiguous(), q.contiguous()
        _check_equal(f"int8_dot ({label})", I8.int8_dot(p, q), I8.int8_dot_plain(p, q))
    # the loop at the same shapes, on both ranges (the unsigned one's 32768
    # sums wrap past 2^31)
    u64 = torch.as_tensor(nrng.integers(0, 127, (M, 64), dtype=np.int8), device=dev)
    v64 = torch.as_tensor(nrng.integers(0, 127, (64, N), dtype=np.int8), device=dev)
    slices = I8.CLUSTER
    loop_ks = sorted(set(INT8_LOOP_KS) | {slices - 1, slices + 1})
    loop_err = 0.0
    for rng_label, (p0, q0, p64, q64) in (("unsigned", (x, w, u64, v64)), ("signed", (xs, ws, x64, w64))):
        for label, (p, q) in (("1024 x 48 x 96", (p0, q0)), ("1003 x 40 x 90", (p64[:1003, :40], q64[:40, :90])),
                              ("1003 x 37 x 90", (p64[:1003, :37], q64[:37, :90])), ("K = 1", (p64[:, :1], q64[:1])),
                              ("K = 64", (p64, q64))):
            p, q = p.contiguous(), q.contiguous()
            for k in loop_ks:
                loop_err = max(loop_err, _check_equal(f"int8_dot_loop k={k} ({label}, {rng_label})",
                                                      I8.int8_dot_loop(p, q, k), I8.int8_dot_loop_plain(p, q, k)))
    log(f"kernel int8_dot_loop: bit-identical to int8_dot_loop_plain at k = {loop_ks} on (1024,48)@(48,96), "
        f"(1003,40)@(40,90), (1003,37)@(37,90), K = 1 and K = 64, each on the unsigned and the signed range, "
        f"on {card}")
    loop_sass = _int8_loop_sass()
    loop_sms = _int8_loop_sms(x, w, card)
    n = 1 << 17
    a, b = _field_inputs(FQ, n, rng, dev)
    mxu = MX.mont_mul_mxu(FQ, a, b)
    mxu_err = _check_equal("mont_mul_mxu", mxu, MX.mont_mul_mxu_plain(FQ, a, b))
    _check_equal("mont_mul_mxu vs mont_mul (kernel)", mxu, MK.mont_mul(FQ, a, b))
    _check_equal("mont_mul_mxu vs mont_mul_plain", mxu, MK.mont_mul_plain(FQ, a, b))
    ar, br = a[:1003], b[:1003]
    _check_equal("mont_mul_mxu (ragged)", MX.mont_mul_mxu(FQ, ar, br), MX.mont_mul_mxu_plain(FQ, ar, br))
    _check_equal("mont_mul_mxu (ragged) vs mont_mul", MX.mont_mul_mxu(FQ, ar, br), MK.mont_mul(FQ, ar, br))
    # contiguous rows one int32 into their buffer: the kernel's 4-byte staging
    bufs = torch.zeros((2, 1003 * FQ.L + 1), dtype=torch.int32, device=dev)
    bufs[0, 1:], bufs[1, 1:] = ar.reshape(-1), br.reshape(-1)
    au, bu = (bufs[i, 1:].view(1003, FQ.L) for i in (0, 1))
    _check_equal("mont_mul_mxu (unaligned)", MX.mont_mul_mxu(FQ, au, bu), MX.mont_mul_mxu_plain(FQ, ar, br))
    _check_equal("mont_mul_mxu (unaligned) vs mont_mul", MX.mont_mul_mxu(FQ, au, bu), MK.mont_mul(FQ, ar, br))

    dot_bytes, mxu_bytes = M * K + K * N + 4 * M * N, 3 * n * FQ.L * 4
    lib_ms, why = _int_mm_ms(x, w, plain, dot_bytes)
    # the loop's yardstick: one product of the K-tiled operands, the sum of 64
    xt, wt = x.repeat(1, 64), w.repeat(64, 1)
    loop_lib_ms, loop_why = _int_mm_ms(xt, wt, I8.int8_dot_loop_plain(x, w, 64), 64 * K * (M + N) + 4 * M * N)
    out = {
        "int8_dot": {
            "n": M, "max_abs_err": err, "library_ms": lib_ms,
            "ms": _kernel_ms(I8.int8_dot, (x, w), dot_bytes),
            "eager_ms": _median_ms(lambda: I8.int8_dot(x, w), 10),
            "plain_ms": _median_ms(lambda: I8.int8_dot_plain(x, w), 3),
            "ops_ms": 1e3 * M * K * N / INT8_MAC_PER_S, "bytes": dot_bytes,
        },
        "int8_dot_loop": {
            "n": M, "max_abs_err": loop_err, "library_ms": loop_lib_ms, "sass": loop_sass, "probe_sms": loop_sms,
            "rep_bound_ms": 1e3 * M * K * N / INT8_MAC_PER_S,
            "ms": _kernel_ms(lambda p, q: I8.int8_dot_loop(p, q, 64), (x, w), dot_bytes),
            "k8_ms": _kernel_ms(lambda p, q: I8.int8_dot_loop(p, q, 8), (x, w), dot_bytes),
            "eager_ms": _median_ms(lambda: I8.int8_dot_loop(x, w, 64), 10),
            "plain_ms": _median_ms(lambda: I8.int8_dot_loop_plain(x, w, 64), 3),
            "ops_ms": 1e3 * 64 * M * K * N / INT8_MAC_PER_S, "bytes": dot_bytes,
        },
        "mont_mul_mxu": {
            "n": n, "max_abs_err": mxu_err, "library_ms": None,
            "ms": _kernel_ms(lambda p, q: MX.mont_mul_mxu(FQ, p, q), (a, b), mxu_bytes),
            "eager_ms": _median_ms(lambda: MX.mont_mul_mxu(FQ, a, b), 10),
            "plain_ms": _median_ms(lambda: MX.mont_mul_mxu_plain(FQ, a, b), 3),
            # the product phase's 2 W^2 IMADs (W = 12); the reductions run on the tensor cores
            "ops_ms": _imad_ms(n * 2 * 144), "bytes": mxu_bytes,
        },
    }
    for name, r in out.items():
        bytes_ms, ops_ms = _set_bound(r)
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
        log(f"kernel {name}: n={r['n']} bit-identical to plain (tolerance: exact; max_abs_err {r['max_abs_err']}); "
            f"kernel {r['ms']:.4f} ms per launch in a CUDA graph, inputs from HBM ({r['eager_ms']:.4f} ms "
            f"eager, median of 10), "
            f"plain {r['plain_ms']:.3f} ms (median of 3), library {lib}, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}; bytes {bytes_ms:.6f} ms, operations {ops_ms:.6f} ms "
            f"at the data sheet's {'1,979 int8 TOPS' if name.startswith('int8') else 'INT32 IMAD rate'}) on {card}")
    for name, reason in (("int8_dot", why), ("int8_dot_loop", loop_why)):
        if reason:
            log(f"kernel {name}: library_ms null: {reason}")
    # the tool's question on this card: the tensor-core reductions against the integer product
    out["mont_mul_mxu"]["mont_mul_fq_ms"] = _kernel_ms(lambda p, q: MK.mont_mul(FQ, p, q), (a, b), mxu_bytes)
    log(f"kernel mont_mul_fq at the same {n} rows: {out['mont_mul_mxu']['mont_mul_fq_ms']:.4f} ms per launch in a "
        f"CUDA graph, inputs from HBM, against mont_mul_mxu's {out['mont_mul_mxu']['ms']:.4f} ms on {card}")

    reset_launches()
    t0 = time.perf_counter()
    report = bench_kernel_micro.main("cuda", log=lambda m: log(f"[bench_kernel_micro] {m}"))
    exp_mxu_mont.main("cuda", log=lambda m: log(f"[exp_mxu_mont] {m}"))
    launches = dict(LAUNCHES)
    log(f"[tools] both tools at full size in {time.perf_counter() - t0:.1f} s; launches that ran eagerly "
        f"(graph captures and replays not counted): {json.dumps({k: launches[k] for k in TOOL_KERNELS})}")
    for name in TOOL_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[tools] kernel {name} was not launched by the tools")
        out[name]["launches"] = launches[name]
    # the loop's time a product: the tool's graph slope from 4096 to 32768
    # products; its fixed cost: a launch of 8 products in a graph of many
    # (the slope's constant, one launch a graph, is mostly that graph's
    # replay floor, and is logged, not reported as the kernel's)
    rate = report["int8_dot_loop"][(4096, 32768)]
    loop = out["int8_dot_loop"]
    loop["rep_ms"] = rate["graph"]
    lib = "refused" if loop["library_ms"] is None else f"{loop['library_ms']:.4f} ms"
    log(f"kernel int8_dot_loop: {1e6 * loop['rep_ms']:.3f} ns a product (graph slope, 4096 -> 32768) against its "
        f"bound {1e6 * loop['rep_bound_ms']:.3f} ns ({loop['rep_bound_ms'] / loop['rep_ms']:.1%}); a launch in a "
        f"CUDA graph of many (inputs from HBM) {loop['k8_ms']:.4f} ms at k = 8 (the fixed cost), {loop['ms']:.4f} ms "
        f"at k = 64; the slope's constant {rate['graph_const']:.4f} ms (one launch a graph: its replay floor "
        f"included); torch._int_mm of the K-tiled operands {lib}, on {card}")
    return out


def prove_phase(label, asm, params, rs, check, card, dev, must_launch):
    """One warm-up proof, then len(rs) - 1 timed proofs with the stage spans
    and the launch counts, which start at 0 just before the timed proofs.
    Every timed proof must pass ``check``; every kernel in must_launch must
    have launched. Returns (proofs, launches)."""
    from masp_tpu_torch.groth16 import create_proof_from_assembly
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    create_proof_from_assembly(asm, params, *rs[0], device=dev)
    log(f"[{label}] warm-up proof: {time.perf_counter() - t0:.2f} s")
    tracing.enable()
    tracing.reset()
    reset_launches()
    times, proofs = [], []
    for r, s in rs[1:]:
        t0 = time.perf_counter()
        proofs.append(create_proof_from_assembly(asm, params, r, s, device=dev))
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    stages = tracing.stats()
    tracing.enable(False)
    log(f"[{label}] proofs: {[round(t, 4) for t in times]} s; median {np.median(times):.4f} s; "
        f"{len(times) / sum(times):.3f} proofs/s on {card}")
    for name, st in stages.items():
        dev_ms = "n/a" if st["device_ms"] is None else f"{st['device_ms'] / st['count']:.2f} ms"
        log(f"[{label}]   stage {name}: host {1e3 * st['host_s'] / st['count']:.2f} ms, stream {dev_ms} per proof")
    log(f"[{label}] launches over {len(times)} proofs: {json.dumps(launches)}")
    for name in must_launch:
        if launches[name] <= 0:
            raise AssertionError(f"[{label}] kernel {name} was not launched on the proof path")
    for (r, s), proof in zip(rs[1:], proofs):
        check(r, s, proof)
    log(f"[{label}] all {len(proofs)} proofs pass verify_proof and equal the toxic-waste oracle")
    return proofs, launches


def profile_proof(label, asm, params, rs, dev, card):
    """One proof under torch.profiler (device activity only): the device's
    busy time against the wall time, its activities and PyTorch's copy
    kernels, the kernels that take the most, and every point add,
    Montgomery product and inversion."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masp_tpu_torch.groth16 import create_proof_from_assembly

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        create_proof_from_assembly(asm, params, *rs, device=dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[{label}] profiled proof: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%, idle {100 - 100 * busy_ms / wall_ms:.1f}%) on {card}")
    copies = [e for e in events if "copy" in e.key and not e.key.startswith("Memcpy")]
    log(f"[{label}]   {sum(e.count for e in events)} device activities; PyTorch's copy kernels "
        f"{sum(e.self_device_time_total for e in copies) / 1e3:.2f} ms in {sum(e.count for e in copies)} launches")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        log(f"[{label}]   {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} calls  {e.key[:90]}")
    for e in events:  # every point-add instance (the leaf forms among them), product and inversion
        if "add_kernel" in e.key or "mont_mul_kernel" in e.key or "mont_inv_kernel" in e.key:
            log(f"[{label}]   kernel: {e.self_device_time_total / 1e3:.2f} ms {e.count} calls  {e.key[:90]}")


# --- the real circuits --------------------------------------------------------------

def circuit_phase(kind: str, dev, rng, card: str, profile: bool = False) -> dict:
    """One real circuit through the port in the default MSM configuration:
    its structure from the host copies, held against the pinned counts and
    digest; parameters on the card from seeded toxic waste; bench.py's
    fixture; one warm-up proof, whose witness records the tape; then
    CIRCUIT_PROOFS[kind] timed proofs, each from a fresh witness, with the
    launch counts zeroed just before them. Every timed witness must come from
    the native tape, every timed proof must pass the host verifier with the
    fixture's public inputs and equal the toxic-waste oracle, and every scan
    kernel must have launched. Returns the launches and times."""
    import torch

    from masp_tpu_torch.groth16 import create_proof_from_assembly, generate_parameters
    from masp_tpu_torch.groth16.generator import eval_at_tau
    from masp_tpu_torch.groth16.synthesis import structure_assembly, synthesize_witness
    from masp_tpu_torch.host.circuits.convert import Convert
    from masp_tpu_torch.host.circuits.sapling import Output, Spend
    from masp_tpu_torch.host.r1cs.cs import TestConstraintSystem
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.ops import msm_sorted as MS
    from masp_tpu_torch.tools.fixtures import fixture
    from masp_tpu_torch.utils import tracing

    label = f"circuit {kind}"
    cls = {"spend": Spend, "output": Output, "convert": Convert}[kind]
    n_pin, inputs_pin, _ = CIRCUITS[kind]
    t0 = time.perf_counter()
    asm = structure_assembly(cls)
    t1 = time.perf_counter()
    tcs = TestConstraintSystem()
    cls().synthesize(tcs)
    digest = tcs.hash()
    log(f"[{label}] structure in {t1 - t0:.1f} s (input constraints included): "
        f"{json.dumps(r1cs_counts(asm))}; TestConstraintSystem in {time.perf_counter() - t1:.1f} s: "
        f"{tcs.num_constraints} constraints, {tcs.num_inputs} inputs, digest {digest}")
    if (tcs.num_constraints, tcs.num_inputs, digest) != CIRCUITS[kind]:
        raise AssertionError(f"[{label}] counts or digest differ from the pins {CIRCUITS[kind]}")
    if (asm.num_constraints, asm.num_inputs) != (n_pin + inputs_pin, inputs_pin):
        raise AssertionError(f"[{label}] the structure has {asm.num_constraints} constraints and "
                             f"{asm.num_inputs} inputs, the pins {n_pin} + {inputs_pin} and {inputs_pin}")
    tau, alpha, beta, gamma, delta = (rng.randrange(1, 1 << 250) for _ in range(5))
    t0 = time.perf_counter()
    params = generate_parameters(asm, tau, alpha, beta, gamma, delta, device=dev)
    torch.cuda.synchronize()
    log(f"[{label}] parameters on the card in {time.perf_counter() - t0:.1f} s "
        f"(h {len(params.h)}, l {len(params.l)}, a {len(params.a)}, b {len(params.b_g1)})")
    u, v, w = eval_at_tau(asm, tau, 1 << (asm.num_constraints - 1).bit_length())
    pvk = prepare_verifying_key(params.vk)
    t0 = time.perf_counter()
    make, publics = fixture(kind)
    log(f"[{label}] bench.py's fixture in {time.perf_counter() - t0:.2f} s; {len(publics)} public inputs")
    rs = [(rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)) for _ in range(1 + CIRCUIT_PROOFS[kind])]

    t0 = time.perf_counter()
    wasm, route = synthesize_witness(make())
    t1 = time.perf_counter()
    create_proof_from_assembly(wasm, params, *rs[0], device=dev)
    log(f"[{label}] warm-up: witness {t1 - t0:.2f} s ({route} route; records the tape), "
        f"proof {time.perf_counter() - t1:.2f} s; MSM configuration: "
        f"{'affine' if MS.AFFINE_LADDER else 'scan'} ladder (the default)")
    tracing.enable()
    tracing.reset()
    reset_launches()
    runs = []
    for r, s in rs[1:]:
        t0 = time.perf_counter()
        wasm, route = synthesize_witness(make())
        t1 = time.perf_counter()
        proof = create_proof_from_assembly(wasm, params, r, s, device=dev)
        runs.append((route, t1 - t0, time.perf_counter() - t1, wasm, proof, r, s))
    launches = dict(LAUNCHES)
    stages = tracing.stats()
    tracing.enable(False)
    for i, (route, wit_s, proof_s, *_) in enumerate(runs):
        log(f"[{label}] proof {i + 1}: witness {1e3 * wit_s:.2f} ms (host, {route} route), proof "
            f"{1e3 * proof_s:.2f} ms, witness + proof {1e3 * (wit_s + proof_s):.2f} ms on {card}")
    for name, st in stages.items():
        dev_ms = "n/a" if st["device_ms"] is None else f"{st['device_ms'] / st['count']:.2f} ms"
        log(f"[{label}]   stage {name}: host {1e3 * st['host_s'] / st['count']:.2f} ms, stream {dev_ms} per proof")
    log(f"[{label}] launches over {len(runs)} proofs: {json.dumps(launches)}")
    for name in SCAN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[{label}] kernel {name} was not launched on the proof path")
    for route, _, _, wasm, proof, r, s in runs:
        if route != "tape":
            raise AssertionError(f"[{label}] the witness came from the {route} route, not the native tape")
        if not verify_proof(pvk, proof, publics):
            raise AssertionError(f"[{label}] a proof failed the host pairing verifier")
        z = [int.from_bytes(row.tobytes(), "little") for row in wasm.assignment]
        if proof != oracle_proof(u, v, w, z, tau, alpha, beta, delta, r, s, asm.num_inputs):
            raise AssertionError(f"[{label}] a proof differs from the toxic-waste oracle")
    log(f"[{label}] all {len(runs)} proofs pass verify_proof with the fixture's public inputs and equal "
        f"the toxic-waste oracle")
    if profile:
        profile_proof(label, wasm, params, rs[1], dev, card)
    return {"launches": launches, "witness_s": [x[1] for x in runs], "proof_s": [x[2] for x in runs],
            "params": params}


def circuits_phase(dev, rng, card: str, profile: bool = False) -> dict:
    """circuit_phase for Spend (profiled with ``profile``), Output and
    Convert; returns each circuit's launches, times and Parameters."""
    t0 = time.perf_counter()
    out = {kind: circuit_phase(kind, dev, rng, card, profile and kind == "spend") for kind in CIRCUITS}
    log(f"[circuits] Spend, Output and Convert in {time.perf_counter() - t0:.1f} s")
    return out


# --- the bundle ------------------------------------------------------------------

def _per_proof(st: dict, name: str, n: int) -> str:
    """A span's host and stream ms per proof of a batch of n."""
    e = st.get(name)
    if e is None:
        return "n/a"
    dev_ms = "n/a" if e["device_ms"] is None else f"{e['device_ms'] / n:.2f}"
    return f"{1e3 * e['host_s'] / n:.2f} / {dev_ms}"


def batch_phase(circuits: dict, dev, card: str) -> dict:
    """A seeded bundle of BATCH_JOBS Spend, Convert and Output jobs
    (tools/fixtures.jobs) proved through LocalTxProver.prove_jobs on the
    circuits phase's three Parameters, once at each of BATCH_WINDOWS, from an
    XorShiftRng seeded alike each time, with the launch counts zeroed just
    before each; then one Spend job through the singular spend_proof. Every
    witness must come from the native tape, every batch proof must equal the
    single-proof path's proof of the same witness with the (r, s) redrawn as
    prove_jobs draws them, pass the verification context (spend authorising
    signature and verify_proof with its job's public inputs) and survive
    Proof.read as 192 bytes; the self-check (verify_proofs_batch) must have
    passed, the binding signature over the bundle's value balance must pass
    final_check, and every scan kernel must have launched in each run; the
    bundle then goes through BatchValidator (validator_phase) and its Spend
    proofs through both pairing routes (pairing_route_phase). Logs,
    per window and kind, wall time per proof, the witness time, the setup,
    inputs and wait spans, beside the circuits phase's one-at-a-time times.
    Returns the launches per window."""
    from masp_tpu_torch.groth16 import prover as TP
    from masp_tpu_torch.groth16 import sapling_prover as SP
    from masp_tpu_torch.groth16.local_prover import LocalTxProver
    from masp_tpu_torch.host.primitives.sapling import spend_sig
    from masp_tpu_torch.host.rng import XorShiftRng, random_scalar
    from masp_tpu_torch.host.structures import Proof
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.tools.fixtures import jobs
    from masp_tpu_torch.utils import tracing

    kinds = ("spend", "convert", "output")
    t0 = time.perf_counter()
    bundle = jobs(*(BATCH_JOBS[k] for k in kinds), BATCH_SEED)
    prover = LocalTxProver(*(circuits[k]["params"] for k in ("spend", "output", "convert")))
    log(f"[batch] bundle of {json.dumps(BATCH_JOBS)} jobs and the prover's verifying keys in "
        f"{time.perf_counter() - t0:.1f} s; value balance {bundle['value_balance']}")
    kind_of = {id(circuits[k]["params"]): k for k in kinds}
    batch_prove, batch_verify = TP.create_proofs_from_assemblies, SP.verify_proofs_batch
    runs, witnesses, checked = {}, {}, []

    def timed(css, params, rss, *args, **kwargs):
        """The batch prover, timed per kind, its witnesses kept."""
        kind = kind_of[id(params)]
        witnesses[kind] = []

        def keep(css):
            for asm in css:
                witnesses[kind].append(asm)
                yield asm

        tracing.reset()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        proofs = batch_prove(keep(css), params, rss, *args, **kwargs)
        run[kind] = {"wall_s": time.perf_counter() - t0, "n": len(proofs), "stages": tracing.stats(),
                     "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
        return proofs

    def self_check(*args, **kwargs):
        ok = batch_verify(*args, **kwargs)
        checked.append((len(args[2]), ok))
        return ok

    TP.create_proofs_from_assemblies, SP.verify_proofs_batch = timed, self_check
    tracing.enable()
    try:
        for window in BATCH_WINDOWS:
            os.environ["MASP_BATCH_WINDOW"] = str(window)
            run, checked[:] = {}, []
            ctx = prover.new_sapling_proving_context()
            rng = XorShiftRng.from_seed(BATCH_SEED)
            reset_launches()
            t0 = time.perf_counter()
            results = prover.prove_jobs(ctx, *(bundle[k] for k in kinds), rng)
            run["wall_s"] = time.perf_counter() - t0
            run["launches"] = dict(LAUNCHES)
            run["results"] = dict(zip(kinds, results))
            run["self_check"] = list(checked)
            run["binding_sig"] = prover.binding_sig(ctx, bundle["value_balance"], BATCH_SIGHASH, rng)
            runs[window] = run
    finally:
        TP.create_proofs_from_assemblies, SP.verify_proofs_batch = batch_prove, batch_verify
        os.environ.pop("MASP_BATCH_WINDOW", None)
        tracing.enable(False)

    for window, run in runs.items():
        log(f"[batch] window {window}: prove_jobs {run['wall_s']:.3f} s for "
            f"{sum(BATCH_JOBS.values())} proofs on {card}")
        for kind in kinds:
            r, st = run[kind], run[kind]["stages"]
            single = circuits[kind]
            one = [1e3 * (w + p) for w, p in zip(single["witness_s"], single["proof_s"])]
            log(f"[batch]   window {window} {kind}: {1e3 * r['wall_s'] / r['n']:.2f} ms per proof, witness "
                f"included, over {r['n']}; witness/tape host {_per_proof(st, 'witness/tape', r['n'])}; "
                f"setup {_per_proof(st, 'setup', r['n'])}; inputs {_per_proof(st, 'inputs', r['n'])}; "
                f"h_pipeline {_per_proof(st, 'h_pipeline', r['n'])}; wait {_per_proof(st, 'wait', r['n'])}; "
                f"assemble {_per_proof(st, 'assemble', r['n'])} (host / stream ms per proof); one at a time "
                f"(circuits phase, witness + proof): {[round(x, 2) for x in one]} ms")
            per = {k: round(n / r["n"], 2) for k, n in r["launches"].items() if n}
            one = {k: round(n / len(single["proof_s"]), 2) for k, n in single["launches"].items() if n}
            log(f"[batch]   window {window} {kind}: launches per proof {json.dumps(per)}; one at a time "
                f"{json.dumps(one)}")
            log(f"[batch]   window {window} {kind}: inputs host ms of each proof "
                f"{[round(1e3 * x, 2) for x in st['inputs']['host_each_s']]}")
            routes = {name: e["count"] for name, e in st.items() if name.startswith("witness/")}
            if routes != {"witness/tape": BATCH_JOBS[kind]}:
                raise AssertionError(f"[batch] window {window} {kind}: witness routes {routes}, "
                                     f"not {BATCH_JOBS[kind]} from the native tape")
        log(f"[batch] window {window} launches: {json.dumps(run['launches'])}")
        for name in SCAN_KERNELS:
            if run["launches"][name] <= 0:
                raise AssertionError(f"[batch] window {window}: kernel {name} was not launched")
        want = [(BATCH_JOBS["spend"], True), (BATCH_JOBS["convert"], True)]
        if run["self_check"] != want:
            raise AssertionError(f"[batch] window {window}: the self-check ran {run['self_check']}, not {want}")

    # the single-proof path on the same witnesses, with the (r, s) prove_jobs drew
    rng = XorShiftRng.from_seed(BATCH_SEED)
    rs = {k: [(random_scalar(rng).n, random_scalar(rng).n) for _ in bundle[k]] for k in kinds}
    params = {k: circuits[k]["params"] for k in kinds}
    for kind in kinds:
        for i, (asm, (r, s)) in enumerate(zip(witnesses[kind], rs[kind])):
            single = TP.create_proof_from_assembly(asm, params[kind], r, s, device=dev).write()
            for window, run in runs.items():
                blob = run["results"][kind][i][0]
                if blob != single:
                    raise AssertionError(f"[batch] window {window}: {kind} proof {i} differs from the single-proof path")
                if len(blob) != 192 or Proof.read(blob).write() != blob:
                    raise AssertionError(f"[batch] window {window}: {kind} proof {i} does not read back from 192 bytes")
    log(f"[batch] every proof of both windows equals the single-proof path's and reads back from 192 bytes")

    # a verifier's view of the bundle (the windows' proofs are equal), and of
    # each window's binding signature
    t0 = time.perf_counter()
    check = SP.SaplingVerificationContext()
    res = runs[BATCH_WINDOWS[0]]["results"]
    vrng = XorShiftRng.from_seed(BATCH_SEED[::-1])
    sigs = []
    for (blob, cv, rk), job, (anchor, nf), ask in zip(res["spend"], bundle["spend"],
                                                     bundle["verifier"]["spend"], bundle["ask"]):
        sigs.append(spend_sig(ask, job["ar"], BATCH_SIGHASH, vrng))
        if not check.check_spend(cv, anchor, nf, rk, BATCH_SIGHASH, sigs[-1], Proof.read(blob), prover.spend_vk):
            raise AssertionError("[batch] a spend description fails verification")
    for (blob, cv), anchor in zip(res["convert"], bundle["verifier"]["convert"]):
        if not check.check_convert(cv, anchor, Proof.read(blob), prover.convert_vk):
            raise AssertionError("[batch] a convert description fails verification")
    for (blob, cv), (cmu, epk) in zip(res["output"], bundle["verifier"]["output"]):
        if not check.check_output(cv, cmu, epk, Proof.read(blob), prover.output_vk):
            raise AssertionError("[batch] an output description fails verification")
    for window, run in runs.items():
        if not check.final_check(bundle["value_balance"], BATCH_SIGHASH, run["binding_sig"]):
            raise AssertionError(f"[batch] window {window}: the binding signature fails final_check")
    log(f"[batch] every description passes check_spend / check_convert / check_output (verify_proof "
        f"with its job's public inputs), each window's binding signature final_check, and the "
        f"self-check passed: {time.perf_counter() - t0:.1f} s of host verification")
    validator_phase(res, bundle, sigs, runs[BATCH_WINDOWS[0]]["binding_sig"], prover, card)
    pairing_route_phase(res, bundle, prover, card)

    job = bundle["spend"][0]
    ctx = prover.new_sapling_proving_context()
    t0 = time.perf_counter()
    blob, cv, rk = prover.spend_proof(ctx, *(job[f] for f in (
        "proof_generation_key", "diversifier", "rseed", "ar", "asset_type", "value", "anchor",
        "merkle_path", "rcv")))
    wall = time.perf_counter() - t0
    anchor, nf = bundle["verifier"]["spend"][0]
    if len(blob) != 192 or not verify_proof(prover.spend_vk, Proof.read(blob),
                                            SP.spend_public_inputs(rk.point, cv, anchor, nf)):
        raise AssertionError("[batch] the singular spend_proof's proof fails verify_proof")
    log(f"[batch] singular spend_proof: {1e3 * wall:.2f} ms (witness, proof and its self-verification), "
        f"192 bytes, passes verify_proof on {card}")
    return {window: run["launches"] for window, run in runs.items()}


def validator_phase(res, bundle, sigs, binding_sig, prover, card: str) -> None:
    """The bundle's descriptions through BatchValidator (check_bundle, then
    validate: the RedJubjub batches, then each kind's Groth16 batch check),
    once with the signature batches on the host and once on the card
    (use_device_sigs=True, ops/jubjub.batch_verify_device); both must pass,
    and both must reject the bundle with one spend signature altered."""
    from types import SimpleNamespace

    from masp_tpu_torch.groth16 import sapling_prover as SP
    from masp_tpu_torch.host.fields import Scalar
    from masp_tpu_torch.host.primitives.redjubjub import Signature
    from masp_tpu_torch.host.rng import XorShiftRng

    def described(spend_sigs):
        return SimpleNamespace(
            shielded_spends=[SimpleNamespace(cv=cv, rk=rk, spend_auth_sig=sig, zkproof=blob, anchor=Scalar(anchor),
                                             nullifier=nf)
                             for (blob, cv, rk), sig, (anchor, nf) in zip(res["spend"], spend_sigs,
                                                                          bundle["verifier"]["spend"])],
            shielded_converts=[SimpleNamespace(cv=cv, zkproof=blob, anchor=Scalar(anchor))
                               for (blob, cv), anchor in zip(res["convert"], bundle["verifier"]["convert"])],
            shielded_outputs=[SimpleNamespace(cv=cv, zkproof=blob, cmu=Scalar(cmu), ephemeral_key=epk.to_bytes())
                              for (blob, cv), (cmu, epk) in zip(res["output"], bundle["verifier"]["output"])],
            value_balance=bundle["value_balance"],
            authorization=SimpleNamespace(binding_sig=binding_sig))

    s = bytearray(sigs[0].sbar)
    s[0] ^= 1
    altered = [Signature(sigs[0].rbar, bytes(s))] + sigs[1:]
    for label, spend_sigs, want in (("as signed", sigs, True), ("one signature altered", altered, False)):
        for on_card in (False, True):
            validator = SP.BatchValidator()
            if not validator.check_bundle(described(spend_sigs), BATCH_SIGHASH):
                raise AssertionError("[batch] BatchValidator.check_bundle refuses the bundle")
            t0 = time.perf_counter()
            ok = validator.validate(prover.spend_vk, prover.convert_vk, prover.output_vk,
                                    XorShiftRng.from_seed(BATCH_SEED), use_device_sigs=on_card)
            wall = time.perf_counter() - t0
            if ok != want:
                raise AssertionError(f"[batch] BatchValidator.validate(use_device_sigs={on_card}) on the bundle "
                                     f"{label}: {ok}, not {want}")
            log(f"[batch] BatchValidator.validate(use_device_sigs={on_card}) on the bundle {label}: {ok} in "
                f"{wall:.3f} s (signature batches and the Groth16 batch checks) on {card}")


# --- phase jubjub: the Jubjub and Pedersen twins ------------------------------------------

def _jubjub_rows(points, dev):
    """Host Jubjub points -> (n, 48) int32 rows (Z = 1) on the card."""
    import torch

    from masp_tpu_torch.ops import jubjub as J

    return torch.as_tensor(np.concatenate(J.encode_points(points), axis=1).astype(np.int32), device=dev)


def _jubjub_chain(n, seed):
    """n distinct points of the prime-order subgroup: a seeded multiple of
    the spending key generator, then successive additions of it."""
    from masp_tpu_torch.host.fields import JubjubFr
    from masp_tpu_torch.host.primitives.constants import spending_key_generator

    g = spending_key_generator()
    p = g * JubjubFr(random.Random(seed).randrange(1, 1 << 128))
    out = []
    for _ in range(n):
        out.append(p)
        p = p + g
    return out


def _jubjub_cases():
    """The JAX test's batch of every complete-addition case: generic pairs,
    P + P, P + (-P), O + P and the order-2 point (0, -1) twice."""
    from masp_tpu_torch.host.fields import SCALAR_MODULUS, Scalar
    from masp_tpu_torch.host.jubjub import ExtendedPoint

    ps = _jubjub_chain(4, 71)
    qs = _jubjub_chain(4, 72)
    t = ExtendedPoint.from_affine(Scalar(0), Scalar(SCALAR_MODULUS - 1))
    return ps + [ps[0], ps[1], ExtendedPoint.identity(), t], qs + [ps[0], -ps[1], ps[2], t]


def _sqrt_products() -> tuple[int, int]:
    """(squarings, other Fr products) of one square root as fr_sqrt_kernel
    runs it: the 4-bit window's table (a^2 by a squaring, a^3 .. a^15 by
    products) and walk (SQRT_WINDOW squarings a digit after the first, a
    product a non-zero digit), x = a w and b = x w, b^2, one squaring an
    inner step, two squarings and two products a boundary step, and the
    final x^2: 752 squarings and 129 other products."""
    from masp_tpu_torch.kernels import jubjub as KJ

    digits = KJ.SQRT_DIGITS
    table_sqr, table_mul = 1, (1 << KJ.SQRT_WINDOW) - 3
    walk_sqr = KJ.SQRT_WINDOW * (len(digits) - 1)
    walk_mul = sum(1 for d in digits[1:] if d)
    steps = KJ.sqrt_schedule()
    inner = sum(1 for j in steps if j)
    bounds = len(steps) - inner
    return table_sqr + walk_sqr + 1 + inner + 2 * bounds + 1, table_mul + walk_mul + 2 + 2 * bounds


def _two_adic_values(odd: int = 4, seed: int = 0) -> list[int]:
    """Fr values that drive every branch of the Tonelli-Shanks steps: z^(2^k)
    c^2 for k = 1 .. S, whose 2-part has order 2^(S - k) exactly (c^2 = u^(2^S)
    lies in the odd-order subgroup), ``odd`` non-squares z^j c^2 with j odd,
    then 0, 1 and -1."""
    from masp_tpu_torch.kernels import jubjub as KJ
    from masp_tpu_torch.ops.field import FR

    rng, z, r, S = random.Random(seed), KJ.root_of_unity(), FR.modulus, KJ.S

    def c2():
        return pow(rng.randrange(1, r), 1 << S, r)

    vals = [pow(z, 1 << k, r) * c2() % r for k in range(1, S + 1)]
    vals += [pow(z, 2 * rng.randrange(1 << (S - 1)) + 1, r) * c2() % r for _ in range(odd)]
    return vals + [0, 1, r - 1]


def _sqrt_products_bitwise() -> int:
    """The same with the exponent walked bit by bit (a squaring a bit, a
    product a set bit), as the ff crate, the JAX program and the plain version
    walk it: the count behind the square root's bound column (951)."""
    from masp_tpu_torch.kernels import jubjub as KJ

    bits = KJ.sqrt_exponent_bits()
    steps = KJ.sqrt_schedule()
    inner = sum(1 for j in steps if j)
    return len(bits) + sum(bits) + 3 + inner + 4 * (len(steps) - inner) + 1


def _sqrt_rows(n, rng, dev):
    """(n, 16) Montgomery rows for the square root: the values of every
    2-adic order first (_two_adic_values: z^(2^k) c^2 for k = 1 .. 32,
    non-squares, 0, 1, -1), then _field_inputs' rows."""
    import torch

    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops.field import FR

    a, _ = _field_inputs(FR, n, rng, dev)
    edge = _two_adic_values(seed=rng.randrange(1 << 30))[:n]
    a[: len(edge)] = torch.as_tensor(F.encode(FR, edge).astype(np.int32), device=dev)
    return a


def jubjub_kernel_phase(dev, rng, card: str):
    """The three Jubjub kernels bit for bit against their plain versions and
    timed in a CUDA graph from HBM: jubjub_add at JUBJUB_ADD_PAIRS pairs
    (projective operands, the edge lanes first, contiguous, strided and
    unaligned) and on the JAX test's batch of every case (also against the
    host curve);
    fr_sqrt at FR_SQRT_ROWS rows (0, 1, N - 1 among them); pedersen_fold at
    FOLD_CHUNKS chunks and each of FOLD_WIDTHS hashes of seeded digits,
    timed at FOLD_TIMED (FOLD_HASHES is its entry's "ms"). Then the SASS
    counts (jubjub_sass_report). Returns the entries and the add's wide
    operands."""
    import torch

    from masp_tpu_torch.kernels import jubjub as KJ
    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops import jubjub as J
    from masp_tpu_torch.ops import pedersen as PED
    from masp_tpu_torch.ops.field import FR

    out = {}
    prod_imad = 2 * (2 * 64 + 8)  # one fe_mul<Fr>: 2 (2 W^2 + W) multiply-adds, W = 8
    # one fr_mul (the add and the fold): a b's 2 W^2 and m N's 2 W (W - 1),
    # since m = -t0 costs no product and m N[0] = m is an add
    fr_mul_imad = 2 * (2 * 64 - 8)
    # one fr_sqr: T's 28 cross products and 8 squares, and m N's 2 W (W - 1) a row
    fr_sqr_imad = 2 * (28 + 8) + 8 * 2 * 7

    # the add: the all-cases batch, then the wide batch
    ps, qs = _jubjub_cases()
    P8, Q8 = _jubjub_rows(ps, dev), _jubjub_rows(qs, dev)
    got = KJ.jubjub_add(P8, Q8)
    _check_equal("jubjub_add (all cases)", got, KJ.jubjub_add_plain(P8, Q8))
    pairs8 = torch.cat([P8, Q8], dim=1)
    _check_equal("jubjub_add (all cases, strided)", KJ.jubjub_add(pairs8[:, :48], pairs8[:, 48:]), got)
    u8 = torch.cat([P8[:, :1], P8, Q8], dim=1)  # rows of 97 words: P8 one word in, Q8 after it
    _check_equal("jubjub_add (all cases, unaligned)", KJ.jubjub_add(u8[:, 1:49], u8[:, 49:]), got)
    if J.decode_points(*(got[:, 16 * i : 16 * (i + 1)] for i in range(3))) != [p + q for p, q in zip(ps, qs)]:
        raise AssertionError("jubjub_add (all cases): the sums differ from the host curve's")
    n = JUBJUB_ADD_PAIRS
    base = _jubjub_rows(_jubjub_chain(1024, rng.randrange(1 << 30)) + ps + qs, dev)
    reps = -(-(n + 1) // base.shape[0])
    rows = base.repeat(reps, 1)[: n + 1]
    a, _ = _field_inputs(FR, n, rng, dev)
    lam = torch.where((a == 0).all(dim=1, keepdim=True), FR.const("ONE_MONT", dev), a)
    # projective operands: (X : Y : Z) scaled by a non-zero lambda per lane
    P = torch.cat([MK.mont_mul_plain(FR, rows[:n, 16 * i : 16 * (i + 1)], lam) for i in range(3)], dim=1)
    Q = rows[1:].contiguous()
    P[: P8.shape[0]], Q[: Q8.shape[0]] = P8, Q8
    want_add = KJ.jubjub_add_plain(P, Q)
    err = _check_equal("jubjub_add", KJ.jubjub_add(P, Q), want_add)
    pairs = torch.cat([P, Q], dim=1)
    _check_equal("jubjub_add (strided)", KJ.jubjub_add(pairs[:, :48], pairs[:, 48:]), want_add)
    # rows of 49 words, one word in: neither base nor stride 16-byte aligned
    Pu, Qu = (torch.cat([x[:, :1], x], dim=1)[:, 1:] for x in (P, Q))
    _check_equal("jubjub_add (unaligned)", KJ.jubjub_add(Pu, Qu), want_add)
    for width in (1, 3, 17, 32, 128, 1003):
        _check_equal(f"jubjub_add (width {width})", KJ.jubjub_add(P[:width], Q[:width]), want_add[:width])
        _check_equal(f"jubjub_add (width {width}, strided)", KJ.jubjub_add(pairs[:width, :48], pairs[:width, 48:]),
                     want_add[:width])
        _check_equal(f"jubjub_add (width {width}, unaligned)", KJ.jubjub_add(Pu[:width], Qu[:width]),
                     want_add[:width])
    nbytes = 3 * n * PT_BYTES
    out["jubjub_add"] = {
        "n": n, "max_abs_err": err, "ms": _kernel_ms(KJ.jubjub_add, (P, Q), nbytes),
        "eager_ms": _median_ms(lambda: KJ.jubjub_add(P, Q), 10),
        "plain_ms": _median_ms(lambda: KJ.jubjub_add_plain(P, Q), 3),
        "ops_ms": _imad_ms(n * 12 * fr_mul_imad), "ops_ms_fe_mul": _imad_ms(n * 12 * prod_imad), "bytes": nbytes,
        "all_cases_ms": _kernel_ms(KJ.jubjub_add, (P8, Q8), 3 * 8 * PT_BYTES, launches=20, from_hbm=False),
    }

    # the square root: the rows of every 2-adic order first
    n = FR_SQRT_ROWS
    a = _sqrt_rows(n, rng, dev)
    root, ok = KJ.fr_sqrt(a)
    want_root, want_ok = KJ.fr_sqrt_plain(a)
    err = _check_equal("fr_sqrt", root, want_root)
    if not torch.equal(ok, want_ok):
        raise AssertionError("fr_sqrt: the flags differ from the plain version's")
    vals, roots = F.decode(FR, a[:64]), F.decode(FR, root[:64])
    for v, r, k in zip(vals, roots, ok[:64].tolist()):
        if k != (v == 0 or pow(v, (FR.modulus - 1) // 2, FR.modulus) == 1) or (k and r * r % FR.modulus != v):
            raise AssertionError("fr_sqrt: a root or flag disagrees with the host")
    for width in (1, 3, 32, 1003):
        r_, k_ = KJ.fr_sqrt(a[:width])
        _check_equal(f"fr_sqrt (width {width})", r_, want_root[:width])
        if not torch.equal(k_, want_ok[:width]):
            raise AssertionError(f"fr_sqrt (width {width}): the flags differ")
    nbytes = n * (2 * 16 + 1) * 4
    sqr, mul = _sqrt_products()
    out["fr_sqrt"] = {
        "n": n, "max_abs_err": err, "ms": _kernel_ms(KJ.fr_sqrt, (a,), nbytes),
        "eager_ms": _median_ms(lambda: KJ.fr_sqrt(a), 10),
        "plain_ms": _median_ms(lambda: KJ.fr_sqrt_plain(a), 3),
        # the kernel's own 752 fr_sqr and 129 fr_mul; beside it the count
        # of the bit-by-bit walk on fe_mul (951), as the parent bounded it
        "ops_ms": _imad_ms(n * (sqr * fr_sqr_imad + mul * fr_mul_imad)), "bytes": nbytes,
        "ops_ms_fe_mul": _imad_ms(n * _sqrt_products_bitwise() * prod_imad),
        "products": sqr + mul,
    }
    log(f"kernel fr_sqrt: bit-identical to plain at widths 1, 3, 32, 1003 and {n}, the first "
        f"{len(_two_adic_values())} rows of every 2-adic order (z^(2^k) c^2, k = 1 .. 32, non-squares, 0, 1, -1); "
        f"{sqr + mul} products a row ({sqr} fr_sqr, {mul} fr_mul; {_sqrt_products_bitwise()} bit by bit): "
        f"operations {out['fr_sqrt']['ops_ms']:.6f} ms as the kernel does them (the bound), "
        f"{out['fr_sqrt']['ops_ms_fe_mul']:.6f} ms as {_sqrt_products_bitwise()} fe_mul on {card}")

    # the fold: every width against the plain version of the widest, then
    # timed at the tree's widths; the table stays in L2 as on the path (each
    # level folds with the same table), the digits come from HBM from 4,096
    # hashes up
    C, n = FOLD_CHUNKS, FOLD_HASHES
    t0 = time.perf_counter()
    table = PED._chunk_tables(C, dev)
    KJ.fold_table(table)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    wide = max(FOLD_WIDTHS)
    idx_all = torch.as_tensor(
        np.random.default_rng(rng.randrange(1 << 30)).integers(0, 9, (C, wide), dtype=np.int32), device=dev)
    t0 = time.perf_counter()
    want = KJ.pedersen_fold_plain(table, idx_all)
    torch.cuda.synchronize()
    plain_wide_s = time.perf_counter() - t0
    err = 0.0
    for width in FOLD_WIDTHS:
        got = KJ.pedersen_fold(table, idx_all[:, :width].contiguous())
        err = max(err, _check_equal(f"pedersen_fold (width {width})", got, want[:width]))

    def fold_ms(width):
        sub = idx_all[:, :width].contiguous()
        return _kernel_ms(lambda i: KJ.pedersen_fold(table, i), (sub,), C * width * 4 + width * PT_BYTES,
                          from_hbm=width >= 4096)

    widths_ms = {w: fold_ms(w) for w in FOLD_TIMED}
    idx = idx_all[:, :n].contiguous()
    out["pedersen_fold"] = {
        "n": n, "chunks": C, "max_abs_err": err, "ms": widths_ms[n], "widths_ms": widths_ms,
        "eager_ms": _median_ms(lambda: KJ.pedersen_fold(table, idx), 10),
        "plain_ms": _median_ms(lambda: KJ.pedersen_fold_plain(table, idx), 3),
        # the mixed add's 11 fr_mul a step; the parent's 12 fe_mul beside it
        "ops_ms": _imad_ms(C * n * 11 * fr_mul_imad), "ops_ms_fe_mul": _imad_ms(C * n * 12 * prod_imad),
        "bytes": C * n * 4 + C * 9 * PT_BYTES + n * PT_BYTES, "table_s": table_s,
    }
    log(f"kernel pedersen_fold: the {C}-chunk table built on the host and copied in {table_s:.3f} s (with its "
        f"fold_table layout); plain version at {wide} hashes in {plain_wide_s:.1f} s; bit-identical to it at "
        f"widths {list(FOLD_WIDTHS)} (tolerance: exact)")
    log(f"kernel pedersen_fold by width (hashes: ms per launch in a CUDA graph, table in L2, digits from HBM from "
        f"4096 up): {json.dumps({w: round(t, 4) for w, t in widths_ms.items()})}; bound at {n} hashes "
        f"{out['pedersen_fold']['ops_ms']:.6f} ms (11 fr_mul a step), {out['pedersen_fold']['ops_ms_fe_mul']:.6f} "
        f"ms as 12 fe_mul; jubjub_add's at {out['jubjub_add']['n']} pairs {out['jubjub_add']['ops_ms']:.6f} ms "
        f"(12 fr_mul), {out['jubjub_add']['ops_ms_fe_mul']:.6f} ms as 12 fe_mul on {card}")
    for name, r in out.items():
        bytes_ms, ops_ms = _set_bound(r)
        log(f"kernel {name}: n={r['n']} bit-identical to plain (tolerance: exact; max_abs_err {r['max_abs_err']}); "
            f"kernel {r['ms']:.4f} ms per launch in a CUDA graph, inputs from HBM ({r['eager_ms']:.4f} ms eager), "
            f"plain {r['plain_ms']:.3f} ms (median of 3), bound {r['bound_ms']:.6f} ms ({r['bound_by']}; bytes "
            f"{bytes_ms:.6f} ms, operations {ops_ms:.6f} ms) on {card}")
    log(f"kernel jubjub_add on the all-cases batch (8 pairs): {out['jubjub_add']['all_cases_ms']:.4f} ms per "
        f"launch in a CUDA graph, inputs in L2 on {card}")
    jubjub_sass_report()
    return out, (P, Q), a


def jubjub_sass_report() -> dict:
    """Static SASS instructions (cuobjdump -sass) of jubjub_add_kernel,
    pedersen_fold_kernel and fr_sqrt_kernel in the built library, and of
    the probe kernels of the JUBJUB_PROBE build, each one Fr product between
    the same 16 loads and 8 stores: probe_fr_mul and probe_fr_sqr (the
    carry-chain product and square) and probe_fe_mul (field.cuh's
    fe_mul<Fr>, which the square root ran before the carry-chain forms)."""
    from collections import Counter
    from pathlib import Path

    from masp_tpu_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        log(f"  sass: no cuobjdump beside nvcc ({tool}): not measured")
        return {}
    out = {}
    for defines, parts in (((), ("jubjub_add_kernel", "pedersen_fold_kernel", "fr_sqrt_kernel")),
                           (JUBJUB_PROBE, ("probe_fr_mul", "probe_fr_sqr", "probe_fe_mul"))):
        build.library("jubjub", defines)
        text = subprocess.run([str(tool), "-sass", str(build.lib_path("jubjub", defines))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        funcs = _sass_functions(text)
        for part in parts:
            found = [ins for f, ins in funcs.items() if part in f]
            if len(found) != 1:
                raise AssertionError(f"sass: {len(found)} functions of jubjub.cu match {part}")
            c = Counter(op for _, op, _ in found[0])
            out[part] = {"instructions": sum(c.values()), "imad": c["IMAD"], "top": dict(c.most_common(8))}
            log(f"  sass {part}: {out[part]['instructions']} instructions (static), IMAD family {c['IMAD']}; most "
                f"frequent {json.dumps(out[part]['top'])}")
    log(f"  sass Fr product: the carry-chain fr_mul's probe {out['probe_fr_mul']['instructions']} instructions, "
        f"fr_sqr's {out['probe_fr_sqr']['instructions']}, against fe_mul<Fr>'s "
        f"{out['probe_fe_mul']['instructions']} (each with the same loads and stores)")
    return out


def jubjub_add_path_log(widths, P, Q, card: str) -> None:
    """jubjub_add's launches on the Jubjub path by width, and their kernel
    time summed: the kernel timed in a CUDA graph at each width the path
    launched it at (contiguous rows of P and Q, inputs in L2, as a bucket
    chain finds them), times its launches there."""
    from collections import Counter

    from masp_tpu_torch.kernels import jubjub as KJ

    counts = Counter(widths)
    reps = -(-max(counts) // P.shape[0])
    P, Q = (x.repeat(reps, 1) if reps > 1 else x for x in (P, Q))
    ms = {w: _kernel_ms(KJ.jubjub_add, (P[:w], Q[:w]), 3 * w * PT_BYTES, launches=20, from_hbm=False)
          for w in sorted(counts)}
    log(f"kernel jubjub_add on the Jubjub path: {len(widths)} launches, {sum(widths)} pairs (launches by width "
        f"{json.dumps(dict(sorted(counts.items())))}); {sum(ms[w] * k for w, k in counts.items()):.4f} ms of kernel "
        f"time summed (in a CUDA graph, inputs in L2; ms per launch by width: "
        f"{json.dumps({w: round(t, 4) for w, t in ms.items()})}) on {card}")


def fr_sqrt_path_log(widths, a, card: str) -> dict:
    """fr_sqrt's launches on the Jubjub path by width (the signature batches'
    R decompressions and the decompression of the encodings), and their
    kernel time summed: the kernel timed in a CUDA graph at each width, on
    rows of a, inputs from HBM from 4,096 rows up. Returns {width: ms}."""
    from collections import Counter

    from masp_tpu_torch.kernels import jubjub as KJ

    counts = Counter(widths)
    reps = -(-max(counts) // a.shape[0])
    a = a.repeat(reps, 1) if reps > 1 else a
    ms = {w: _kernel_ms(KJ.fr_sqrt, (a[:w].contiguous(),), w * (2 * 16 + 1) * 4, from_hbm=w >= 4096)
          for w in sorted(counts)}
    log(f"kernel fr_sqrt on the Jubjub path: {len(widths)} launches (launches by width "
        f"{json.dumps(dict(sorted(counts.items())))}); {sum(ms[w] * k for w, k in counts.items()):.4f} ms of kernel "
        f"time summed (in a CUDA graph, inputs from HBM from 4096 rows up; ms per launch by width: "
        f"{json.dumps({w: round(t, 4) for w, t in ms.items()})}) on {card}")
    return ms


def _tree_levels(n_leaves: int):
    """(start, width) in a FrozenCommitmentTree's flat node list of each
    level above the leaves while it has at least one pair, for a power-of-two
    leaf count."""
    out, start, width = [], 0, n_leaves
    while width > 1:
        start, width = start + width, width // 2
        out.append((start, width))
    return out


def jubjub_phase(dev, rng, card: str) -> dict:
    """Phase jubjub: the kernel checks (jubjub_kernel_phase), then the path
    with the launch counts zeroed just before it, each part held against the
    host: a whole 256-leaf tree against the host-built one, then a
    FrozenCommitmentTree of JUBJUB_TREE_LEAVES seeded leaves, both through
    the default route (MASP_MERKLE_DEVICE_MIN unset: 64 pairs a level and up
    on the card), 128 random parents of each device level of the big tree
    recomputed with the host merkle_hash; JUBJUB_SIGS RedJubjub signatures through
    batch_verify(use_device=True), true, then false with one altered, each
    equal to the host route; an MSM of JUBJUB_MSM_POINTS points i G against
    (sum s_i i mod q) G; batch_from_bytes on JUBJUB_DECOMPRESS encodings and
    the JAX test's invalid ones against the host's. Every kernel of
    JUBJUB_KERNELS must launch. Returns the kernel entries and the launches."""
    import torch

    from masp_tpu_torch.host import jubjub as HJ
    from masp_tpu_torch.host.fields import SCALAR_MODULUS, JubjubFr, Scalar
    from masp_tpu_torch.host.jubjub import ExtendedPoint
    from masp_tpu_torch.host.primitives import redjubjub as RJ
    from masp_tpu_torch.host.primitives.constants import spending_key_generator
    from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
    from masp_tpu_torch.host.primitives.sapling import Node, merkle_hash
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.ops import jubjub as J
    from masp_tpu_torch.ops import pedersen as PED

    from masp_tpu_torch.kernels import jubjub as KJ

    kern, (add_p, add_q), sqrt_a = jubjub_kernel_phase(dev, rng, card)
    if "MASP_MERKLE_DEVICE_MIN" in os.environ:
        raise AssertionError("[jubjub] MASP_MERKLE_DEVICE_MIN is set: the tree must take the default route")
    q = JubjubFr.META.modulus
    R = SCALAR_MODULUS
    t0 = time.perf_counter()
    leaves = [Node(rng.randrange(R).to_bytes(32, "little")) for _ in range(JUBJUB_TREE_LEAVES)]
    p_g = spending_key_generator()
    keys = random.Random(rng.randrange(1 << 30))

    class _Bytes:
        def fill_bytes(self, k):
            return keys.randbytes(k)

    entries = []
    for i in range(JUBJUB_SIGS):
        sk = RJ.PrivateKey(JubjubFr(keys.randrange(1, q)))
        msg = f"jubjub-phase-{i}".encode()
        entries.append(RJ.BatchEntry(vk=RJ.PublicKey.from_private(sk, p_g), msg=msg, sig=sk.sign(msg, _Bytes(), p_g)))
    s = bytearray(entries[JUBJUB_SIGS // 2].sig.sbar)
    s[0] ^= 1
    bad = list(entries)
    bad[JUBJUB_SIGS // 2] = RJ.BatchEntry(vk=bad[JUBJUB_SIGS // 2].vk, msg=bad[JUBJUB_SIGS // 2].msg,
                                          sig=RJ.Signature(bad[JUBJUB_SIGS // 2].sig.rbar, bytes(s)))
    chain = _jubjub_chain(max(JUBJUB_MSM_POINTS, JUBJUB_DECOMPRESS), rng.randrange(1 << 30))
    g = spending_key_generator()
    msm_points, acc = [], ExtendedPoint.identity()
    for _ in range(JUBJUB_MSM_POINTS):
        msm_points.append(acc)
        acc = acc + g
    scalars = [rng.randrange(q) for _ in range(JUBJUB_MSM_POINTS)]
    items = [p.to_bytes() for p in chain[:JUBJUB_DECOMPRESS]]
    neg_zero = bytearray(ExtendedPoint.identity().to_bytes())
    neg_zero[31] |= 0x80
    notsq = bytearray(items[0])
    while ExtendedPoint.from_bytes(bytes(notsq)) is not None:
        notsq[0] = (notsq[0] + 1) & 0xFF
    items += [ExtendedPoint.identity().to_bytes(), ExtendedPoint.from_affine(Scalar(0), Scalar(R - 1)).to_bytes(),
              (R + 1).to_bytes(32, "little"), bytes(neg_zero), bytes(notsq), b"\x00" * 31]
    log(f"[jubjub] setup on the host: {JUBJUB_TREE_LEAVES} leaves, {JUBJUB_SIGS} signatures, "
        f"{JUBJUB_MSM_POINTS} MSM points, {len(items)} encodings in {time.perf_counter() - t0:.1f} s")

    # the device levels' times, through the twin the copy imports
    levels, twin = [], PED.batch_merkle_hash

    def timed(depth, pairs, *args, **kwargs):
        t0 = time.perf_counter()
        res = twin(depth, pairs, *args, **kwargs)
        levels.append((depth, len(pairs), time.perf_counter() - t0))
        return res

    # jubjub_add's and fr_sqrt's widths on the path, through recorders (the
    # launches still run and count)
    add_widths, real_add = [], KJ.jubjub_add
    sqrt_widths, real_sqrt = [], KJ.fr_sqrt

    def record(p, q):
        add_widths.append(p.shape[0])
        return real_add(p, q)

    def record_sqrt(a):
        sqrt_widths.append(a.shape[0])
        return real_sqrt(a)

    reset_launches()
    KJ.jubjub_add = record
    KJ.fr_sqrt = record_sqrt
    try:
        # the 256-leaf tree first: its two device levels also take the first
        # use of each library and table out of the timed tree
        t0 = time.perf_counter()
        small = leaves[:256]
        dev_tree = FrozenCommitmentTree.new(small)
        times = {"tree_256": time.perf_counter() - t0}
        PED.batch_merkle_hash = timed
        try:
            t0 = time.perf_counter()
            tree = FrozenCommitmentTree.new(leaves)
            times["tree"] = time.perf_counter() - t0
        finally:
            PED.batch_merkle_hash = twin
        t0 = time.perf_counter()
        sig_ok = RJ.batch_verify(XorShiftRng.from_seed(BATCH_SEED), entries, p_g, use_device=True)
        times["sigs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sig_bad = RJ.batch_verify(XorShiftRng.from_seed(BATCH_SEED), bad, p_g, use_device=True)
        times["sigs_altered"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        msm_sum = J.msm(msm_points, scalars)
        times["msm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = J.batch_from_bytes(items)
        times["decompress"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        KJ.jubjub_add = real_add
        KJ.fr_sqrt = real_sqrt
    launches = dict(LAUNCHES)
    log(f"[jubjub] launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    for name in JUBJUB_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[jubjub] kernel {name} was not launched on the Jubjub path")
    if len(add_widths) != launches["jubjub_add"]:
        raise AssertionError(f"[jubjub] {len(add_widths)} adds recorded, {launches['jubjub_add']} launched")
    jubjub_add_path_log(add_widths, add_p, add_q, card)
    if len(sqrt_widths) != launches["fr_sqrt"]:
        raise AssertionError(f"[jubjub] {len(sqrt_widths)} square roots recorded, {launches['fr_sqrt']} launched")
    kern["fr_sqrt"]["path_widths_ms"] = fr_sqrt_path_log(sqrt_widths, sqrt_a, card)

    # the tree against the host
    want_levels = [(d, JUBJUB_TREE_LEAVES >> (d + 1)) for d in range(len(levels))]
    if [(d, n) for d, n, _ in levels] != want_levels or levels[-1][1] != 64:
        raise AssertionError(f"[jubjub] device levels {[(d, n) for d, n, _ in levels]}, not {want_levels} down to 64")
    for d, n, t in levels:
        log(f"[jubjub] tree level {d}: {n} pairs on the card in {1e3 * t:.2f} ms "
            f"({1e6 * t / n:.3f} us a hash) on {card}")
    log(f"[jubjub] FrozenCommitmentTree.new of {JUBJUB_TREE_LEAVES} leaves, default route: {times['tree']:.3f} s "
        f"({sum(t for _, _, t in levels):.3f} s in the {len(levels)} device levels) on {card}")
    t0 = time.perf_counter()
    prev = 0
    for d, (start, width) in enumerate(_tree_levels(JUBJUB_TREE_LEAVES)[: len(levels)]):
        for j in random.Random(d).sample(range(width), min(128, width)):
            want = merkle_hash(d, tree.nodes[prev + 2 * j].repr, tree.nodes[prev + 2 * j + 1].repr)
            if tree.nodes[start + j].repr != want:
                raise AssertionError(f"[jubjub] tree level {d + 1} node {j} differs from the host merkle_hash")
        prev = start
    os.environ["MASP_MERKLE_DEVICE_MIN"] = "0"
    try:
        host_tree = FrozenCommitmentTree.new(small)
    finally:
        os.environ.pop("MASP_MERKLE_DEVICE_MIN")
    if dev_tree != host_tree or dev_tree.root() != host_tree.root():
        raise AssertionError("[jubjub] the 256-leaf tree differs from the one built on the host")
    log(f"[jubjub] 128 random parents (all of the 64-pair level) of each device level equal the host "
        f"merkle_hash's, and the 256-leaf tree (2 device levels, {times['tree_256']:.3f} s, built first) equals "
        f"the host-built tree: {time.perf_counter() - t0:.1f} s of host checks")

    # signatures against the host route
    t0 = time.perf_counter()
    host_ok = RJ.batch_verify(XorShiftRng.from_seed(BATCH_SEED), entries, p_g, use_device=False)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_bad = RJ.batch_verify(XorShiftRng.from_seed(BATCH_SEED), bad, p_g, use_device=False)
    host_bad_s = time.perf_counter() - t0
    if (sig_ok, sig_bad, host_ok, host_bad) != (True, False, True, False):
        raise AssertionError(f"[jubjub] signature batches: card {sig_ok}/{sig_bad}, host {host_ok}/{host_bad}, "
                             f"not True/False")
    log(f"[jubjub] {JUBJUB_SIGS} RedJubjub signatures, batch_verify(use_device=True): {sig_ok} in "
        f"{times['sigs']:.3f} s, one altered: {sig_bad} in {times['sigs_altered']:.3f} s; host route "
        f"{host_ok} in {host_s:.3f} s, {host_bad} in {host_bad_s:.3f} s on {card}")

    # the MSM against one host scalar multiplication
    want = g * JubjubFr(sum(s * i for i, s in enumerate(scalars)) % q)
    if msm_sum != want:
        raise AssertionError("[jubjub] the MSM differs from (sum s_i i mod q) G")
    log(f"[jubjub] msm of {JUBJUB_MSM_POINTS} points i G: {times['msm']:.3f} s, equal to "
        f"(sum s_i i mod q) G on {card}")

    # decompression against the host
    t0 = time.perf_counter()
    host = HJ.batch_from_bytes(items[:-1]) + [None]  # the host helper takes 32-byte items
    host_dec_s = time.perf_counter() - t0
    if [None if p is None else p.to_bytes() for p in decoded] != [None if p is None else p.to_bytes() for p in host]:
        raise AssertionError("[jubjub] batch_from_bytes differs from the host's")
    if sum(p is None for p in decoded) != 4:
        raise AssertionError("[jubjub] batch_from_bytes did not reject the four invalid encodings")
    log(f"[jubjub] batch_from_bytes of {len(items)} encodings: {times['decompress']:.3f} s on the card, "
        f"equal to host/jubjub.batch_from_bytes ({host_dec_s:.3f} s on the host) on {card}")
    return {"kernels": kern, "launches": launches, "times": times, "levels": levels}


# --- phase pairing: the device pairing ---------------------------------------------------

def _fq12_limbs(f):
    """An Fq12 tuple's limbs as one CPU tensor, for comparing runs."""
    import torch

    return torch.stack([x.cpu() for f6 in f for x in f6])


def pairing_profile(x, card: str) -> None:
    """Where a product check's time goes: PAIRING_PROFILE_BITS steps of the
    hard part's square-and-multiply (most of a check) on the Fq12 value x,
    timed alone, then under torch.profiler (device activity only): the wall
    time a step, the device's busy share, the device activities a step and
    the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from masp_tpu_torch.ops import pairing as P

    bits = [1] * PAIRING_PROFILE_BITS
    P._hard_chunk(x, x, bits[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P._hard_chunk(x, x, bits)
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        P._hard_chunk(x, x, bits)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    products = 2 * len(bits)
    log(f"[pairing] profile: {len(bits)} square-and-multiply steps ({products} Fq12 products) in {alone_ms:.2f} ms "
        f"({alone_ms / products:.3f} ms a product; {wall_ms:.2f} ms profiled), device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(e.count for e in events) / products:.1f} device activities a "
        f"product, on {card}")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[pairing]   {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} calls  {e.key[:90]}")


def pairing_phase(dev, rng, card: str, profile: bool = False) -> dict:
    """Phase pairing: ops/pairing.py on the card. (a) The tower operations
    (f12mul, f12sq, f12conj, f12inv, f12frobenius2 and the easy part) on
    two seeded Fq12 values give the same limbs as their CPU run, and the
    host's values; (b) multi_miller_loop_device and then
    final_exponentiation_device on PAIRING_PAIRS seeded pairs equal the host
    copy's multi_miller_loop and final_exponentiation; (c) the path, with
    the launch counts zeroed just before it: pairing_product_is_one_device
    is True for e(P, Q) e(-P, Q), True for an identity-only list and False
    for e(P, Q) e(P, Q), each timed with its launches. mont_mul_fq and
    mont_inv_fq must launch in (c). With ``profile``, pairing_profile after
    (a). Returns the launches of (c)."""
    import torch

    from masp_tpu_torch.host import bls12_381 as HB
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.ops import pairing as P

    def rand_fq12():
        f2 = [HB.Fq2(rng.randrange(HB.Q), rng.randrange(HB.Q)) for _ in range(6)]
        return HB.Fq12(HB.Fq6(*f2[:3]), HB.Fq6(*f2[3:]))

    a, b = rand_fq12(), rand_fq12()
    ops = {
        "f12mul": (lambda x, y: P.f12mul(x, y), a * b),
        "f12sq": (lambda x, y: P.f12sq(x), a * a),
        "f12conj": (lambda x, y: P.f12conj(x), a.conjugate()),
        "f12inv": (lambda x, y: P.f12inv(x), a.invert()),
        "f12frobenius2": (lambda x, y: P.f12frobenius2(x), a.frobenius().frobenius()),
        "easy part": (lambda x, y: P._easy_part(x), HB._easy_part(a)),
    }
    on = {d: (P.encode_fq12(a, d), P.encode_fq12(b, d)) for d in ("cpu", dev)}
    for name, (op, want) in ops.items():
        cpu = op(*on["cpu"])
        card_out = op(*on[dev])
        if not torch.equal(_fq12_limbs(card_out), _fq12_limbs(cpu)):
            raise AssertionError(f"[pairing] {name}: the card's limbs differ from the CPU run's")
        if P.decode_fq12(card_out) != want:
            raise AssertionError(f"[pairing] {name}: the card's value differs from the host's")
    log(f"[pairing] tower operations on the card equal their CPU run limb for limb and the host's values: "
        f"{', '.join(ops)}")
    if profile:
        pairing_profile(on[dev][0], card)

    g1, g2 = HB.G1.generator(), HB.G2.generator()
    pairs = [(g1 * rng.randrange(1, HB.R), g2 * rng.randrange(1, HB.R)) for _ in range(PAIRING_PAIRS)]
    t0 = time.perf_counter()
    want_ml = HB.multi_miller_loop(pairs)
    want_fe = HB.final_exponentiation(want_ml)
    host_s = time.perf_counter() - t0
    coords = P.encode_pairs(pairs, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ml = P.multi_miller_loop_device(*coords)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe = P.final_exponentiation_device(ml)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    def first(f):
        return P._fq12_map(lambda x: x[0], f)

    if P.decode_fq12(first(ml)) != want_ml:
        raise AssertionError(f"[pairing] the device Miller loop on {PAIRING_PAIRS} pairs differs from the host's")
    if P.decode_fq12(first(fe)) != want_fe:
        raise AssertionError("[pairing] the device final exponentiation differs from the host's")
    log(f"[pairing] {PAIRING_PAIRS} pairs: multi_miller_loop_device {t1 - t0:.3f} s, final_exponentiation_device "
        f"{t2 - t1:.3f} s, each equal to the host copy's (host {host_s:.3f} s for both) on {card}")

    p, q = pairs[0]
    checks = (("e(P, Q) e(-P, Q)", [(p, q), (-p, q)], True),
              ("identities only", [(HB.G1.identity(), q), (p, HB.G2.identity())], True),
              ("e(P, Q) e(P, Q)", [(p, q), (p, q)], False))
    reset_launches()
    for label, check_pairs, want in checks:
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        got = P.pairing_product_is_one_device(check_pairs, device=dev)
        wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"[pairing] pairing_product_is_one_device({label}): {got}, not {want}")
        used = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
        log(f"[pairing] pairing_product_is_one_device({label}) = {got} in {wall:.3f} s, launches "
            f"{json.dumps(used)} on {card}")
    launches = dict(LAUNCHES)
    for name in PAIRING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[pairing] kernel {name} was not launched on the pairing path")
    return {"launches": launches}


def pairing_route_phase(res, bundle, prover, card: str) -> None:
    """verify_proofs_batch on the bundle's Spend proofs through both routes,
    the device pairing (use_device_pairing=True, ops/pairing.py) and the
    host pairing: with their public inputs both are True, with one input
    altered both are False; the device route must launch mont_mul_fq and
    mont_inv_fq, the host route neither."""
    from masp_tpu_torch.groth16 import sapling_prover as SP
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.host.structures import Proof
    from masp_tpu_torch.host.verifier import verify_proofs_batch
    from masp_tpu_torch.kernels import LAUNCHES

    proofs = [Proof.read(blob) for blob, _, _ in res["spend"]]
    inputs = [SP.spend_public_inputs(rk.point, cv, anchor, nf)
              for (_, cv, rk), (anchor, nf) in zip(res["spend"], bundle["verifier"]["spend"])]
    altered = [list(x) for x in inputs]
    altered[0][0] += 1
    for label, public, want in (("as proved", inputs, True), ("one input altered", altered, False)):
        for on_card in (True, False):
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            ok = verify_proofs_batch(prover.spend_vk, XorShiftRng.from_seed(BATCH_SEED), proofs, public,
                                     use_device_pairing=on_card)
            wall = time.perf_counter() - t0
            used = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
            if ok != want:
                raise AssertionError(f"[batch] verify_proofs_batch(use_device_pairing={on_card}) on the Spend "
                                     f"proofs {label}: {ok}, not {want}")
            if on_card != all(used.get(k, 0) > 0 for k in PAIRING_KERNELS):
                raise AssertionError(f"[batch] verify_proofs_batch(use_device_pairing={on_card}) launched {used}")
            log(f"[batch] verify_proofs_batch(use_device_pairing={on_card}) on the {len(proofs)} Spend proofs "
                f"{label}: {ok} in {wall:.3f} s, launches {json.dumps(used)} on {card}")


# --- phase tx: the transaction builder, keys and note encryption -----------------------

def _tx_step(steps: dict, name: str, fn):
    """fn() with the launch counts zeroed just before it and read just
    after (the card synchronised); its launches go into steps[name]."""
    import torch

    from masp_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps[name] = dict(LAUNCHES)
    return out, wall


def _tx_verdict(bundle, sighash, prover, spends=None, binding_sig=None):
    """BatchValidator on the bundle, its spends or binding signature
    replaced where given: (check_bundle, validate or None) with the
    signature batches on the card and the Groth16 batches on the host
    pairing."""
    from types import SimpleNamespace

    from masp_tpu_torch.groth16 import sapling_prover as SP
    from masp_tpu_torch.host.rng import XorShiftRng

    validator = SP.BatchValidator()
    described = SimpleNamespace(
        shielded_spends=bundle.shielded_spends if spends is None else spends,
        shielded_converts=bundle.shielded_converts, shielded_outputs=bundle.shielded_outputs,
        value_balance=bundle.value_balance,
        authorization=SimpleNamespace(binding_sig=binding_sig or bundle.authorization.binding_sig))
    if not validator.check_bundle(described, sighash):
        return False, None
    return True, validator.validate(prover.spend_vk, prover.convert_vk, prover.output_vk,
                                    XorShiftRng.from_seed(TX_SEEDS[2]), use_device_sigs=True)


def tx_phase(circuits: dict, dev, card: str) -> dict:
    """Phase tx: a wallet's whole flow through the port's transaction
    builder (masp_tpu_torch/tools/wallet.py), at the real sizes, on the
    circuits phase's three Parameters. Keys: a ZIP-32 master key from a seed
    and its hardened child, their default addresses (FF1 over host/crypto.py's
    AES). Trees: TX_LEAVES notes with the two funding notes at known
    positions and TX_CONVERSIONS conversions, each through
    FrozenCommitmentTree.new's device route (64 pairs a level and up), root
    and the spent paths equal to the host's CommitmentTree and
    IncrementalWitness. Build: Builder.build with 2 Spends of two asset
    types, 1 Convert, 3 Outputs and a transparent output through
    LocalTxProver.prove_jobs, timed, prove_jobs apart; every scan-path kernel
    must launch. Checks: the bytes re-parse to the same bytes and txid;
    BatchValidator passes (signatures on the card, proofs on the host
    pairing) and fails with one proof byte flipped, with the two spends'
    proofs swapped and with one binding signature byte flipped. Rebuild from
    the stored build parameters (through their borsh bytes) with the same
    seeds: the same txid and the same bytes but for the proofs, which
    prove_jobs draws from the OS; it validates too. Decrypt: every output with
    its recipient's ivk, and with the sender's ovk all but the one sent
    without it, each equal to what was added. Scan: TX_SCAN compact outputs
    of the tree's last notes with both accounts' ivks, through batch_epk's
    device branch (fr_sqrt must launch), equal to the host route
    (MASP_EPK_DEVICE_MIN=0) output by output and to what was sent. Returns
    the phase's launches, summed over its steps."""
    import importlib.util

    from masp_tpu_torch.groth16.local_prover import LocalTxProver
    from masp_tpu_torch.host.note_encryption import (
        batch_try_compact_note_decryption, try_note_decryption, try_output_recovery_with_ovk,
    )
    from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain
    from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
    from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
    from masp_tpu_torch.host.primitives.redjubjub import Signature
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.host.structures import Proof
    from masp_tpu_torch.host.transaction.components.sapling import SpendDescription
    from masp_tpu_torch.host.transaction.components.sapling_builder import RngBuildParams, StoredBuildParams
    from masp_tpu_torch.host.transaction.fees import FixedFeeRule
    from masp_tpu_torch.host.transaction.sighash import SignableInput, signature_hash
    from masp_tpu_torch.host.transaction.transaction import Transaction
    from masp_tpu_torch.host.transaction.txid import TxIdDigester
    from masp_tpu_torch.tools import wallet as W

    for var in ("MASP_MERKLE_DEVICE_MIN", "MASP_EPK_DEVICE_MIN"):
        if var in os.environ:
            raise AssertionError(f"[tx] {var} is set: the trees and the scan must take the default routes")
    log(f"[tx] `cryptography` importable on this machine: {importlib.util.find_spec('cryptography') is not None} "
        f"(the port uses masp_tpu_torch/host/crypto.py either way)")
    t0 = time.perf_counter()
    w = W.make_wallet(W.SEED, TX_LEAVES, TX_CONVERSIONS)
    scanned = range(TX_LEAVES - TX_SCAN, TX_LEAVES)
    compact = W.compact_outputs(w, scanned)
    log(f"[tx] wallet on the host: keys, {TX_LEAVES} notes, {TX_CONVERSIONS} conversions and {TX_SCAN} compact "
        f"outputs encrypted in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    root, host_spend_paths = W.host_paths(w.leaves, w.positions)
    croot, (host_cpath,) = W.host_paths(w.conversions, (w.conversion_pos,))
    log(f"[tx] host CommitmentTree and IncrementalWitness paths of both trees in {time.perf_counter() - t0:.1f} s")

    steps, times = {}, {}
    (tree, ctree), times["trees"] = _tx_step(steps, "trees", lambda: (
        FrozenCommitmentTree.new(w.leaves), FrozenCommitmentTree.new(w.conversions)))
    spend_paths, cpath = [tree.path(p) for p in w.positions], ctree.path(w.conversion_pos)
    if (tree.root(), ctree.root()) != (root, croot):
        raise AssertionError("[tx] a tree's root built on the card differs from the host CommitmentTree's")
    if [p.to_bytes() for p in spend_paths + [cpath]] != [p.to_bytes() for p in host_spend_paths + [host_cpath]]:
        raise AssertionError("[tx] a path of the card-built trees differs from the host IncrementalWitness path")
    for name in ("pedersen_fold", "mont_mul_fr", "mont_inv_fr"):
        if steps["trees"][name] <= 0:
            raise AssertionError(f"[tx] kernel {name} was not launched by the trees")
    log(f"[tx] trees of {TX_LEAVES} notes and {TX_CONVERSIONS} conversions on the card in {times['trees']:.3f} s, "
        f"roots and the {len(spend_paths) + 1} paths equal to the host's; launches "
        f"{json.dumps({k: n for k, n in steps['trees'].items() if n})} on {card}")

    prover = LocalTxProver(*(circuits[k]["params"] for k in ("spend", "output", "convert")))
    prove_jobs, spans = prover.prove_jobs, []

    def timed_prove_jobs(*args, **kwargs):
        t0 = time.perf_counter()
        out = prove_jobs(*args, **kwargs)
        spans.append(time.perf_counter() - t0)
        return out

    prover.prove_jobs = timed_prove_jobs

    def build(bparams):
        return W.builder(w, spend_paths, cpath).build(
            prover, FixedFeeRule.non_standard(W.fee()), XorShiftRng.from_seed(TX_SEEDS[0]), bparams)

    bparams = RngBuildParams(XorShiftRng.from_seed(TX_SEEDS[1]))
    (tx, meta), times["build"] = _tx_step(steps, "build", lambda: build(bparams))
    bundle = tx.sapling_bundle
    shape = [len(x) for x in (bundle.shielded_spends, bundle.shielded_converts, bundle.shielded_outputs)]
    if shape != [2, 1, 3] or len(tx.transparent_bundle.vout) != 1 or len(spans) != 1:
        raise AssertionError(f"[tx] the build gave {shape} descriptions, {len(tx.transparent_bundle.vout)} "
                             f"transparent outputs, {len(spans)} prove_jobs calls")
    for name in SCAN_KERNELS:
        if steps["build"][name] <= 0:
            raise AssertionError(f"[tx] kernel {name} was not launched by Builder.build")
    log(f"[tx] Builder.build of 2 Spends, 1 Convert, 3 Outputs and 1 transparent output: {times['build']:.3f} s, "
        f"of it prove_jobs {spans[0]:.3f} s and the rest (shuffle, note encryption, digests, signing) "
        f"{times['build'] - spans[0]:.3f} s; {len(tx.to_bytes())} bytes, txid {tx.txid().data[::-1].hex()}; "
        f"launches {json.dumps({k: n for k, n in steps['build'].items() if n})} on {card}")

    raw = tx.to_bytes()
    again = Transaction.from_bytes(raw)
    if again.to_bytes() != raw or again.txid() != tx.txid():
        raise AssertionError("[tx] the transaction does not re-parse to the same bytes and txid")
    sighash = signature_hash(tx.data, SignableInput.shielded(), tx.data.digest(TxIdDigester()))
    verdict, times["validate"] = _tx_step(steps, "validate", lambda: _tx_verdict(bundle, sighash, prover))
    if verdict != (True, True):
        raise AssertionError(f"[tx] BatchValidator on the transaction: {verdict}, not (True, True)")
    for name in ("jubjub_add", "fr_sqrt"):
        if steps["validate"][name] <= 0:
            raise AssertionError(f"[tx] kernel {name} was not launched by the device signature batches")
    log(f"[tx] BatchValidator on the transaction: True in {times['validate']:.3f} s (signature batches on the "
        f"card, Groth16 batches on the host pairing); launches "
        f"{json.dumps({k: n for k, n in steps['validate'].items() if n})} on {card}")
    spend0 = bundle.shielded_spends[0]
    proof = bytearray(spend0.zkproof)
    proof[TX_FLIP] ^= 1
    flipped = [SpendDescription(spend0.cv, spend0.anchor, spend0.nullifier, spend0.rk, bytes(proof),
                                spend0.spend_auth_sig)] + bundle.shielded_spends[1:]
    a, b = bundle.shielded_spends
    swapped = [SpendDescription(s.cv, s.anchor, s.nullifier, s.rk, o.zkproof, s.spend_auth_sig)
               for s, o in ((a, b), (b, a))]
    sig = bundle.authorization.binding_sig
    sbar = bytearray(sig.sbar)
    sbar[0] ^= 1
    for label, kwargs in (("one proof byte flipped", {"spends": flipped}),
                          ("the two spends' proofs swapped", {"spends": swapped}),
                          ("one binding signature byte flipped", {"binding_sig": Signature(sig.rbar, bytes(sbar))})):
        t0 = time.perf_counter()
        got = _tx_verdict(bundle, sighash, prover, **kwargs)
        if got not in ((False, None), (True, False)) or "swapped" in label and got != (True, False):
            raise AssertionError(f"[tx] BatchValidator on the transaction with {label}: {got}")
        log(f"[tx] BatchValidator with {label}: check_bundle {got[0]}, validate {got[1]} "
            f"({time.perf_counter() - t0:.3f} s)")
    log(f"[tx] with its byte {TX_FLIP} flipped the first spend's proof "
        f"{'still parses' if Proof.try_read(bytes(proof)) is not None else 'no longer parses'} (Proof.try_read)")

    stored = StoredBuildParams.from_bytes(bparams.to_stored().to_bytes())
    (rebuilt, _), times["rebuild"] = _tx_step(steps, "rebuild", lambda: build(stored))
    if rebuilt.txid() != tx.txid() or W.without_proofs(rebuilt) != W.without_proofs(tx):
        raise AssertionError("[tx] the rebuild from the stored build parameters differs beyond its proofs")
    fresh = sum(x.zkproof != y.zkproof for kind in ("shielded_spends", "shielded_converts", "shielded_outputs")
                for x, y in zip(getattr(tx.sapling_bundle, kind), getattr(rebuilt.sapling_bundle, kind)))
    rsighash = signature_hash(rebuilt.data, SignableInput.shielded(), rebuilt.data.digest(TxIdDigester()))
    if rsighash != sighash or _tx_verdict(rebuilt.sapling_bundle, rsighash, prover) != (True, True):
        raise AssertionError("[tx] the rebuilt transaction does not validate under the same sighash")
    if fresh != 6:
        raise AssertionError(f"[tx] only {fresh} of the rebuild's 6 proofs differ; prove_jobs draws (r, s) afresh")
    log(f"[tx] rebuild from the stored build parameters ({len(bparams.to_stored().to_bytes())} borsh bytes): "
        f"{times['rebuild']:.3f} s, the same txid and bytes but for its 6 fresh proofs, and it validates")

    domain = SaplingDomain(TEST_NETWORK, W.HEIGHT)
    ivk_of = {w.addr.to_bytes(): w.ivks()[0], w.child_addr.to_bytes(): w.ivks()[1]}
    t0 = time.perf_counter()
    recovered = 0
    for n, (ovk, to, asset, value, memo) in enumerate(W.outputs(w)):
        out = bundle.shielded_outputs[meta.output_index(n)]
        got = try_note_decryption(domain, ivk_of[to.to_bytes()], out)
        if got is None or (got[0].asset_type, got[0].value, got[1], got[2]) != (asset, value, to, memo):
            raise AssertionError(f"[tx] output {n} does not decrypt to what was sent")
        back = try_output_recovery_with_ovk(domain, w.xsk.expsk.ovk, out, out.cv, out.out_ciphertext)
        if (back is not None) != (ovk is not None) or back is not None and back != got:
            raise AssertionError(f"[tx] output {n}: the sender's ovk recovers {back is not None}, sent with "
                                 f"ovk {ovk is not None}")
        recovered += back is not None
    times["decrypt"] = time.perf_counter() - t0
    log(f"[tx] every output decrypts with its recipient's ivk to what was sent; the sender's ovk recovers "
        f"{recovered} of 3 (not the one sent without it): {times['decrypt']:.3f} s on the host")

    scan, times["scan"] = _tx_step(steps, "scan", lambda: batch_try_compact_note_decryption(w.ivks(), compact))
    if steps["scan"]["fr_sqrt"] <= 0 or steps["scan"]["mont_inv_fr"] <= 0:
        raise AssertionError(f"[tx] the scan did not take batch_epk's device branch: {steps['scan']}")
    os.environ["MASP_EPK_DEVICE_MIN"] = "0"
    try:
        t0 = time.perf_counter()
        host = batch_try_compact_note_decryption(w.ivks(), compact)
        times["scan_host"] = time.perf_counter() - t0
    finally:
        os.environ.pop("MASP_EPK_DEVICE_MIN")
    got = [W.scan_key(r) for r in scan]
    if got != [W.scan_key(r) for r in host]:
        raise AssertionError("[tx] the scan through the device branch differs from the host route")
    if [None if g is None else g[-1] for g in got] != W.expected_scan(w, scanned):
        raise AssertionError("[tx] the scan did not find exactly the notes sent to the two accounts")
    log(f"[tx] scan of {TX_SCAN} compact outputs with 2 ivks: {times['scan']:.3f} s through batch_epk's device "
        f"branch, {times['scan_host']:.3f} s on the host route, {sum(g is not None for g in got)} notes found, "
        f"equal output by output; launches {json.dumps({k: n for k, n in steps['scan'].items() if n})} on {card}")
    # the part of the scan that the routes differ in: batch_epk alone, each
    # route 3 times on the host clock (the device branch returns host
    # points, so it has waited for the card)
    domain = compact[0][0]
    keys = [o.ephemeral_key for _, o in compact]
    for route, use_device in (("epk_device", True), ("epk_host", False)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            domain.batch_epk(keys, use_device=use_device)
            runs.append(time.perf_counter() - t0)
        times[route] = sorted(runs)[1]
    log(f"[tx] batch_epk alone on the {TX_SCAN} encodings, median of 3: device branch {times['epk_device']:.4f} s, "
        f"host route {times['epk_host']:.4f} s, of the scan's {times['scan']:.3f} s on {card}")
    launches = {k: sum(s[k] for s in steps.values()) for k in steps["build"]}
    log(f"[tx] times {json.dumps({k: round(v, 4) for k, v in times.items()})} s; launches over the phase's steps "
        f"{json.dumps({k: n for k, n in launches.items() if n})} on {card}")
    for name in SCAN_KERNELS + JUBJUB_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[tx] kernel {name} was not launched on the transaction path")
    return {"launches": launches, "times": times}


# --- phase mesh: the multi-device layer on a virtual mesh of the card ------------------

def _affine_point(group, row):
    """A packed projective row (on any device) as a host point."""
    from masp_tpu_torch.ops import weierstrass as W
    from masp_tpu_torch.ops.projective import unpack_rows

    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*unpack_rows(group, row.reshape(1, -1).cpu()))[0]


def _timed(fn, warm: bool = False):
    """fn() and its wall time, the card synchronised at both ends; with
    ``warm``, after one untimed call (which builds the tables and constants
    that a first call makes)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    if warm:
        fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def mesh_phase(circuits: dict, dev, rng, card: str) -> dict:
    """Phase mesh: parallel/mesh.py, the signed digits, the lane-private
    Pippenger and the prover's mesh= route on the card, at the real Spend's
    width, on virtual meshes whose every position is the card (one card;
    each exchange a device-to-device copy). 1. sharded_ntt at m = 2^17 on
    MESH_NTT_POSITIONS positions, forward and inverse, equal to Domain.fft /
    ifft limb for limb. 2. sharded_sorted_msm of the real Spend's l query
    (G1, 2^17 rows) and b_g2 (G2, 2^16 rows) on MESH_POSITIONS positions at
    c = 8, unsigned and signed, every position with the same limbs, equal as
    points to the single-device sorted_msm_from_limbs. 3. the real Spend
    proved with MASP_MSM_SIGNED on, on the scan ladder and on the
    batch-affine one, each proof byte-equal to the unsigned proof of the same
    witness and (r, s), and verified. 4. the real Spend through
    create_proof_from_assembly(mesh=) on MESH_POSITIONS positions, after a
    warm-up, with the launch counts zeroed just before it and the stage
    spans, beside a single-device proof's: byte-equal, verified, every scan
    kernel launched. 5. pippenger_msm of MESH_PIPPENGER G1 points at c = 8,
    64 lanes, equal to sorted_msm. 6. multichip's entry and
    dryrun_multichip(8) (which runs mesh_prover_check) on 8 positions of the
    card. Returns the mesh proof's launches."""
    import torch

    from masp_tpu_torch.groth16 import prover as TP
    from masp_tpu_torch.groth16.domain import Domain
    from masp_tpu_torch.groth16.synthesis import synthesize_witness
    from masp_tpu_torch.host.bls12_381 import R
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops import msm as M
    from masp_tpu_torch.ops import msm_sorted as MS
    from masp_tpu_torch.ops import weierstrass as W
    from masp_tpu_torch.ops.field import FR
    from masp_tpu_torch.parallel import mesh as PM
    from masp_tpu_torch.tools import multichip
    from masp_tpu_torch.tools.fixtures import fixture
    from masp_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    params = circuits["spend"]["params"]
    m = len(params.h) + 1

    def fr_rows(n, mont=True):
        return torch.as_tensor(F.encode(FR, [rng.randrange(R) for _ in range(n)], mont=mont).astype(np.int32),
                               device=dev)

    def placed(sh, label):
        for p in sh.mesh.local_positions():
            if sh.shards[p].device != sh.mesh.device(p):
                raise AssertionError(f"[mesh] {label}: position {p}'s shard is on {sh.shards[p].device}")
        return sh

    # 1. the sharded NTT at full width
    dom = Domain(m, device=dev)
    x = fr_rows(m)
    (want_f, want_i), single_s = _timed(lambda: (dom.fft(x), dom.ifft(x)), warm=True)
    for n in MESH_NTT_POSITIONS:
        mesh = PM.make_mesh(n, devices=[dev] * n)
        fwd, fwd_s = _timed(lambda: PM.gather(placed(PM.sharded_ntt(mesh, dom, x, axis="msm"), "ntt")), warm=True)
        inv, inv_s = _timed(lambda: PM.gather(placed(PM.sharded_ntt(mesh, dom, x, axis="msm", inverse=True),
                                                     "intt")), warm=True)
        if not (torch.equal(fwd, want_f) and torch.equal(inv, want_i)):
            raise AssertionError(f"[mesh] sharded_ntt on {n} positions differs from Domain.fft / ifft")
        log(f"[mesh] sharded_ntt m=2^{m.bit_length() - 1} on {n} positions of the card: forward {1e3 * fwd_s:.2f} ms, "
            f"inverse {1e3 * inv_s:.2f} ms (Domain.fft + ifft {1e3 * single_s:.2f} ms), each after a warm-up call, "
            f"equal limb for limb, on {card}")

    # 2. the sharded sorted MSM on the real Spend's l and b_g2 queries
    mesh = PM.make_mesh(MESH_POSITIONS, devices=[dev] * MESH_POSITIONS)
    for q, group in (("l", 1), ("b_g2", 2)):
        fops = W.G1Ops if group == 1 else W.G2Ops
        pk = torch.as_tensor(TP._pad_pow2(params.rows(q), group == 2), device=dev)
        limbs = fr_rows(pk.shape[0], mont=False)
        pts = {}
        for signed in (False, True):
            out, mesh_s = _timed(lambda: placed(PM.sharded_sorted_msm(mesh, fops, pk, limbs, 8, axis="msm",
                                                                      from_limbs=True, signed=signed), q), warm=True)
            single, single_s = _timed(lambda: MS.sorted_msm_from_limbs(fops, pk, limbs, 8, signed=signed), warm=True)
            rows = [out.shards[p] for p in mesh.local_positions()]
            if not all(torch.equal(r, rows[0]) for r in rows):
                raise AssertionError(f"[mesh] {q}: the positions hold different limbs after the butterfly")
            pts[signed] = _affine_point(group, rows[0])
            if pts[signed] != _affine_point(group, single):
                raise AssertionError(f"[mesh] {q}: the sharded MSM (signed={signed}) differs from the single one")
            log(f"[mesh] sharded_sorted_msm {q} ({pk.shape[0]} rows, G{group}, c=8, signed={signed}) on "
                f"{MESH_POSITIONS} positions: {1e3 * mesh_s:.2f} ms, single device {1e3 * single_s:.2f} ms, each "
                f"after a warm-up call; equal as points, every position the same limbs, on {card}")
        if pts[False] != pts[True]:
            raise AssertionError(f"[mesh] {q}: signed and unsigned MSMs differ")

    # 3. signed proofs on both ladders, against the unsigned proofs
    pvk = prepare_verifying_key(params.vk)
    make, publics = fixture("spend")
    wasm, route = synthesize_witness(make())
    r, s = rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)
    signed0, affine0 = TP.MSM_SIGNED, MS.AFFINE_LADDER
    try:
        for affine in (False, True):
            MS.AFFINE_LADDER = affine
            proofs = {}
            for signed in (False, True):
                TP.MSM_SIGNED = signed
                proofs[signed], secs = _timed(lambda: TP.create_proof_from_assembly(wasm, params, r, s, device=dev))
                log(f"[mesh] Spend proof, {'affine' if affine else 'scan'} ladder, signed={signed}: "
                    f"{1e3 * secs:.2f} ms on {card}")
            if proofs[True].write() != proofs[False].write() or not verify_proof(pvk, proofs[True], publics):
                raise AssertionError(f"[mesh] the signed proof ({'affine' if affine else 'scan'} ladder) differs "
                                     f"from the unsigned one or fails verify_proof")
    finally:
        TP.MSM_SIGNED, MS.AFFINE_LADDER = signed0, affine0
    log("[mesh] signed proofs on both ladders equal the unsigned proofs byte for byte and verify")

    # 4. the mesh proof beside the single-device proof
    TP.create_proof_from_assembly(wasm, params, r, s, mesh=mesh)  # warm-up: the sharded queries
    tracing.enable()
    tracing.reset()
    reset_launches()
    mesh_proof, mesh_s = _timed(lambda: TP.create_proof_from_assembly(wasm, params, r, s, mesh=mesh))
    launches = dict(LAUNCHES)
    mesh_stages = tracing.stats()
    TP.create_proof_from_assembly(wasm, params, r, s, device=dev)  # warm-up: the single-device queries
    tracing.reset()
    single_proof, single_s = _timed(lambda: TP.create_proof_from_assembly(wasm, params, r, s, device=dev))
    single_stages = tracing.stats()
    tracing.enable(False)
    log(f"[mesh] Spend proof on {MESH_POSITIONS} positions of the card: {1e3 * mesh_s:.2f} ms; single device "
        f"{1e3 * single_s:.2f} ms, on {card}")
    for name in dict.fromkeys([*single_stages, *mesh_stages]):
        log(f"[mesh]   stage {name}: mesh {_per_proof(mesh_stages, name, 1)}, single "
            f"{_per_proof(single_stages, name, 1)} (host / stream ms)")
    log(f"[mesh] launches of the mesh proof: {json.dumps({k: v for k, v in launches.items() if v})}")
    if mesh_proof.write() != single_proof.write() or not verify_proof(pvk, mesh_proof, publics):
        raise AssertionError("[mesh] the mesh proof differs from the single-device proof or fails verify_proof")
    for name in SCAN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"[mesh] kernel {name} was not launched by the mesh proof")
    log("[mesh] the mesh proof equals the single-device proof byte for byte and verifies")

    # 5. the lane-private Pippenger against the sorted MSM
    pk = torch.as_tensor(params.rows("l")[:MESH_PIPPENGER], device=dev)
    digits = MS.windows_from_limbs(fr_rows(MESH_PIPPENGER, mont=False), 8)
    xyz = tuple(pk[:, i * 24 : (i + 1) * 24] for i in range(3))
    pip, pip_s = _timed(lambda: M.pippenger_msm(W.G1Ops, xyz, digits, 8, lanes=64), warm=True)
    srt, srt_s = _timed(lambda: MS.sorted_msm(W.G1Ops, pk, digits, 8), warm=True)
    if _affine_point(1, torch.cat([c.reshape(-1) for c in pip])) != _affine_point(1, srt):
        raise AssertionError("[mesh] pippenger_msm differs from sorted_msm")
    log(f"[mesh] pippenger_msm {MESH_PIPPENGER} G1 points c=8 64 lanes: {1e3 * pip_s:.2f} ms, sorted_msm "
        f"{1e3 * srt_s:.2f} ms, each after a warm-up call, equal as points, on {card}")

    # 6. the tools' entry and dry run on 8 positions of the card
    fn, args = multichip.entry(dev)
    point, entry_s = _timed(lambda: fn(*args))
    if not W.decode_g1_points(*(c.cpu()[None] for c in point))[0].is_on_curve():
        raise AssertionError("[mesh] multichip.entry's MSM is not a curve point")
    t0 = time.perf_counter()
    multichip.dryrun_multichip(8, devices=[dev] * 8)
    log(f"[mesh] multichip entry {1e3 * entry_s:.2f} ms; dryrun_multichip(8) and mesh_prover_check "
        f"{time.perf_counter() - t0:.2f} s on 8 positions of the card; phase mesh {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")
    return {"launches": launches, "mesh_s": mesh_s, "single_s": single_s}


# --- phase routes: the prover's off-by-default MSM routes ------------------------------

def routes_phase(circuits: dict, dev, rng, card: str) -> dict:
    """Phase routes: the real Spend of phase circuits, one witness and one
    (r, s), proved through every route of ROUTES on the card: the default,
    host digits, the stacked G1 MSMs, the fused prove, BGMW for h at c = 12
    and the lane-private Pippenger. Each route: one warm-up proof (it builds
    the route's device layout), then one timed proof with the tracing spans
    on and the launch counts zeroed just before it; both must pass the host
    verifier and equal the default proof byte for byte, and the timed proof
    must launch every kernel of ROUTE_KERNELS. For BGMW the table's build
    time and memuse.device_usage(params) before and after it are logged. The
    module constants are restored, and the parameters' device cache
    cleared, in a finally. Returns each route's launches and times."""
    import torch

    from masp_tpu_torch.groth16 import prover as TP
    from masp_tpu_torch.groth16.synthesis import synthesize_witness
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.tools.fixtures import fixture
    from masp_tpu_torch.utils import memuse, tracing

    t_phase = time.perf_counter()
    params = circuits["spend"]["params"]
    pvk = prepare_verifying_key(params.vk)
    make, publics = fixture("spend")
    wasm, _ = synthesize_witness(make())
    r, s = rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)
    saved = {k: getattr(TP, k) for k in TP.msm_flags({})}
    out = {"launches": {}, "wall_s": {}, "stages": {}}
    want = None
    try:
        for label, env in ROUTES:
            for k, v in TP.msm_flags(env).items():
                setattr(TP, k, v)
            if label == "bgmw_h":
                TP.MSM_BGMW_H = False
                TP.prepare_device_params(params, dev)
                before = memuse.device_usage(params)
                TP.MSM_BGMW_H = True
                _, build_s = _timed(lambda: TP.prepare_device_params(params, dev))
                after = memuse.device_usage(params)
                out["bgmw"] = {"build_s": build_s, "bytes_before": before, "bytes_after": after}
                log(f"[routes] bgmw_h: table of {params.device['h_bgmw'].shape[0]} rows (c = {TP.MSM_BGMW_C}, "
                    f"{TP.MSM_BGMW_C * (params.device['h_bgmw'].shape[0] // params.device['h'].shape[0] - 1)} "
                    f"g1_add launches) built in {build_s:.4f} s; memuse.device_usage(params) {before} -> {after} "
                    f"bytes (+{after - before}), on {card}")
            warm, warm_s = _timed(lambda: TP.create_proof_from_assembly(wasm, params, r, s, device=dev))
            tracing.enable()
            tracing.reset()
            reset_launches()
            proof, wall_s = _timed(lambda: TP.create_proof_from_assembly(wasm, params, r, s, device=dev))
            launches = dict(LAUNCHES)
            stages = tracing.stats()
            tracing.enable(False)
            if want is None:
                want = proof.write()
            for p in (warm, proof):
                if p.write() != want or not verify_proof(pvk, p, publics):
                    raise AssertionError(f"[routes] {label}: a proof differs from the default proof or fails "
                                         f"verify_proof")
            for name in ROUTE_KERNELS:
                if launches[name] <= 0:
                    raise AssertionError(f"[routes] {label}: kernel {name} was not launched")
            out["launches"][label], out["wall_s"][label], out["stages"][label] = launches, wall_s, stages
            log(f"[routes] {label}: proof {1e3 * wall_s:.2f} ms (warm-up {1e3 * warm_s:.2f} ms; layout "
                f"{params.device['layout']}), equal to the default proof and verified, on {card}")
            for name in stages:
                log(f"[routes]   {label} stage {name}: {_per_proof(stages, name, 1)} (host / stream ms)")
            log(f"[routes]   {label} launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    finally:
        for k, v in saved.items():
            setattr(TP, k, v)
        params.device.clear()
        tracing.enable(False)
    log(f"[routes] phase routes {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# --- phase bench: the port's measurement entry points ---------------------------------

def bench_phase(circuits: dict, dev, card: str, full: bool = False) -> dict:
    """Phase bench: the twins of bench.py and tools/bench_*.py
    (masp_tpu_torch/tools/) run in-process on the circuits phase's
    Parameters, each printing its JSON lines through utils/benchlog.py:
    bench.py's single mode on the real Spend at BENCH_ITERS (its span table
    logged), then BENCH_BATCH proofs a window as one stream; bench_batch on
    Output at B = BENCH_BATCH; bench_tx at one iteration; bench_verify at B =
    BENCH_BATCH with the device pairing; with ``full`` (--bench) also the
    64-proof mixed bundle and bench_verify at B = BENCH_VERIFY_FULL. Every
    proof the twins make is checked by them (the host verifier, the batch
    validator); each run's launches start at 0 just before it, and the
    proving runs must launch every scan kernel, bench_verify the device
    pairing's and the RedJubjub device batch's kernels. Logs launches per
    proof beside the circuits phase's. Returns the launches by run."""
    from masp_tpu_torch.groth16.local_prover import LocalTxProver
    from masp_tpu_torch.groth16.prover import create_proof_from_assembly, synthesize_witness
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.kernels import LAUNCHES, reset_launches
    from masp_tpu_torch.tools import bench, bench_batch, bench_mixed_batch, bench_tx, bench_verify
    from masp_tpu_torch.tools.fixtures import BENCH_SEED, fixture
    from masp_tpu_torch.utils import benchlog, tracing

    t_phase = time.perf_counter()
    params = {k: circuits[k]["params"] for k in CIRCUITS}
    launches = {}

    def run(label, fn, must_launch, proofs=None):
        """fn() with the launch counts zeroed just before it; its launches
        per proof of ``proofs`` (kind, count) beside the circuits phase's."""
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        launches[label] = dict(LAUNCHES)
        missing = [k for k in must_launch if launches[label][k] <= 0]
        if missing:
            raise AssertionError(f"[bench] {label}: kernels {missing} were not launched")
        log(f"[bench] {label}: {wall:.2f} s on {card}; launches {json.dumps({k: v for k, v in launches[label].items() if v})}")
        if proofs is not None:
            kind, n = proofs
            one = circuits[kind]
            per = {k: round(v / n, 2) for k, v in launches[label].items() if v}
            was = {k: round(v / len(one["proof_s"]), 2) for k, v in one["launches"].items() if v}
            log(f"[bench] {label}: launches per proof {json.dumps(per)}; circuits phase {json.dumps(was)}")
        return res

    def emit(result, samples=None, **extra):
        """benchlog's line, then its raw samples, which only the log keeps."""
        benchlog.emit(result, samples, device=str(dev), **extra)
        if samples is not None:
            log(f"[bench]   samples (s): {[round(x, 6) for x in samples]}")

    make, publics = fixture("spend")
    tracing.enable()
    try:
        result, raw = run("bench", lambda: bench.measure(make, params["spend"], publics, BENCH_ITERS, device=dev),
                          SCAN_KERNELS, ("spend", 1 + BENCH_ITERS))
        for line in tracing.report().splitlines():
            log(f"[bench]   {line}")
    finally:
        tracing.enable(False)
    emit(result, raw, circuit="spend", batch=0)
    result, raw = run("bench_stream", lambda: bench.measure(make, params["spend"], publics, BENCH_ITERS, BENCH_BATCH,
                                                            True, dev), SCAN_KERNELS,
                      ("spend", 1 + BENCH_ITERS * BENCH_BATCH))
    emit(result, raw, circuit="spend", batch=BENCH_BATCH, stream=True)

    make_o, publics_o = fixture("output")
    result = run("bench_batch", lambda: bench_batch.measure(make_o, params["output"], publics_o, BENCH_BATCH,
                                                            "output", dev), SCAN_KERNELS,
                 ("output", 1 + 3 * BENCH_BATCH))
    emit(result, circuit="output", batch=BENCH_BATCH)

    prover = LocalTxProver(params["spend"], params["output"], params["convert"])
    for line in run("bench_tx", lambda: bench_tx.measure(prover, XorShiftRng.from_seed(BENCH_SEED), 1, dev),
                    SCAN_KERNELS):
        emit(*line)
    if full:
        for line in run("bench_mixed_batch", lambda: bench_mixed_batch.measure(
                prover, XorShiftRng.from_seed(BENCH_SEED), BENCH_MIXED_ITERS, device=dev), SCAN_KERNELS):
            emit(*line)

    proof = create_proof_from_assembly(synthesize_witness(make_o()), params["output"], 7, 9, device=dev)
    pvk = prepare_verifying_key(params["output"].vk)
    for batch, iters in [(BENCH_BATCH, 1)] + ([(BENCH_VERIFY_FULL, BENCH_VERIFY_ITERS)] if full else []):
        for line in run(f"bench_verify B={batch}", lambda: bench_verify.measure(
                pvk, proof, publics_o, XorShiftRng.from_seed(BENCH_SEED), batch, iters, dev),
                PAIRING_KERNELS + ["jubjub_add", "fr_sqrt", "mont_mul_fr"]):
            emit(*line)
    log(f"[bench] phase bench {time.perf_counter() - t_phase:.1f} s on {card} (backend {benchlog.backend()})")
    return launches


# --- main ------------------------------------------------------------------------------

def ptxas_report(build) -> dict:
    """Each kernel's "registers, shared bytes, spill bytes" from ptxas's
    report (-Xptxas -v) in its source's build log."""
    import re

    entries = {}
    for src in build.SOURCES:
        fn = None
        for line in build.log_path(src).read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                entries.setdefault((src, fn), {})["spill"] = max(int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                smem = re.search(r"(\d+) bytes smem", line)
                entries.setdefault((src, fn), {}).update(regs=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    out = {}
    for name, (src, part) in ENTRY.items():
        found = [e for (s_, fn), e in entries.items() if s_ == src and part in fn and "regs" in e]
        out[name] = (f"{found[0]['regs']} registers, {found[0]['smem']} B shared, {found[0].get('spill', 0)} B spill"
                     if len(found) == 1 else None)
        if out[name] is None:
            log(f"  ptxas: no single entry function of {src}.cu matches {part} ({len(found)} found)")
    return out


def _sass_functions(text: str) -> dict:
    """{function: [(address, opcode, operands)]} from cuobjdump -sass
    output, NOPs left out; opcodes without their modifiers (IMAD.WIDE is
    IMAD)."""
    import re

    funcs, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*)", line)
        if m and fn and m.group(2) != "NOP":
            funcs[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def _loop_body(ins: list):
    """The instructions of the function's one loop: from the target of its
    one backward branch to that branch (None unless there is exactly one)."""
    import re

    back = []
    for addr, op, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    if len(back) != 1:
        return None
    lo, hi = back[0]
    return [x for x in ins if lo <= x[0] <= hi]


def sass_report(build) -> dict:
    """Static SASS instructions of each mont_mul_kernel instance in the
    built library (cuobjdump -sass): one thread runs the function once for
    its one product, so this is the count per product, both load paths
    (16-byte and 4-byte) included; with the IMAD family and IADD3 among
    them. For each mont_inv_kernel instance, the static count, its batch
    loop's body and the instructions one row runs: the rest once and the
    body once a batch (no branch inside it depends on the data)."""
    from collections import Counter
    from pathlib import Path

    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.ops.field import FQ, FR

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        log(f"  sass: no cuobjdump beside nvcc ({tool}): not measured")
        return {}
    text = subprocess.run([str(tool), "-sass", str(build.lib_path("mont_mul"))], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    funcs = _sass_functions(text)

    def one(part):
        found = [ins for f, ins in funcs.items() if part in f]
        if len(found) != 1:
            raise AssertionError(f"sass: {len(found)} functions of mont_mul.cu match {part}")
        return found[0]

    out = {}
    for name, part in (("mont_mul_fr", "mont_mul_kernelI2Fr"), ("mont_mul_fq", "mont_mul_kernelI2Fq")):
        c = Counter(op for _, op, _ in one(part))
        out[name] = {"instructions": sum(c.values()), "imad": c["IMAD"], "iadd3": c["IADD3"],
                     "top": dict(c.most_common(8))}
        log(f"  sass {name}: {out[name]['instructions']} instructions per product (static, both load paths), "
            f"IMAD family {c['IMAD']}, IADD3 {c['IADD3']}; most frequent {json.dumps(out[name]['top'])}")
    for name, part, spec in (("mont_inv_fr", "mont_inv_kernelI2Fr", FR), ("mont_inv_fq", "mont_inv_kernelI2Fq", FQ)):
        ins = one(part)
        body = _loop_body(ins)
        batches = MK.divstep_constants(spec).batches
        r = {"instructions": len(ins), "top": dict(Counter(op for _, op, _ in ins).most_common(8))}
        if body is None:
            log(f"  sass {name}: {len(ins)} instructions (static); no single batch loop found: the chain's length "
                f"not measured")
        else:
            c = Counter(op for _, op, _ in body)
            r.update(loop=len(body), per_row=len(ins) - len(body) + batches * len(body),
                     loop_top=dict(c.most_common(8)))
            log(f"  sass {name}: {len(ins)} instructions (static), the batch loop's body {len(body)} (IMAD family "
                f"{c['IMAD']}), so {r['per_row']} a row over {batches} batches; the body's most frequent "
                f"{json.dumps(r['loop_top'])}")
        out[name] = r
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from masp_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: masp_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2
    from masp_tpu_torch.groth16 import generate_parameters
    from masp_tpu_torch.groth16.generator import eval_at_tau
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.ops import msm_sorted as MS

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    variants = ([("point_add", (f"MASP_G1_ADD_BLOCK={b}",)) for b in G1_BLOCKS]
                + [("jubjub", JUBJUB_PROBE), ("int8_dot", INT8_PROBE)])
    build.build_all(variants)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (one nvcc per source and variant, in parallel)")
    for src, defines in [(s, ()) for s in build.SOURCES] + variants:
        for line in build.log_path(src, defines).read_text().splitlines():
            if any(t in line for t in ("registers", "spill", "Compiling entry", "Performance Loss")):
                log(f"  ptxas {' '.join([src, *defines])}: {line.strip()}")

    rng = random.Random(SEED)
    if "--pairing" in argv:
        pairing_phase(dev, rng, card, "--profile" in argv)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
        return 0
    if "--jubjub" in argv:
        jubjub_phase(dev, rng, card)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
        return 0
    if any(f in argv for f in ("--circuits", "--batch", "--tx", "--mesh", "--routes", "--bench")):
        circuits = circuits_phase(dev, rng, card, "--profile" in argv)
        if "--batch" in argv:
            batch_phase(circuits, dev, card)
        if "--tx" in argv:
            tx_phase(circuits, dev, card)
        if "--mesh" in argv:
            mesh_phase(circuits, dev, rng, card)
        if "--routes" in argv:
            routes_phase(circuits, dev, rng, card)
        if "--bench" in argv:
            bench_phase(circuits, dev, card, full=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
        return 0
    t0 = time.perf_counter()
    asm, z, publics = spend_shaped_r1cs(SEED)
    counts = r1cs_counts(asm)
    log(f"setup: Spend-shaped R1CS in {time.perf_counter() - t0:.1f} s: {json.dumps(counts)}")
    for k, want in SPEND.items():
        if abs(counts[k] - want) > 0.05 * want:
            raise AssertionError(f"R1CS count {k} = {counts[k]} is not within 5% of Spend's {want}")
    tau, alpha, beta, gamma, delta = (rng.randrange(1, 1 << 250) for _ in range(5))
    t0 = time.perf_counter()
    params = generate_parameters(asm, tau, alpha, beta, gamma, delta, device=dev)
    torch.cuda.synchronize()
    log(f"setup: parameters on the card in {time.perf_counter() - t0:.1f} s "
        f"(h {len(params.h)}, l {len(params.l)}, a {len(params.a)}, b {len(params.b_g1)})")

    ptxas = ptxas_report(build)
    sass = sass_report(build)
    kern = kernel_phase(params, dev, rng, card)
    tools = tools_phase(dev, rng, card)
    if "--kernels" in argv:
        return 0

    m = 1 << (asm.num_constraints - 1).bit_length()
    u, v, w = eval_at_tau(asm, tau, m)
    pvk = prepare_verifying_key(params.vk)
    rs = [(rng.randrange(1, 1 << 250), rng.randrange(1, 1 << 250)) for _ in range(4)]

    def check(r, s, proof):
        if not verify_proof(pvk, proof, publics):
            raise AssertionError("a proof failed the host pairing verifier")
        if proof != oracle_proof(u, v, w, z, tau, alpha, beta, delta, r, s, asm.num_inputs):
            raise AssertionError("a proof differs from the toxic-waste oracle")

    # both MSM configurations, each with the launch counts zeroed just before
    # its timed proofs: the default (the main path) first, the projective
    # scan ladder with the sequential reduction; then the batch-affine
    # ladder with the wide reduction, which runs every proof kernel
    affine_kernels = [k for k in PROOF_KERNELS if k.startswith("affine")]
    configs = {"scan": (False, SCAN_KERNELS),
               "affine": (True, PROOF_KERNELS)}
    order = sorted(configs, key=lambda label: configs[label][0] != MS.AFFINE_LADDER)
    default, launches = MS.AFFINE_LADDER, {}
    try:
        for label in order:
            MS.AFFINE_LADDER, must_launch = configs[label]
            launches[label] = prove_phase(label, asm, params, rs, check, card, dev, must_launch)[1]
        if "--profile" in argv:
            for label in order:
                MS.AFFINE_LADDER = configs[label][0]
                profile_proof(label, asm, params, rs[1], dev, card)
    finally:
        MS.AFFINE_LADDER = default
    if any(launches["scan"][k] for k in affine_kernels):
        raise AssertionError("[scan] the scan ladder launched the affine kernels")
    circuits = circuits_phase(dev, rng, card, "--profile" in argv)
    batch = batch_phase(circuits, dev, card)
    tx = tx_phase(circuits, dev, card)
    mesh = mesh_phase(circuits, dev, rng, card)
    routes = routes_phase(circuits, dev, rng, card)
    jubjub = jubjub_phase(dev, rng, card)
    pairing = pairing_phase(dev, rng, card, "--profile" in argv)
    bench = bench_phase(circuits, dev, card)
    kern.update(jubjub["kernels"])
    leaf_per_proof(leaf_widths(asm, params, rs[1], dev), params, dev, card)
    for name, r in mont_mul_per_proof(mont_mul_widths(asm, params, rs[1], dev), dev, card).items():
        kern[name]["per_proof"] = r

    def path_launches(name):
        """Launches on the path that runs the kernel: the affine kernels'
        in the affine configuration's proofs, the Jubjub kernels' and the Fr
        inversion's on the Jubjub path, the other proof kernels' in the main
        path's."""
        if name in EDWARDS_KERNELS or name == "mont_inv_fr":
            return jubjub["launches"][name]
        return launches["affine" if name in affine_kernels else order[0]][name]

    # "ms" is per launch inside a CUDA graph with inputs from HBM; "eager_ms"
    # is CUDA events around one eager call, the host's launch included;
    # "bytes" and "ops_ms" are the two sides of the bound; "launches_by_path"
    # holds each configuration's and each real circuit's launches over its
    # timed proofs, the bundle's at window 2, the default ("batch"), the
    # wallet's transaction path, summed over phase tx's steps ("tx"), the
    # mesh proof of phase mesh ("mesh"), each route's timed proof of phase
    # routes ("routes/<route>"), the Jubjub path's ("jubjub"), the
    # device pairing's product checks
    # ("pairing"; the tools' kernels have this entry alone) and phase bench's
    # runs of the measurement twins, summed ("bench");
    # "widest" is a leaf add's pairs and ms at the main path's widest leaf
    # launch; a product's "forms" (ms through F.mont_mul and
    # bound per operand form), "narrow_ms" (rows: ms, inputs in L2),
    # "per_proof" (the main path's launches timed at their widths and forms,
    # summed) and "sass"; "all_cases_ms" is jubjub_add's ms on the 8 pairs of
    # every addition case; "widths_ms" pedersen_fold's ms by hashes;
    # "ops_ms_fe_mul" the operation bound of the add, the fold and fr_sqrt as
    # their parents counted it, in fe_mul's multiply-adds: 12 products an
    # add or a step (they run 12 or 11 of fr_mul's fewer), 951 a square root
    # (it runs 752 fr_sqr and 129 fr_mul); "path_widths_ms" fr_sqrt's ms at
    # each width the Jubjub path launches it at;
    # "mont_mul_fq_ms" mont_mul_fq's ms on mont_mul_mxu's rows; int8_dot_loop's
    # "rep_ms" (ms a product: the tools' graph slope from 4096 to 32768),
    # "rep_bound_ms" (one product's operation bound), "k8_ms" (ms a launch
    # of 8 products, as "ms" is of 64: the fixed cost), "probe_sms" (the SMs
    # of one launch of the -DMASP_INT8_PROBE build) and "sass" (its
    # tensor-core instructions); its "library_ms" is torch._int_mm of the
    # K-tiled operands
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
        "launches": k["launches"] if name in TOOL_KERNELS else path_launches(name),
        "launches_by_path": {"pairing": pairing["launches"][name]} if name in TOOL_KERNELS else {
            **{label: launches[label][name] for label in order},
            **{kind: c["launches"][name] for kind, c in circuits.items()},
            "batch": batch[BATCH_WINDOWS[-1]][name], "tx": tx["launches"][name], "mesh": mesh["launches"][name],
            **{f"routes/{label}": routes["launches"][label][name] for label, _ in ROUTES},
            "jubjub": jubjub["launches"][name], "pairing": pairing["launches"][name],
            "bench": sum(run[name] for run in bench.values())},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "eager_ms": k["eager_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k.get("library_ms"), "bytes": k["bytes"],
        "ops_ms": k["ops_ms"], "ptxas": ptxas[name], "widest": k.get("widest"),
        **{key: k[key] for key in ("forms", "narrow_ms", "per_proof", "all_cases_ms", "widths_ms", "ops_ms_fe_mul",
                                   "path_widths_ms", "mont_mul_fq_ms", "rep_ms", "rep_bound_ms", "k8_ms",
                                   "probe_sms", "sass") if key in k},
        **({"sass": sass[name]} if name in sass else {})}
        for name, k in {**kern, **tools}.items()]}
    print(json.dumps(line))
    print(card)
    # the run used one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
