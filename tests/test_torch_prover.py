"""The port's Groth16 prover and generator against the JAX package's host
reference: parameters carried across with params_from_arrays, the R1CS with
assembly_from_arrays, proofs compared byte for byte with
masp_tpu.groth16.reference.host_proof (and, marked slow for its minutes of
XLA compilation on the CPU, with masp_tpu's create_proof_from_assembly)."""

import os
import ast
from pathlib import Path

import pytest
import torch

from masp_tpu.curves.bls12_381 import G1, G2, R
from masp_tpu.groth16 import generator as GEN
from masp_tpu.groth16 import prover as P
from masp_tpu.groth16 import reference as REF
from masp_tpu.groth16.structures import Parameters, VerifyingKey
from masp_tpu.primitives.pedersen import Personalization as JPersonalization
from masp_tpu.primitives.pedersen import pedersen_hash as host_pedersen_hash
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu.r1cs.cs import ONE, KeypairAssembly, ProvingAssembly, lc_var
from masp_tpu.r1cs.gadgets import boolean as JB
from masp_tpu.r1cs.gadgets import pedersen as JPED
from masp_tpu.r1cs.gadgets.boolean import AllocatedBit
from masp_tpu_torch import groth16 as TG
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import synthesis as TS
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.host.primitives.pedersen import Personalization as TPersonalization
from masp_tpu_torch.host.r1cs.cs import KeypairAssembly as TKeypairAssembly
from masp_tpu_torch.host.r1cs.gadgets import boolean as TB
from masp_tpu_torch.host.r1cs.gadgets import pedersen as TPED
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.host.structures import prepare_verifying_key
from masp_tpu_torch.host.verifier import verify_proof
from tests.test_groth16 import CubicCircuit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parent.parent
WASTE = (11, 13, 17, 19, 23)  # tau, alpha, beta, gamma, delta


class BitsCircuit:
    """Six bits, their xor and and, packed into v; out = v^2 + (b0 xor b1)."""

    def __init__(self, bits=None):
        self.bits = bits

    def synthesize(self, cs):
        vals = self.bits or [None] * 6
        bs = [AllocatedBit.alloc(cs, b) for b in vals]
        x = AllocatedBit.xor(cs, bs[0], bs[1])
        AllocatedBit.and_(cs, bs[2], bs[3])
        known = self.bits is not None
        v_val = sum(b << i for i, b in enumerate(vals)) if known else None
        v = cs.alloc("v", v_val)
        pack = lc_var(bs[0].var)
        for i, b in enumerate(bs[1:], 1):
            pack = pack + lc_var(b.var, 1 << i)
        cs.enforce("pack", pack, lc_var(ONE), lc_var(v))
        sq = cs.alloc("sq", v_val * v_val if known else None)
        cs.enforce("sq", lc_var(v), lc_var(v), lc_var(sq))
        out_val = (v_val * v_val + (vals[0] ^ vals[1])) % R if known else None
        out = cs.alloc_input("out", out_val)
        cs.enforce("out", lc_var(sq) + x.var, lc_var(ONE), lc_var(out))


class PedersenBitsCircuit:
    """A u64 split into 64 boolean wires and Pedersen-hashed in the circuit
    (note-commitment personalization); the hash point is the public input.
    ``mods`` = (boolean gadgets, Pedersen gadget, Personalization) of either
    package, so that each synthesises it with its own copy."""

    def __init__(self, mods, value=None):
        self.mods = mods
        self.value = value

    def synthesize(self, cs):
        boolean, pedersen, personalization = self.mods
        with cs.ns("value"):
            bits = boolean.u64_into_boolean_vec_le(cs, self.value)
        with cs.ns("hash"):
            point = pedersen.pedersen_hash(cs, personalization.note_commitment(), bits)
        point.inputize(cs)


def _host_params(circuit):
    """masp_tpu Parameters from the toxic waste, by host scalar muls."""
    tau, alpha, beta, gamma, delta = WASTE
    cs = KeypairAssembly()
    circuit.synthesize(cs)
    GEN._add_input_constraints(cs)
    m = 1 << (cs.num_constraints - 1).bit_length()
    u, v, w, _ = GEN._eval_at_tau(cs, tau, m)
    ad, bd = GEN._densities(cs)
    ni = cs.num_inputs
    gi, di = pow(gamma, -1, R), pow(delta, -1, R)
    g1, g2 = G1.generator(), G2.generator()
    k = [(beta * u[i] + alpha * v[i] + w[i]) % R for i in range(len(u))]
    zt = (pow(tau, m, R) - 1) % R
    vk = VerifyingKey(g1 * alpha, g1 * beta, g2 * beta, g2 * gamma, g1 * delta, g2 * delta,
                      [g1 * (k[i] * gi % R) for i in range(ni)])
    return Parameters(
        vk=vk,
        h=[g1 * (zt * di * pow(tau, i, R) % R) for i in range(m - 1)],
        l=[g1 * (k[i] * di % R) for i in range(ni, len(u))],
        a=[g1 * u[i] for i in range(len(u)) if ad[i]],
        b_g1=[g1 * v[i] for i in range(len(v)) if bd[i]],
        b_g2=[g2 * v[i] for i in range(len(v)) if bd[i]],
    ), cs


def _port_params(params):
    vk = params.vk
    enc1, enc2 = WJ.encode_g1_points, WJ.encode_g2_points
    return TG.params_from_arrays(
        enc1([vk.alpha_g1, vk.beta_g1, vk.delta_g1]), enc2([vk.beta_g2, vk.gamma_g2, vk.delta_g2]),
        enc1(vk.ic), enc1(params.h), enc1(params.l), enc1(params.a), enc1(params.b_g1),
        enc2(params.b_g2),
    )


def _witness(circuit):
    cs = ProvingAssembly()
    circuit.synthesize(cs)
    GEN._add_input_constraints(cs)
    indptr, var_idx, coeffs = P._csr_for(cs)
    return cs, TG.assembly_from_arrays(cs.num_inputs, indptr, var_idx, coeffs, P._assignment_u64(cs))


@pytest.fixture(params=["affine", "scan"])
def ladder(request, monkeypatch):
    """Both prover configurations: the batch-affine MSM ladder with the wide
    reduction (the default) and the projective scan ladder. The affine case
    runs one affine level, a quarter of the CPU's root-inverse chains;
    tests/test_torch_affine.py holds the multi-level ladder."""
    monkeypatch.setattr(MS, "AFFINE_LADDER", request.param == "affine")
    monkeypatch.setattr(MS, "AFFINE_LEVELS", 1)
    return request.param


@pytest.fixture
def small_window(monkeypatch):
    # c = 4 halves the sequential bucket-reduction steps on the CPU; the
    # proof does not depend on the window width
    monkeypatch.setattr(TP, "MSM_C", 4)


def test_cubic_proof_matches_host_reference(small_window, ladder):
    params, _ = _host_params(CubicCircuit())
    tparams = _port_params(params)
    cs, asm = _witness(CubicCircuit(x=3))
    r, s = 5, 7
    proof = TG.create_proof_from_assembly(asm, tparams, r, s, device="cpu")
    assert proof.write() == REF.host_proof(cs, params, r, s).write()
    pvk = prepare_verifying_key(tparams.vk)
    assert verify_proof(pvk, proof, [35])
    assert not verify_proof(pvk, proof, [36])
    assert not any(k.endswith("_small") for k in tparams.device)


def test_split_proof_matches_host_reference(small_window, ladder, monkeypatch):
    """A circuit with bit wires, the boolean split forced on by a lower
    threshold: the l/a/b queries each run a masked sum plus a full MSM."""
    monkeypatch.setattr(TP, "MSM_SPLIT_MIN", 2)
    bits = [1, 0, 1, 1, 0, 1]
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    cs, asm = _witness(BitsCircuit(bits))
    mask = TP.boolean_var_mask(asm)
    assert (mask == P._boolean_var_mask(cs)).all() and mask.sum() == 8
    r, s = 3, 9
    proof = TG.create_proof_from_assembly(asm, tparams, r, s, device="cpu")
    assert {k for k in tparams.device if k.endswith("_small")} == {"l_small", "a_small", "b_g1_small", "b_g2_small"}
    assert proof.write() == REF.host_proof(cs, params, r, s).write()
    v = sum(b << i for i, b in enumerate(bits))
    assert verify_proof(prepare_verifying_key(tparams.vk), proof, [v * v + (bits[0] ^ bits[1])])


def test_msm_flags_are_read_or_raise(monkeypatch):
    """The JAX package's MSM variables are read at import with the port's
    defaults and derived as the reference derives them (FROM_LIMBS only for
    the sorted MSM unstacked, SIGNED and FUSED only with FROM_LIMBS, SPLIT
    only for the sorted MSM unstacked, BGMW_H only for the sorted MSM with
    FROM_LIMBS), and MASP_MSM_SPLIT=0 keeps every query whole where the
    split would run; a value the port does not take raises ValueError."""
    import subprocess
    import sys

    default = {"MSM_C": 8, "MSM_IMPL": "sorted", "MSM_STACK": False, "MSM_FROM_LIMBS": True,
               "MSM_SIGNED": False, "MSM_SPLIT": True, "MSM_SPLIT_MIN": 32768, "MSM_FUSED": False,
               "MSM_BGMW_H": False, "MSM_BGMW_C": 12, "ABC_DEVICE": True}
    assert TP.msm_flags({}) == default
    assert TP.msm_flags({"MASP_MSM_C": "4", "MASP_MSM_SPLIT": "0", "MASP_MSM_SPLIT_MIN": "2",
                         "MASP_ABC_DEVICE": "1"}) == {**default, "MSM_C": 4, "MSM_SPLIT": False, "MSM_SPLIT_MIN": 2}
    assert TP.msm_flags({"MASP_MSM_SIGNED": "1", "MASP_ABC_DEVICE": "0"}) == {
        **default, "MSM_SIGNED": True, "ABC_DEVICE": False}
    # each route, and what the reference's derivations make of it
    routes = [
        ({"MASP_MSM_FROM_LIMBS": "0", "MASP_MSM_SIGNED": "1", "MASP_MSM_FUSED": "1", "MASP_MSM_BGMW_H": "1"},
         {"MSM_FROM_LIMBS": False}),
        ({"MASP_MSM_STACK": "1", "MASP_MSM_SIGNED": "1"}, {"MSM_STACK": True, "MSM_FROM_LIMBS": False,
                                                           "MSM_SPLIT": False}),
        ({"MASP_MSM_FUSED": "1", "MASP_MSM_SIGNED": "1"}, {"MSM_FUSED": True, "MSM_SIGNED": True}),
        ({"MASP_MSM_BGMW_H": "1", "MASP_MSM_BGMW_C": "5"}, {"MSM_BGMW_H": True, "MSM_BGMW_C": 5}),
        ({"MASP_MSM": "lanes", "MASP_MSM_BGMW_H": "1", "MASP_MSM_FUSED": "1", "MASP_MSM_C": "4"},
         {"MSM_IMPL": "lanes", "MSM_FROM_LIMBS": False, "MSM_SPLIT": False, "MSM_C": 4}),
        ({"MASP_MSM_BGMW_C": "16"}, {"MSM_BGMW_C": 16}),
    ]
    for env, changed in routes:
        assert TP.msm_flags(env) == {**default, **changed}, env
    assert (TP.MSM_LANES_G1, TP.MSM_LANES_G2) == (P.MSM_LANES_G1, P.MSM_LANES_G2) == (64, 32)
    assert MS.ladder_flags({}) == (False, 4)
    assert MS.ladder_flags({"MASP_MSM_AFFINE": "1", "MASP_MSM_AFFINE_LEVELS": "2",
                            "MASP_MSM_WIDE_REDUCE": "1"}) == (True, 2)
    for env, match in (({"MASP_MSM_SIGNED": "2"}, None), ({"MASP_MSM_FUSED": "yes"}, None),
                       ({"MASP_MSM_BGMW_H": "2"}, None), ({"MASP_ABC_DEVICE": "yes"}, None),
                       ({"MASP_MSM": "pippenger"}, None), ({"MASP_MSM_C": "17"}, None),
                       ({"MASP_MSM_STACK": "on"}, None), ({"MASP_MSM_FROM_LIMBS": "no"}, None),
                       ({"MASP_MSM_BGMW_C": "17"}, None), ({"MASP_MSM_BGMW_C": "1"}, None),
                       ({"MASP_MSM_FROM_LIMBS": "0", "MASP_MSM_C": "5"}, "MASP_MSM_C="),
                       ({"MASP_MSM_STACK": "1", "MASP_MSM_C": "6"}, "MASP_MSM_C="),
                       ({"MASP_MSM": "lanes", "MASP_MSM_C": "12"}, "MASP_MSM_C=")):
        with pytest.raises(ValueError, match=match or next(iter(env)) + "="):
            TP.msm_flags(env)
    # the wide reduction runs on either ladder: the flag leaves the scan ladder
    assert MS.ladder_flags({"MASP_MSM_WIDE_REDUCE": "1"}) == (False, 4)
    with pytest.raises(ValueError, match="MASP_MSM_AFFINE="):
        MS.ladder_flags({"MASP_MSM_AFFINE": "yes"})
    monkeypatch.setattr(MS, "AFFINE_LADDER", True)
    with pytest.raises(ValueError, match="26 windows"):
        TP.msm_flags({"MASP_MSM_C": "10"})
    code = ("from masp_tpu_torch.groth16 import prover as P; from masp_tpu_torch.ops import msm_sorted as M; "
            "print(P.MSM_C, P.MSM_SPLIT, P.MSM_SPLIT_MIN, M.AFFINE_LADDER, M.AFFINE_LEVELS, P.MSM_SIGNED, "
            "P.ABC_DEVICE, P.MSM_FUSED, P.MSM_BGMW_H, P.MSM_BGMW_C, P.MSM_IMPL, P.MSM_STACK, P.MSM_FROM_LIMBS)")
    env = {**os.environ, "MASP_MSM_C": "4", "MASP_MSM_SPLIT": "0", "MASP_MSM_SPLIT_MIN": "9",
           "MASP_MSM_AFFINE": "1", "MASP_MSM_AFFINE_LEVELS": "3", "MASP_MSM_SIGNED": "1", "MASP_ABC_DEVICE": "0",
           "MASP_MSM_FUSED": "1", "MASP_MSM_BGMW_H": "1", "MASP_MSM_BGMW_C": "8"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.split() == ["4", "False", "9", "True", "3", "True", "False", "True", "True", "8", "sorted", "False",
                           "True"]

    monkeypatch.setattr(MS, "AFFINE_LADDER", False)
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    _, asm = _witness(BitsCircuit([1, 0, 1, 1, 0, 1]))
    TP.prepare_device_params(tparams, "cpu")
    monkeypatch.setattr(TP, "MSM_SPLIT_MIN", 2)
    TP.prepare_split_queries(tparams, asm)
    assert "l_small" in tparams.device
    monkeypatch.setattr(TP, "MSM_SPLIT", False)
    TP.prepare_split_queries(tparams, asm)
    assert not any(k.endswith("_small") for k in tparams.device)


def test_tracing_reads_masp_trace_and_profiles(tmp_path, monkeypatch):
    """The tracer starts enabled under MASP_TRACE=1 and disabled without it
    (read at import, as the reference reads it); device_profile writes a
    Chrome trace of the enclosed work into its directory, and does nothing
    for None."""
    import json
    import subprocess
    import sys

    from masp_tpu_torch.utils import tracing as T

    code = ("import importlib, os\n"
            "from masp_tpu_torch.utils import tracing as T\n"
            "for value in ('1', '0'):\n"
            "    os.environ['MASP_TRACE'] = value\n"
            "    importlib.reload(T)\n"
            "    with T.span('s'):\n        pass\n"
            "    print(T._tracer.enabled, T.stats().get('s', {}).get('count'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.split("\n")[:2] == ["True 1", "False None"]
    with T.device_profile(str(tmp_path / "trace")):
        F.mont_mul(F.FR, torch.ones(4, 16, dtype=torch.int32), torch.ones(4, 16, dtype=torch.int32))
    (trace,) = (tmp_path / "trace").iterdir()
    assert trace.suffix == ".json" and json.loads(trace.read_text())["traceEvents"]

    def no_profiler(*args, **kwargs):
        raise AssertionError("profiled without a directory")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    for log_dir in (None, ""):
        with T.device_profile(log_dir):
            pass
    assert [p.name for p in tmp_path.iterdir()] == ["trace"]


def test_h_coefficients_match_host_reference():
    """The device a/b/c evaluation and h pipeline of the prover against
    reference.host_h_coeffs on a circuit with bit wires."""
    cs, asm = _witness(BitsCircuit([0, 1, 1, 0, 1, 1]))
    cache = {"dev": torch.device("cpu")}
    st = TP._structure(cache, asm)
    m = st["m"]
    v16 = torch.as_tensor(TP._limbs(asm.assignment, asm.num_vars))
    got = TP._abc_h(Domain(m, device="cpu"), st, v16)
    assert F.decode(F.FR, got) == REF.host_h_coeffs(cs, m)


def test_generator_matches_host_parameters():
    params, kcs = _host_params(CubicCircuit())
    want = _port_params(params)
    indptr, var_idx, coeffs = P._csr_for(kcs)
    asm = TG.assembly_from_arrays(kcs.num_inputs, indptr, var_idx, coeffs,
                                  num_vars=kcs.num_inputs + kcs.num_aux)
    got = TG.generate_parameters(asm, *WASTE, device="cpu")
    assert got.vk == want.vk
    for q in ("h", "l", "a", "b_g1", "b_g2"):
        assert (getattr(got, q) == getattr(want, q)).all(), q


def test_assembly_from_arrays_checks_shapes():
    cs, asm = _witness(CubicCircuit(x=3))
    with pytest.raises(ValueError):
        TG.assembly_from_arrays(asm.num_inputs, asm.indptr[:-1], asm.var_idx, asm.coeffs, asm.assignment)
    with pytest.raises(ValueError):
        TG.assembly_from_arrays(asm.num_inputs, asm.indptr, asm.var_idx, asm.coeffs, asm.assignment[:2])
    with pytest.raises(ValueError):
        TG.assembly_from_arrays(asm.num_inputs, asm.indptr, asm.var_idx, asm.coeffs)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_masp_tpu():
    files = sorted((REPO / "masp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "masp_tpu"), (f, name)


@pytest.mark.slow
def test_proof_matches_jax_prover(small_window):
    params, _ = _host_params(CubicCircuit())
    cs, asm = _witness(CubicCircuit(x=3))
    want = P.create_proof_from_assembly(cs, params, 5, 7)
    got = TG.create_proof_from_assembly(asm, _port_params(params), 5, 7, device="cpu")
    assert got.write() == want.write()


@pytest.mark.slow
def test_split_proof_matches_jax_prover(small_window, monkeypatch):
    """The boolean split forced on by a lower threshold on both sides."""
    monkeypatch.setattr(P, "MSM_SPLIT_MIN", 2)
    monkeypatch.setattr(TP, "MSM_SPLIT_MIN", 2)
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    cs, asm = _witness(BitsCircuit([1, 0, 1, 1, 0, 1]))
    want = P.create_proof_from_assembly(cs, params, 3, 9)
    got = TG.create_proof_from_assembly(asm, tparams, 3, 9, device="cpu")
    split = {"l_small", "a_small", "b_g1_small", "b_g2_small"}
    assert split <= set(params.device) and split <= set(tparams.device)
    assert got.write() == want.write()


@pytest.mark.slow
def test_gadget_circuit_proof_matches_jax_prover(small_window):
    """The slice at a small size: a circuit of the copied gadgets with bit
    wires, synthesised by both packages; the port's structure, generator,
    witness and prover give masp_tpu's proof byte for byte."""
    value = 0x0123456789ABCDEF
    jax_mods, port_mods = (JB, JPED, JPersonalization), (TB, TPED, TPersonalization)
    params, _ = _host_params(PedersenBitsCircuit(jax_mods))
    cs, _ = _witness(PedersenBitsCircuit(jax_mods, value))
    want = P.create_proof_from_assembly(cs, params, 5, 7)
    kcs = TKeypairAssembly()
    PedersenBitsCircuit(port_mods).synthesize(kcs)
    TS.add_input_constraints(kcs)
    structure = TS.assembly_from_cs(kcs)
    assert structure.num_constraints == cs.num_constraints <= 1 << 10
    assert TP.boolean_var_mask(structure)[structure.num_inputs :].sum() >= 64
    tparams = TG.generate_parameters(structure, *WASTE, device="cpu")
    asm, route = TS.synthesize_witness(PedersenBitsCircuit(port_mods, value))
    assert route == "python"
    got = TG.create_proof_from_assembly(asm, tparams, 5, 7, device="cpu")
    assert got.write() == want.write()
    u, v = host_pedersen_hash(JPersonalization.note_commitment(),
                              [(value >> i) & 1 == 1 for i in range(64)]).to_affine()
    assert verify_proof(prepare_verifying_key(tparams.vk), got, [u.n, v.n])
