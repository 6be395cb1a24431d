"""The port's bundle-proving path against the JAX package's, on the CPU at
tiny sizes: the batch prover (create_proofs_from_assemblies) byte for byte
against masp_tpu.groth16.reference.host_proof, its window and its lazy
input; random parameter generation (the toxic-waste draws, the points, the
cache file); the parameter loader's checks; the batch verifier; and the
Sapling proving context on the same jobs and rng, with each package's
proving function replaced by the same deterministic stub (no full-size
proof and no JAX compile on the CPU; chip_smoke.py proves the bundle on
the card)."""

import io

import pytest

from masp_tpu.curves.bls12_381 import G1 as JG1
from masp_tpu.curves.bls12_381 import G2 as JG2
from masp_tpu.curves.jubjub import ExtendedPoint as JExtendedPoint
from masp_tpu.fields import JubjubFr as JJubjubFr
from masp_tpu.groth16 import generator as GEN
from masp_tpu.groth16 import prover as P
from masp_tpu.groth16 import reference as REF
from masp_tpu.groth16 import sapling_prover as JSP
from masp_tpu.groth16.structures import Proof as JProof
from masp_tpu.groth16.structures import prepare_verifying_key as jprepare_verifying_key
from masp_tpu.groth16.verifier import verify_proofs_batch as jverify_proofs_batch
from masp_tpu.primitives.asset_type import AssetType as JAssetType
from masp_tpu.primitives.convert import AllowedConversion as JAllowedConversion
from masp_tpu.primitives.merkle_tree import MerklePath as JMerklePath
from masp_tpu.r1cs.cs import ONE, lc_var
from masp_tpu.primitives.sapling import (
    Diversifier as JDiversifier, PaymentAddress as JPaymentAddress,
    ProofGenerationKey as JProofGenerationKey, Rseed as JRseed,
)
from masp_tpu.transaction.amount import ValueSum as JValueSum
from masp_tpu.utils.encoding import Reader as JReader
from masp_tpu.utils.rng import XorShiftRng as JXorShiftRng
from masp_tpu.utils.rng import random_scalar as jrandom_scalar
from masp_tpu_torch.groth16 import generator as TGEN
from masp_tpu_torch.groth16 import params_io as PIO
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import sapling_prover as SP
from masp_tpu_torch.groth16.local_prover import LocalTxProver
from masp_tpu_torch.groth16.params import params_from_host, params_to_host
from masp_tpu_torch.host import structures as HS
from masp_tpu_torch.host.bls12_381 import G1, G2
from masp_tpu_torch.host.fields import Scalar
from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
from masp_tpu_torch.host.primitives.sapling import Node
from masp_tpu_torch.host.rng import XorShiftRng, random_scalar
from masp_tpu_torch.host.verifier import verify_proofs_batch
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.tools.fixtures import jobs
from tests import test_torch_prover as TTP
from tests.test_torch_prover import (  # noqa: F401 (_one_torch_thread: autouse fixture)
    BitsCircuit, CubicCircuit, _host_params, _one_torch_thread, _port_params, _witness,
)

SEED = bytes(range(1, 17))
SIGHASH = bytes(range(32))


def _bits(i: int) -> list[int]:
    return [(i >> k) & 1 for k in range(6)]


class NamedCubicCircuit:
    """CubicCircuit (x^3 + x + 5 == out) with a distinct name for each
    variable and constraint, as TestConstraintSystem, whose digest keys
    cached_test_params' file, requires."""

    def synthesize(self, cs):
        xv = cs.alloc("x", None)
        x2 = cs.alloc("x2", None)
        cs.enforce("x * x = x2", lc_var(xv), lc_var(xv), lc_var(x2))
        x3 = cs.alloc("x3", None)
        cs.enforce("x2 * x = x3", lc_var(x2), lc_var(xv), lc_var(x3))
        out = cs.alloc_input("out", None)
        cs.enforce("x3 + x + 5 = out", lc_var(x3) + xv + (5, ONE), lc_var(ONE), lc_var(out))


@pytest.mark.parametrize("ladder, window, lazy", [("scan", 1, True), ("affine", 2, False)])
def test_batch_matches_host_reference(ladder, window, lazy, monkeypatch):
    """Each batch proof equals host_proof of its witness and (r, s): the
    scan ladder at window 1 with more proofs than the window, witnesses from
    a generator and the boolean split forced on by a lower threshold (bit
    wires); the affine ladder (one level) at window 2 on a list."""
    monkeypatch.setattr(TP, "MSM_C", 4)
    monkeypatch.setattr(MS, "AFFINE_LADDER", ladder == "affine")
    monkeypatch.setattr(MS, "AFFINE_LEVELS", 1)
    monkeypatch.setenv("MASP_BATCH_WINDOW", str(window))
    if ladder == "scan":
        monkeypatch.setattr(TP, "MSM_SPLIT_MIN", 2)
        circuits = [BitsCircuit(_bits(i)) for i in (45, 22)]
        params, _ = _host_params(BitsCircuit())
    else:
        circuits = [CubicCircuit(x=x) for x in (3, 10)]
        params, _ = _host_params(CubicCircuit())
    tparams = _port_params(params)
    witnesses = [_witness(c) for c in circuits]
    rs = [(3 + 2 * i, 9 + 5 * i) for i in range(len(circuits))]
    asms = (asm for _, asm in witnesses) if lazy else [asm for _, asm in witnesses]
    proofs = TP.create_proofs_from_assemblies(asms, tparams, rs, device="cpu")
    assert len(proofs) == len(circuits)
    for (cs, _), (r, s), proof in zip(witnesses, rs, proofs):
        assert proof.write() == REF.host_proof(cs, params, r, s).write()
    assert any(k.endswith("_small") for k in tparams.device) == (ladder == "scan")


def test_batch_window_order(monkeypatch):
    """The window with the device halves stubbed: at window w, proof i is
    drained once proofs i+1 .. i+w-1 are enqueued, before proof i+w is; a
    lazy input yields each witness just before its proof is enqueued; no
    job gives []; a witness of another domain raises before it is enqueued."""
    events = []
    monkeypatch.setattr(TP, "_enqueue", lambda asm, params, r, s, device, mesh: events.append(f"E{r}") or r)
    monkeypatch.setattr(TP, "_drain", lambda r: events.append(f"D{r}") or r)
    _, cubic = _witness(CubicCircuit(x=3))
    _, bits = _witness(BitsCircuit(_bits(5)))
    params = _port_params(_host_params(CubicCircuit())[0])

    def lazy(n):
        for i in range(n):
            events.append(f"S{i}")
            yield cubic

    for window, want in ((1, "S0 E0 S1 D0 E1 S2 D1 E2 D2"), (2, "S0 E0 S1 E1 S2 D0 E2 D1 D2"),
                         (4, "S0 E0 S1 E1 S2 E2 D0 D1 D2")):
        monkeypatch.setenv("MASP_BATCH_WINDOW", str(window))
        events.clear()
        assert TP.create_proofs_from_assemblies(lazy(3), params, [(i, 0) for i in range(3)]) == [0, 1, 2]
        assert " ".join(events) == want, window
    events.clear()
    assert TP.create_proofs_from_assemblies([], params, []) == [] and not events
    with pytest.raises(ValueError, match="domain"):
        TP.create_proofs_from_assemblies([cubic, bits], params, [(1, 0), (2, 0)])
    assert events == ["E1"]


def test_generate_random_parameters(monkeypatch, tmp_path):
    """The port draws the JAX package's toxic waste from the same seeded rng
    (the JAX generator itself stubbed: no compile), its points equal the
    host scalar multiples of that waste (in chunks of two scalars), and
    cached_test_params writes them in bellman's format, the bytes of the
    host Parameters, and reads them back."""
    drawn = {}
    monkeypatch.setattr(GEN, "generate_parameters", lambda circuit, *waste: drawn.setdefault("jax", waste))
    GEN.generate_random_parameters(NamedCubicCircuit(), JXorShiftRng.from_seed(SEED))
    generate = TGEN.generate_parameters

    def spy(asm, *waste, device):
        drawn["port"] = waste
        return generate(asm, *waste, device=device)

    random_parameters = TGEN.generate_random_parameters
    monkeypatch.setattr(TGEN, "generate_parameters", spy)
    monkeypatch.setattr(TGEN, "generate_random_parameters",
                        lambda circuit, rng: random_parameters(circuit, rng, device="cpu"))
    monkeypatch.setattr(TGEN, "CHUNK", {1: 2, 2: 2})
    got = PIO.cached_test_params("cubic", NamedCubicCircuit, XorShiftRng.from_seed(SEED), cache_dir=tmp_path)
    assert drawn["port"] == drawn["jax"] and len(drawn["jax"]) == 5
    monkeypatch.setattr(TTP, "WASTE", drawn["jax"])
    host, _ = _host_params(NamedCubicCircuit())
    want = _port_params(host)
    assert got.vk == want.vk
    for q in ("h", "l", "a", "b_g1", "b_g2"):
        assert (getattr(got, q) == getattr(want, q)).all(), q
    (path,) = tmp_path.glob("cubic-*.params")
    assert path.read_bytes() == host.write() == params_to_host(got).write()
    del drawn["port"]
    again = PIO.cached_test_params("cubic", NamedCubicCircuit, XorShiftRng.from_seed(SEED), cache_dir=tmp_path)
    assert "port" not in drawn and again.vk == got.vk
    for q in ("h", "l", "a", "b_g1", "b_g2"):
        assert (getattr(again, q) == getattr(got, q)).all(), q
    round_trip = params_from_host(HS.Parameters.read(io.BytesIO(host.write())))
    assert all((getattr(round_trip, q) == getattr(want, q)).all() for q in ("h", "l", "a", "b_g1", "b_g2"))


def test_load_parameters_checks_size_and_hash(tmp_path):
    paths = []
    for name in (PIO.MASP_SPEND_NAME, PIO.MASP_OUTPUT_NAME, PIO.MASP_CONVERT_NAME):
        paths.append(tmp_path / name)
        paths[-1].write_bytes(b"\x00" * 64)
    with pytest.raises(PIO.ParameterError, match="expected 49848572"):
        PIO.load_parameters(*paths)
    with pytest.raises(PIO.ParameterError, match="does not match expected"):
        PIO.load_parameters(*paths, check_sizes=False)
    # the download path is ported too (tests/test_torch_utils.py drives it
    # through a local opener)
    assert "download_masp_parameters" in PIO.__all__ and callable(PIO.fetch_params)


def test_verify_proofs_batch_matches_jax():
    """The batch verifier's answer, true and false (one proof altered), is
    the JAX copy's on the same proofs and seeded rng."""
    params, _ = _host_params(CubicCircuit())
    witnesses = [_witness(CubicCircuit(x=x)) for x in (3, 4)]
    blobs = [REF.host_proof(cs, params, 5 + i, 7 + i).write() for i, (cs, _) in enumerate(witnesses)]
    inputs = [[35], [73]]
    jpvk = jprepare_verifying_key(params.vk)
    pvk = HS.prepare_verifying_key(_port_params(params).vk)
    altered = JProof.read(blobs[1])
    altered.c = altered.c + JG1.generator()
    for proofs, want in ((blobs, True), ([blobs[0], altered.write()], False)):
        got_jax = jverify_proofs_batch(jpvk, JXorShiftRng.from_seed(SEED), [JProof.read(b) for b in proofs], inputs)
        got = verify_proofs_batch(pvk, XorShiftRng.from_seed(SEED), [HS.Proof.read(b) for b in proofs], inputs)
        assert got == got_jax == want

def test_device_pairing_raises_and_bulk_tree_matches_host(monkeypatch):
    """verify_proofs_batch's device pairing goes to the port's twin,
    ops/pairing.pairing_product_is_one_device (here a recorder that answers
    with the host pairing), never to the host pairing directly: true for the
    right input, false for a wrong one, with the source's last pair
    ((-alpha) sum z, beta); the frozen tree's bulk hash from 64 pairs a level
    (the default route) goes through the Pedersen twin, here on the CPU: a
    128-leaf tree equals the one hashed on the host."""
    from masp_tpu_torch.host.bls12_381 import R, pairing_product_is_one
    from masp_tpu_torch.ops import pairing as TPAIR
    from masp_tpu_torch.ops import pedersen as TPED

    params, _ = _host_params(CubicCircuit())
    cs, _ = _witness(CubicCircuit(x=3))
    pvk = HS.prepare_verifying_key(_port_params(params).vk)
    proof = HS.Proof.read(REF.host_proof(cs, params, 5, 7).write())
    recorded = []

    def recorder(pairs):
        recorded.append(list(pairs))
        return pairing_product_is_one(pairs)

    monkeypatch.setattr(TPAIR, "pairing_product_is_one_device", recorder)
    z = int.from_bytes(XorShiftRng.from_seed(SEED).fill_bytes(16), "little")
    for inputs, want in (([[35]], True), ([[36]], False)):
        got = verify_proofs_batch(pvk, XorShiftRng.from_seed(SEED), [proof], inputs, use_device_pairing=True)
        assert got is want
        assert len(recorded[-1]) == 4
        assert recorded[-1][-1] == ((-pvk.alpha_g1) * (z % R), pvk.beta_g2)
    assert len(recorded) == 2
    leaves = [Node.from_scalar(Scalar(i + 2)) for i in range(128)]
    calls, twin = [], TPED.batch_merkle_hash

    def on_cpu(depth, pairs):
        calls.append(len(pairs))
        return twin(depth, pairs, device="cpu")

    monkeypatch.setattr(TPED, "batch_merkle_hash", on_cpu)
    monkeypatch.delenv("MASP_MERKLE_DEVICE_MIN", raising=False)
    tree = FrozenCommitmentTree.new(leaves)
    assert calls == [64]
    monkeypatch.setenv("MASP_MERKLE_DEVICE_MIN", "0")
    host = FrozenCommitmentTree.new(leaves)
    assert tree == host and tree.root() == host.root() and calls == [64]
    assert tree.root() == tree.path(77).root(leaves[77]) and tree.size() == 128


def _to_jax(value):
    """A job's value as the JAX package's object, through its bytes."""
    name = type(value).__name__
    if name == "JubjubFr":
        return JJubjubFr.from_bytes(value.to_bytes())
    if name == "AssetType":
        return JAssetType.from_identifier(value.get_identifier())
    if name == "Diversifier":
        return JDiversifier(value.d)
    if name == "Rseed":
        return JRseed.before_zip212(_to_jax(value.rcm()))
    if name == "ProofGenerationKey":
        return JProofGenerationKey(ak=JExtendedPoint.from_bytes(value.ak.to_bytes()), nsk=_to_jax(value.nsk))
    if name == "PaymentAddress":
        return JPaymentAddress.from_bytes(value.to_bytes())
    if name == "MerklePath":
        return JMerklePath.from_slice(value.to_bytes())
    if name == "AllowedConversion":
        return JAllowedConversion.read(JReader(value.to_bytes()))
    if name == "ValueSum":
        return JValueSum.read(JReader(value.to_bytes()))
    assert isinstance(value, int), name
    return value


def _stub_proving(monkeypatch, prover, sapling_prover, proof, g1, g2, draw):
    """Replace a package's proving functions with the same deterministic
    stub (a proof of [r] G1, [s] G2, [r + s] G1, with (r, s) drawn as the
    real ones draw them) and its self-verification with one that draws as
    the batch verifier draws and passes."""
    def make(r, s):
        return proof(a=g1 * r, b=g2 * s, c=g1 * (r + s))

    def batch(css, params, rss, *args, **kwargs):
        return [make(r, s) for r, s in rss]

    def single(circuit, params, rng, *args, **kwargs):
        return make(draw(rng).n, draw(rng).n)

    def verify_batch(pvk, rng, proofs, inputs, *args, **kwargs):
        for _ in proofs:
            rng.fill_bytes(16)
        return True

    monkeypatch.setattr(prover, "create_proofs_from_assemblies", batch)
    monkeypatch.setattr(sapling_prover, "create_random_proof", single)
    monkeypatch.setattr(sapling_prover, "verify_proofs_batch", verify_batch)
    monkeypatch.setattr(sapling_prover, "verify_proof", lambda *args: True)


def test_prove_jobs_matches_jax_context(monkeypatch):
    """SaplingProvingContext of both packages on the same bundle and seeded
    rng, through prove_jobs (the port's by LocalTxProver) and the singular
    methods: the same proofs, cv, rk, bsk, cv_sum and binding signature
    bytes; the port's binding signature passes its verification context."""
    _stub_proving(monkeypatch, TP, SP, HS.Proof, G1.generator(), G2.generator(), random_scalar)
    _stub_proving(monkeypatch, P, JSP, JProof, JG1.generator(), JG2.generator(), jrandom_scalar)
    bundle = jobs(2, 1, 2, SEED)
    kinds = ("spend", "convert", "output")
    port_jobs = [bundle[k] for k in kinds]
    jax_jobs = [[{k: _to_jax(v) for k, v in j.items()} for j in bundle[kind]] for kind in kinds]
    ctx, jctx = SP.SaplingProvingContext(), JSP.SaplingProvingContext()
    rng, jrng = XorShiftRng.from_seed(SEED), JXorShiftRng.from_seed(SEED)
    vk = object()
    prover = LocalTxProver.__new__(LocalTxProver)
    prover.spend_params = prover.output_params = prover.convert_params = None
    prover.spend_vk = prover.output_vk = prover.convert_vk = vk
    got = prover.prove_jobs(ctx, *port_jobs, rng)
    want = jctx.prove_jobs(*jax_jobs, None, vk, None, vk, None, jrng)

    def as_bytes(results):
        return [[b if isinstance(b, bytes) else b.to_bytes() for b in row] for row in results]

    assert as_bytes(got[0]) == as_bytes([(p.write(), cv, rk.point) for p, cv, rk in want[0]])
    for g, w in zip(got[1:], want[1:]):
        assert as_bytes(g) == as_bytes([(p.write(), cv) for p, cv in w])
    assert (ctx.bsk.to_bytes(), ctx.cv_sum.to_bytes()) == (jctx.bsk.to_bytes(), jctx.cv_sum.to_bytes())
    balance = bundle["value_balance"]
    sig = prover.binding_sig(ctx, balance, SIGHASH, rng)
    assert sig.to_bytes() == jctx.binding_sig(_to_jax(balance), SIGHASH, jrng).to_bytes()

    check = SP.SaplingVerificationContext()
    for _, cv, _ in got[0]:
        check.cv_sum = check.cv_sum + cv
    for (_, cv) in got[1]:
        check.cv_sum = check.cv_sum + cv
    for (_, cv) in got[2]:
        check.cv_sum = check.cv_sum - cv
    assert check.final_check(balance, SIGHASH, sig)
    assert not check.final_check(balance + balance, SIGHASH, sig)

    # the singular methods, on a fresh context each
    ctx, jctx = SP.SaplingProvingContext(), JSP.SaplingProvingContext()
    rng, jrng = XorShiftRng.from_seed(SEED), JXorShiftRng.from_seed(SEED)
    j, jj = bundle["spend"][0], jax_jobs[0][0]
    fields = ("proof_generation_key", "diversifier", "rseed", "ar", "asset_type", "value", "anchor", "merkle_path")
    p, cv, rk = ctx.spend_proof(*[j[f] for f in fields], None, vk, j["rcv"], rng)
    jp, jcv, jrk = jctx.spend_proof(*[jj[f] for f in fields], None, vk, jj["rcv"], jrng)
    assert (p.write(), cv.to_bytes(), rk.point.to_bytes()) == (jp.write(), jcv.to_bytes(), jrk.point.to_bytes())
    j, jj = bundle["convert"][0], jax_jobs[1][0]
    fields = ("allowed_conversion", "value", "anchor", "merkle_path")
    p, cv = ctx.convert_proof(*[j[f] for f in fields], None, vk, j["rcv"], rng)
    jp, jcv = jctx.convert_proof(*[jj[f] for f in fields], None, vk, jj["rcv"], jrng)
    assert (p.write(), cv.to_bytes()) == (jp.write(), jcv.to_bytes())
    j, jj = bundle["output"][0], jax_jobs[2][0]
    fields = ("esk", "payment_address", "rcm", "asset_type", "value")
    p, cv = ctx.output_proof(*[j[f] for f in fields], None, j["rcv"], rng)
    jp, jcv = jctx.output_proof(*[jj[f] for f in fields], None, jj["rcv"], jrng)
    assert (p.write(), cv.to_bytes()) == (jp.write(), jcv.to_bytes())
    assert (ctx.bsk.to_bytes(), ctx.cv_sum.to_bytes()) == (jctx.bsk.to_bytes(), jctx.cv_sum.to_bytes())
