"""The port's copy of the host circuit stack against the JAX package's:
every copied module verbatim apart from its import paths, the Spend, Output
and Convert structures and the bench fixtures' witnesses and public inputs
bit-equal to masp_tpu's, the boolean mask of the real Spend, and the native
witness tape built where the port keeps it. Host only: no proof at this size
on the CPU (chip_smoke.py --circuits proves them on the card)."""

import ast
import difflib
import re
from pathlib import Path

import numpy as np
import pytest

import bench
from masp_tpu.circuits import witness_tape as JWT
from masp_tpu.circuits.convert import Convert as JConvert
from masp_tpu.circuits.sapling import Output as JOutput, Spend as JSpend
from masp_tpu.groth16 import prover as P
from masp_tpu.utils.rng import XorShiftRng as JXorShiftRng
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import synthesis as S
from masp_tpu_torch.host import native
from masp_tpu_torch.host.circuits.convert import Convert
from masp_tpu_torch.host.circuits.sapling import Output, Spend
from masp_tpu_torch.host.r1cs import cs as CS
from masp_tpu_torch.tools.fixtures import BENCH_SEED, fixture

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "masp_tpu_torch"

# port file -> its source: whole modules
COPIES = {
    "host/fields.py": "masp_tpu/fields/__init__.py",
    "host/bls12_381.py": "masp_tpu/curves/bls12_381.py",
    "host/structures.py": "masp_tpu/groth16/structures.py",
    "host/rng.py": "masp_tpu/utils/rng.py",
    "host/jubjub.py": "masp_tpu/curves/jubjub.py",
    **{f"host/primitives/{m}.py": f"masp_tpu/primitives/{m}.py" for m in (
        "constants", "group_hash", "pedersen", "keys", "asset_type", "sapling", "redjubjub")},
    **{f"host/r1cs/{m}.py": f"masp_tpu/r1cs/{m}.py" for m in ("cs", "tape", "wit")},
    **{f"host/r1cs/gadgets/{m}.py": f"masp_tpu/r1cs/gadgets/{m}.py" for m in (
        "boolean", "num", "uint32", "multipack", "lookup", "blake2s", "ecc", "pedersen")},
    **{f"host/circuits/{m}.py": f"masp_tpu/circuits/{m}.py" for m in (
        "constants", "sapling", "convert", "witness_tape")},
    **{f"host/native/{m}": f"masp_tpu/native/{m}" for m in (
        "__init__.py", "lc_eval.cpp", "witness_tape.cpp")},
    "host/encoding.py": "masp_tpu/utils/encoding.py",
    "host/transaction/amount.py": "masp_tpu/transaction/amount.py",
    "host/transaction/tx_prover.py": "masp_tpu/transaction/tx_prover.py",
    "host/primitives/convert.py": "masp_tpu/primitives/convert.py",
    "host/primitives/merkle_tree.py": "masp_tpu/primitives/merkle_tree.py",
    "host/verifier.py": "masp_tpu/groth16/verifier.py",
    **{f"groth16/{m}.py": f"masp_tpu/groth16/{m}.py" for m in (
        "sapling_prover", "params_io", "local_prover")},
    **{f"host/primitives/{m}.py": f"masp_tpu/primitives/{m}.py" for m in ("consensus", "memo", "ff1", "zip32")},
    **{f"host/note_encryption/{m}.py": f"masp_tpu/note_encryption/{m}.py" for m in ("__init__", "sapling_domain")},
    **{f"host/{m}.py": f"masp_tpu/utils/{m}.py" for m in ("borsh", "borsh_schema")},
    **{f"host/transaction/{m}.py": f"masp_tpu/transaction/{m}.py" for m in (
        "components/transparent", "components/transparent_builder", "txid", "components/sapling", "transaction",
        "sighash", "fees", "components/sapling_builder", "builder", "borsh_io")},
    **{f"host/{m}.py": f"masp_tpu/utils/{m}.py" for m in ("hashreader", "downloadreader")},
    **{f"host/primitives/{m}.py": f"masp_tpu/primitives/{m}.py" for m in ("blake2", "zip339")},
    "groth16/embedded_vks.py": "masp_tpu/groth16/embedded_vks.py",
}
# port file -> (its source, the functions copied from it)
FUNCTION_COPIES = {
    "tools/fixtures.py": ("bench.py", ("_spend_fixture", "_convert_fixture", "_output_fixture")),
    "utils/memuse.py": ("masp_tpu/utils/memuse.py", ("register", "dynamic_usage", "dynamic_usage_bounds")),
}
# the only copies with marked departures from their source: the native
# library's build, and the port's Parameters where the proving keys are
# taken, loaded or written (every copied device branch reaches its twin)
DEPARTURES = {
    "host/native/__init__.py", "groth16/sapling_prover.py", "groth16/params_io.py",
    "groth16/local_prover.py"}
# port import path -> source import path, the first match per import line;
# the ciphers of host/crypto.py stand where the source imports `cryptography`
IMPORTS = [
    ("masp_tpu_torch.host.crypto import InvalidTag", "cryptography.exceptions import InvalidTag"),
    ("masp_tpu_torch.host.crypto import ChaCha20Poly1305",
     "cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305"),
    ("masp_tpu_torch.host.crypto import Cipher", "cryptography.hazmat.primitives.ciphers import Cipher"),
    ("masp_tpu_torch.ops.pairing", "masp_tpu.ops.pairing_jax"),
    ("masp_tpu_torch.ops.pedersen", "masp_tpu.ops.pedersen_jax"),
    ("masp_tpu_torch.ops.jubjub", "masp_tpu.ops.jubjub_jax"),
    ("masp_tpu_torch.groth16.synthesis import add_input_constraints as _add_input_constraints",
     "masp_tpu.groth16.generator import _add_input_constraints"),
    ("masp_tpu_torch.host.encoding", "masp_tpu.utils.encoding"),
    ("masp_tpu_torch.host.downloadreader", "masp_tpu.utils.downloadreader"),
    ("masp_tpu_torch.host.hashreader", "masp_tpu.utils.hashreader"),
    ("masp_tpu_torch.host import borsh", "masp_tpu.utils import borsh"),
    ("masp_tpu_torch.host.borsh", "masp_tpu.utils.borsh"),
    ("masp_tpu_torch.host.verifier", "masp_tpu.groth16.verifier"),
    ("masp_tpu_torch.groth16.", "masp_tpu.groth16."),
    ("masp_tpu_torch.host.fields", "masp_tpu.fields"),
    ("masp_tpu_torch.host.bls12_381", "masp_tpu.curves.bls12_381"),
    ("masp_tpu_torch.host.jubjub", "masp_tpu.curves.jubjub"),
    ("masp_tpu_torch.host.rng", "masp_tpu.utils.rng"),
    ("masp_tpu_torch.host.structures", "masp_tpu.groth16.structures"),
    ("masp_tpu_torch.host.", "masp_tpu."),
    ("masp_tpu_torch.host import", "masp_tpu import"),
]

KINDS = {"spend": (Spend, JSpend), "output": (Output, JOutput), "convert": (Convert, JConvert)}
# constraints before the input constraints, inputs with ONE, and the
# TestConstraintSystem digests that tests/test_circuits.py pins
PINS = {
    "spend": (100_637, 8, "34e4a634c80e4e4c6250e63b7855532e60b36d1371d4d7b1163218b69f09eb3d"),
    "output": (31_205, 6, "93e445d7858e98c7138558df341f020aedfe75893535025587d64731e244276a"),
    "convert": (47_358, 4, "f74b47ef6e59081548f81f5806bd15b1f4a65d2e57681e6db2b8db7eef2ff814"),
}


def _source_imports(lines: list[str]) -> list[str]:
    out = []
    for line in lines:
        if line.lstrip().startswith(("from ", "import ")):
            for port, src in IMPORTS:
                if port in line:
                    line = line.replace(port, src, 1)
                    break
        out.append(line)
    return out


def _strip_header(lines: list[str], source: str) -> list[str]:
    """Drop the copy's header comment, which names its source and ends with
    the line that ends "masp_tpu."."""
    for i, line in enumerate(lines[:8]):
        if line.endswith("masp_tpu."):
            assert source in " ".join(lines[: i + 1]), f"header does not name {source}"
            return lines[i + 1 :]
    raise AssertionError("no copy header")


def _departure_blocks(lines: list[str]) -> list[tuple[int, int]]:
    blocks, start = [], None
    for i, line in enumerate(lines):
        if "# departs from the source" in line:
            start = i
        elif "# end of departure" in line and start is not None:
            blocks.append((start, i + 1))
            start = None
    return blocks


def _module_differences(port_file: str, source: str) -> str | None:
    """None when the copy equals its source once the header and the import
    paths are normalised, except inside its marked departures; else why."""
    src = (REPO / source).read_text().split("\n")
    copy = _source_imports(_strip_header((PORT / port_file).read_text().split("\n"), source))
    blocks = _departure_blocks(copy)
    if bool(blocks) != (port_file in DEPARTURES):
        return "marked departures where none is allowed" if blocks else "its departure is not marked"
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, src, copy, autojunk=False).get_opcodes():
        if tag != "equal" and not any(s <= j1 and j2 <= e for s, e in blocks):
            return f"source lines {i1 + 1}-{i2} differ from copy lines {j1 + 1}-{j2}"
    return None


def _functions(text: str, names) -> list[str]:
    tree = ast.parse(text)
    segs = {n.name: ast.get_source_segment(text, n) for n in tree.body if isinstance(n, ast.FunctionDef)}
    return [segs.get(name) for name in names]


def test_copies_are_verbatim_apart_from_imports():
    """Every copied module and function against its source; the one item
    names every copy that differs."""
    differ = {}
    for port_file, source in COPIES.items():
        why = _module_differences(port_file, source)
        if why:
            differ[port_file] = why
    for port_file, (source, names) in FUNCTION_COPIES.items():
        text = (PORT / port_file).read_text()
        _strip_header(text.split("\n"), source)
        got = ["\n".join(_source_imports(f.split("\n"))) if f else None for f in _functions(text, names)]
        want = _functions((REPO / source).read_text(), names)
        for name, g, w in zip(names, got, want):
            if g != w:
                differ[f"{port_file}:{name}"] = "function differs from its source"
    assert not differ, differ


@pytest.fixture(scope="module")
def structures():
    """kind -> (the port's structure Assembly, masp_tpu's structure
    KeypairAssembly), each synthesised once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            port_kind, jax_kind = KINDS[kind]
            cache[kind] = (S.structure_assembly(port_kind), JWT.structure_for(jax_kind))
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", list(KINDS))
def test_structure_matches_masp_tpu(kind, structures):
    asm, jcs = structures(kind)
    n, n_inputs, digest = PINS[kind]
    assert (asm.num_constraints, asm.num_inputs, asm.num_vars) == (
        jcs.num_constraints, jcs.num_inputs, jcs.num_inputs + jcs.num_aux)
    assert (asm.num_constraints, asm.num_inputs) == (n + n_inputs, n_inputs)
    for got, want in zip((asm.indptr, asm.var_idx, asm.coeffs), P._csr_for(jcs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    tcs = CS.TestConstraintSystem()
    KINDS[kind][0]().synthesize(tcs)
    assert (tcs.num_constraints, tcs.num_inputs, tcs.hash()) == (n, n_inputs, digest)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fixture_witness_matches_masp_tpu(kind):
    """bench.py's fixture and the port's, from the same seed: equal public
    inputs, and the tape route's witness equals masp_tpu's (for Output the
    Python gadget walk's as well)."""
    make, publics = fixture(kind)
    jmake, jpublics = getattr(bench, f"_{kind}_fixture")(JXorShiftRng.from_seed(BENCH_SEED))
    assert publics == jpublics and len(publics) == PINS[kind][1] - 1
    asm, route = S.synthesize_witness(make())
    assert route == "tape"
    want = P._assignment_u64(P.synthesize_witness(jmake()))
    assert asm.assignment.dtype == want.dtype
    np.testing.assert_array_equal(asm.assignment, want)
    if kind == "output":
        py, route = S.synthesize_witness(make(), use_tape=False)
        assert route == "python"
        np.testing.assert_array_equal(py.assignment, want)
        for got, ref in zip((py.indptr, py.var_idx, py.coeffs), (asm.indptr, asm.var_idx, asm.coeffs)):
            np.testing.assert_array_equal(got, ref)


def test_boolean_mask_of_real_spend(structures):
    """The interleaved numbering of the r1cs rows against the Assembly's
    global one shows in the mask: it must equal masp_tpu's on the real Spend."""
    asm, jcs = structures("spend")
    mask = TP.boolean_var_mask(asm)
    np.testing.assert_array_equal(mask, P._boolean_var_mask(jcs))
    assert int(mask[asm.num_inputs :].sum()) == 68_418


def test_native_tape_builds_in_ignored_directory():
    assert native.tape_available()
    build = PORT / "host/native/build"
    assert native._SO.parent == build and native._SO.exists()
    assert re.fullmatch(r"libmasp_native-[0-9a-f]{12}\.so", native._SO.name)
    assert "masp_tpu_torch/host/native/build/" in (REPO / ".gitignore").read_text().split("\n")
