"""The port's utility modules and host copies against the JAX package's:
memuse (dynamic_usage equal on the JAX tests' objects; device_usage over
torch storages and the prover's device cache), the download path
(host/downloadreader.py, host/hashreader.py, params_io.fetch_params and
download_masp_parameters) through tests/test_downloadreader.py's cases with a
local opener and no network, ZIP-339 through tests/test_zip339.py's vectors
and its in-repo word list, and embedded_vks' None path."""

import hashlib
import inspect
from pathlib import Path

import pytest
import torch

import tests.test_downloadreader as JD
import tests.test_zip339 as JZ
from masp_tpu.transaction.components.sapling import OutputDescription as JOutputDescription
from masp_tpu.utils import memuse as JM
from masp_tpu_torch.groth16 import embedded_vks as EV
from masp_tpu_torch.groth16 import params_io as PIO
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.host import downloadreader as DR
from masp_tpu_torch.host import hashreader as HR
from masp_tpu_torch.host.primitives import zip339 as Z
from masp_tpu_torch.host.transaction.components.sapling import OutputDescription
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.utils import memuse as M
from tests.test_torch_prover import BitsCircuit, _host_params, _port_params

REPO = Path(__file__).resolve().parent.parent


def test_memuse_matches_reference(monkeypatch):
    """dynamic_usage and its bounds equal masp_tpu's on tests/test_memuse.py's
    objects (each package's OutputDescription); device_usage counts each
    storage once (a view, a tensor reached twice, a slice of another) and
    the prover's device cache after prepare_device_params in each layout,
    with a BGMW table's rows on top."""
    od = dict(cv=b"\x01" * 32, cmu=b"\x02" * 32, ephemeral_key=b"\x03" * 32, enc_ciphertext=b"\x04" * 612,
              out_ciphertext=b"\x05" * 80, zkproof=b"\x06" * 192)
    for obj in (7, None, True, b"\x00" * 192, [b"x" * 10, b"y" * 20], {b"k": b"v" * 4}, "memo", (1, b"ab")):
        assert M.dynamic_usage(obj) == JM.dynamic_usage(obj), obj
        assert M.dynamic_usage_bounds(obj) == JM.dynamic_usage_bounds(obj), obj
    usage = M.dynamic_usage(OutputDescription(**od))
    assert usage == JM.dynamic_usage(JOutputDescription(**od)) and usage >= 192 + 612 + 80

    a = torch.zeros((16, 8), dtype=torch.int32)
    b = torch.ones((4,), dtype=torch.int32)
    assert M.device_usage(a) == a.nbytes == 512
    assert M.device_usage({"x": a, "y": [a, b, a[3:], a.T]}) == a.nbytes + b.nbytes
    assert M.device_usage(a[:4]) == a.nbytes  # a view holds its whole storage

    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    monkeypatch.setattr(MS, "AFFINE_LADDER", False)
    sizes = {}
    for layout, env in (("sorted", {}), ("stacked", {"MASP_MSM_STACK": "1"}), ("lanes", {"MASP_MSM": "lanes"})):
        for name, value in TP.msm_flags({"MASP_MSM_C": "4", **env}).items():
            monkeypatch.setattr(TP, name, value)
        TP.prepare_device_params(tparams, "cpu")
        assert tparams.device["layout"] == layout
        rows = {q: TP._dev_n(tparams.device[q]) for q in ("h", "l", "a", "b_g1", "b_g2") if q in tparams.device}
        if layout == "stacked":
            rows.update({q: tparams.device["n_g1"] for q in ("h", "l", "a", "b_g1")})
        sizes[layout] = 4 * (72 * sum(n for q, n in rows.items() if q != "b_g2") + 144 * rows["b_g2"])
        assert M.device_usage(tparams) == sizes[layout], layout
    for name, value in TP.msm_flags({"MASP_MSM_C": "4", "MASP_MSM_BGMW_H": "1", "MASP_MSM_BGMW_C": "5"}).items():
        monkeypatch.setattr(TP, name, value)
    TP.prepare_device_params(tparams, "cpu")
    n_h = tparams.device["h"].shape[0]
    assert M.device_usage(tparams) == sizes["sorted"] + 4 * 72 * MS.n_windows_for(5) * n_h


def test_download_cases_through_port_copies(tmp_path, monkeypatch):
    """Every case of tests/test_downloadreader.py run against the port's
    ResponseLazyReader, HashReader, fetch_params and ParameterError (a local
    io stream as the opener; no network), then download_masp_parameters with
    a local opener a name: the same files and errors as the JAX package."""
    for name, obj in (("ResponseLazyReader", DR.ResponseLazyReader), ("HashReader", HR.HashReader),
                      ("fetch_params", PIO.fetch_params), ("ParameterError", PIO.ParameterError)):
        monkeypatch.setattr(JD, name, obj)
    cases = [(n, f) for n, f in vars(JD).items() if n.startswith("test_") and callable(f)]
    assert len(cases) == 9
    for i, (name, case) in enumerate(cases):
        kwargs = {"tmp_path": tmp_path / str(i)} if "tmp_path" in inspect.signature(case).parameters else {}
        for d in kwargs.values():
            d.mkdir()
        case(**kwargs)

    blobs = {name: bytes([k + 1]) * (100 + k) for k, name in enumerate(
        (PIO.MASP_SPEND_NAME, PIO.MASP_OUTPUT_NAME, PIO.MASP_CONVERT_NAME))}
    for name, data in blobs.items():
        kind = name.split("-")[1].split(".")[0].upper()
        monkeypatch.setattr(PIO, f"MASP_{kind}_HASH", hashlib.blake2b(data, digest_size=64).hexdigest())
        monkeypatch.setattr(PIO, f"MASP_{kind}_BYTES", len(data))
    opened = []

    def opener(name):
        return lambda: opened.append(name) or JD.FlakyStream(blobs[name])

    paths = PIO.download_masp_parameters(params_dir=tmp_path / "params", opener=opener)
    assert [p.read_bytes() for p in paths] == list(blobs.values()) and opened == list(blobs)
    assert PIO.download_masp_parameters(params_dir=tmp_path / "params", opener=opener) == paths
    assert opened == list(blobs)  # present files are re-verified, not fetched
    monkeypatch.setattr(PIO, "MASP_SPEND_HASH", "00" * 64)
    with pytest.raises(PIO.ParameterError, match="clean your MASP parameters directory"):
        PIO.download_masp_parameters(params_dir=tmp_path / "params", opener=opener)


def test_zip339_vectors_through_port_copy(monkeypatch):
    """tests/test_zip339.py's BIP-39 vectors through the port's zip339, with
    the word list copied beside it (the same SHA-256)."""
    assert Z._WORDLIST_PATH == REPO / "masp_tpu_torch/host/primitives/data/bip39-english.txt"
    data = Z._WORDLIST_PATH.read_bytes()
    assert hashlib.sha256(data).hexdigest() == Z.ENGLISH_WORDLIST_SHA256
    assert data == (REPO / "masp_tpu/primitives/data/bip39-english.txt").read_bytes()
    for name in ("Mnemonic", "MnemonicError", "_load_wordlist"):
        monkeypatch.setattr(JZ, name, getattr(Z, name))
    JZ.test_official_wordlist_loads()
    for entropy_hex, phrase in JZ.VECTORS:
        JZ.test_bip39_entropy_to_mnemonic(entropy_hex, phrase)
    JZ.test_bip39_seed_vector()
    JZ.test_invalid_checksum_rejected()


def test_embedded_vks_none_path(tmp_path, monkeypatch):
    """The .vk files are not in the repository: each key is None, also when
    a search directory holds only a git-lfs pointer; verify_vk_file checks a
    file's SHA-256."""
    assert EV._SEARCH_DIRS[0] == REPO / "masp_tpu_torch/groth16/params" and not EV._SEARCH_DIRS[0].exists()
    pointer = tmp_path / "masp-spend.vk"
    pointer.write_bytes(b"version https://git-lfs.github.com/spec/v1\noid sha256:" + EV.SPEND_VK_SHA256.encode())
    monkeypatch.setattr(EV, "_SEARCH_DIRS", [tmp_path, tmp_path / "absent"])
    assert (EV.spend_vk(), EV.output_vk(), EV.convert_vk()) == (None, None, None)
    assert EV.verify_vk_file(pointer, hashlib.sha256(pointer.read_bytes()).hexdigest())
    assert not EV.verify_vk_file(pointer, EV.SPEND_VK_SHA256)
    assert EV.VK_SIZE == 1636
