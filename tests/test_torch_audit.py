"""The port's ceremony audit (``algoplonk_tpu_torch/setups/audit.py``): the
reference's tests/test_audit.py, run against the port (reference
setup/*/audit.go behavior).

The Ethereum KZG audit runs against the *real bundled blobs* by synthesizing
the sequencer transcript from them (the inverse of the audit direction, so
byte-comparison exercises the true artifacts).  Dusk and PPoT audits run on
synthetic small-scale artifacts in a temp data dir: every test that writes
points the port's ``audit.DATA_DIR`` at ``tmp_path``, and none writes into
the bundled data directory, which the port reads in place.  The CLI tests
run against that directory itself, with artifacts made from its vk.bin, and
check that the rebuilt pk lands beside the artifact and the directory stays
as it was.
"""

import json
import os
import pathlib
import struct
import subprocess
import sys

import pytest

import algoplonk_tpu_torch as apt
from algoplonk_tpu_torch.host import fp as hfp
from algoplonk_tpu_torch.host.serialize import PointCodec
from algoplonk_tpu_torch.setups import audit
from algoplonk_tpu_torch.setups.registry import DATA_DIR

ETH_DIR = os.path.join(DATA_DIR, "EthereumKzgCeremonyBLS12_381")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _eth_transcript(tmp_path, tamper=False):
    pk = open(os.path.join(ETH_DIR, "pk.bin"), "rb").read()
    vk = open(os.path.join(ETH_DIR, "vk.bin"), "rb").read()
    n = struct.unpack(">I", pk[:4])[0]
    g1 = [pk[4 + i * 48 : 4 + (i + 1) * 48] for i in range(n)]
    if tamper:
        g1[5] = bytes([g1[5][0]]) + bytes([g1[5][1] ^ 1]) + g1[5][2:]
    g2 = [vk[:96], vk[96:192]]
    doc = {
        "transcripts": [
            {  # decoy with the wrong size must be skipped
                "numG1Powers": 4096,
                "numG2Powers": 65,
                "powersOfTau": {"G1Powers": [], "G2Powers": []},
            },
            {
                "numG1Powers": n,
                "numG2Powers": 65,
                "powersOfTau": {
                    "G1Powers": ["0x" + b.hex() for b in g1],
                    "G2Powers": ["0x" + b.hex() for b in g2],
                },
            },
        ]
    }
    p = tmp_path / "transcript.json"
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.mark.skipif(
    not os.path.exists(os.path.join(ETH_DIR, "pk.bin")),
    reason="bundled Ethereum KZG pk.bin absent",
)
def test_audit_ethereum_kzg_real_blobs(tmp_path):
    pk, vk = audit.audit_ethereum_kzg(
        _eth_transcript(tmp_path), log=lambda *a: None
    )
    assert pk == open(os.path.join(ETH_DIR, "pk.bin"), "rb").read()
    assert vk == open(os.path.join(ETH_DIR, "vk.bin"), "rb").read()


@pytest.mark.skipif(
    not os.path.exists(os.path.join(ETH_DIR, "pk.bin")),
    reason="bundled Ethereum KZG pk.bin absent",
)
def test_audit_ethereum_kzg_detects_tamper(tmp_path):
    with pytest.raises(audit.AuditError, match="pk mismatch"):
        audit.audit_ethereum_kzg(
            _eth_transcript(tmp_path, tamper=True), log=lambda *a: None
        )


def test_audit_ethereum_kzg_missing_transcript(tmp_path):
    p = tmp_path / "transcript.json"
    p.write_text(json.dumps({"transcripts": []}))
    with pytest.raises(audit.AuditError, match="numG1Powers"):
        audit.audit_ethereum_kzg(str(p), log=lambda *a: None)


def test_audit_dusk_synthetic(tmp_path, monkeypatch):
    """Small-scale Dusk response layout: 64B hash ‖ G1 powers ‖ (at the
    fixed offset) 2 G2 points; vk = G2_0 ‖ G2_1 ‖ G1_0."""
    n_tau = 8
    monkeypatch.setattr(audit, "DUSK_MAX_TAU_POWERS", n_tau)
    data = tmp_path / "data"
    (data / "DuskBLS12_381").mkdir(parents=True)
    monkeypatch.setattr(audit, "DATA_DIR", str(data))

    codec = PointCodec(apt.BLS12_381)
    F = hfp.GF(apt.BLS12_381.fp.modulus)
    F2 = hfp.GF2(apt.BLS12_381.fp.modulus, apt.BLS12_381.fp2_nonresidue)
    tau = 7919
    g1 = [
        codec.g1_compressed(hfp.ec_mul(F, apt.BLS12_381.g1, pow(tau, i, apt.BLS12_381.fr.modulus)))
        for i in range(n_tau + 1)
    ]
    g2_gen = (apt.BLS12_381.g2_x, apt.BLS12_381.g2_y)
    g2 = [
        codec.g2_compressed(g2_gen),
        codec.g2_compressed(hfp.ec_mul(F2, g2_gen, tau)),
    ]
    g2_off = ((n_tau << 1) - 1) * 48 + 64
    resp = bytearray(g2_off + 192)
    resp[0:64] = b"\x11" * 64
    at = 64
    for b in g1:
        resp[at : at + 48] = b
        at += 48
    resp[g2_off : g2_off + 96] = g2[0]
    resp[g2_off + 96 : g2_off + 192] = g2[1]
    rp = tmp_path / "response"
    rp.write_bytes(bytes(resp))

    vk_bytes = g2[0] + g2[1] + g1[0]
    (data / "DuskBLS12_381" / "vk.bin").write_bytes(vk_bytes)
    pk_bytes = struct.pack(">I", n_tau + 1) + b"".join(g1)
    (data / "DuskBLS12_381" / "pk.bin").write_bytes(pk_bytes)

    pk, vk = audit.audit_dusk(str(rp), log=lambda *a: None)
    assert pk == pk_bytes and vk == vk_bytes

    # tamper: flip a byte in the stored vk
    bad = bytearray(vk_bytes)
    bad[-1] ^= 1
    (data / "DuskBLS12_381" / "vk.bin").write_bytes(bytes(bad))
    with pytest.raises(audit.AuditError, match="vk mismatch"):
        audit.audit_dusk(str(rp), log=lambda *a: None)


def _write_ptau(path, power, tau):
    """Synthesize a snarkjs .ptau: LE Montgomery coordinates."""
    F = hfp.GF(apt.BN254.fp.modulus)
    F2 = hfp.GF2(apt.BN254.fp.modulus, apt.BN254.fp2_nonresidue)
    r_mod = apt.BN254.fr.modulus
    g1 = [hfp.ec_mul(F, apt.BN254.g1, pow(tau, i, r_mod))
          for i in range((1 << power) * 2 - 1)]
    g2_gen = (apt.BN254.g2_x, apt.BN254.g2_y)
    g2 = [hfp.ec_mul(F2, g2_gen, pow(tau, i, r_mod)) for i in range(1 << power)]
    _write_ptau_points(path, power, g1, g2)


def _write_ptau_points(path, power, g1, g2):
    """A .ptau holding the given affine G1 and G2 points."""
    q = apt.BN254.fp.modulus
    n8 = 32
    R = 1 << (8 * n8)

    def mont(v):
        return (v * R % q).to_bytes(n8, "little")

    g1_data = b"".join(mont(P[0]) + mont(P[1]) for P in g1)
    g2_data = b"".join(
        mont(Q[0][0]) + mont(Q[0][1]) + mont(Q[1][0]) + mont(Q[1][1]) for Q in g2
    )
    header = struct.pack("<I", n8) + q.to_bytes(n8, "little") + struct.pack(
        "<II", power, power
    )
    blob = b"ptau" + struct.pack("<II", 1, 3)
    for sid, data in ((1, header), (2, g1_data), (3, g2_data)):
        blob += struct.pack("<IQ", sid, len(data)) + data
    path.write_bytes(blob)


def test_audit_ppot_synthetic(tmp_path, monkeypatch):
    data = tmp_path / "data"
    (data / "PerpetualPowersOfTauBN254").mkdir(parents=True)
    monkeypatch.setattr(audit, "DATA_DIR", str(data))

    power, tau = 3, 1234577
    pt = tmp_path / "tiny.ptau"
    _write_ptau(pt, power, tau)

    codec = PointCodec(apt.BN254)
    F = hfp.GF(apt.BN254.fp.modulus)
    F2 = hfp.GF2(apt.BN254.fp.modulus, apt.BN254.fp2_nonresidue)
    r_mod = apt.BN254.fr.modulus
    g1c = [
        codec.g1_compressed(hfp.ec_mul(F, apt.BN254.g1, pow(tau, i, r_mod)))
        for i in range(1 << power)
    ]
    g2_gen = (apt.BN254.g2_x, apt.BN254.g2_y)
    vk_bytes = (
        codec.g2_compressed(g2_gen)
        + codec.g2_compressed(hfp.ec_mul(F2, g2_gen, tau))
        + g1c[0]
    )
    pk_bytes = struct.pack(">I", len(g1c)) + b"".join(g1c)
    (data / "PerpetualPowersOfTauBN254" / "vk.bin").write_bytes(vk_bytes)
    (data / "PerpetualPowersOfTauBN254" / "pk.bin").write_bytes(pk_bytes)

    pk, vk = audit.audit_ppot(str(pt), log=lambda *a: None)
    assert pk == pk_bytes and vk == vk_bytes


def test_audit_ppot_writes_pk_audit_when_blob_absent(tmp_path, monkeypatch):
    data = tmp_path / "data"
    (data / "PerpetualPowersOfTauBN254").mkdir(parents=True)
    monkeypatch.setattr(audit, "DATA_DIR", str(data))

    power, tau = 2, 31337
    pt = tmp_path / "tiny.ptau"
    _write_ptau(pt, power, tau)

    codec = PointCodec(apt.BN254)
    F2 = hfp.GF2(apt.BN254.fp.modulus, apt.BN254.fp2_nonresidue)
    g2_gen = (apt.BN254.g2_x, apt.BN254.g2_y)
    vk_bytes = (
        codec.g2_compressed(g2_gen)
        + codec.g2_compressed(hfp.ec_mul(F2, g2_gen, tau))
        + codec.g1_compressed(apt.BN254.g1)
    )
    (data / "PerpetualPowersOfTauBN254" / "vk.bin").write_bytes(vk_bytes)

    pk, vk = audit.audit_ppot(str(pt), log=lambda *a: None)
    out = tmp_path / "pk.audit"
    assert out.exists() and out.read_bytes() == pk
    assert sorted(os.listdir(data / "PerpetualPowersOfTauBN254")) == ["vk.bin"]


def _data_dir_state():
    """Every file under the bundled ceremony directory, with size and mtime."""
    state = {}
    for root, _, files in os.walk(DATA_DIR):
        for f in files:
            st = os.stat(os.path.join(root, f))
            state[os.path.relpath(os.path.join(root, f), DATA_DIR)] = (st.st_size, st.st_mtime_ns)
    return state


def _skip_without_bundled_vk(name):
    vk = os.path.join(DATA_DIR, name, "vk.bin")
    if not os.path.exists(vk) or os.path.exists(os.path.join(DATA_DIR, name, "pk.bin")):
        pytest.skip(f"needs {name}'s bundled vk.bin without its pk.bin")
    return open(vk, "rb").read()


def test_audit_cli_ppot_writes_beside_the_artifact(tmp_path):
    """The CLI, run as a module against the real bundled data directory, on
    a .ptau whose vk points are the bundled ones: the vk matches, pk.bin is
    absent, and the rebuilt blob lands beside the artifact while the
    bundled directory stays as it was."""
    vk_bytes = _skip_without_bundled_vk("PerpetualPowersOfTauBN254")
    codec = PointCodec(apt.BN254)
    F = hfp.GF(apt.BN254.fp.modulus)
    g2 = [codec.g2_from_compressed(vk_bytes[:64]),
          codec.g2_from_compressed(vk_bytes[64:128])]
    g1_0 = codec.g1_from_compressed(vk_bytes[128:])
    g1 = [g1_0, hfp.ec_mul(F, g1_0, 2), hfp.ec_mul(F, g1_0, 3)]
    art = tmp_path / "artifact"
    art.mkdir()
    pt = art / "tiny.ptau"
    _write_ptau_points(pt, 1, g1, g2)
    before = _data_dir_state()
    proc = subprocess.run(
        [sys.executable, "-m", "algoplonk_tpu_torch.setups.audit", "ppot", str(pt)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert str(art / "pk.audit") in proc.stdout
    pk = struct.pack(">I", 2) + codec.g1_compressed(g1[0]) + codec.g1_compressed(g1[1])
    assert (art / "pk.audit").read_bytes() == pk
    assert _data_dir_state() == before
    assert not list(pathlib.Path(REPO, "algoplonk_tpu").rglob("pk.audit"))


def test_audit_cli_dusk_writes_beside_the_artifact(tmp_path, monkeypatch, capsys):
    """``main`` on a small Dusk response whose vk bytes are the bundled
    ones, against the real bundled data directory."""
    vk_bytes = _skip_without_bundled_vk("DuskBLS12_381")
    n_tau = 4
    monkeypatch.setattr(audit, "DUSK_MAX_TAU_POWERS", n_tau)
    g2_0, g2_1, g1_0 = vk_bytes[:96], vk_bytes[96:192], vk_bytes[192:]
    g1 = [g1_0] + [bytes([0xA0 | i]) + bytes(47) for i in range(1, n_tau + 1)]
    g2_off = ((n_tau << 1) - 1) * 48 + 64
    resp = bytearray(g2_off + 192)
    resp[64 : 64 + 48 * len(g1)] = b"".join(g1)
    resp[g2_off:] = g2_0 + g2_1
    rp = tmp_path / "response"
    rp.write_bytes(bytes(resp))
    before = _data_dir_state()
    assert audit.main(["dusk", str(rp)]) == 0
    assert str(tmp_path / "pk.audit") in capsys.readouterr().out
    assert (tmp_path / "pk.audit").read_bytes() == struct.pack(">I", n_tau + 1) + b"".join(g1)
    assert _data_dir_state() == before
    assert not list(pathlib.Path(REPO, "algoplonk_tpu").rglob("pk.audit"))


def test_audit_cli_usage():
    assert audit.main([]) == 2
    assert audit.main(["nope", "x"]) == 2
