"""Trusted-setup audit programs.

Rebuild each ceremony's pk.bin / vk.bin from the *public ceremony artifacts*
and byte-compare against the bundled blobs, so users never have to trust this
repo's copies.  Behavioral spec: the reference ships one standalone audit
program per ceremony (reference setup/PerpetualPowersOfTauBN254/audit.go,
setup/EethereumKzgCeremonyBLS12_381/audit.go:27-156,
setup/DuskBLS12_381/audit.go:92-204).

Artifacts (download instructions in the reference's setup/*/doc.go):
  * Ethereum KZG ceremony: ``transcript.json`` from the sequencer — the
    transcript with numG1Powers == 32768 is the one used.
  * Dusk Network: the raw ``response`` file (64-byte hash, then uncompressed-
    count G1 points at 48 B each, then the two G2 points).
  * Perpetual Powers of Tau: ``powersOfTau28_hez_final_18.ptau`` (snarkjs
    binary format); points are re-serialized to gnark's compressed encoding.

Each audit returns the rebuilt (pk_bytes, vk_bytes) and raises AuditError on
mismatch with the bundled files; missing bundled pk.bin (this mount strips
the large blobs) downgrades the pk comparison to a warning and writes
``pk.audit`` next to the artifact so the rebuilt blob can be installed.

CLI:  python -m algoplonk_tpu_torch.setups.audit {ethereum_kzg,dusk,ppot} ARTIFACT

Copied from ``algoplonk_tpu/setups/audit.py`` so that the port imports
nothing of the JAX package.  ``DATA_DIR`` is the port's registry's, which
names the reference's ceremony files; the audit only reads there, and
writes ``pk.audit`` beside the artifact it was given, where the reference
writes it beside the bundle.
"""

from __future__ import annotations

import json
import os
import struct
import sys

from ..fields.params import BLS12_381, BN254
from ..host.serialize import PointCodec
from .registry import DATA_DIR

HASH_SIZE = 64                # Dusk response prefix
DUSK_MAX_TAU_POWERS = 1 << 21
G1_COMPRESSED_BLS = 48
G2_COMPRESSED_BLS = 96
ETH_KZG_NUM_G1 = 32768


class AuditError(Exception):
    pass


def _bundle_dir(name_path: str) -> str:
    return os.path.join(DATA_DIR, name_path)


def _compare(name_path: str, pk_bytes: bytes, vk_bytes: bytes,
             artifact_path: str, log=print) -> None:
    """Byte-compare rebuilt blobs against the bundled ones (the audit core:
    reference audit.go 'check the files match' blocks).  Without a bundled
    pk.bin the rebuilt one goes to ``pk.audit`` in the artifact's directory:
    the bundle is read, never written."""
    d = _bundle_dir(name_path)
    vk_path = os.path.join(d, "vk.bin")
    if not os.path.exists(vk_path):
        raise AuditError(f"bundled {vk_path} missing")
    if open(vk_path, "rb").read() != vk_bytes:
        raise AuditError(f"vk mismatch: rebuilt vk != {vk_path}")
    pk_path = os.path.join(d, "pk.bin")
    if os.path.exists(pk_path):
        if open(pk_path, "rb").read() != pk_bytes:
            raise AuditError(f"pk mismatch: rebuilt pk != {pk_path}")
        log(f"audit OK: pk.bin and vk.bin match rebuilt artifacts ({name_path})")
    else:
        out = os.path.join(os.path.dirname(os.path.abspath(artifact_path)),
                           "pk.audit")
        with open(out, "wb") as f:
            f.write(pk_bytes)
        log(
            f"audit: vk.bin matches; bundled pk.bin absent (stripped large "
            f"blob) — rebuilt blob written to {out}; rename to pk.bin to "
            f"install"
        )


# --------------------------------------------------------------- Ethereum KZG


def audit_ethereum_kzg(transcript_path: str, log=print):
    """Rebuild from the ceremony sequencer transcript
    (reference EethereumKzgCeremonyBLS12_381/audit.go:52-130): select the
    numG1Powers==32768 transcript; pk = u32-BE count + the 48-byte compressed
    G1 powers verbatim; vk = G2Powers[0] ‖ G2Powers[1] ‖ G1Powers[0]."""
    with open(transcript_path) as f:
        doc = json.load(f)
    tsc = None
    for t in doc.get("transcripts", []):
        if t.get("numG1Powers") == ETH_KZG_NUM_G1:
            tsc = t
            break
    if tsc is None:
        raise AuditError(
            f"no transcript with numG1Powers == {ETH_KZG_NUM_G1} found"
        )
    g1 = [bytes.fromhex(p[2:]) for p in tsc["powersOfTau"]["G1Powers"]]
    g2 = [bytes.fromhex(p[2:]) for p in tsc["powersOfTau"]["G2Powers"][:2]]
    for b in g1:
        if len(b) != G1_COMPRESSED_BLS:
            raise AuditError("G1 power is not 48 bytes")
    for b in g2:
        if len(b) != G2_COMPRESSED_BLS:
            raise AuditError("G2 power is not 96 bytes")
    pk = struct.pack(">I", len(g1)) + b"".join(g1)
    vk = g2[0] + g2[1] + g1[0]
    _compare("EthereumKzgCeremonyBLS12_381", pk, vk, transcript_path, log=log)
    return pk, vk


# ----------------------------------------------------------------------- Dusk


def audit_dusk(response_path: str, log=print):
    """Rebuild from Dusk's raw ceremony ``response`` file
    (reference DuskBLS12_381/audit.go:29-89): G1 powers start after a 64-byte
    hash, 2^21+1 compressed 48-byte points; the two G2 points sit at
    ((2^21<<1)-1)*48 + 64."""
    raw = open(response_path, "rb").read()
    g1 = []
    off = HASH_SIZE
    for _ in range(DUSK_MAX_TAU_POWERS + 1):
        if off + G1_COMPRESSED_BLS > len(raw):
            break
        g1.append(raw[off : off + G1_COMPRESSED_BLS])
        off += G1_COMPRESSED_BLS
    if not g1:
        raise AuditError("response file holds no G1 points")
    g2_off = ((DUSK_MAX_TAU_POWERS << 1) - 1) * G1_COMPRESSED_BLS + HASH_SIZE
    if g2_off + 2 * G2_COMPRESSED_BLS > len(raw):
        raise AuditError("response file truncated before the G2 points")
    g2 = [
        raw[g2_off : g2_off + G2_COMPRESSED_BLS],
        raw[g2_off + G2_COMPRESSED_BLS : g2_off + 2 * G2_COMPRESSED_BLS],
    ]
    pk = struct.pack(">I", len(g1)) + b"".join(g1)
    vk = g2[0] + g2[1] + g1[0]
    _compare("DuskBLS12_381", pk, vk, response_path, log=log)
    return pk, vk


# ----------------------------------------------------------------------- PPoT


def _read_ptau_sections(raw: bytes) -> dict:
    """snarkjs container: 'ptau' magic, u32 LE version, u32 LE nSections,
    then (u32 LE id, u64 LE size, data) per section."""
    if raw[:4] != b"ptau":
        raise AuditError("not a .ptau file (bad magic)")
    n_sections = struct.unpack_from("<I", raw, 8)[0]
    sections, off = {}, 12
    for _ in range(n_sections):
        if off + 12 > len(raw):
            break
        sid, size = struct.unpack_from("<IQ", raw, off)
        off += 12
        sections[sid] = (off, size)
        off += size
    return sections


def parse_ptau(path: str, max_g1: int | None = None):
    """Parse a snarkjs .ptau: header (section 1), tauG1 (section 2, LE
    Montgomery coordinate pairs), tauG2 (section 3, x0 x1 y0 y1).  Returns
    (power, g1 affine int tuples, first two g2 affine ((x0,x1),(y0,y1)))."""
    raw = open(path, "rb").read()
    sections = _read_ptau_sections(raw)
    if 1 not in sections or 2 not in sections:
        raise AuditError(".ptau missing header/tauG1 sections")
    hoff, _ = sections[1]
    n8 = struct.unpack_from("<I", raw, hoff)[0]
    q = int.from_bytes(raw[hoff + 4 : hoff + 4 + n8], "little")
    power = struct.unpack_from("<I", raw, hoff + 4 + n8)[0]
    r_inv = pow(1 << (8 * n8), -1, q)

    def fe(at: int) -> int:  # LE Montgomery -> canonical
        return int.from_bytes(raw[at : at + n8], "little") * r_inv % q

    g1off, g1size = sections[2]
    n_g1_avail = g1size // (2 * n8)
    n_g1 = min(n_g1_avail, max_g1 if max_g1 is not None else 1 << power)
    g1 = []
    for i in range(n_g1):
        at = g1off + i * 2 * n8
        g1.append((fe(at), fe(at + n8)))

    g2 = []
    if 3 in sections:
        g2off, g2size = sections[3]
        for i in range(min(2, g2size // (4 * n8))):
            at = g2off + i * 4 * n8
            g2.append(((fe(at), fe(at + n8)), (fe(at + 2 * n8), fe(at + 3 * n8))))
    return power, g1, g2


def audit_ppot(ptau_path: str, log=print, max_g1: int | None = None):
    """Rebuild from the snarkjs .ptau (reference
    PerpetualPowersOfTauBN254/audit.go:12-49, which shells through
    gnark-ptau's ToSRS + gnark's Pk/Vk WriteTo): take the first 2^power tau
    G1 powers and the first two tau G2 powers, re-serialize with gnark's
    compressed encodings into the pk/vk layouts the registry loads."""
    codec = PointCodec(BN254)
    power, g1, g2 = parse_ptau(ptau_path, max_g1=max_g1)
    if len(g2) < 2:
        raise AuditError(".ptau missing tauG2 points")
    log(f"ptau power={power}, rebuilding {len(g1)} G1 powers")
    pk = struct.pack(">I", len(g1)) + b"".join(
        codec.g1_compressed(P) for P in g1
    )
    vk = (
        codec.g2_compressed(g2[0])
        + codec.g2_compressed(g2[1])
        + codec.g1_compressed(g1[0])
    )
    _compare("PerpetualPowersOfTauBN254", pk, vk, ptau_path, log=log)
    return pk, vk


AUDITS = {
    "ethereum_kzg": audit_ethereum_kzg,
    "dusk": audit_dusk,
    "ppot": audit_ppot,
}


def main(argv=None):  # pragma: no cover - thin CLI
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in AUDITS:
        print(
            "usage: python -m algoplonk_tpu_torch.setups.audit "
            "{ethereum_kzg,dusk,ppot} ARTIFACT_PATH",
            file=sys.stderr,
        )
        return 2
    try:
        AUDITS[argv[0]](argv[1])
    except (AuditError, FileNotFoundError) as e:
        print(f"AUDIT FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
