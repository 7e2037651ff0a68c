"""Compiled-circuit checkpointing (reference utils/utils.go:89-157).

Counterpart of the reference ``utils/cache.py``: persists {ccs, pk, vk,
curve} so that compile + setup runs once per circuit, in the reference's
container, a pickle of {"meta", "arrays"} whose "arrays" is an .npz archive
of the proving key's tensors.  Here those are the port's [..., W] int32
Montgomery words, moved to the host; "meta" says so with "layout": "words"
and each field's W, and the keys are loaded back onto a device.

This is a trusted local cache, as the reference's gob files are: read only
files this package wrote.  The reader unpickles with a restricted
``Unpickler`` so that a file of another package fails plainly: the meta
holds plain containers and this package's classes only, so a file that
names anything else (the reference's files name ``algoplonk_tpu`` classes,
whose import would load jax) is refused with ValueError before anything is
imported.  That narrows what a file can reach to this package's classes;
it does not make an untrusted file safe to load.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from ..fields.words import word_field

_PK_TENSORS = (
    "qk_ev",
    "s1_ev", "s2_ev", "s3_ev",
    "ql_c", "qr_c", "qm_c", "qo_c", "qk_c",
    "s1_c", "s2_c", "s3_c", "srs_g1",
)
_PACKAGE = __name__.split(".")[0]


def _widths(curve) -> dict:
    return {"fr": word_field(curve.fr).W, "fp": word_field(curve.fp).W}


def serialize_compiled_circuit(cc) -> bytes:
    pk = cc.pk
    arrays = {name: getattr(pk, name).cpu().numpy() for name in _PK_TENSORS}
    for i, a in enumerate(pk.qcp_ev):
        arrays[f"qcp_ev_{i}"] = a.cpu().numpy()
    for i, a in enumerate(pk.qcp_c):
        arrays[f"qcp_c_{i}"] = a.cpu().numpy()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    meta = {
        "curve": cc.curve.name,
        "layout": "words",
        "W": _widths(cc.curve),
        "ccs": cc.ccs,
        "vk": cc.vk,
        "pk_scalars": {
            "n": pk.n, "log_n": pk.log_n, "omega": pk.omega,
            "coset_shift": pk.coset_shift, "nb_public": pk.nb_public,
            "n_qcp": len(pk.qcp_ev),
        },
    }
    return pickle.dumps({"meta": meta, "arrays": buf.getvalue()})


class _Unpickler(pickle.Unpickler):
    """Resolves classes defined in this package only: a module outside it, a
    dotted name (which would reach what a module imports) or an object that
    is not one of the package's classes is refused."""

    def find_class(self, module, name):
        if module.split(".")[0] == _PACKAGE and "." not in name:
            obj = super().find_class(module, name)
            if isinstance(obj, type) and obj.__module__.split(".")[0] == _PACKAGE:
                return obj
        raise ValueError(f"not a cache file of {_PACKAGE}: it names {module}.{name}")


def deserialize_compiled_circuit(data: bytes, device="cuda"):
    """The CompiledCircuit of ``serialize_compiled_circuit``'s bytes, with
    its proving key on ``device``."""
    from .. import CompiledCircuit
    from ..fields.params import CURVES
    from ..plonk.keys import ProvingKey

    blob = _Unpickler(io.BytesIO(data)).load()
    meta = blob["meta"]
    curve = CURVES[meta["curve"]]
    if meta.get("layout") != "words" or meta.get("W") != _widths(curve):
        raise ValueError(f"not a cache file of {_PACKAGE}: layout "
                         f"{meta.get('layout')!r}, W {meta.get('W')!r}")
    # the pickled curve is a copy: point the keys at the package's own
    meta["ccs"].curve = meta["vk"].curve = curve
    z = np.load(io.BytesIO(blob["arrays"]))
    s = meta["pk_scalars"]
    arr = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    pk = ProvingKey(
        curve=curve,
        n=s["n"], log_n=s["log_n"], omega=s["omega"],
        coset_shift=s["coset_shift"], nb_public=s["nb_public"],
        qcp_ev=[arr[f"qcp_ev_{i}"] for i in range(s["n_qcp"])],
        qcp_c=[arr[f"qcp_c_{i}"] for i in range(s["n_qcp"])],
        vk=meta["vk"],
        **{name: arr[name] for name in _PK_TENSORS},
    )
    return CompiledCircuit(ccs=meta["ccs"], pk=pk, vk=meta["vk"], curve=curve)


def write_compiled_circuit(cc, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(serialize_compiled_circuit(cc))


def read_compiled_circuit(path: str, device="cuda"):
    with open(path, "rb") as fh:
        return deserialize_compiled_circuit(fh.read(), device)
