"""Port of `vmn_tpu.protocol.interfaces`: the same file formats.

A plug-in named by a dotted path is loaded from anywhere but the JAX
package (`vmn_tpu.*`), which the port never imports.

Pluggable external formats for keys / ciphertexts / plaintexts.

Rebuild of the reference's ProtocolElGamalInterface registry
(reference: ProtocolElGamalInterface.java:58 and factory
ProtocolElGamalInterfaceFactory.java:61-66 mapping
raw / native / json / jsondecode / seqhex / seqjson).

Interfaces convert between the framework's device arrays and operator-
facing files:
  raw        — byte-tree files (.bt), the internal canonical format
  native     — hex-encoded byte trees, one object per file
  json       — JSON arrays of decimal-string ciphertext components
  jsondecode — like json for input; plaintexts decoded to strings
  seqhex     — newline-separated hex byte trees, one ciphertext each
  seqjson    — newline-separated JSON objects, one ciphertext each
"""

from __future__ import annotations

import json as _json
from pathlib import Path
from typing import List

from vmn_tpu_torch.arith.pgroup import GArray, PPArray, PPGroup
from vmn_tpu_torch.eio.bytetree import ByteTree, node
from vmn_tpu_torch.protocol.elgamal import ElGamalPublicKey


class InterfaceError(Exception):
    pass


def _flatten(elem) -> List[GArray]:
    """Leaves of a (possibly nested) product element, in order."""
    if isinstance(elem, PPArray):
        out = []
        for c in elem.components:
            out.extend(_flatten(c))
        return out
    return [elem]


def _unflatten(group, leaves, it=None):
    """Rebuild a product element from leaf arrays."""
    if it is None:
        it = iter(leaves)
    if isinstance(group, PPGroup):
        comps = tuple(
            _unflatten(f, leaves, it) for f in group.factors
        )
        return PPArray(group, comps)
    return next(it)


class RawInterface:
    """Byte-tree files (reference: ProtocolElGamalInterfaceRaw)."""

    NAME = "raw"

    def write_public_key(self, pk: ElGamalPublicKey, path) -> None:
        Path(path).write_bytes(pk.to_bytetree().to_bytes())

    def read_public_key(self, group, path) -> ElGamalPublicKey:
        bt = ByteTree.read_file(path)
        return ElGamalPublicKey.from_bytetree(group, bt)

    def write_ciphertexts(self, ciphs: PPArray, path) -> None:
        Path(path).write_bytes(ciphs.to_bytetree().to_bytes())

    def read_ciphertexts(self, ciph_group, path) -> PPArray:
        bt = ByteTree.read_file(path)
        return ciph_group.elem_from_bytetree(bt)

    def write_plaintexts(self, plain, path) -> None:
        Path(path).write_bytes(plain.to_bytetree().to_bytes())

    def read_plaintexts(self, plain_group, path):
        bt = ByteTree.read_file(path)
        return plain_group.elem_from_bytetree(bt)

    def decode_plaintexts(self, plain, path) -> None:
        """Write decoded message strings, one per line
        (reference: decodePlaintexts)."""
        msgs = decode_plaintexts(plain)
        Path(path).write_bytes(b"\n".join(msgs) + b"\n")


class NativeInterface(RawInterface):
    """Hex byte trees (reference: ProtocolElGamalInterfaceNative)."""

    NAME = "native"

    def write_public_key(self, pk: ElGamalPublicKey, path) -> None:
        Path(path).write_text(pk.to_bytetree().to_hex() + "\n")

    def read_public_key(self, group, path) -> ElGamalPublicKey:
        bt = ByteTree.from_hex(Path(path).read_text().strip())
        return ElGamalPublicKey.from_bytetree(group, bt)

    def write_ciphertexts(self, ciphs: PPArray, path) -> None:
        Path(path).write_text(ciphs.to_bytetree().to_hex() + "\n")

    def read_ciphertexts(self, ciph_group, path) -> PPArray:
        bt = ByteTree.from_hex(Path(path).read_text().strip())
        return ciph_group.elem_from_bytetree(bt)

    def write_plaintexts(self, plain, path) -> None:
        Path(path).write_text(plain.to_bytetree().to_hex() + "\n")

    def read_plaintexts(self, plain_group, path):
        bt = ByteTree.from_hex(Path(path).read_text().strip())
        return plain_group.elem_from_bytetree(bt)


class JSONInterface(RawInterface):
    """JSON decimal-string format
    (reference: ProtocolElGamalInterfaceJSON)."""

    NAME = "json"

    def write_public_key(self, pk: ElGamalPublicKey, path) -> None:
        g = _flatten(pk.g)
        y = _flatten(pk.y)
        obj = {
            "g": [str(a.to_ints()[0]) for a in g],
            "y": [str(a.to_ints()[0]) for a in y],
        }
        Path(path).write_text(_json.dumps(obj) + "\n")

    def read_public_key(self, group, path) -> ElGamalPublicKey:
        obj = _json.loads(Path(path).read_text())
        base = group
        while isinstance(base, PPGroup):
            base = base.project(0)
        gs = [base.from_ints([int(x)]).get(0) for x in obj["g"]]
        ys = [base.from_ints([int(x)]).get(0) for x in obj["y"]]
        g = _unflatten(group, gs) if isinstance(group, PPGroup) else gs[0]
        y = _unflatten(group, ys) if isinstance(group, PPGroup) else ys[0]
        return ElGamalPublicKey(g, y)

    def write_ciphertexts(self, ciphs: PPArray, path) -> None:
        comps = _flatten(ciphs)
        cols = [c.to_ints() for c in comps]
        rows = [
            [str(col[i]) for col in cols] for i in range(len(cols[0]))
        ]
        Path(path).write_text(_json.dumps(rows) + "\n")

    def read_ciphertexts(self, ciph_group, path) -> PPArray:
        rows = _json.loads(Path(path).read_text())
        ncomp = len(rows[0])
        base = ciph_group
        while isinstance(base, PPGroup):
            base = base.project(0)
        cols = [
            base.from_ints([int(r[c]) for r in rows])
            for c in range(ncomp)
        ]
        return _unflatten(ciph_group, cols)

    def write_plaintexts(self, plain, path) -> None:
        comps = _flatten(plain)
        cols = [c.to_ints() for c in comps]
        rows = [
            [str(col[i]) for col in cols] for i in range(len(cols[0]))
            ] if len(comps) > 1 else [str(x) for x in cols[0]]
        Path(path).write_text(_json.dumps(rows) + "\n")

    def read_plaintexts(self, plain_group, path):
        rows = _json.loads(Path(path).read_text())
        base = plain_group
        while isinstance(base, PPGroup):
            base = base.project(0)
        if rows and isinstance(rows[0], list):
            cols = [
                base.from_ints([int(r[c]) for r in rows])
                for c in range(len(rows[0]))
            ]
            return _unflatten(plain_group, cols)
        arr = base.from_ints([int(x) for x in rows])
        return (
            _unflatten(plain_group, [arr])
            if isinstance(plain_group, PPGroup) else arr
        )


class JSONDecodeInterface(JSONInterface):
    """json for input, decoded strings for plaintext output
    (reference: ProtocolElGamalInterfaceJSONDecode)."""

    NAME = "jsondecode"

    def write_plaintexts(self, plain, path) -> None:
        msgs = decode_plaintexts(plain)
        Path(path).write_text(
            _json.dumps([m.decode("utf-8", "replace") for m in msgs]) + "\n"
        )


class SeqJSONInterface(JSONInterface):
    """Newline-separated JSON objects, one ciphertext per line
    (reference: ProtocolElGamalInterfaceSeqJSON)."""

    NAME = "seqjson"

    def write_ciphertexts(self, ciphs: PPArray, path) -> None:
        comps = _flatten(ciphs)
        cols = [c.to_ints() for c in comps]
        lines = [
            _json.dumps([str(col[i]) for col in cols])
            for i in range(len(cols[0]))
        ]
        Path(path).write_text("\n".join(lines) + "\n")

    def read_ciphertexts(self, ciph_group, path) -> PPArray:
        rows = [
            _json.loads(ln)
            for ln in Path(path).read_text().splitlines()
            if ln.strip()
        ]
        ncomp = len(rows[0])
        base = ciph_group
        while isinstance(base, PPGroup):
            base = base.project(0)
        cols = [
            base.from_ints([int(r[c]) for r in rows])
            for c in range(ncomp)
        ]
        return _unflatten(ciph_group, cols)


class SeqHexInterface(RawInterface):
    """Newline-separated hex byte trees, one ciphertext per line
    (reference: ProtocolElGamalInterfaceSeqHex)."""

    NAME = "seqhex"

    def write_ciphertexts(self, ciphs: PPArray, path) -> None:
        bt = ciphs.to_bytetree()
        n = ciphs.size
        # transpose array-of-components to per-ciphertext byte trees
        lines = []
        for i in range(n):
            lines.append(_project_row(bt, i).to_hex())
        Path(path).write_text("\n".join(lines) + "\n")

    def read_ciphertexts(self, ciph_group, path) -> PPArray:
        lines = [
            ln.strip() for ln in Path(path).read_text().splitlines()
            if ln.strip()
        ]
        rows = [ByteTree.from_hex(ln) for ln in lines]
        bt = _rows_to_array(rows)
        return ciph_group.elem_from_bytetree(bt)


def _project_row(bt: ByteTree, i: int) -> ByteTree:
    """Array byte tree -> element i byte tree (recursively)."""
    if bt.is_leaf:
        raise InterfaceError("not an array byte tree")
    if all(c.is_leaf for c in bt.children):
        return bt.children[i]
    return node(*[_project_row(c, i) for c in bt.children])


def _rows_to_array(rows: List[ByteTree]) -> ByteTree:
    """Per-element byte trees -> array byte tree (recursively)."""
    first = rows[0]
    if first.is_leaf:
        return node(*rows)
    return node(*[
        _rows_to_array([r.children[c] for r in rows])
        for c in range(len(first.children))
    ])


def decode_plaintexts(plain) -> List[bytes]:
    """Decode group elements back to messages."""
    comps = _flatten(plain)
    grp = comps[0].grp
    out = []
    cols = [c.to_ints() for c in comps]
    for i in range(len(cols[0])):
        parts = [grp.decode_message(col[i]) for col in cols]
        out.append(b"".join(parts))
    return out


_REGISTRY = {
    c.NAME: c
    for c in (RawInterface, NativeInterface, JSONInterface,
              JSONDecodeInterface, SeqHexInterface, SeqJSONInterface)
}


def get_interface(name: str):
    """Look up an interface by name.

    Unknown names are loaded as user plug-in classes — a dotted path
    `package.module.ClassName` is imported and instantiated, matching
    the reference's reflective loading of custom interface classes
    (reference: ProtocolElGamalInterfaceFactory.java:90-110)."""
    cls = _REGISTRY.get(name)
    if cls is not None:
        return cls()
    if "." in name:
        import importlib

        mod_name, _, cls_name = name.rpartition(".")
        if mod_name.split(".")[0] in ("vmn_tpu", "jax"):
            raise InterfaceError(
                f"plug-in interface {name!r}: the port does not load "
                "modules of the JAX package")
        try:
            mod = importlib.import_module(mod_name)
            plugin = getattr(mod, cls_name)
        except (ImportError, AttributeError) as e:
            raise InterfaceError(
                f"cannot load plug-in interface {name!r}: {e}"
            )
        for meth in ("write_ciphertexts", "read_ciphertexts"):
            if not hasattr(plugin, meth):
                raise InterfaceError(
                    f"plug-in {name!r} lacks required method {meth!r}"
                )
        return plugin()
    raise InterfaceError(f"unknown interface: {name}")
