"""Port of `vmn_tpu.eio.marshal` (a host-only copy; byte-identical behaviour).

Marshalling of configured objects into byte trees.

The reference's VCR Marshalizer stores objects as
``node(leaf(java-class-name), object-byte-tree)`` and renders them in
config files as ``<comment>::<hex-of-byte-tree>``.  We keep the Java class
names verbatim as interop identifiers so that group/PRG/hash descriptions in
protocol-info files and global-prefix derivations remain compatible with the
reference (reference: ProtocolElGamal.java:352-434 unmarshals these strings;
the full string is hashed into the global prefix, ProtocolElGamal.java:659-683).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from vmn_tpu_torch.eio.bytetree import ByteTree, ByteTreeError, leaf, node

# Registry: java-class-name -> constructor from a byte tree and the
# `device` its arrays live on.
_REGISTRY: Dict[str, Callable[..., object]] = {}


def register(class_name: str):
    """Class decorator: register `from_bytetree` under an interop name."""

    def wrap(cls):
        cls.MARSHAL_NAME = class_name
        _REGISTRY[class_name] = cls.from_bytetree
        return cls

    return wrap


def marshal(obj) -> ByteTree:
    """node(leaf(class name), object byte tree)."""
    name = getattr(obj, "MARSHAL_NAME", None)
    if name is None:
        raise ByteTreeError(f"object {type(obj)} has no MARSHAL_NAME")
    return node(leaf(name.encode("utf-8")), obj.to_bytetree())


def unmarshal(bt: ByteTree, device="cuda"):
    """The object of a marshalled byte tree; a group (or an object that
    holds one) is built on `device`."""
    if bt.is_leaf or len(bt.children) != 2:
        raise ByteTreeError("malformed marshalled object")
    name = bt[0].to_string()
    ctor = _REGISTRY.get(name)
    if ctor is None:
        raise ByteTreeError(f"unknown marshalled class: {name}")
    return ctor(bt[1], device=device)


def marshal_hex(obj, comment: str = "") -> str:
    """Render as ``comment::hex`` as found in protocol-info files."""
    hx = marshal(obj).to_hex()
    if comment:
        return f"{comment}::{hx}"
    return hx


def split_hex(s: str) -> Tuple[str, str]:
    """Split ``comment::hex`` into (comment, hex)."""
    if "::" in s:
        comment, hx = s.rsplit("::", 1)
        return comment, hx
    return "", s


def unmarshal_hex(s: str, device="cuda"):
    _, hx = split_hex(s)
    return unmarshal(ByteTree.from_hex(hx), device)
