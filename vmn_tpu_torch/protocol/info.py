"""Port of `vmn_tpu.protocol.info`: the same XML layout and merge rules.

`ProtocolInfo.group(device)` and `to_params(device)` build the group on
the device the caller names (the card unless it asks for the CPU).
`PrivateInfo.read` refuses a file that is not a private info file: the
wrong root element, or a required field missing (`vmn_tpu` reads the
mergeable protocol stub as an empty private info; fault F4).

Protocol/private info files — the two-layer XML configuration.

Rebuild of the reference's info-file system (reference: SURVEY.md §5
config system — shared `protInfo.xml` + per-party `privInfo.xml`,
generated and merged by `vmni`; schema fields added in
ProtocolElGamalGen.java:96-160 and MixNetElGamalGen.java:84-95).

The XML layout mirrors the reference's field names so operators can
carry configurations across.  Marshalled objects (groups, PRGs, hash
functions) are stored as `name::hex` strings exactly like `vog` output.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from vmn_tpu_torch import VCR_COMPAT_VERSION

# The groups and the protocol parameters (and with them torch) are
# imported where they are built, so that `vmni`, which only reads and
# writes XML, starts in a fraction of a second.


class InfoError(ValueError):
    """An info file that is not what its reader expects."""


def _root(path, tag: str, what: str):
    try:
        root = ET.parse(str(path)).getroot()
    except ET.ParseError as e:
        raise InfoError(f"{path}: not a {what} file: {e}") from e
    if root.tag != tag:
        raise InfoError(
            f"{path}: not a {what} file: root element <{root.tag}>, "
            f"expected <{tag}>")
    return root


def group_of(spec: str, device="cuda"):
    """The group of a `pgroup` string on `device`: `named:<name>` (modp*
    names and NIST curve names) or marshalled hex."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup
    from vmn_tpu_torch.eio.marshal import unmarshal_hex

    if spec.startswith("named:"):
        name = spec[len("named:"):]
        if name.startswith("P-"):
            from vmn_tpu_torch.arith.ec import ECqPGroup

            return ECqPGroup.named(name, device)
        return ModPGroup.named(name, device)
    return unmarshal_hex(spec, device)


@dataclass
class PartyInfo:
    """Per-party public block of the protocol info."""

    name: str
    srtbyrole: str = "anyrole"
    descr: str = ""
    pkey: str = ""  # signature public key (marshalled hex)
    http: str = ""  # bulletin-board HTTP address
    hint: str = ""  # hint-server UDP address


@dataclass
class ProtocolInfo:
    """Shared protocol info (protInfo.xml equivalent)."""

    version: str = VCR_COMPAT_VERSION
    sid: str = "SID"
    name: str = ""
    descr: str = ""
    nopart: int = 1
    statdist: int = 100
    bullboard: str = "com.verificatum.protocol.com.BullBoardBasicHTTPW"
    thres: int = 1
    pgroup: str = ""  # marshalled hex of the group
    keywidth: int = 1
    vbitlen: int = 128
    vbitlenro: int = 256
    ebitlen: int = 128
    ebitlenro: int = 256
    prg: str = "SHA-256"
    rohash: str = "SHA-256"
    corr: str = "noninteractive"
    width: int = 1
    maxciph: int = 0
    parties: List[PartyInfo] = field(default_factory=list)

    # ------------------------------------------------------------- I/O
    # Field ORDER mirrors the reference protInfo.xml layout (version,
    # sid, name, descr, nopart, statdist, bullboard, thres, pgroup,
    # keywidth, bit lengths, prg, rohash, corr, width, maxciph, then
    # per-party blocks) so generated files diff cleanly against
    # reference-generated ones; unknown elements are ignored on read,
    # so real Verificatum files parse.

    _FIELDS = [
        "version", "sid", "name", "descr", "nopart", "statdist",
        "bullboard", "thres", "pgroup", "keywidth", "vbitlen",
        "vbitlenro", "ebitlen", "ebitlenro", "prg", "rohash", "corr",
        "width", "maxciph",
    ]
    _PARTY_FIELDS = ["name", "srtbyrole", "descr", "pkey", "http", "hint"]

    def to_xml(self) -> str:
        root = ET.Element("protocol")
        for f in self._FIELDS:
            el = ET.SubElement(root, f)
            el.text = str(getattr(self, f))
        for p in self.parties:
            pe = ET.SubElement(root, "party")
            for f in self._PARTY_FIELDS:
                el = ET.SubElement(pe, f)
                el.text = str(getattr(p, f))
        ET.indent(root)
        return ET.tostring(root, encoding="unicode", xml_declaration=True)

    def write(self, path) -> None:
        Path(path).write_text(self.to_xml() + "\n")

    @classmethod
    def read(cls, path) -> "ProtocolInfo":
        root = _root(path, "protocol", "protocol info")
        pi = cls()
        for f in cls._FIELDS:
            el = root.find(f)
            if el is not None and el.text is not None:
                cur = getattr(pi, f)
                setattr(pi, f, int(el.text) if isinstance(cur, int)
                        else el.text.strip())
        pi.parties = []
        for pe in root.findall("party"):
            p = PartyInfo(name="")
            for f in cls._PARTY_FIELDS:
                el = pe.find(f)
                if el is not None and el.text is not None:
                    setattr(p, f, el.text.strip())
            pi.parties.append(p)
        return pi

    # -------------------------------------------------------- semantics

    def group(self, device="cuda"):
        """Instantiate the configured group on `device`: `named:<name>`
        resolves modp* names and NIST curve names; otherwise marshalled
        hex."""
        return group_of(self.pgroup, device)

    def to_params(self, device="cuda") -> "ProtocolParams":
        from vmn_tpu_torch.protocol.context import ProtocolParams

        return ProtocolParams(
            sid=self.sid,
            k=self.nopart,
            threshold=self.thres,
            pgroup=self.group(device),
            keywidth=self.keywidth,
            vbitlen=self.vbitlen,
            vbitlenro=self.vbitlenro,
            ebitlen=self.ebitlen,
            ebitlenro=self.ebitlenro,
            rbitlen=self.statdist,
            prg_name=self.prg,
            rohash_name=self.rohash,
            noninteractive=self.corr != "interactive",
        )

    def merge(self, other: "ProtocolInfo") -> "ProtocolInfo":
        """Merge party blocks from per-party protInfo copies
        (reference: vmni -merge)."""
        for f in self._FIELDS:
            if getattr(self, f) != getattr(other, f):
                raise ValueError(f"protocol info mismatch in field {f}")
        merged = ProtocolInfo(**{f: getattr(self, f) for f in self._FIELDS})
        names = set()
        merged.parties = []
        for p in self.parties + other.parties:
            if p.name not in names:
                names.add(p.name)
                merged.parties.append(p)
        return merged


@dataclass
class PrivateInfo:
    """Per-party private info (privInfo.xml equivalent)."""

    version: str = VCR_COMPAT_VERSION
    name: str = ""
    dir: str = "."
    rand: str = "RandomDevice"  # randomness-source description
    skey: str = ""  # signature secret key (marshalled hex)
    keygen: str = ""  # CCA2 key generator description
    arrays: str = "ram"
    nizkp: str = "nizkp"
    seed: str = ""

    _FIELDS = ["version", "name", "dir", "rand", "skey", "keygen",
               "arrays", "nizkp", "seed"]

    def to_xml(self) -> str:
        root = ET.Element("private")
        for f in self._FIELDS:
            el = ET.SubElement(root, f)
            el.text = str(getattr(self, f))
        ET.indent(root)
        return ET.tostring(root, encoding="unicode", xml_declaration=True)

    def write(self, path) -> None:
        Path(path).write_text(self.to_xml() + "\n")

    # Fields a private info file must hold (`vmni -party` writes them all).
    _REQUIRED = ["name", "dir", "rand", "skey"]

    @classmethod
    def read(cls, path) -> "PrivateInfo":
        root = _root(path, "private", "private info")
        missing = [f for f in cls._REQUIRED if root.find(f) is None]
        if missing:
            raise InfoError(
                f"{path}: not a private info file: no "
                f"{', '.join('<' + f + '>' for f in missing)}")
        pi = cls()
        for f in cls._FIELDS:
            el = root.find(f)
            if el is not None and el.text is not None:
                setattr(pi, f, el.text.strip())
        return pi
