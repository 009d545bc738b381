"""Port of `vmn_tpu.cli.vmnv`: the same switches, test-vector blocks
and verdict lines; the verifier's arrays live on `device`.

`vmnv` — standalone universal verifier.

Rebuild of the reference verifier CLI (reference:
MixNetElGamalVerifyFiatShamirTool.java:540-641):

    vmnv protInfo nizkpdir [-mix|-shuffle|-decrypt] [-auxsid SID]
         [-nopos] [-nodec] [-t name1,name2,...] [-v]
"""

from __future__ import annotations

import argparse
import sys

# Verbatim test-vector descriptions of the reference verifier
# (reference: MixNetElGamalVerifyFiatShamirTool.java:85-225
# VALID_TEST_VECTOR_NAMES) so `-t` output blocks match the
# `TEST VECTOR\n<name> - <description>\n<value>` format an external
# checker of the Verificatum verifier spec expects.
TV_DESCRIPTIONS = {
    "par": "Parameters.",
    "par.version": "Version.",
    "par.sid": "Session identifier of mix-net.",
    "par.k": "Number of mix-servers.",
    "par.lambda": "Threshold number of parties needed to decrypt.",
    "par.n_e": "Bit length of components in random vectors used for "
               "batching.",
    "par.n_r": "Bit length of random paddings.",
    "par.n_v": "Bit length of challenges.",
    "par.s_PRG": "Description of PRG used for batching.",
    "par.s_Gq": "Description of underlying group.",
    "par.s_H": "Description of hash function used to implement random "
               "oracles.",
    "par.omega": "Width of ciphertexts.",
    "par.N_0": "Number of ciphertexts for which precomputation is done.",
    "der": "Derived values.",
    "der.rho": "Derived prefix bytes to all random oracle queries.",
    "bas": "Basic inputs.",
    "bas.pk": "Joint public key.",
    "bas.y_l": "Public keys of threshold number of mix-servers.",
    "bas.x_l": "Secret keys of some mix-servers (null if a key is not "
               "present).",
    "bas.M_omega": "Space of plaintexts.",
    "bas.R_omega": "Space of randomness.",
    "bas.C_omega": "Space of ciphertexts.",
    "bas.h": "Independent generators.",
    "bas.L_0": "Original list of ciphertexts.",
    "bas.L_l": "Intermediate list of ciphertexts.",
    "u": "Permutation commitment.",
    "PoSC": "Proof of shuffle of commitments.",
    "PoSC.s": "PoSC. Seed to derive batching vector in hexadecimal "
              "notation.",
    "PoSC.v": "PoSC. Integer challenge in hexadecimal notation.",
    "CCPoS": "Commitment-consistent proof of a shuffle.",
    "CCPoS.s": "CCPoS. Seed to derive batching vector in hexadecimal "
               "notation.",
    "CCPoS.v": "CCPoS. Integer challenge in hexadecimal notation.",
    "PoS": "All test vectors for proofs of shuffles.",
    "PoS.s": "PoS. Seed to derive batching vector in hexadecimal "
             "notation.",
    "PoS.v": "PoS. Integer challenge in hexadecimal notation.",
    "PoS.A": "PoS. Batched permutation commitment.",
    "PoS.F": "PoS. Batched input ciphertexts.",
    "PoS.B": "PoS. Commitment components.",
    "PoS.C": "PoS. Derived intermediate values.",
    "PoS.D": "PoS. Derived intermediate values.",
    "PoS.Ap": "PoS. Commitment components.",
    "PoS.Bp": "PoS. Commitment components.",
    "PoS.Cp": "PoS. Commitment components.",
    "PoS.Dp": "PoS. Commitment components.",
    "PoS.Fp": "PoS. Commitment components.",
    "PoS.k_A": "PoS. Reply components.",
    "PoS.k_B": "PoS. Reply components.",
    "PoS.k_C": "PoS. Reply components.",
    "PoS.k_D": "PoS. Reply components.",
    "PoS.k_E": "PoS. Reply components.",
    "PoS.k_F": "PoS. Reply components.",
    "Dec": "Proof of correct decryption.",
    "Dec.s": "Dec. Seed to derive batching vector in hexadecimal "
             "notation.",
    "Dec.v": "Dec. Integer challenge in hexadecimal notation.",
}


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(prog="vmnv", description=__doc__)
    p.add_argument("protinfo")
    p.add_argument("nizkp")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-mix", action="store_true")
    mode.add_argument("-shuffle", action="store_true")
    mode.add_argument("-decrypt", action="store_true")
    p.add_argument("-auxsid", default=None)
    p.add_argument("-nopos", action="store_true",
                   help="skip proofs of shuffles")
    p.add_argument("-nodec", action="store_true",
                   help="skip decryption proof")
    p.add_argument("-noposc", action="store_true",
                   help="skip proofs of shuffles of commitments")
    p.add_argument("-noccpos", action="store_true",
                   help="skip commitment-consistent proofs of shuffles")
    p.add_argument("-sloppy", action="store_true",
                   help="relax strict byte-format checks")
    p.add_argument("-width", type=int, default=None,
                   help="expected width of ciphertexts")
    p.add_argument("-wd", default=None, metavar="DIR",
                   help="working directory for temporary files")
    p.add_argument("-a", default=None, metavar="BACKEND",
                   help="array backend: ram or file")
    p.add_argument("-mc", action="store_true",
                   help="print verifier-spec compatibility usage and exit")
    p.add_argument("-t", default=None,
                   help="comma-separated test-vector names to print")
    p.add_argument("-v", action="store_true", help="verbose")
    args = p.parse_args(argv)

    if args.mc:
        # Compatibility mode: the usage form mandated by the Verificatum
        # verifier specification (reference:
        # MixNetElGamalVerifyFiatShamirTool.java -mc flag).
        print("Usage: vmnv -mix|-shuffle|-decrypt [-auxsid <auxsid>] "
              "[-width <width>] <protInfo> <nizkp>")
        return 0

    if args.wd:
        import os
        import tempfile
        os.makedirs(args.wd, exist_ok=True)
        tempfile.tempdir = args.wd

    from vmn_tpu_torch.protocol.info import InfoError, ProtocolInfo
    from vmn_tpu_torch.protocol.mixnet.verifier import (
        FiatShamirVerifier,
        VerificationError,
    )

    try:
        prot = ProtocolInfo.read(args.protinfo)
    except InfoError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    expected = (
        "mixing" if args.mix else
        "shuffling" if args.shuffle else
        "decryption" if args.decrypt else None
    )
    tv = args.t.split(",") if args.t else None
    verifier = FiatShamirVerifier(prot.to_params(device), args.nizkp,
                                  test_vectors=tv)
    try:
        res = verifier.verify(
            expected_type=expected,
            expected_auxsid=args.auxsid,
            check_pos=not args.nopos,
            check_dec=not args.nodec,
            check_posc=not args.noposc,
            check_ccpos=not args.noccpos,
            expected_width=args.width,
            sloppy=args.sloppy,
        )
    except VerificationError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1

    for name, value in res.test_vectors.items():
        # Reference output block (reference:
        # MixNetElGamalVerifyFiatShamir.printTestVector:382-388 +
        # MixNetElGamalVerifyFiatShamirTool.testVectorHeader:292-309).
        key = name
        idx = None
        if name[-1].isdigit():
            base = name.rstrip("0123456789")
            if base in TV_DESCRIPTIONS:
                key, idx = base, name[len(base):]
        desc = TV_DESCRIPTIONS.get(key, "")
        shown = key[:-1] + idx if idx is not None else key
        print(f"\nTEST VECTOR\n{shown} - {desc}\n{value}")
    if args.v:
        print(f"type={res.type} auxsid={res.auxsid} width={res.width} "
              f"active_threshold={res.active_threshold}")
    if res.ok:
        print("Proof is valid.")
        return 0
    print("PROOF IS INVALID.", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
