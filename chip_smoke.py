"""Drive the vmn_tpu_torch mix paths once on one CUDA card.

Usage:  python3 chip_smoke.py [--n N] [--ec-n N] [--k3-n N] [--k3i-n N]
                              [--profile PATH ...]
        python3 chip_smoke.py --cli-party -- <vmn arguments>
          (one `vmn` of the port on the card, its launches and board
          figures on its last line: the party processes of phase 10)
        python3 chip_smoke.py --shard-rank -- <workdir> <N> <EC N>
          (one rank, by the VMN_DIST_* triplet, of the sharded mixes of
          phase 7: a JSON line a mix)
        python3 chip_smoke.py --alone -- golden|slice <group> <workdir>
          (one golden of phase 5 or slice of phase 6 alone: the ffc15360
          golden, run beside the CLI runs of phase 10, and its slice, run
          beside the k=3 and precomputation phases 8 and 9)

Phases (one line each; any failure raises and the exit code is not 0):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build the Hopper kernels from vmn_tpu_torch/csrc with nvcc (one nvcc
     per source file, all started together), and beside them the
     Montgomery libraries of the widths this run builds on demand
     (ON_DEMAND_WIDTHS: W = 32 for the fresh groups, W = 12 and W' = 20
     for H3, H4 and the chain, W = 192 and 256 for RFC 3526's modp6144
     and modp8192, W = 480 and 512 past 8192 bits and W = 288 between;
     one nvcc each, started with the rest),
     each with its seconds, TPIs, registers and spill bytes on its
     `[build] width=` line, and its ptxas lines;
  3. check H1 mont_mul, H2 mont_exp, H3 mont_fb_exp, H4
     mont_expprod_positions and K7's combine mont_expprod_combine at each
     width a path runs: modp2048 (W=64), modp3072 (W=96) and modp4096
     (W=128) on N elements (--n, default 10000) with full-width exponents
     (H4: 256-bit ones, and at W=96 and 128 also full-width ones), H1, H2,
     H3 and H4 also on one element (H2: a^(m-2) as MontCtx.inv raises
     it), H3 at window 8 (at W=64 also window 4 at 256 bits), the combine
     over a full-width exponent's positions (512, 768, 1024), H2 at W=64
     also on 1.25·N elements at 64-bit exponents (the precomputation's
     raised values); at the P-256 field (W=8) H1 and H2 on --ec-n, on N
     and on one, H3 at window 4 on N and on one, H4 on N; at the P-384
     field (W=12) H1 and H2 on --ec-n and on one, and K7's combine over
     96 positions; at the P-224 and P-521 fields and rings (L = 14 and
     33 limbs at the inner widths W' = 8 and 20, converted at the
     kernels' boundary) H1 and H2 on --ec-n, whole on 4096 and on one,
     and H3 at window 4, H4 and K7's combine (on no curve's path, from
     the on-demand libraries at W = 12 and 20) on 1000 elements
     (SMALL_N), the same at the P-384 field; at the fresh groups vog1024
     (W = 32) and vog1000 (63 limbs at W' = 32, converting) as at the
     wide groups, and H3 at window 4 on 1000 elements; H3 at window 4
     at W = 96 and 128 on N at 256-bit exponents (a group with a short
     q); at modp6144 (W = 192) and modp8192 (W = 256) as at the wide
     groups, but H4 at full width on 16 elements spread over the batch in
     a launch of their own (PY_ELEMENTS), with H3 at window 4 on N at
     256-bit exponents; at W = 480 (the 15360-bit group ffc15360) and
     W = 512 (a 16384-bit odd modulus, `wide_modulus`), checked first,
     on the ffc15360 slice's 1000 elements (FFC_N): H1, and H2, H3 at
     both windows and H4 at 256-bit exponents, H1-H3 held on HELD_ROWS
     spread rows; H2 and H3 at window 8 also at full width, held to
     their plain versions (on host copies) and to Python pow on the five
     edge and spread rows of py_rows, H4 at full width on 16 elements
     spread over the batch in a launch of their own; on one element at
     full width H1, H2 (a^(m-2)), H3 at window 8 and H4, with K7's
     combine over a full-width exponent's positions (3840, 4096), their
     Python checks in the host pool while the other checks run; at
     W = 288 (MID_WIDTH), between 256 and 480 words, at a 9216-bit odd
     modulus and at an 8224-bit one (W' = 288, converting), H1, and H2,
     H3 at both windows and H4 at 256-bit exponents on FFC_N elements,
     H1 and H2 (a^(m-2)) on one, and K7's combine over 64 positions;
     then each of H1-H4 at the first
     N of any TPI of its
     rule that those miss, so that every TPI (lanes an element) the
     wrappers choose is checked (it fails otherwise); then the ChaCha20
     kernel of the device PRF (chacha20_limbs, csrc/prf_kernels.cu) at
     the DeviceSource mixes' draws, N rows of 2147 bits (modp2048) and
     --ec-n rows of 356 bits (P-256), whole and over a row range that
     starts mid-block, and RFC 8439 §2.3.2's block on the card.  Each
     against its plain PyTorch version on the card, exact equality of
     the whole output, but H1-H3 at W=96 and 128, and H2 at W=12, P-224 and W'=20
     on --ec-n, on 256
     rows spread over the batch (a full-width plain power takes seconds
     whatever the rows); a few rows (H4: its positions combined, at W=96
     and 128 those of 16 elements in a launch of their own) against
     Python pow; each timed on its whole batch (kernels on the device:
     vmn_tpu_torch/kernel_timing.py's device_ms);
  4. check H5 ec_scalar_mul, H6 ec_multiexp_positions (with the rest of
     `ec_multiexp`), the position combine ec_multiexp_combine (64
     positions, a 256-bit multi-exponentiation), H7 ec_fb_exp and H8
     ec_point_add at P-256 the same way (exact equality of Jacobian limbs;
     after `normalize`, a few rows against Python EC arithmetic), with
     infinity, P == Q, P == -Q, scalar 0 and scalar n - 1 among the
     inputs, and H7 against H5 on the same fixed-base batch: once whole
     on 4096 points and once on the EC path's batch (--ec-n; there H5, H7
     and H8 on 256 rows spread over the batch with the edge rows, H6
     whole on 16384 points of the batch's launch shape),
     H8 also on one pair; H5 and H8 also at the first N of any TPI (lanes
     a point) that those batches do not reach, so that every TPI their
     wrappers choose is checked; H5 also at 64-bit scalars on
     1.25·min(--ec-n, 65536) points (the precomputation's raised
     values); then the same at P-224 (the P-256 kernels at W' = 8 with
     the boundary conversion: 224-bit scalars, the combine over 64
     positions, no H7: off its path and not built at a padded modulus),
     at P-384 (W=12: 384-bit scalars, the combine over 96 positions) and
     at P-521 (W' = 20: 521-bit scalars, the combine over 144 positions,
     no H7), one loop over the curves;
  5. the test256 and P-256 golden mixes on the card: each transcript must
     equal tests/golden/nizkp_{test256,p256}_k1 byte for byte, and the
     port's verifier must accept it and write the test vectors of
     tests/golden/test_vectors{,_p256}.json; the same for the test256
     golden with precomputation for 8 ciphertexts
     (nizkp_test256_k1_precomp, test_vectors_precomp.json), and once
     more with out-of-core arrays (arrays=file, every array spilled:
     the spill files' count and bytes on its line); then the k=3, t=2,
     width-2 golden mix (three parties in threads over one
     LocalBoardHub): party 1's transcript must equal
     tests/golden/nizkp_test256_k3_w2 and its test vectors
     test_vectors_k3w2.json, and the k=3, t=2 golden over P-224 (width
     1, 3 messages: nizkp_p224_k3, test_vectors_p224_k3.json); then the modp3072 and modp4096 goldens
     (nizkp_modp{3072,4096}_k1, test_vectors_modp{3072,4096}.json, written
     by tests/torch_make_wide_golden.py), the fresh groups' goldens
     (nizkp_vog{1024,1000}_k1, test_vectors_vog{1024,1000}.json, the
     groups in group_vog{1024,1000}.json, the same script), the modp6144
     and modp8192 goldens (nizkp_modp{6144,8192}_k1,
     test_vectors_modp{6144,8192}.json, the groups in
     group_modp{6144,8192}.json, the same script), the ffc15360 golden
     (nizkp_ffc15360_k1, test_vectors_ffc15360.json, the group in
     group_ffc15360.json, the same script; its five messages from
     `random_array`, as the script makes them; run in a process of its
     own beside the CLI runs of phase 10, its powers latency-bound), and
     the
     P-224, P-384 and P-521 goldens (nizkp_p{224,384,521}_k1,
     test_vectors_p{224,384,521}.json, the same script), the modp2048
     golden (nizkp_modp2048_k1, test_vectors_modp2048.json, the same
     script), and four configurations of vmn_tpu's check matrix
     (tests/test_matrix.py, the reference's demo/mixnet/check) with its
     `_run_mix` inputs, the parties in threads: test256 with keywidth 2,
     with keywidth 2 and width 2, with k = 7 and t = 4, and with the
     provable primitives (PRGElGamal, the Pedersen random-oracle hash):
     party 1's transcript equal to tests/golden/nizkp_test256_{kw2,
     kw2w2,k7t4,prov} and its test vectors to test_vectors_test256_*.json
     (the same script), the parties' agreement and the first leaf's
     multiset; then the live adversaries of tests/test_adversarial.py at
     test256, k=3, t=2 (`[adversary]` lines; tests/torch_port_util.py's
     flows, the parties on the card): party 2's wrong decryption factors
     isolated (CorrectIndices 1, 0, 1), party 3's mis-opened coin shares
     recovered, party 2 killed after its shuffled ciphertexts and
     restarted with a RandomDevice (its replay accepted, the transcript
     verified), and the P-224 coin flipping of
     tests/golden/coinflip_p224_k3.json (every party's coins vmn_tpu's);
  6. the ModP path: modp2048, k=1, N ciphertexts (default 10000): keygen,
     encryption, mix (shuffle + proof of shuffle + verifiable
     decryption), plaintext multiset check, the standalone verifier, and
     the same transcript with one flipped byte rejected; then each
     (N, exponent bits) at which the mix and the verify called H4 (H6 on
     the EC path) with its calls (`multiexp` lines; their times are
     vmn_tpu_torch/kernel_timing.py's); then the same at modp3072 and
     modp4096 with N ciphertexts, the same --n, and at the fresh groups
     vog1024 and vog1000 (every Montgomery launch of their mixes at
     W = 32, converting at vog1000's 63 limbs: the `slice` line's
     `launches_at_w`), at modp6144 and modp8192 (every launch at
     W = 192 and 256), and at ffc15360 with FFC_N = 1000 ciphertexts
     (every launch at W = 480, the scalar ring's products at W' = 480
     converting; the mix and verify under torch.profiler, the device's
     idle share from the mix's start to the verifier's return on the
     line; in a process of its own beside phases 8 and 9, whose work is
     on the host, so its seconds and idle share are taken on a card that
     those phases share); after the EC slices (phase 7), the modp2048 and
     P-256 mixes again with the party's randomness from
     DeviceSource(b"bench-party"), bench.py's seed (`[devicesource]`
     lines): every prover draw of the mix expanded on the card by the
     ChaCha20 kernel, whose launches must equal the mix's draws, H1-H4
     and K7's combine (modp2048), H5, H6, the EC combine and H8 (P-256)
     launched, checked as above, the mix and verify seconds beside the
     SeededSource slice's; after the modp2048 slice, modp2048 with
     keywidth 2 and width 2 at N (`[slice] group=modp2048-kw2w2`: the
     product groups at a deployment's batch): the first leaf's
     multiset, the verifier, a flipped byte rejected, H1-H4 and K7's
     combine launched;
  7. the EC paths: the same at P-256, P-384 and P-521 with --ec-n
     ciphertexts (default 131072 = 2^17, from where `exp_prod` takes H6)
     and at P-224 with min(--ec-n, 65536) (P224_SLICE_N: its H6 and
     combine at 2^17 are the P-224 k=3 mix's, phase 8); then the sharded
     mixes (`[sharded]` lines): two rank processes (`--shard-rank`) on
     this one card, joined over gloo (vmn_tpu_torch.parallel), each
     holding one block of the ciphertext axis, mix the test256 golden
     (n = 5: blocks of 3 and 2), modp2048 at N and P-256 at --ec-n with
     the slice phase's seeds: both ranks' nizkp digests equal, each
     rank's transcript equal byte for byte to the unsharded one
     (tests/golden/nizkp_test256_k1, the slices' transcripts), the
     port's verifier accepts rank 0's, and H1-H4 and K7's combine
     (modp2048), H5 and H8 (P-256; H6 is off sharded operands, as in
     vmn_tpu) must launch on each rank's own block; each rank's block,
     launches and mix seconds beside the unsharded mix's, and the
     phase's wall seconds, are on the lines; then one DeviceSource draw
     of N rows at modp2048, each rank expanding its own block (one
     ChaCha20 launch a rank), equal to those rows of the unsharded draw,
     and the test256 golden's inputs mixed with a DeviceSource party,
     each rank's transcript byte-equal to the same mix unsharded;
  8. the multi-party path: modp2048, k=3 mix-servers, threshold 2, --k3-n
     ciphertexts (default 10000), Fiat–Shamir: the three parties (threads
     of this process on this one card) agree on the public key and on
     the plaintexts, which are the messages; the port's verifier accepts
     party 1's transcript and rejects it with one flipped byte; then the
     same at --k3i-n ciphertexts (default 1000) with interactive
     challenges (jointly flipped coins), agreement and multiset only,
     with the launches of H2 and H3 made inside the coin flipping; then
     k=3, t=2, Fiat–Shamir over P-224 with --ec-n ciphertexts, checked
     as the modp2048 one (H1, H2, H5, H6, the EC combine and H8 must
     launch); then modp3072 k=3, t=2, Fiat–Shamir at N, checked as the
     modp2048 one, every Montgomery launch at W = 96 (`launches_at_w`)
     and H4 held to its plain version at each (N, exponent bits) the mix
     and the verify called it with (`multiexp` lines);
  9. the precomputation path (`[precomp]` lines): modp2048 with k=1 and
     with k=3, t=2 (Fiat–Shamir), precomputation (PoSC) for 1.25·N
     ciphertexts (N and --k3-n: 12500 by default), then the online mix
     (keep-list shrink, CCPoS, decryption) of N, then P-256, k=1,
     1.25·min(--ec-n, 65536) (81920) -> 65536 (PC_EC_N), then modp3072,
     k=1, 1.25·N -> N (every launch at W = 96; a shape its k=3 mix
     checked takes that check, `checked_in`): the plaintext
     multiset (and for k=3
     the parties' agreement), the port's verifier accepting party 1's transcript and
     rejecting it with one flipped byte in CCPoSReply01.bt and, apart,
     in PoSCReply01.bt; each line gives the precomputation's, the online
     mix's and the verify's seconds beside the plain mix's of the same
     call, and the launches of the precomputation and of the online mix
     apart; then H4 (H6 at P-256) at each (N, exponent bits) that the
     precomputation, the online mix and the verify called it with, each
     also equal to its plain version (`multiexp` lines);
 10. the operator tools (`[cli]` lines), each tool its own process
     (`python3 -m vmn_tpu_torch.cli.main <tool>`, a `vmn` through
     `--cli-party`), fixed signature keys and seed files: test256, k=1,
     vmni -> vmn -keygen -> vmnd -ciphs -> vmn -mix -> vmnv -t on the
     card, and the same commands in this process on the CPU, with
     byte-equal nizkp directories, public key, ciphertexts and
     plaintexts and equal -t output; modp2048, k=1, N ciphertexts, then
     vmn -precomp for 1.25·N and vmn -mix in a second process on a new
     auxsid, both with out-of-core arrays (arrays=file in the private
     info; the spill files under <dir>/arrays counted): vmnv accepts both and rejects one flipped byte in
     PoSReply01.bt / CCPoSReply01.bt, the plaintexts decode to vmnd's
     messages; modp2048, k=3, t=2, --k3-n ciphertexts, three concurrent
     `vmn -keygen` and then three concurrent `vmn -mix` processes over
     the signed localhost HTTP board: equal keys and plaintexts, the
     messages, vmnv accepting every party's transcript and rejecting a
     flipped byte, each party's board figures (network, waiting, bytes,
     signing and verifying seconds, nizkp bytes); P-256, k=1, --ec-n
     ciphertexts written here through the raw interface; then vdemo
     (k=3, t=2, 1000 messages, modp2048, over HTTP) and vdemo -protocol
     all.  The five runs go at once (a thread of this process each,
     their own directories, ports and processes).  Each line gives every
     step's seconds, process start-up included, beside the other runs.
     H1-H4 and the combine must launch in every modp2048 `vmn -mix`
     process, H5, H6, the EC combine and H8 in the P-256 one.

--profile modp2048|P-256|P-224|P-384|P-521|modp2048-k3|modp3072|modp4096|
          vog1024|vog1000|modp6144|modp8192|ffc15360
profiles one more
mix + verify of that path after the phases (host spans, device time by
kernel, the device's idle share); it may be given more than once.

Each mix zeroes the wrappers' launch counters just before `session.mix`
(all three parties' in the k=3 runs: the counts are totals over the
parties) and reads them just after it; a precomputation path does the
same around its precomputation, and then around its online mix.  H1-H4
and the combine must have launched in the modp2048, modp3072,
modp4096, vog1024, vog1000, modp6144, modp8192 and ffc15360 mixes, in
the k=3
mixes (modp2048, modp3072), in the modp2048 and modp3072 k=1
precomputation paths, in the modp2048-kw2w2 mix, in each check-matrix
golden's mix and in each live adversary's flow, H2 and H3 in the
interactive mix's coin flipping, H5, H6, the EC combine (once per H6
call) and H8 in the P-256 mix, and the same with H1 and H2 at W=12 in
the P-224 mix (W'=8; its H6 and combine in the P-224 k=3 mix), the
P-384 mix and at W'=20 in the P-521 mix (H7 is off those paths, as in
vmn_tpu, and reports 0); the
`launches` line also counts H1's, H2's, H3's, H5's
and H8's launches in each mix by batch size (1, 2-127, >=128); the
`kernels` line reports each kernel's launches in its own path's mix
(also by path, `launches_by_path`, with the CLI's `vmn -mix` processes:
"cli modp2048 k=1 mix", its precomputed "... online mix", "cli modp2048
k=3 mix" summed over the three processes, "cli P-256 mix", and each
rank's of the sharded mixes: "sharded modp2048 mix (rank i)" for the
Montgomery kernels, "sharded P-256 mix (rank i)" for the EC ones;
chacha20_limbs's in the modp2048 DeviceSource mix, by path also the
P-256 one's and the sharded test256 DeviceSource mix's; the new runs'
too: "modp3072 k=3 mix", "modp3072 precomp" and its online mix,
"modp2048-kw2w2 mix", each check-matrix golden's mix and each live
adversary's flow), beside the
error, time, plain version's
time and bound (the least time the card could take for the same work)
of its check at that path's batch; the EC kernels' check at 4096 points
stands under `at_4096`, and each kernel's launches in the P-384 mix with
its check at W=12 under `p384`, in the P-224 and P-521 mixes with their
checks at W'=8 and 20 under `p224` and `p521`, each Montgomery kernel's
launches in the fresh groups' mixes with its checks there under `vog`,
in the modp6144 and modp8192 mixes with its checks at W = 192 and 256
under `rfc`, in the ffc15360 mix with its checks at W = 480 and its
checks at W = 512 and 288 under `ffc`.  The last three lines are
that JSON object, the card's name and power limit, and a JSON status
object.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"

# Per wrapper: file:line of the Pallas kernel its Hopper kernel replaces,
# and the check of phase 3 or 4 that holds its path's shapes.
# mont_fb_exp replaces both K4 (window 8, every fixed-base exponent of the
# modp2048 mix) and K5 (window 4, exponents under 512 bits: test256 only).
REPLACES = {
    "mont_mul": "vmn_tpu/ops/mont_kernels.py:192",
    "mont_exp": "vmn_tpu/ops/mont_kernels.py:754",
    "mont_fb_exp": "vmn_tpu/ops/mont_kernels.py:443",
    "mont_expprod_positions": "vmn_tpu/ops/mont_kernels.py:616",
    "mont_expprod_combine": "vmn_tpu/ops/mont_kernels.py:731",
    "ec_scalar_mul": "vmn_tpu/ops/ec_kernels.py:278",
    "ec_multiexp_positions": "vmn_tpu/ops/ec_kernels.py:445",
    "ec_multiexp_combine": "vmn_tpu/ops/ec_kernels.py:445",
    "ec_fb_exp": "vmn_tpu/ops/ec_kernels.py:668",
    "ec_point_add": "vmn_tpu/ops/ec_kernels.py:748",
}
MAIN_CHECK = {"mont_mul": "mont_mul", "mont_exp": "mont_exp",
              "mont_fb_exp": "mont_fb_exp8",
              "mont_expprod_positions": "mont_expprod_positions",
              "mont_expprod_combine": "mont_expprod_combine",
              "ec_scalar_mul": "ec_scalar_mul",
              "ec_multiexp_positions": "ec_multiexp_positions",
              "ec_multiexp_combine": "ec_multiexp_combine",
              "ec_fb_exp": "ec_fb_exp", "ec_point_add": "ec_point_add"}
# phase 3's cooperative kernels
COOP_MONT = ("mont_mul", "mont_exp", "mont_fb_exp", "mont_expprod_positions")
# The verifier's test-vector names that tools/make_golden.py requests
# (copied: that script imports jax).
TV_NAMES = [
    "par.sid", "par.version", "par.k", "par.lambda", "par.n_e",
    "par.n_r", "par.n_v", "par.s_PRG", "par.s_Gq", "par.s_H",
    "par.omega", "der.rho", "bas.pk", "bas.C_omega", "bas.M_omega",
    "bas.R_omega", "bas.h", "bas.L_0", "bas.L_l", "bas.y_l", "u",
    "PoS.s", "PoS.v", "PoS.A", "PoS.F", "PoS.B", "PoS.Ap", "PoS.Bp",
    "PoS.Cp", "PoS.Dp", "PoS.Fp", "PoS.C", "PoS.D", "PoS.k_A",
    "PoS.k_B", "PoS.k_C", "PoS.k_D", "PoS.k_E", "PoS.k_F", "Dec.s",
    "Dec.v",
    # precomputation-mode names (PoSC + CCPoS chains)
    "par.N_0", "PoSC.s", "PoSC.v", "CCPoS.s", "CCPoS.v",
]

# Bounds: the larger of bytes moved (each input read once, each output
# written once, int32 limbs as stored) over the card's memory rate, and
# operations over its peak rate for their type.  The operations are the
# 32-bit integer multiplies of the Montgomery products the function needs:
# a W-word CIOS product (W = L/2) takes W² low and W² high halves of a·b,
# W multiplies q = t·m' and 2·W² halves of q·m, 4·W² + W in all, each one
# multiply-add instruction.  A digit of 0 multiplies or adds nothing, so
# the digits of this run's exponents are counted.  Field additions and
# selects are left out, so the true bound is higher still.  Rates, H100
# SXM at its 700 W limit: 3.35 TB/s (NVIDIA's data sheet), and 32-bit
# integer multiplies at 64 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0; half the 128
# FMA lanes behind the data sheet's 67 TFLOP/s fp32) on 132 SMs at the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT_MUL_PER_S = 132 * 64 * 1.98e9
# The ChaCha20 kernel's operations are 32-bit integer adds, XORs and
# funnel-shift rotations, also 64 a clock an SM at compute capability 9.0
# (the same guide's table), over the same 132 SMs at 1.98 GHz; a 64-byte
# block takes 20 rounds of 4 quarter rounds of 12 such operations and 16
# final adds (the stores' index work left out).
INT_OPS_PER_S = 132 * 64 * 1.98e9
CHACHA_BLOCK_OPS = 20 * 4 * 12 + 16
# The file:line the ChaCha20 kernel stands in for: no Pallas kernel, but
# vmn_tpu's XLA program that expands a DeviceSource draw (Threefry words
# into 16-bit limbs).
PRF_REPLACES = ("vmn_tpu/crypto/randomsource.py:141 (_prf_limbs, an XLA "
                "program; no Pallas kernel)")
# bench.py's DeviceSource seed, the party's of the [devicesource] mixes
DEVICE_PARTY_SEED = b"bench-party"
# Montgomery products per point operation at a = -3, Jacobian coordinates
# (products and squarings alike):
EC_ADD_PRODUCTS = 16    # general addition, 12 + 4
EC_MADD_PRODUCTS = 11   # mixed addition (the second point affine), 7 + 4
EC_DOUBLE_PRODUCTS = 8  # doubling, 3 + 5
# The 16-entry table of a point: 2·P one doubling, 3·P..15·P mixed adds.
EC_TABLE_PRODUCTS = EC_DOUBLE_PRODUCTS + 13 * EC_MADD_PRODUCTS


def nonzero_digits(e: torch.Tensor, ndig: int, window: int) -> int:
    from vmn_tpu_torch.ops.mont_kernels import _digits

    return int((_digits(e, ndig, window) != 0).sum())


def bound(products: int, words: int, nbytes: int) -> dict:
    ops = products * (4 * words * words + words)
    t_ops, t_bytes = ops / INT_MUL_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def bound_words(nbits: int) -> int:
    """The 32-bit words of a modulus of nbits bits: the width of the bound
    (the least work): P-224's 7 and P-521's 17 where their kernels
    compute at 8 and 20."""
    return -(-nbits // 32)


# Held by phase() and by the CLI phase's in-process runs while they
# redirect stdout: the CLI runs are threads of this process (cli_phase)
OUT_LOCK = threading.RLock()


def phase(tag: str, **fields) -> None:
    with OUT_LOCK:
        print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
              flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """One line per kernel instantiation from nvcc's -Xptxas -v report:
    name<widths>, registers, stack frame and spill bytes, and the static
    shared memory where it has any."""
    name = None
    out = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry .*?([a-z][a-z_]*_kernel)I((?:Li\d+E)+)",
                      line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
            name, frame = f"{m.group(1)}<{args}>", ""
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"stack={m.group(1)}B spill_st={m.group(2)}B "
                     f"spill_ld={m.group(3)}B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name} regs={m.group(1)} {frame}"
                       + (f" smem={smem.group(1)}B" if smem else ""))
            name = None
    return out


_HOST_MODS: dict = {}


def host_args(*args):
    """args with each tensor copied to the host and each Modulus remade
    there (kept a run, by the card modulus's identity)."""
    from vmn_tpu_torch.ops import mont_kernels as K

    def one(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, K.Modulus):
            if id(x) not in _HOST_MODS:
                _HOST_MODS[id(x)] = (x, K.Modulus.of(x.m, x.L, "cpu"))
            return _HOST_MODS[id(x)][1]
        if isinstance(x, (tuple, list)):
            return type(x)(one(y) for y in x)
        return x

    return tuple(one(x) for x in args)


def plain_on_host(fn, *args):
    """fn(*args), a plain version, on host copies of its inputs
    (host_args), its output copied back to the card.  For a chain on one
    row (a batch of one, K7's and the EC combine) the plain version then
    runs its steps on Python integers (mont_kernels.host_route, at most
    HOST_ROWS rows): the same function and limbs as on the card, in
    milliseconds where the card's thousands of dependent torch launches
    took seconds."""
    out = fn(*host_args(*args))
    dev = torch.device("cuda", 0)
    if isinstance(out, tuple):
        return tuple(t.to(dev) for t in out)
    return out.to(dev)


def timed(fn):
    """(result, milliseconds) of one run of fn(), host launch work
    included, timed with CUDA events on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ------------------------------------------------------------ phase 3


# The wide RFC 3526 groups and their widths W = L/2 (32-bit words).
WIDE_GROUPS = {"modp3072": 96, "modp4096": 128}
# Fresh groups, as `vog -gen ModPGroup -bitlen n` makes them
# (tests/golden/group_{name}.json, vmn_tpu's random_group by
# tests/torch_make_wide_golden.py), and the tags of their kernels'
# checks: 1024 bits (L = 64 limbs, W = 32) and 1000 bits (L = 63, an odd
# count: W' = 32 with the boundary conversion), each field and scalar
# ring on the width-32 library built on demand.
VOG_GROUPS = {"vog1024": "_vog1024", "vog1000": "_vog1000"}
VOG_WORDS = 32
# RFC 3526's groups past 4096 bits, loaded from their group files as the
# fresh ones are (tests/golden/group_{name}.json: p by the RFC's formula,
# written by tests/torch_make_wide_golden.py), and their widths W = L/2,
# each built on demand: modp6144 (§6, group 17) at W = 192, modp8192
# (§7, group 18) at W = 256.
RFC_GROUPS = {"modp6144": 192, "modp8192": 256}
# Past 8192 bits (tests/golden/group_ffc15360.json: NIST SP 800-57's
# 15360-bit finite field, p = c·q + 1 from a seeded search, by
# tests/torch_make_wide_golden.py) at W = 480, and the width above it
# that no group of the repo has, W = 512, checked at a 16384-bit odd
# modulus (kernel_timing.wide_modulus, FFC_WIDE); each built on demand.
FFC_GROUPS = {"ffc15360": 480}
FFC_WIDTHS = (480, 512)
# Ciphertexts of the ffc15360 slice, and elements of the kernels' checks
# at FFC_WIDTHS and MID_WIDTH: about one wave of the card at TPI 32 (a
# full-width power of one element is over a second there).
FFC_N = 1000
# Between 256 and 480 words no group of the repo has a width, but the cap
# of 512 words opens every multiple of 32 there: W = 288, the width of
# the first group past 8192 bits, is checked at odd moduli of 9216 bits
# (W = 288) and 8224 bits (L = 514 limbs at W' = 288, converting),
# kernel_timing.wide_modulus.
MID_WIDTH = 288
MID_BITS = (9216, 8224)
# This process's share of the card's memory while an FFC_GROUPS slice runs
# beside it (`Aside`; that slice held 16.8 GB at its peak).
ASIDE_MEMORY = 0.7
# The groups read from a group file (`file_group`).
FILE_GROUPS = (*VOG_GROUPS, *RFC_GROUPS, *FFC_GROUPS)
# The widths built on demand in the build phase beside the main library
# (ops/mont_kernels.py build_widths): W = 32 for the fresh groups, W = 12
# and W' = 20 for H3, H4 (and K7's combine at 20), which the P-384 and
# P-521 fields' checks run, W = 192 and 256 for RFC_GROUPS, FFC_WIDTHS
# and MID_WIDTH.
ON_DEMAND_WIDTHS = (VOG_WORDS, 12, 20, *RFC_GROUPS.values(), *FFC_WIDTHS,
                    MID_WIDTH)
# Elements of the one small shape at which a kernel that no path
# launches at a width is held to its plain version (H3 at window 4 at
# W = 32, H3 and H4 at W = 12 and at the padded moduli).
SMALL_N = 1000
# Rows of a wide batch (W = 96, 128) at which H1-H3 are held to their
# plain versions, spread from row 0 to row N-1 so that every block of the
# launch holds some: a full-width plain power takes about as long on 256
# rows as on one (PERF.md §6), and minutes on the whole batch.
HELD_ROWS = 256
# Elements of a wide H4 batch whose positions, combined, are held to
# Python pow, in a launch of their own (each a full-width Python pow; N
# of them would take minutes): the launch on the whole batch is held to
# the plain version.
PY_ELEMENTS = 16


def spread(count: int, k: int) -> list:
    """k rows of a batch of count, evenly spaced from the first to the
    last (all of them where count <= k)."""
    if count <= k:
        return list(range(count))
    return sorted({i * (count - 1) // (k - 1) for i in range(k)})


def py_rows(count: int) -> list:
    """The rows held to Python: 0-2 (the edge values), the middle, the
    last."""
    return sorted({0, 1, 2, count // 2, count - 1} & set(range(count)))


def kernel_of(name: str, kernels) -> str:
    """The kernel (wrapper name) whose check `name` is."""
    return max((k for k in kernels if name.startswith(k)), key=len)


def checks_at(checks: dict, name: str, tag: str, kernels) -> dict:
    """The checks of kernel `name` whose width or curve tag is `tag`
    ("_w96", "_w12", "_p384"; "_w12" is not "_w128")."""
    return {case: r for case, r in checks.items()
            if re.search(rf"{tag}(_|$)", case)
            and kernel_of(case, kernels) == name}


def check_kernels(n: int, ec_n: int, pc_maxciph: int) -> dict:
    """H1-H4 and K7's combine against their plain versions on the card,
    at each width a path runs: modp2048 (W=64), modp3072 (96) and
    modp4096 (128) on n elements, the P-256 field (W=8) on ec_n and n,
    the P-384 field (W=12, where its path runs H1 and H2 alone) on ec_n
    and on one, and K7's combine there over a 384-bit exponent's 96
    positions (built with the width, on no path).
    H1 and H2 on the batch and on one element (a product; a power as
    MontCtx.inv gives it), H2 at full-width exponents (W=8: 256 bits) and
    at W=64 also on pc_maxciph elements at 64-bit exponents, as the
    precomputation raises its generators and commitments; H3 at the
    path's window (8; W=8: 4) on the batch and on one, window 4 also at
    W=64; H4 on the batch at 256-bit exponents (at W=96 and 128 also at
    full width) and on one element at full width; the combine over a
    full-width exponent's positions (512, 768, 1024); then each of H1-H4
    at the first N of any TPI of its rule that these miss.  Exact
    equality with the plain version on the whole output, but H1-H3 at
    W=96 and 128, and H2 at W=12 on ec_n, on HELD_ROWS rows spread over
    the batch; a few rows (H4: its positions combined) against Python
    pow.  Fails unless every TPI of every rule was checked."""
    from types import SimpleNamespace

    from vmn_tpu_torch.arith.ec import _CURVES
    from vmn_tpu_torch.arith.limbs import int_to_limbs, ints_to_limbs
    from vmn_tpu_torch.arith.mont import MontCtx, device_limbs
    from vmn_tpu_torch.arith.pgroup import _NAMED_GROUPS
    from vmn_tpu_torch.kernel_timing import _moduli, device_ms, wide_modulus
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2048)
    g = 4  # the fixed base of H3

    def ints(count, bits):
        nb = (bits + 7) // 8 + 8
        return [int.from_bytes(rng.bytes(nb), "big") % (1 << bits)
                for _ in range(count)]

    def limbs(e_int, bits):
        return device_limbs(ints_to_limbs(e_int, -(-bits // 16)), dev)

    def width(ctx, bits, count, held=False):
        """Inputs at ctx's width: count bases a, b (rows 0-2: 1, m - 1,
        2), exponents e of `bits` bits and e256 of 256 (row 0: 0, row 1:
        all ones).  `held`: H2 is held on HELD_ROWS rows, as at the wide
        widths H1-H3 are."""
        m = ctx.m
        d = SimpleNamespace(ctx=ctx, mod=ctx.mod, m=m, L=ctx.L,
                            W=ctx.mod.W, BW=bound_words(ctx.nbits),
                            bits=bits, wide=ctx.L > 128, held=held)
        d.a_int = [x % m for x in ints(count, ctx.nbits)]
        d.a_int[:3] = [1, m - 1, 2]
        d.b_int = [x % m for x in ints(count, ctx.nbits)]
        d.a, d.b = ctx.encode(d.a_int), ctx.encode(d.b_int)
        for name, nb in (("e", bits), ("e256", 256)):
            e_int = ints(count, nb)
            e_int[0], e_int[1] = 0, (1 << nb) - 1
            setattr(d, name + "_int", e_int)
            setattr(d, name, limbs(e_int, nb))
        return d

    # name: (MontCtx, kernel on the batch, rows of its output held to the
    # plain version (None: all), plain version on those rows, Python check
    # of the kernel's output, elements, bound, products run where latency
    # bounds the call)
    cases = {}
    pool = None  # the host processes of the Python checks (below)

    def pows(pairs, m):
        """pow(b, e, m) of each (b, e) pair, in a pool of host processes
        (a full-width Python pow takes about a second at 8192 bits, nine
        at 15360, and a check holds up to PY_ELEMENTS of them): a
        function that waits for them, so that the next checks run on the
        card meanwhile."""
        futs = [pool.submit(pow, b, e, m) for b, e in pairs]
        return lambda: [f.result() for f in futs]

    def later(have, want):
        """A check's Python comparison, made once `want` (a function that
        waits for the pool) has its values."""
        return lambda: have == want()

    def exp_products(count, e, ndig):
        # the table's 14 products, 4 squarings a digit below the top and,
        # for a digit that is not 0, one product (the top digit's entry
        # starts the accumulator)
        nz = nonzero_digits(e, ndig - 1, 4) if ndig > 1 else 0
        return count * (14 + 4 * (ndig - 1)) + nz

    def elementwise(name, d, fn, pre, rows_in, post, py, count, bnd,
                    products=None, whole=False, few=False):
        """K.fn(*pre, *rows_in, *post), whose output row i depends on row
        i of rows_in alone: held to K.fn_plain on HELD_ROWS rows at the
        wide widths (and H2 where d.held), else on all; with `few`, on
        the rows of py_rows alone, the plain version on host copies of
        them in the pool (past 256 words a full-width plain power takes
        about two minutes on the card whatever the rows, ten seconds a
        row on the host); py(i) is row i's (base, exponent), its Python
        value pow(base, exponent, m)."""
        kern, plain = getattr(K, fn), getattr(K, fn + "_plain")
        rows = py_rows(count)
        held, held_in = None, rows_in
        if few:
            held = torch.tensor(rows, device=dev)
            held_in = tuple(t[held] for t in rows_in)
        elif ((d.wide or (d.held and fn == "mont_exp")) and count > HELD_ROWS
                and not whole):
            held = torch.tensor(sorted(set(spread(count, HELD_ROWS))
                                       | set(rows)), device=dev)
            held_in = tuple(t[held] for t in rows_in)
        plain_args = (*pre, *held_in, *post)
        cases[name] = (
            d.ctx, lambda: kern(*pre, *rows_in, *post), held,
            HostPlain(plain, plain_args) if count == 1 or few
            else (lambda: plain(*plain_args)),
            lambda got: later(d.ctx.decode(got[rows]),
                              pows(map(py, rows), d.m)),
            count, bnd, products)

    def mul_case(d, name, count, at=0):
        s = slice(at, at + count)
        elementwise(name, d, "mont_mul", (), (d.a[s], d.b[s]), (d.mod,),
                    lambda i: (d.a_int[at + i] * d.b_int[at + i], 1),
                    count, bound(count, d.BW, 3 * 4 * count * d.L),
                    1 if count == 1 else None)

    def exp_case(d, name, x, x_int, e, e_int, bits, products=None,
                 whole=False, few=False):
        count = x.shape[0]
        elementwise(name, d, "mont_exp", (), (x, e), (d.mod, bits),
                    lambda i: (x_int[i], e_int[i]), count,
                    bound(exp_products(count, e, -(-bits // 4)), d.BW,
                          2 * 4 * count * d.L + 4 * e.numel()), products,
                    whole, few)

    def fb_case(d, name, tbl, e, e_int, count, at=0, few=False):
        window = tbl.shape[1].bit_length() - 1
        e = e[at : at + count].contiguous()
        elementwise(name, d, "mont_fb_exp", (tbl,), (e,), (d.mod,),
                    lambda i: (g, e_int[at + i]), count,
                    bound(nonzero_digits(e, tbl.shape[0], window), d.W,
                          4 * tbl.numel() + 4 * e.numel() + 4 * count * d.L),
                    tbl.shape[0] if count == 1 else None, few=few)

    def ep_case(d, name, e, e_int, bits, count, at=0, rows=None):
        """H4 on elements at .. at + count, or on the batch's `rows` in a
        launch of their own; its positions, combined (K7's combine),
        against Python pow: those of the launch, or at the wide widths
        those of PY_ELEMENTS of its elements in their own launch."""
        if rows is None:
            rows = list(range(at, at + count))
            x, e = d.a[at : at + count], e[at : at + count].contiguous()
        else:
            t = torch.tensor(rows, device=dev)
            x, e = d.a[t], e[t].contiguous()
        at_int = [(d.a_int[r], e_int[r]) for r in rows]
        ix = list(range(count))
        launch = (lambda ix: K.mont_expprod_positions(x[ix], e[ix], d.mod,
                                                      bits))
        py_out = lambda got: got  # noqa: E731
        if d.wide and count > PY_ELEMENTS:
            ix = spread(count, PY_ELEMENTS)
            t = torch.tensor(ix, device=dev)
            py_out = lambda got: launch(t)  # noqa: E731

        def truth(got):
            vals = pows((at_int[i] for i in ix), d.m)

            def want():
                acc = 1
                for v in vals():
                    acc = acc * v % d.m
                return [acc]

            return later(d.ctx.decode(
                K.mont_expprod_combine(py_out(got), d.mod)[None]), want)

        ndig = -(-bits // 4)
        # each base's table, then per position one product per digit that
        # is not 0, less the first; a batch of one runs the table's four
        # levels and one fold product back to back
        plain = (HostPlain(K.mont_expprod_positions_plain,
                           (x, e, d.mod, bits)) if count == 1 else
                 (lambda: K.mont_expprod_positions_plain(x, e, d.mod, bits)))
        cases[name] = (
            d.ctx, lambda: K.mont_expprod_positions(x, e, d.mod, bits), None,
            plain, truth, count,
            bound(count * 14 + max(nonzero_digits(e, ndig, 4) - ndig, 0),
                  d.W, 4 * count * d.L + 4 * e.numel()
                  + 4 * K._ndig_pad(bits) * d.L),
            5 if count == 1 else None)

    def combine_case(d, name):
        J = K._ndig_pad(d.bits)
        P_int = [x % d.m for x in ints(J, d.ctx.nbits)]
        P = d.ctx.encode(P_int)

        def truth(got):
            acc = pool.submit(horner16, P_int, d.m)
            return later(d.ctx.decode(got), lambda: [acc.result()])

        # 4 squarings and one product per position below the top
        cases[name] = (
            d.ctx, lambda: K.mont_expprod_combine(P, d.mod)[None], None,
            HostPlain(K.mont_expprod_combine_plain, (P, d.mod), lead=True),
            truth, J,
            bound(5 * (J - 1), d.W, 4 * J * d.L + 4 * d.L), 5 * (J - 1))

    def small_cases(d, tag):
        """H3 at window 4, H4 and K7's combine at d's width, where no
        path launches them, on SMALL_N elements at full-width exponents
        (the combine over their positions)."""
        d.tbl = d.ctx.fixed_base_table(g, d.bits, 4)
        fb_case(d, f"mont_fb_exp4{tag}", d.tbl, d.e, d.e_int, SMALL_N)
        ep_case(d, f"mont_expprod_positions{tag}", d.e, d.e_int, d.bits,
                SMALL_N)
        if f"mont_expprod_combine{tag}" not in cases:
            combine_case(d, f"mont_expprod_combine{tag}")

    def batch_cases(d, tag, count):
        """H1 and H2 on `count` elements and on one (row 3), the batch-1
        power as MontCtx.inv raises a^(m-2)."""
        mul_case(d, f"mont_mul{tag}", count)
        exp_case(d, f"mont_exp{tag}", d.a[:count], d.a_int, d.e[:count],
                 d.e_int, d.bits)
        inv_cases(d, tag)

    def inv_cases(d, tag):
        """H1 and H2 on one element (row 3), the power as MontCtx.inv
        raises a^(m-2)."""
        mul_case(d, f"mont_mul{tag}_b1", 1, at=3)
        inv_bits = (d.m - 2).bit_length()
        e_inv = device_limbs(int_to_limbs(d.m - 2, -(-inv_bits // 16)),
                             dev)[None]
        a1 = d.a[3:4]
        max_abs_err(d.ctx.inv(a1), K.mont_exp(a1, e_inv, d.mod, inv_bits))
        exp_case(d, f"mont_exp{tag}_b1", a1, d.a_int[3:4], e_inv, [d.m - 2],
                 inv_bits, products=14 + 5 * (-(-inv_bits // 4) - 1))

    def _tpi_cases(d, tag, window, kernel, rule, reached):
        """kernel on d's modulus at 37 past the first N of each TPI of
        its rule that `reached` lacks (up to n elements)."""
        for lo, tpi in rule:
            c = lo + 37
            if tpi in reached or c > n:
                continue
            if kernel == "mont_mul":
                mul_case(d, f"mont_mul{tag}_tpi{tpi}", c)
            elif kernel == "mont_exp":
                exp_case(d, f"mont_exp{tag}_tpi{tpi}", d.a[:c], d.a_int,
                         d.e[:c], d.e_int, d.bits)
            elif kernel == "mont_fb_exp":
                fb_case(d, f"mont_fb_exp{window}{tag}_tpi{tpi}", d.tbl, d.e,
                        d.e_int, c)
            else:
                ep_case(d, f"{kernel}{tag}_tpi{tpi}", d.e256, d.e256_int,
                        256, c)

    # per width: its inputs, its tag, the H3 table and exponents of its
    # path, and its ModP-path cases
    widths = {}  # W: [(inputs, tag, H3's window)], a modulus each
    # past 256 words (W = 480: ffc15360; W = 512: a 16384-bit odd
    # modulus), first, so that their full-width Python checks (about nine
    # seconds a pow) run in the pool while the rest run on the card: on
    # FFC_N elements H1, and H2, H3 at both windows and H4 at 256-bit
    # exponents (H1-H3 held on HELD_ROWS spread rows); H2 (as membership
    # by x^q raises every parsed array) and H3 at window 8 (the path's
    # fixed-base powers) at full width on FFC_N, held on the rows of
    # py_rows; H4 at full width on PY_ELEMENTS elements spread over the
    # batch in a launch of their own, as at RFC_GROUPS; on one element at
    # full width H1, H2 (a^(m-2), as MontCtx.inv), H3 at window 8 (the
    # path's table) and H4; K7's combine over a full-width exponent's
    # positions
    for W, ctx in _moduli(dev, FFC_WIDTHS).items():
        d = width(ctx, ctx.nbits - 1, FFC_N)
        tag = f"_w{W}"
        d.tbl = ctx.fixed_base_table(g, 256, 8)
        tbl_full = ctx.fixed_base_table(g, d.bits, 8)
        widths[W] = [(d, tag, 8)]
        mul_case(d, f"mont_mul{tag}", FFC_N)
        exp_case(d, f"mont_exp{tag}", d.a, d.a_int, d.e256, d.e256_int, 256)
        exp_case(d, f"mont_exp{tag}_full", d.a, d.a_int, d.e, d.e_int,
                 d.bits, few=True)
        fb_case(d, f"mont_fb_exp8{tag}", d.tbl, d.e256, d.e256_int, FFC_N)
        fb_case(d, f"mont_fb_exp8{tag}_full", tbl_full, d.e, d.e_int, FFC_N,
                few=True)
        fb_case(d, f"mont_fb_exp4{tag}", ctx.fixed_base_table(g, 256, 4),
                d.e256, d.e256_int, FFC_N)
        ep_case(d, f"mont_expprod_positions{tag}", d.e256, d.e256_int, 256,
                FFC_N)
        rows = spread(FFC_N, PY_ELEMENTS)
        ep_case(d, f"mont_expprod_positions{tag}_full", d.e, d.e_int,
                d.bits, len(rows), rows=rows)
        inv_cases(d, tag)
        fb_case(d, f"mont_fb_exp8{tag}_b1", tbl_full, d.e, d.e_int, 1, at=3)
        ep_case(d, f"mont_expprod_positions{tag}_b1", d.e, d.e_int, d.bits,
                1, at=3)
        combine_case(d, f"mont_expprod_combine{tag}")
    # W = 288 (MID_WIDTH), on no path, at both its moduli: H1, and H2, H3
    # at both windows and H4 at 256-bit exponents on FFC_N elements (H1-H3
    # held on HELD_ROWS spread rows), H1 and H2 (a^(m-2)) on one, K7's
    # combine over a 256-bit exponent's 64 positions
    for nbits in MID_BITS:
        ctx = MontCtx(wide_modulus(nbits), dev)
        d = width(ctx, 256, FFC_N)
        tag = f"_w{MID_WIDTH}_{nbits}"
        d.tbl = ctx.fixed_base_table(g, 256, 8)
        widths.setdefault(ctx.mod.W, []).append((d, tag, 8))
        batch_cases(d, tag, FFC_N)
        fb_case(d, f"mont_fb_exp8{tag}", d.tbl, d.e, d.e_int, FFC_N)
        fb_case(d, f"mont_fb_exp4{tag}", ctx.fixed_base_table(g, 256, 4),
                d.e, d.e_int, FFC_N)
        ep_case(d, f"mont_expprod_positions{tag}", d.e, d.e_int, 256, FFC_N)
        combine_case(d, f"mont_expprod_combine{tag}")
    for group, W in (("modp2048", 64), *WIDE_GROUPS.items()):
        ctx = MontCtx(_NAMED_GROUPS[group][0], dev)
        d = width(ctx, ctx.nbits - 1, n)  # |q|: full-width exponents
        tag = "" if W == 64 else f"_w{W}"
        d.tbl = ctx.fixed_base_table(g, d.bits, 8)
        widths[W] = [(d, tag, 8)]
        batch_cases(d, tag, n)
        fb_case(d, f"mont_fb_exp8{tag}", d.tbl, d.e, d.e_int, n)
        fb_case(d, f"mont_fb_exp8{tag}_b1", d.tbl, d.e, d.e_int, 1, at=3)
        ep_case(d, f"mont_expprod_positions{tag}", d.e256, d.e256_int, 256,
                n)
        if d.wide:
            ep_case(d, f"mont_expprod_positions{tag}_full", d.e, d.e_int,
                    d.bits, n)
        # the path's smallest call: one element at full width, on row 3
        ep_case(d, f"mont_expprod_positions{tag}_b1", d.e, d.e_int, d.bits,
                1, at=3)
        combine_case(d, f"mont_expprod_combine{tag}")
        if d.wide:
            # window 4 at 256-bit exponents: the fixed-base powers of a
            # group with a short q (FIPS 186-4 §4.2's (3072, 256))
            tbl4 = ctx.fixed_base_table(g, 256, 4)
            fb_case(d, f"mont_fb_exp4{tag}", tbl4, d.e256, d.e256_int, n)
        if W == 64:
            # the precomputation's raised values: pc_maxciph bases,
            # exponents of 64 bits in the field's L limbs, as
            # GArray.exp_bits hands them on
            pc_int = [x % d.m for x in ints(pc_maxciph, ctx.nbits)]
            pc_e_int = ints(pc_maxciph, 64)
            exp_case(d, "mont_exp_e64", ctx.encode(pc_int), pc_int,
                     device_limbs(ints_to_limbs(pc_e_int, d.L), dev),
                     pc_e_int, 64)
            tbl4 = ctx.fixed_base_table(g, 256, 4)
            fb_case(d, "mont_fb_exp4", tbl4, d.e256, d.e256_int, n)
    # the fresh groups (W = 32; vog1000 at W' = 32, converting): as the
    # wide groups, H1-H3 held on HELD_ROWS spread rows and H4 also at
    # full width; H3 at window 4 (on no path: their fixed-base exponents
    # are full width) on SMALL_N elements
    for group, tag in VOG_GROUPS.items():
        ctx = MontCtx(file_group(group)[0], dev)
        d = width(ctx, ctx.nbits - 1, n)
        d.wide = True
        d.tbl = ctx.fixed_base_table(g, d.bits, 8)
        widths.setdefault(ctx.mod.W, []).append((d, tag, 8))
        batch_cases(d, tag, n)
        fb_case(d, f"mont_fb_exp8{tag}", d.tbl, d.e, d.e_int, n)
        fb_case(d, f"mont_fb_exp8{tag}_b1", d.tbl, d.e, d.e_int, 1, at=3)
        fb_case(d, f"mont_fb_exp4{tag}", ctx.fixed_base_table(g, d.bits, 4),
                d.e, d.e_int, SMALL_N)
        ep_case(d, f"mont_expprod_positions{tag}", d.e256, d.e256_int, 256,
                n)
        ep_case(d, f"mont_expprod_positions{tag}_full", d.e, d.e_int,
                d.bits, n)
        ep_case(d, f"mont_expprod_positions{tag}_b1", d.e, d.e_int, d.bits,
                1, at=3)
        combine_case(d, f"mont_expprod_combine{tag}")
    # RFC 3526's groups past 4096 bits (W = 192, 256; built on demand): as
    # the wide groups, but H4 at full width on PY_ELEMENTS elements spread
    # over the batch in a launch of their own, held to its plain version
    # and, combined, to Python pow (its plain version grows with W³: on
    # all N at W = 128 it took 53.6 s)
    for group, W in RFC_GROUPS.items():
        ctx = MontCtx(file_group(group)[0], dev)
        d = width(ctx, ctx.nbits - 1, n)
        tag = f"_w{W}"
        d.tbl = ctx.fixed_base_table(g, d.bits, 8)
        widths[W] = [(d, tag, 8)]
        batch_cases(d, tag, n)
        fb_case(d, f"mont_fb_exp8{tag}", d.tbl, d.e, d.e_int, n)
        fb_case(d, f"mont_fb_exp8{tag}_b1", d.tbl, d.e, d.e_int, 1, at=3)
        fb_case(d, f"mont_fb_exp4{tag}", ctx.fixed_base_table(g, 256, 4),
                d.e256, d.e256_int, n)
        ep_case(d, f"mont_expprod_positions{tag}", d.e256, d.e256_int, 256,
                n)
        rows = spread(n, PY_ELEMENTS)
        ep_case(d, f"mont_expprod_positions{tag}_full", d.e, d.e_int,
                d.bits, len(rows), rows=rows)
        ep_case(d, f"mont_expprod_positions{tag}_b1", d.e, d.e_int, d.bits,
                1, at=3)
        combine_case(d, f"mont_expprod_combine{tag}")
    # the P-256 field (the EC path's and the test256 golden's width): H1
    # and H2 on ec_n and on n, H3 at window 4 and H4 on n
    ctx8 = MontCtx(_CURVES["P-256"][0], dev)
    d8 = width(ctx8, 256, max(n, ec_n))
    d8.tbl = ctx8.fixed_base_table(g, 256, 4)
    widths[8] = [(d8, "_w8", 4)]
    batch_cases(d8, "_w8", ec_n)
    mul_case(d8, "mont_mul_w8_n", n)
    exp_case(d8, "mont_exp_w8_n", d8.a[:n], d8.a_int, d8.e[:n], d8.e_int,
             256)
    ep_case(d8, "mont_expprod_positions_w8", d8.e, d8.e_int, 256, n)
    fb_case(d8, "mont_fb_exp4_w8", d8.tbl, d8.e, d8.e_int, n)
    fb_case(d8, "mont_fb_exp4_w8_b1", d8.tbl, d8.e, d8.e_int, 1, at=3)
    # the P-384 field (W = 12): H1 and H2 on ec_n and on one (the path's
    # batch-1 inversions); the full-width plain power on all of ec_n would
    # take seconds a row block, so H2 is held on HELD_ROWS rows
    ctx12 = MontCtx(_CURVES["P-384"][0], dev)
    d12 = width(ctx12, 384, ec_n, held=True)
    widths[12] = [(d12, "_w12", 4)]
    batch_cases(d12, "_w12", ec_n)
    combine_case(d12, "mont_expprod_combine_w12")
    small_cases(d12, "_w12")
    # the P-224 and P-521 fields and scalar rings (L = 14 and 33 limbs at
    # the inner widths W' = 8 and 20, converted at the kernels' boundary):
    # H1 and H2 on ec_n (H2 held on HELD_ROWS rows), whole on EC_CHECK_N
    # elements, as the curve's kernels, and on one; H3, H4 and K7's
    # combine, converting too, on no curve's path: on SMALL_N elements
    for curve, ring in ((c, r) for c in PADDED_CURVES for r in (False, True)):
        grp = _group(curve)
        ctx = grp.ring.ctx if ring else grp.ctx
        d = width(ctx, ctx.nbits, ec_n, held=True)
        tag = CURVE_W_TAG[curve] + ("_ring" if ring else "")
        widths.setdefault(ctx.mod.W, []).append((d, tag, 4))
        small_cases(d, tag)
        batch_cases(d, tag, ec_n)
        k = min(ec_n, EC_CHECK_N)
        mul_case(d, f"mont_mul{tag}_{k}", k)
        exp_case(d, f"mont_exp{tag}_{k}", d.a[:k], d.a_int, d.e[:k],
                 d.e_int, d.bits, whole=True)

    # and each kernel at 37 past the first N of any TPI of its rule that
    # these miss
    # (of each modulus of a width)
    reached = {}
    for name, (cx, *_, count, _, _) in cases.items():
        kernel, W = kernel_of(name, K.KERNELS), cx.mod.W
        if kernel in COOP_MONT:
            reached.setdefault((kernel, W, id(cx)), set()).add(
                K.threads_per_element(kernel, W, count))
    for kernel, W in sorted({*K.COOP_TPI, *((k, w) for k, w, _ in reached)}):
        if kernel not in COOP_MONT:
            continue
        for d, tag, window in widths.get(W, ()):
            _tpi_cases(d, tag, window, kernel, K.coop_rule(kernel, W),
                       reached.get((kernel, W, id(d.ctx)), set()))


    results, tpis, pending, deferred = {}, set(), [], []
    # one core left to this process, which drives the card
    pool = ProcessPoolExecutor(
        max_workers=max(1, (os.cpu_count() or 2) - 1),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        for name, (cx, kern, held, plain, truth, count, bnd,
                   products) in cases.items():
            got, first_ms = timed(kern)  # first launch: compare, then time
            if isinstance(plain, HostPlain):  # compared below
                deferred.append((name, (got if held is None else got[held])
                                 .cpu(), plain.submit(pool)))
                err = plain_ms = None
            else:
                want, plain_ms = timed(plain)
                err = max_abs_err(got if held is None else got[held], want)
            pending.append((name, truth(got)))  # waited for below
            # where the first launch took seconds (H2 at full width, W =
            # 192 and 256), its own time: more runs would add seconds
            ms = first_ms if first_ms > 1000 else device_ms(kern)
            r = {"N": count, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, **bnd}
            if held is not None:
                r["checked_rows"] = len(held)
            kernel, W = kernel_of(name, K.KERNELS), cx.mod.W
            if kernel in COOP_MONT:
                r["tpi"] = K.threads_per_element(kernel, W, count)
                tpis.add((kernel, W, r["tpi"]))
            if products is not None:
                # a chain of dependent products on one element: the bound
                # that binds is one product's latency, not the card's
                # throughput
                r.update(products=products,
                         us_per_product=1e3 * ms / products,
                         bound_note="latency-bound: one element on one warp"
                         if kernel != "mont_expprod_positions" else
                         "latency-bound: four table levels and one product")
            results[name] = r
            if err is not None:
                kernel_line(name, r)
        for name, got, fut in deferred:
            want, plain_ms = fut.result()
            results[name].update(max_abs_err=max_abs_err(got, want),
                                 plain_ms=plain_ms)
            kernel_line(name, results[name])
        for name, check in pending:
            if not check():
                raise AssertionError(f"{name}: kernel != Python pow")
    finally:
        pool.shutdown(cancel_futures=True)
    # every TPI of every measured rule, and of the rule taken at each
    # width checked without one (coop_rule: W = 12 and 20 for H3, H4)
    rules = {*K.COOP_TPI, *((k, w) for k, w, _ in tpis)}
    built = {(k, w, t) for k, w in rules if k in COOP_MONT
             for _, t in K.coop_rule(k, w)}
    if built - tpis:
        raise AssertionError(f"H1-H4 instantiations not checked: "
                             f"{sorted(built - tpis)}")
    return results


@dataclasses.dataclass
class HostPlain:
    """A one-row plain check of check_kernels, run on host copies of its
    inputs (`host_args`: its integer route, as plain_on_host runs it) in
    a process of the check's pool, while the next checks run on the card;
    `lead`: its result gets a leading axis, as the kernel's call does."""

    fn: object
    args: tuple
    lead: bool = False

    def submit(self, pool):
        """The future of (result, milliseconds) (`host_plain`)."""
        return pool.submit(host_plain, self.fn, host_args(*self.args),
                           self.lead)


def host_plain(fn, args, lead: bool):
    """(fn(*args), its milliseconds), in a host process of the pool."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out[None] if lead else out, 1e3 * (time.perf_counter() - t0)


def horner16(xs: list, m: int) -> int:
    """prod_j xs[j]^(16^j) mod m, Horner from the top: K7's combine on
    Python integers (a host process of check_kernels' pool)."""
    acc = 1
    for x in reversed(xs):
        acc = pow(acc, 16, m) * x % m
    return acc


def max_abs_err(got, want) -> int:
    """Largest absolute limb difference of kernel and plain outputs (a
    tensor or a tuple of tensors); raises unless they are equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel != plain (max abs {err})")
    return err


def kernel_line(name: str, r: dict) -> None:
    extra = {}
    if "us_per_product" in r:
        extra = {"products": r["products"],
                 "us_per_product": f"{r['us_per_product']:.3f}",
                 "bound": f"'{r['bound_note']}'"}
    if "us_per_point_op" in r:
        extra = {"point_ops": r["point_ops"],
                 "us_per_point_op": f"{r['us_per_point_op']:.3f}",
                 "bound": f"'{r['bound_note']}'"}
    if "tpi" in r:
        extra["tpi"] = r["tpi"]
    if "checked_rows" in r:
        extra["checked_rows"] = r["checked_rows"]
    if "checked_points" in r:
        extra["checked_points"] = r["checked_points"]
    if "shape" in r:
        extra["shape"] = json.dumps(r["shape"], separators=(",", ":"))
    phase("kernel", name=name, N=r["N"], tolerance="exact", equal=True,
          max_abs_err=r["max_abs_err"], ms=f"{r['ms']:.3f}",
          plain_ms=f"{r['plain_ms']:.3f}", bound_ms=f"{r['bound_ms']:.4f}",
          bound_by=r["bound_by"], **extra)


def prf_bound(blocks: int, nbytes: int) -> dict:
    """The least time of a ChaCha20 expansion: `blocks` blocks'
    operations over the integer rate, or `nbytes` written over the
    memory rate (nothing is read)."""
    t_ops = blocks * CHACHA_BLOCK_OPS / INT_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def mid_block_rows(n: int, bits: int) -> tuple:
    """A row range [a, b) of an n-row draw whose first row starts inside
    a 64-byte block: from the first such row at n/3 or after, to 2n/3."""
    nw = (-(-bits // 16) + 1) // 2
    a = next(i for i in range(n // 3, n) if (i * nw) % 16)
    return a, max(a + 1, 2 * n // 3)


def check_prf_kernels(n: int, ec_n: int) -> dict:
    """The ChaCha20 kernel (`chacha20_limbs`, csrc/prf_kernels.cu) against
    its plain version on the card, exact equality of every limb, at the
    draws of the DeviceSource mixes: modp2048's re-encryption exponents
    (N rows of |q| + rbitlen = 2147 bits) and P-256's (--ec-n rows of
    356 bits), each whole and over a row range that starts mid-block (a
    rank's block of a sharded draw); then RFC 8439 §2.3.2's block on the
    card.  Each timed on the device, beside its plain version's time and
    its bound."""
    import hashlib

    from vmn_tpu_torch.crypto import randomsource as R
    from vmn_tpu_torch.kernel_timing import device_ms
    from vmn_tpu_torch.ops import prf_kernels as PK

    dev = torch.device("cuda", 0)
    key = hashlib.sha256(b"smoke-prf").digest()
    shapes = {}
    for tag, name, count in (("", "modp2048", n), ("_p256", "P-256", ec_n)):
        group = _group(name)
        shapes[tag] = (count, group.ring.nbits
                       + _params("Smoke", group).rbitlen)
    cases = {}
    for tag, (count, bits) in shapes.items():
        cases[f"chacha20_limbs{tag}"] = (count, bits, None)
        cases[f"chacha20_limbs{tag}_range"] = (
            count, bits, mid_block_rows(count, bits))
    results = {}
    for name, (count, bits, rows) in cases.items():
        a, b, lt, nw, _ = PK.layout(count, bits, rows)

        def run():
            return PK.chacha20_limbs(key, 5, count, bits, rows, dev)

        got = run()
        want, plain_ms = timed(
            lambda: PK.chacha20_limbs_plain(key, 5, count, bits, rows, dev))
        blocks = -(-b * nw // 16) - a * nw // 16
        r = {"N": b - a, "bits": bits, "rows": [a, b],
             "max_abs_err": max_abs_err(got, want), "ms": device_ms(run),
             "plain_ms": plain_ms, "tolerance": "exact",
             **prf_bound(blocks, got.numel() * got.element_size())}
        results[name] = r
        phase("kernel", name=name, N=r["N"], bits=bits, rows=f"{a}:{b}",
              tolerance="exact", equal=True, max_abs_err=r["max_abs_err"],
              ms=f"{r['ms']:.4f}", plain_ms=f"{plain_ms:.3f}",
              bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
              blocks=blocks)
    rfc = PK.chacha20_limbs(R.RFC_KEY, R.RFC_DRAW, 1, 512, device=dev,
                            counter=R.RFC_COUNTER, nonce0=R.RFC_NONCE0)
    got = R.limbs_bytes(rfc)
    if got != R.RFC_BLOCK:
        raise AssertionError(f"ChaCha20 on the card: RFC 8439's block "
                             f"{got.hex()} != {R.RFC_BLOCK.hex()}")
    phase("kernel", name="chacha20_limbs_rfc8439", N=1, equal=True,
          block=got[:8].hex(), tolerance="exact")
    return results


# ------------------------------------------------------------ phase 4


def host_ec_add(p: int, a: int, P, Q):
    """Affine addition over Python ints (None = infinity)."""
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def host_ec_mul(p: int, a: int, P, k: int):
    acc, add = None, P
    while k:
        if k & 1:
            acc = host_ec_add(p, a, acc, add)
        add = host_ec_add(p, a, add, add)
        k >>= 1
    return acc


def ec_bounds(n: int, e: torch.Tensor, ndig: int, table_words: int,
              npos: int, W: int = 8, L: int = 0) -> dict:
    """Bounds of H5-H8 on n points of a curve of W-word coordinates
    (P-256: 8, P-224: 7, P-384: 12, P-521: 17, bound_words) held in L
    16-bit limbs (default 2W; P-224: 14, P-521: 33) and exponents e of
    ndig 4-bit digits (the fixed-base table of table_words words), and of
    the combine over npos positions."""
    L = L or 2 * W
    nb = 4 * n * L  # one (n, L) int32 array
    nz = nonzero_digits(e, ndig, 4)
    return {
        # the table, 4 doublings between digits, one general addition per
        # digit that is not 0
        "ec_scalar_mul": bound(
            n * (EC_TABLE_PRODUCTS + 4 * (ndig - 1) * EC_DOUBLE_PRODUCTS)
            + nz * EC_ADD_PRODUCTS, W, 2 * nb + n + nb + 3 * nb),
        # each point's table, then per position one addition per digit
        # that is not 0, less the first
        "ec_multiexp_positions": bound(
            n * EC_TABLE_PRODUCTS + max(nz - ndig, 0) * EC_ADD_PRODUCTS,
            W, 2 * nb + n + nb + 3 * 4 * ndig * L),
        # one mixed addition of an affine table row per digit that is not 0
        "ec_fb_exp": bound(nz * EC_MADD_PRODUCTS, W,
                           4 * table_words + nb + 3 * nb),
        "ec_point_add": bound(n * EC_ADD_PRODUCTS, W, 6 * nb + 3 * nb),
        # 4 doublings and one general addition per position
        "ec_multiexp_combine": bound(
            npos * (4 * EC_DOUBLE_PRODUCTS + EC_ADD_PRODUCTS), W,
            3 * 4 * npos * L + 3 * 4 * L),
    }


EC_CHECK_N = 4096  # the small EC check, beside the one at --ec-n
# Points of a curve's --ec-n batch on which H6, a sum over the batch, is
# held whole to its plain version, with the path batch's launch shape
# (132 blocks, each walking several chunks): on all 2^17 the plain fold at
# P-384 took 41.7 s and left the run 44 s under its limit, less than the
# spread between two runs (PERF.md §6); an eighth of the batch gives back
# about 36 s (at P-256 too, once P-224's checks took the run past 1100
# s).  At the whole batch H6 is timed and, with the combine, held to
# Python EC arithmetic over H5's outputs.
MEXP_HELD_N = 16384
# The NIST curves of the EC paths, each checked, mixed and verified the
# same way: P-256 (W = 8), P-224 (L = 14 limbs at the inner width W' = 8,
# P-256's kernels converting at their boundary), P-384 (W = 12), P-521
# (L = 33 limbs at the inner width W' = 20).
EC_PATH_CURVES = ("P-256", "P-224", "P-384", "P-521")
# The curves whose field and ring the kernels compute at a padded width.
PADDED_CURVES = ("P-224", "P-521")
# The Montgomery kernels of the P-224, P-384 and P-521 mixes: the field's
# and the ring's products and powers.
CURVE_MONT = ("mont_mul", "mont_exp")
# The suffix of the Montgomery kernels' check names at each curve but
# P-256 (whose field is "_w8"): its width, or at P-224, whose W' is
# P-256's, its name.
CURVE_W_TAG = {"P-224": "_p224", "P-384": "_w12", "P-521": "_w20"}


def curve_tag(curve: str) -> str:
    """The suffix of a curve's EC check names: none at P-256, "_p224",
    "_p384", "_p521"."""
    return "" if curve == "P-256" else "_" + curve_key(curve)


def curve_key(curve: str) -> str:
    """"p256", "p224", "p384", "p521": a curve's key in the printed
    lines."""
    return curve.replace("-", "").lower()


def check_ec_kernels(n: int, curve: str = "P-256") -> dict:
    """H5-H8 on n points of `curve` (EC_PATH_CURVES): kernel == plain, a
    few rows against Python EC arithmetic, times; H7 also against H5 on
    g (not at P-224 and P-521, where H7 is not built: off the path); the
    combine on the first ndig_pad of H5's Jacobian outputs (64 positions
    at P-256 and P-224, whose 56 digits pad to 64, 96 at P-384, 144 at
    P-521).  Run at 4096 points and at the EC path's batch (--ec-n),
    where H6 splits the points into its widest lanes.  Held to the plain
    versions on the whole batch, but above EC_CHECK_N points H5, H7 and
    H8, whose output rows each depend on their own inputs alone, on
    HELD_ROWS rows spread over the batch with the edge rows (a P-384
    plain scalar multiple on all 2^17 would take minutes, P-256's took
    50.6 s), and H6, a sum over the batch, whole on its first
    MEXP_HELD_N points in a launch of their own, of the batch's launch
    shape.  Results are keyed by kernel name, with curve_tag(curve)
    after it."""
    from vmn_tpu_torch.arith import ec as EC
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.kernel_timing import device_ms
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    grp = EC.ECqPGroup.named(curve, device=dev)
    mod, p, a, q = grp.ctx.mod, grp.p, grp.a, grp.n
    L, W, tag = grp.L, mod.W, curve_tag(curve)
    fb = not mod.conv  # H7 is built at the unpadded widths alone
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-ec-points"))
    pts = grp.random_array(n, prg, 8)
    x, y = pts.x.clone(), pts.y.clone()
    inf = pts.inf.clone()
    x[0], y[0], inf[0] = 0, 0, True  # row 0: the point at infinity
    rng = np.random.default_rng(256)
    nbits = grp.ring.nbits
    ks = [int.from_bytes(rng.bytes(nbits // 8 + 8), "big") % q
          for _ in range(n)]
    ks[1], ks[2], ks[3] = 0, q - 1, 1
    e = grp.ring.from_ints(ks).limbs
    ndig = -(-nbits // 4)
    X, Y, Z = E.ec_scalar_mul(x, y, inf, e, mod, nbits)
    # H8 pairs: rows 0-2 add a point to itself (row 0: infinity +
    # infinity), row 3 its negative; the rest pair the batch with its
    # reverse (the last row: P + infinity).  Non-trivial Z from H5.
    idx = torch.arange(n - 1, -1, -1, device=dev)
    idx[:4] = torch.arange(4, device=dev)
    j1 = (X, Y, Z)
    j2 = [t[idx] for t in j1]
    j2[1][3] = grp.ctx.neg(Y[3])
    tbx, tby = (EC._ec_fb_table(grp.curve, *grp.g._jac(), ndig) if fb
                else (torch.zeros(0), torch.zeros(0)))
    gx = grp.g.x.expand(n, L).contiguous()
    gy = grp.g.y.expand(n, L).contiguous()
    no_inf = torch.zeros(n, dtype=torch.bool, device=dev)

    def affine(jac):
        return grp.to_affine(EC.ECArray(grp, *grp.curve.normalize(*jac)))

    in_pts = [None] + pts.copy_of_range(1, n).to_affine()
    rows = sorted({0, 1, 2, 3, 4, n // 3, n // 2, n - 1})
    rows_t = torch.tensor(rows, device=dev)

    def pick(ts):  # the rows held to Python EC arithmetic
        return tuple(t[rows_t] for t in ts)

    G = (grp.gx, grp.gy)
    J = K._ndig_pad(nbits)
    BW = bound_words(p.bit_length())
    bnds = ec_bounds(n, e, ndig, tbx.numel() + tby.numel(), J, BW, L)
    Pj = [t[:J].contiguous() for t in (X, Y, Z)]
    h = None  # the rows of H5, H7 and H8 held to their plain versions
    m = n  # the points of H6's launch held to its plain version
    if n > EC_CHECK_N:
        h = torch.tensor(sorted(set(spread(n, HELD_ROWS)) | set(rows)),
                         device=dev)
        m = min(n, MEXP_HELD_N)
        if E.mexp_shape(m, J, W) != E.mexp_shape(n, J, W):
            raise AssertionError(f"H6 held at {m} points: another shape")
    at = (lambda ts: ts) if h is None else (
        lambda ts: tuple(t[h] for t in ts))
    mexp_m = (x[:m], y[:m], inf[:m], e[:m], mod, nbits)
    cases = {
        "ec_scalar_mul": (
            lambda: E.ec_scalar_mul(x, y, inf, e, mod, nbits),
            lambda: E.ec_scalar_mul_plain(*at((x, y, inf, e)), mod, nbits),
            lambda out: [host_ec_mul(p, a, in_pts[i], ks[i])
                         if in_pts[i] else None for i in rows]),
        "ec_multiexp_positions": (
            lambda: E.ec_multiexp_positions(x, y, inf, e, mod, nbits),
            lambda: E.ec_multiexp_positions_plain(*mexp_m), None),
        **({"ec_fb_exp": (
            lambda: E.ec_fb_exp(tbx, tby, e, mod),
            lambda: E.ec_fb_exp_plain(tbx, tby, *at((e,)), mod),
            lambda out: [host_ec_mul(p, a, G, ks[i]) for i in rows])}
           if fb else {}),
        "ec_point_add": (
            lambda: E.ec_point_add(*j1, *j2, mod),
            lambda: E.ec_point_add_plain(*at(j1), *at(j2), mod),
            None),
        "ec_multiexp_combine": (
            lambda: tuple(t[None] for t in E.ec_multiexp_combine(*Pj, mod)),
            lambda: tuple(t[None] for t in plain_on_host(
                E.ec_multiexp_combine_plain, *Pj, mod)),
            None),
    }
    results = {}
    smul_aff = None
    for name, (kern, plain, py) in cases.items():
        got, _ = timed(kern)
        want, plain_ms = timed(plain)
        held = h is not None and name in ("ec_scalar_mul", "ec_fb_exp",
                                          "ec_point_add")
        if name == "ec_multiexp_positions" and m < n:
            got_m = E.ec_multiexp_positions(*mexp_m)
        else:
            got_m = got
        err = max_abs_err(at(got) if held else got_m, want)
        if name == "ec_scalar_mul":
            smul_aff = affine(got)
            if [smul_aff[i] for i in rows] != py(got):
                raise AssertionError(f"{name}{tag}: kernel != Python EC")
        elif name == "ec_multiexp_positions":
            acc = None
            for pt in smul_aff:
                acc = host_ec_add(p, a, acc, pt)
            combined = E.ec_multiexp(x, y, inf, e, mod, nbits)
            if affine(tuple(t[None] for t in combined)) != [acc]:
                raise AssertionError(f"{name}{tag}: multi-exp != Python EC")
        elif name == "ec_fb_exp":
            if affine(pick(got)) != py(got):
                raise AssertionError(f"{name}{tag}: kernel != Python EC")
        elif name == "ec_multiexp_combine":
            acc = None  # sum_j 16^j·S_j, Horner from the top position
            for pt in reversed(smul_aff[:J]):
                for _ in range(4):
                    acc = host_ec_add(p, a, acc, acc)
                acc = host_ec_add(p, a, acc, pt)
            if affine(got) != [acc]:
                raise AssertionError(f"{name}{tag}: kernel != Python EC")
        else:
            second = [smul_aff[k] for k in idx.tolist()]
            s3 = smul_aff[3]
            second[3] = None if s3 is None else (s3[0], (-s3[1]) % p)
            if (affine(pick(got))
                    != [host_ec_add(p, a, smul_aff[i], second[i])
                        for i in rows]):
                raise AssertionError(f"{name}{tag}: kernel != Python EC")
        ms = device_ms(kern)
        r = results[name + tag] = {"N": n, "max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms, **bnds[name]}
        if held:
            r["checked_rows"] = len(h)
        elif got_m is not got:
            r["checked_points"] = m
        if name in ("ec_scalar_mul", "ec_point_add"):
            r["tpi"] = K.threads_per_element(name, W, n)
        elif name == "ec_multiexp_positions":
            blocks, subs = E.mexp_shape(n, J, W)
            chunk, folders = E.MEXP_SHAPES[W]
            r["shape"] = {"chunk": chunk, "folders": folders,
                          "blocks": blocks, "subs": subs,
                          "partials_a_position": blocks * subs,
                          "lanes_a_group": E.MEXP_TPI.get(W, 1)}
        elif name == "ec_multiexp_combine":
            ops = 5 * J
            r.update(N=J, tpi=K.threads_per_element(name, W, 1),
                     point_ops=ops, us_per_point_op=1e3 * ms / ops,
                     bound_note="latency-bound: one point on one warp")
        kernel_line(name + tag, r)
    # H8 on one pair (row 4: two random points), as the EC path's
    # single-point additions and doublings call it
    one = [t[4:5].contiguous() for t in (*j1, *j2)]
    got, _ = timed(lambda: E.ec_point_add(*one, mod))
    want, plain_ms = timed(lambda: plain_on_host(E.ec_point_add_plain,
                                                 *one, mod))
    err = max_abs_err(got, want)
    s3 = smul_aff[idx[4].item()]
    if affine(got) != [host_ec_add(p, a, smul_aff[4], s3)]:
        raise AssertionError(f"ec_point_add_b1{tag}: kernel != Python EC")
    ms = device_ms(lambda: E.ec_point_add(*one, mod))
    b1 = f"ec_point_add_b1{tag}"
    results[b1] = {
        "N": 1, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "tpi": K.threads_per_element("ec_point_add", W, 1),
        **ec_bounds(1, e[:1], ndig, 0, 0, BW, L)["ec_point_add"],
        "products": 24, "us_per_product": 1e3 * ms / 24,
        "bound_note": "latency-bound: the 24 products of one pair"}
    kernel_line(b1, results[b1])
    if not fb:
        return results
    # The routing fact for fixed-base powers: H7 against H5 on g.
    fb_ms = device_ms(lambda: E.ec_fb_exp(tbx, tby, e, mod))
    sm_ms = device_ms(lambda: E.ec_scalar_mul(gx, gy, no_inf, e, mod, nbits))
    results["ec_fb_exp" + tag]["vs_ec_scalar_mul_on_g"] = {"fb_ms": fb_ms,
                                                           "smul_ms": sm_ms}
    phase("fixed-base", curve=curve, base="g", N=n, bits=nbits,
          h7_ms=f"{fb_ms:.3f}", h5_ms=f"{sm_ms:.3f}",
          h5_over_h7=f"{sm_ms / fb_ms:.2f}")
    return results


def check_ec_e64(n: int, curve: str = "P-256") -> dict:
    """H5 at 64-bit scalars on n points of `curve`, as the precomputation
    raises its generators and commitments (exp_bits(·, 64) on the ring's
    limbs): kernel == plain on the whole batch, a few rows against
    Python EC arithmetic, times."""
    from vmn_tpu_torch.arith import ec as EC
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.kernel_timing import device_ms
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    dev = torch.device("cuda", 0)
    grp = EC.ECqPGroup.named(curve, device=dev)
    mod, p, a, W = grp.ctx.mod, grp.p, grp.a, grp.ctx.mod.W
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-ec-e64"))
    pts = grp.random_array(n, prg, 8)
    rng = np.random.default_rng(64)
    ks = [int.from_bytes(rng.bytes(8), "big") for _ in range(n)]
    ks[1], ks[2] = 0, (1 << 64) - 1
    e = grp.ring.from_ints(ks).limbs
    ins = (pts.x, pts.y, pts.inf, e, mod, 64)
    got, _ = timed(lambda: E.ec_scalar_mul(*ins))
    want, plain_ms = timed(lambda: E.ec_scalar_mul_plain(*ins))
    err = max_abs_err(got, want)
    rows = [0, 1, 2, 3, n // 2, n - 1]
    at = torch.tensor(rows, device=dev)
    in_pts = grp.to_affine(EC.ECArray(grp, pts.x[at], pts.y[at], pts.inf[at]))
    out = grp.to_affine(EC.ECArray(
        grp, *grp.curve.normalize(*(t[at] for t in got))))
    if out != [host_ec_mul(p, a, P, ks[i]) for P, i in zip(in_pts, rows)]:
        raise AssertionError("ec_scalar_mul_e64: kernel != Python EC")
    r = {"N": n, "bits": 64, "max_abs_err": err,
         "ms": device_ms(lambda: E.ec_scalar_mul(*ins)), "plain_ms": plain_ms,
         "tpi": K.threads_per_element("ec_scalar_mul", W, n),
         **ec_bounds(n, e, 16, 0, 0, bound_words(p.bit_length()),
                     grp.L)["ec_scalar_mul"]}
    kernel_line("ec_scalar_mul_e64" + curve_tag(curve), r)
    return r


def check_ec_tpis(kernel: str, checked: set, seed: bytes, case,
                  curve: str = "P-256") -> dict:
    """H5 or H8 (`kernel`) at `curve` against its plain version at 37
    points past the first N of each TPI that its rule can choose and that
    `checked` (the TPIs of the checks already made) lacks; fails unless
    every TPI of the rule has been checked.  case(grp, pts, tpi) ->
    (kernel call, plain call, bound) on n random points `pts` drawn from
    `seed`."""
    from vmn_tpu_torch.arith import ec as EC
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.kernel_timing import device_ms
    from vmn_tpu_torch.ops import mont_kernels as K

    grp = EC.ECqPGroup.named(curve, device=torch.device("cuda", 0))
    W = grp.ctx.mod.W
    results = {}
    for lo, tpi in K.COOP_TPI[kernel, W]:
        if tpi in checked:
            continue
        n = lo + 37
        if K.threads_per_element(kernel, W, n) != tpi:
            n = lo
        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(seed))
        kern, plain, bnd = case(grp, grp.random_array(n, prg, 8), tpi)
        got, _ = timed(kern)
        want, plain_ms = timed(plain)
        name = f"{kernel}{curve_tag(curve)}_tpi{tpi}"
        results[name] = {
            "N": n, "tpi": tpi, "max_abs_err": max_abs_err(got, want),
            "plain_ms": plain_ms, "ms": device_ms(kern), **bnd}
        kernel_line(name, results[name])
        checked.add(tpi)
    want = {t for _, t in K.COOP_TPI[kernel, W]}
    if checked != want:
        raise AssertionError(f"{kernel} at {curve}: instantiations not "
                             f"checked: {sorted(want - checked)}")
    return results


def smul_case(grp, pts, tpi):
    """H5 on pts (row 0 at infinity) with random scalars and 0, 1, q - 1."""
    from vmn_tpu_torch.ops import ec_kernels as E

    n, q, bits = len(pts.inf), grp.n, grp.ring.nbits
    inf = pts.inf.clone()
    inf[0] = True  # row 0: the point at infinity
    rng = np.random.default_rng(tpi)
    ks = [int.from_bytes(rng.bytes(bits // 8 + 8), "big") % q
          for _ in range(n)]
    ks[1:4] = [0, 1, q - 1][: n - 1]
    e = grp.ring.from_ints(ks).limbs
    args = (pts.x, pts.y, inf, e, grp.ctx.mod, bits)
    return (lambda: E.ec_scalar_mul(*args),
            lambda: E.ec_scalar_mul_plain(*args),
            ec_bounds(n, e, -(-bits // 4), 0, 0, bound_words(grp.p.bit_length()),
                      grp.L)["ec_scalar_mul"])


def add_case(grp, pts, tpi):
    """H8 on pts against their reversal (the middle row: P + P)."""
    from vmn_tpu_torch.ops import ec_kernels as E

    n, mod = len(pts.inf), grp.ctx.mod
    j1 = pts._jac()
    j2 = [t.flip(0).contiguous() for t in j1]
    return (lambda: E.ec_point_add(*j1, *j2, mod),
            lambda: E.ec_point_add_plain(*j1, *j2, mod),
            bound(n * EC_ADD_PRODUCTS, bound_words(grp.p.bit_length()),
                  9 * 4 * n * grp.L))


# ---------------------------------------------------------- phases 5-7


def counted(fn):
    """fn() with the wrappers' launch counters zeroed just before it and
    read just after it: (result, seconds, launches, H1/H2/H3/H5/H8
    launches by batch size)."""
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K
    from vmn_tpu_torch.ops import prf_kernels as PK

    torch.cuda.synchronize()
    K.reset_launches()
    E.reset_launches()
    PK.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**K.LAUNCHES, **E.LAUNCHES, **PK.LAUNCHES}
    sizes = {k: dict(v) for k, v in (*K.LAUNCH_SIZES.items(),
                                     *E.LAUNCH_SIZES.items())}
    return out, seconds, launches, sizes


def run_mix(params, msgs, workdir: Path, party_seed: bytes,
            ciph_seed: bytes, maxciph: int = 0, source=None):
    """keygen -> encrypt the message array `msgs` -> (precomputation for
    `maxciph` ciphertexts, if not 0) -> mix, the party's randomness from
    `source` (a class; SeededSource where None); returns (nizkp dir,
    plaintext array, mix seconds, kernel launches of the mix alone,
    H1/H2/H3/H5/H8 launches of the mix by batch size, the device draws
    of the mix: 0 but with a DeviceSource)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    group = params.pgroup
    party = MixNetParty(params, LocalBoardHub(1).board(1),
                        (source or SeededSource)(party_seed), str(workdir))
    pk = party.keygen()
    r = group.ring.random((msgs.size,), SeededSource(ciph_seed), 0)
    ciphs = elgamal.encrypt(pk, msgs, r)
    party.board = LocalBoardHub(1).board(1)
    session = party.session(params.sid.lower(), 1)
    if maxciph:
        session.precomp(maxciph)
    drawn = getattr(session.rs, "draws", 0)
    plain, mix_s, launches, sizes = counted(lambda: session.mix(ciphs))
    draws = getattr(session.rs, "draws", 0) - drawn
    return session.nizkp, plain, mix_s, launches, sizes, draws


def file_group(name: str) -> tuple:
    """(p, q, g) of a group of FILE_GROUPS, from its group file: a fresh
    one (its "seed") or an RFC 3526 one (its "source")."""
    f = json.loads((GOLDEN / f"group_{name}.json").read_text())
    return int(f["p"], 16), int(f["q"], 16), int(f["g"], 16)


def _group(name: str):
    """A group on the card: an NIST curve, a named ModP group or one of
    FILE_GROUPS."""
    if name.startswith("P-"):
        from vmn_tpu_torch.arith.ec import ECqPGroup

        return ECqPGroup.named(name, device="cuda")
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    if name in FILE_GROUPS:
        return ModPGroup(*file_group(name), device="cuda")
    return ModPGroup.named(name, device="cuda")


def _params(sid: str, group, k: int = 1, threshold: int = 1,
            noninteractive: bool = True):
    from vmn_tpu_torch.protocol.context import ProtocolParams

    return ProtocolParams(sid=sid, k=k, threshold=threshold, pgroup=group,
                          noninteractive=noninteractive)


def _points(group, arr):
    """Plaintexts as sortable host values: ints (ModP) or affine points."""
    return arr.to_affine() if hasattr(arr, "to_affine") else arr.to_ints()


def verify(params, nizkp: Path, test_vectors=None):
    """(accepted, seconds) of the port's verifier on a mixing transcript;
    with `test_vectors`, (accepted, seconds, the vectors it wrote)."""
    from vmn_tpu_torch.protocol.mixnet.verifier import FiatShamirVerifier

    t0 = time.perf_counter()
    v = FiatShamirVerifier(params, nizkp, test_vectors=test_vectors)
    res = v.verify(expected_type="mixing")
    torch.cuda.synchronize()
    if test_vectors is None:
        return res.ok, time.perf_counter() - t0
    return res.ok, time.perf_counter() - t0, v.tv


def tampered_rejected(params, nizkp: Path, tmp: Path,
                      name: str = "PoSReply01.bt") -> bool:
    """Whether the verifier rejects the transcript with one byte of
    proofs/`name` flipped."""
    bad = Path(tempfile.mkdtemp(prefix=f"tampered_{params.sid}_",
                                dir=tmp)) / name
    shutil.copytree(nizkp, bad)
    reply = bad / "proofs" / name
    raw = bytearray(reply.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    reply.write_bytes(bytes(raw))
    ok, _ = verify(params, bad)
    return not ok


def same_transcript(nizkp: Path, golden: Path) -> int:
    """Raises unless the two transcript directories hold the same files
    with the same bytes; returns the number of files."""
    files = sorted(p.relative_to(golden) for p in golden.rglob("*")
                   if p.is_file())
    got = sorted(p.relative_to(nizkp) for p in nizkp.rglob("*")
                 if p.is_file())
    if files != got:
        raise AssertionError(f"golden file sets differ: {got} != {files}")
    for rel in files:
        if (nizkp / rel).read_bytes() != (golden / rel).read_bytes():
            raise AssertionError(f"golden transcript differs in {rel}")
    return len(files)


def same_test_vectors(tv: dict, name: str) -> int:
    """Raises unless the verifier's test vectors equal tests/golden/name;
    returns their number."""
    want = json.loads((GOLDEN / name).read_text())
    if tv != want:
        bad = sorted(k for k in {*tv, *want} if tv.get(k) != want.get(k))
        raise AssertionError(f"test vectors differ from {name}: {bad}")
    return len(tv)


def golden_phase(tmp: Path, name: str, maxciph: int = 0,
                 arrays_file: bool = False) -> None:
    """The golden k=1 mix of tools/make_golden.py on the card: test256,
    modp3072 or modp4096 (5 messages), P-256, P-224, P-384 or P-521 (3
    messages), or test256 after a precomputation for `maxciph`
    ciphertexts; transcript byte-equal, and the verifier's test vectors
    those vmn_tpu froze (tests/golden/test_vectors_{group}.json for the
    wide groups, test_vectors_p{224,384,521}.json for the other curves,
    written by tests/torch_make_wide_golden.py).  With `arrays_file`,
    out-of-core arrays with every array spilled (MIN_SPILL_BYTES = 0):
    the spill files' count and bytes go on the line."""
    if arrays_file:
        from vmn_tpu_torch.arith import storage

        work = tmp / f"arrays_file_{name}_{maxciph}"  # a fresh party
        spill = work / "arrays"
        saved = storage.MIN_SPILL_BYTES
        storage.set_backend("file", spill)
        storage.MIN_SPILL_BYTES = 0
        try:
            golden_phase(work, name, maxciph, False)
        finally:
            storage.MIN_SPILL_BYTES = saved
            storage.set_backend("ram")
        files = list(spill.glob("spill*.npy"))
        if not files:
            raise AssertionError("arrays=file golden: no spill files")
        phase("golden", group=name + ("-precomp" if maxciph else ""),
              arrays="file", byte_equal=True, spill_files=len(files),
              spill_bytes=sum(f.stat().st_size for f in files))
        return
    t0 = time.perf_counter()
    group = _group(name)
    n, make = ((3, group.from_affine) if name.startswith("P-")
               else (5, group.from_ints))
    golden = GOLDEN / f"nizkp_{name.replace('-', '').lower()}_k1"
    tv_file = ("test_vectors.json" if name == "test256" else
               f"test_vectors_{name.replace('-', '').lower()}.json")
    if maxciph:
        golden = golden.with_name(golden.name + "_precomp")
        tv_file = "test_vectors_precomp.json"
    params = _params("Golden", group)
    if name in FFC_GROUPS:
        # p = c·q + 1 with c > 2: elements from `random_array`, as
        # tests/torch_make_wide_golden.py makes them (encode_message is
        # the safe-prime encoding)
        from vmn_tpu_torch.crypto.hash import SHA256
        from vmn_tpu_torch.crypto.prg import PRGHeuristic

        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"golden-msgs"))
        m = group.random_array(n, prg, params.rbitlen)
        msgs = m.to_ints()
    else:
        msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(n)]
        m = make(msgs)
    nizkp, plain, mix_s, launches, _, _ = run_mix(
        params, m, tmp / f"golden_{name}_{maxciph}",
        b"golden-party", b"golden-ciphs", maxciph)
    files = same_transcript(nizkp, golden)
    if sorted(_points(group, plain)) != sorted(msgs):
        raise AssertionError("golden plaintext multiset differs")
    ok, _, tv = verify(params, nizkp, TV_NAMES)
    if not ok:
        raise AssertionError("port verifier rejected the golden transcript")
    tvs = same_test_vectors(tv, tv_file)
    phase("golden", group=name + ("-precomp" if maxciph else ""),
          **({"maxciph": maxciph} if maxciph else {}),
          files=files, byte_equal=True,
          verify_ok=True, test_vectors=tvs, mix_s=f"{mix_s:.3f}",
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")


def port_util():
    """tests/torch_port_util.py: the port's copies of vmn_tpu's check-matrix
    and live-adversary runs, which the CPU tests hold to vmn_tpu (it
    imports no JAX; its import sets torch's host threads for the test
    workers, this process keeps its own count)."""
    threads = torch.get_num_threads()
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    import torch_port_util

    torch.set_num_threads(threads)
    return torch_port_util


def golden_matrix_phase(tmp: Path, name: str) -> dict:
    """A check-matrix golden on the card (tests/torch_make_wide_golden.py's
    MATRIX: test256 with keywidth 2, keywidth 2 and width 2, k = 7 and
    t = 4, or the provable primitives), with tests/test_matrix.py's
    `_run_mix` inputs (SeededSource(f"party{j}"), SeededSource(
    b"ciphertexts"), 5 messages, auxsid "mx"), the k parties in threads:
    party 1's transcript and the verifier's test vectors as vmn_tpu froze
    them, the parties' agreement, the first leaf's multiset, H1-H4 and
    K7's combine launched in the mix.  Returns the mix's launches."""
    U = port_util()
    import torch_make_wide_golden as W

    t0 = time.perf_counter()
    params, width = U.matrix_params(name, device="cuda")
    group = params.pgroup
    work = tmp / f"golden_{name}"
    parties, keygen_s = keygen_k(params, lambda j: f"party{j}".encode(),
                                 work)
    msgs, ciphs = U.matrix_ciphertexts(params, parties[1], width)
    outs, mix_s, launches, _ = run_mix_k(parties, ciphs, "mx", width)
    dirname, tv_file = W.fixture_names(name)
    files = same_transcript(work / "P01" / "nizkp.mx", GOLDEN / dirname)
    if not all(outs[j].equals(outs[1]) for j in range(2, params.k + 1)):
        raise AssertionError(f"golden {name}: the plaintexts differ")
    if sorted(U.first_leaf(outs[1]).to_ints()) != sorted(msgs):
        raise AssertionError(f"golden {name}: multiset differs")
    ok, _, tv = verify(params, work / "P01" / "nizkp.mx", TV_NAMES)
    if not ok:
        raise AssertionError(f"port verifier rejected the golden {name}")
    tvs = same_test_vectors(tv, tv_file)
    missing = missing_launches(launches, MIX_KERNELS)
    if missing:
        raise AssertionError(f"golden {name}: not launched: {missing}")
    phase("golden", group=name, k=params.k, threshold=params.threshold,
          keywidth=params.keywidth, width=width, files=files,
          byte_equal=True, verify_ok=True, test_vectors=tvs,
          multiset=True, parties_agree=True,
          keygen_s=f"{keygen_s:.3f}", mix_s=f"{mix_s:.3f}",
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def adversary_phase(tmp: Path) -> dict:
    """tests/test_adversarial.py's live adversaries at test256 (k = 3,
    t = 2, 5 messages), the three parties threads of this process on the
    card (tests/torch_port_util.py's flows, which the CPU tests hold to
    vmn_tpu's assertions): wrong decryption factors of party 2 isolated
    by CorrectIndices (bits 1, 0, 1), coin shares of party 3 mis-opened
    and the coins recovered (interactive), party 2 killed after its
    shuffled ciphertexts and restarted with a RandomDevice, its replay
    accepted and the transcript verified; then the P-224 coin flipping
    of tests/golden/coinflip_p224_k3.json, every party's coins equal to
    vmn_tpu's.  Each flow's launches are counted around it (keygen and
    mix); H1-H4 and K7's combine must launch in each mix, H1, H2, H5
    and H8 in the coin flipping.  Returns each flow's launches."""
    import torch_make_wide_golden as W

    U = port_util()
    compact = {"separators": (",", ":")}
    out = {}

    def flow(name, fn, need, **fields):
        t0 = time.perf_counter()
        res, seconds, launches, _ = counted(fn)
        missing = missing_launches(launches, need)
        if missing:
            raise AssertionError(f"adversary {name}: not launched: "
                                 f"{missing}")
        out[name] = launches
        return res, {**fields, "seconds": f"{seconds:.3f}",
                     "launches": json.dumps(
                         {k: v for k, v in launches.items() if v},
                         **compact),
                     "phase_s": f"{time.perf_counter() - t0:.1f}"}

    (msgs, outs, bits), line = flow(
        "garbage decryption factors", lambda: U.adversary_garbage_factors(
            tmp / "adv_garbage", "cuda"), MIX_KERNELS)
    if (sorted(outs[1].to_ints()) != sorted(msgs)
            or not outs[3].equals(outs[1]) or bits[1:] != [1, 0, 1]):
        raise AssertionError(f"garbage factors: CorrectIndices {bits}")
    phase("adversary", flow="garbage-decryption-factors", k=3, threshold=2,
          N=U.ADV_N, excluded=2, correct_indices="1,0,1", multiset=True,
          parties_agree="1,3", party2=f"'{outs[2]}'", **line)

    (msgs, outs), line = flow(
        "coin mis-open", lambda: U.adversary_coin_misopen(
            tmp / "adv_coins", "cuda"), MIX_KERNELS)
    if (sorted(outs[1].to_ints()) != sorted(msgs)
            or not all(outs[j].equals(outs[1]) for j in (2, 3))):
        raise AssertionError("coin mis-open: the mix did not complete")
    phase("adversary", flow="coin-misopen", k=3, threshold=2, N=U.ADV_N,
          interactive=True, coins_recovered=True, multiset=True,
          parties_agree="1,2,3", **line)

    (msgs, outs, params, nizkp, restarted), line = flow(
        "kill and restart", lambda: U.adversary_restart(
            tmp / "adv_restart", "cuda"), MIX_KERNELS)
    if (not restarted or sorted(outs[1].to_ints()) != sorted(msgs)
            or not all(outs[j].equals(outs[1]) for j in (2, 3))):
        raise AssertionError("kill and restart: the replay failed")
    ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError("kill and restart: transcript rejected")
    phase("adversary", flow="kill-and-restart", k=3, threshold=2,
          N=U.ADV_N, restarted=2, replay_accepted=True, multiset=True,
          parties_agree="1,2,3", verify_ok=True,
          verify_s=f"{verify_s:.3f}", **line)

    coins, line = flow("P-224 coin flipping", lambda: U.p224_coins("cuda"),
                       ("mont_mul", "mont_exp", "ec_scalar_mul",
                        "ec_point_add"))
    want = json.loads((GOLDEN / W.COINS_FILE).read_text())["coins"]
    if coins != [want] * W.COIN_K:
        raise AssertionError(f"P-224 coins {coins} != vmn_tpu's {want}")
    phase("adversary", flow="p224-coinflip", k=W.COIN_K,
          threshold=W.COIN_T, session=W.COIN_SID, coin_bytes=W.COIN_BYTES,
          coins=want, coins_equal=True, **line)
    return out


# ------------------------------------------------------------ phase 8


def run_parties(k: int, fn) -> list:
    """fn(j) in one thread for each party j = 1..k: the k mix-servers as
    threads of this process, on this one card.  1-based results; the
    first party's exception is raised once every thread has ended."""
    import threading

    results, errors = [None] * (k + 1), []

    def run(j):
        try:
            results[j] = fn(j)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j,))
               for j in range(1, k + 1)]
    [th.start() for th in threads]
    [th.join() for th in threads]
    if errors:
        raise errors[0]
    return results


def keygen_k(params, seed_of, workdir: Path):
    """keygen of params.k parties in threads over one LocalBoardHub (the
    plain-key exchange, then the DKG); (parties, seconds)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub
    from vmn_tpu_torch.protocol.mixnet.party import MixNetParty

    hub = LocalBoardHub(params.k)

    def one(j):
        party = MixNetParty(params, hub.board(j), SeededSource(seed_of(j)),
                            str(workdir / f"P{j:02d}"))
        party.keygen()
        return party

    t0 = time.perf_counter()
    parties = run_parties(params.k, one)
    torch.cuda.synchronize()
    return parties, time.perf_counter() - t0


def run_mix_k(parties, ciphs, auxsid: str, width: int = 1, around=None):
    """The parties mix `ciphs` in threads over a fresh LocalBoardHub, the
    launch counters zeroed just before and read just after (totals over
    the parties); `around()`, if given, is a context entered by this
    thread around the mix.  (outputs, mix seconds, launches, launches by
    batch size)."""
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub

    k = parties[1].k
    hub = LocalBoardHub(k)
    sessions = [None]
    for j in range(1, k + 1):
        parties[j].board = hub.board(j)
        sessions.append(parties[j].session(auxsid, width))
    with (around() if around is not None else contextlib.nullcontext()):
        return counted(
            lambda: run_parties(k, lambda j: sessions[j].mix(ciphs)))


@contextlib.contextmanager
def launches_inside(module_file: str, log: dict):
    """Counts into log, by wrapper, the Montgomery kernel launches made
    while a frame of `module_file` is on the launching thread's stack."""
    from vmn_tpu_torch.ops import mont_kernels as K

    launched = K._launched

    def counted(name, n, mod=None):
        launched(name, n, mod)
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_filename.endswith(module_file):
                with K.COUNT_LOCK:
                    log[name] = log.get(name, 0) + 1
                break
            f = f.f_back

    K._launched = counted
    try:
        yield log
    finally:
        K._launched = launched


@contextlib.contextmanager
def seconds_in(owner, names, log: dict):
    """Adds into log[name] the host seconds spent in each method `name`
    of class `owner`, over every thread that calls it."""
    import functools
    import threading

    lock = threading.Lock()
    saved = [(name, getattr(owner, name)) for name in names]

    def timed_method(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    log[name] = log.get(name, 0.0) + time.perf_counter() - t0
        return run

    for name, fn in saved:
        setattr(owner, name, timed_method(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved:
            setattr(owner, name, fn)


K3_GOLDENS = {  # group: (width, messages, transcript, test vectors)
    "test256": (2, 5, "nizkp_test256_k3_w2", "test_vectors_k3w2.json"),
    "P-224": (1, 3, "nizkp_p224_k3", "test_vectors_p224_k3.json"),
}


def golden_k3_phase(tmp: Path, name: str = "test256") -> dict:
    """tools/make_golden.py's k=3, t=2 mix on the card (three parties in
    threads): test256 at width 2 with 5 messages, or P-224 at width 1
    with 3 (tests/torch_make_wide_golden.py's "P-224-k3"); party 1's
    transcript and the verifier's test vectors as vmn_tpu froze them.
    Returns the mix's launches."""
    from vmn_tpu_torch.arith.pgroup import PPArray
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal

    t0 = time.perf_counter()
    width, n, golden, tv_file = K3_GOLDENS[name]
    group = _group(name)
    params = _params("Golden", group, k=3, threshold=2)
    work = tmp / f"golden_k3_{name}"
    parties, keygen_s = keygen_k(params, lambda j: f"golden-party{j}".encode(),
                                 work)
    msgs = [group.encode_message(f"{i:08d}".encode()) for i in range(n)]
    m = group.from_affine(msgs) if name.startswith("P-") else \
        group.from_ints(msgs)
    plain = elgamal.plain_group(group, width)
    if width > 1:
        m = PPArray(plain, (m,) * width)
    r = plain.ring.random((n,), SeededSource(b"golden-ciphs"), 0)
    ciphs = elgamal.encrypt(parties[1].full_public_key().widen(width), m, r)
    outs, mix_s, launches, _ = run_mix_k(parties, ciphs, "golden", width)
    nizkp = work / "P01" / "nizkp.golden"
    files = same_transcript(nizkp, GOLDEN / golden)
    if not all(outs[j].equals(outs[1]) for j in (2, 3)):
        raise AssertionError(f"k=3 golden {name}: the plaintexts differ")
    for w in range(width):
        out = outs[1].project(w) if width > 1 else outs[1]
        if sorted(_points(group, out)) != sorted(msgs):
            raise AssertionError(f"k=3 golden {name}: multiset differs")
    ok, _, tv = verify(params, nizkp, TV_NAMES)
    if not ok:
        raise AssertionError(f"port verifier rejected the k=3 golden {name}")
    tvs = same_test_vectors(tv, tv_file)
    phase("golden", group=f"{name}-k3" + (f"w{width}" if width > 1 else ""),
          k=3, threshold=2, width=width,
          files=files, byte_equal=True, verify_ok=True, test_vectors=tvs,
          keygen_s=f"{keygen_s:.3f}", mix_s=f"{mix_s:.3f}",
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


# the check-matrix goldens the card rewrites (tests/torch_make_wide_golden.py
# MATRIX) and the configuration it mixes at a deployment's batch
MATRIX_GOLDENS = ("test256-kw2", "test256-kw2w2", "test256-k7t4",
                  "test256-prov")
MATRIX_SLICE = "modp2048-kw2w2"

# the kernels a k=3 mix must launch, by group
K3_KERNELS = {"modp2048": ("mont_mul", "mont_exp", "mont_fb_exp",
                           "mont_expprod_positions", "mont_expprod_combine"),
              "modp3072": ("mont_mul", "mont_exp", "mont_fb_exp",
                           "mont_expprod_positions", "mont_expprod_combine"),
              "P-224": ("mont_mul", "mont_exp", "ec_scalar_mul",
                        "ec_multiexp_positions", "ec_multiexp_combine",
                        "ec_point_add")}


def multiparty_phase(n: int, tmp: Path, interactive: bool = False,
                     name: str = "modp2048", multiexp_checked=None):
    """k=3 mix-servers, threshold 2, N ciphertexts over modp2048 or
    P-224: keygen, encryption, the mix of the three parties in threads,
    agreement on the key and the plaintexts, the plaintext multiset;
    Fiat–Shamir: the verifier on party 1's transcript, and a flipped byte
    rejected; interactive: the launches made inside the coin flipping.
    At a wide group (WIDE_GROUPS) also every launch at its width and H4
    held to its plain version at each shape the mix and the verify
    called it with, each check kept in `multiexp_checked` (a dict) for a
    later path of the group.  Returns (launches in the mix, by batch
    size, inside the coin flipping, mix seconds)."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.ops import mont_kernels as K
    from vmn_tpu_torch.protocol import elgamal

    t0 = time.perf_counter()
    tag = "interactive" if interactive else "multiparty"
    group = _group(name)
    params = _params(f"Smoke{tag}", group, k=3, threshold=2,
                     noninteractive=not interactive)
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, params.rbitlen)
    msgs = _points(group, m)
    from vmn_tpu_torch.protocol.distr.plainkeys import PlainKeysCipher

    torch.cuda.reset_peak_memory_stats()
    ny_keygen, ny_mix = {}, {}  # host seconds in Naor–Yung, all parties
    with seconds_in(PlainKeysCipher, ("encrypt", "decrypt"), ny_keygen):
        parties, keygen_s = keygen_k(
            params, lambda j: f"smoke-party{j}".encode(),
            tmp / f"{tag}_{name}")
    if len({p.full_public_key().to_bytetree().to_bytes()
            for p in parties[1:]}) != 1:
        raise AssertionError(f"{tag}: the parties' public keys differ")
    r = group.ring.random((n,), SeededSource(b"smoke-ciphs"), 0)
    ciphs = elgamal.encrypt(parties[1].full_public_key(), m, r)
    coins, mix_calls, verify_calls = {}, {}, {}
    with seconds_in(PlainKeysCipher, ("encrypt", "decrypt"), ny_mix), \
            calls_of(K, "mont_expprod_positions", mix_calls):
        outs, mix_s, launches, sizes = run_mix_k(
            parties, ciphs, tag, around=(
                (lambda: launches_inside("protocol/coinflip.py", coins))
                if interactive else None))
    by_width = dict(K.LAUNCH_WIDTHS)  # the mix's, before the verify's
    if not all(outs[j].equals(outs[1]) for j in (2, 3)):
        raise AssertionError(f"{tag}: the parties' plaintexts differ")
    if sorted(_points(group, outs[1])) != sorted(msgs):
        raise AssertionError(f"{tag}: plaintext multiset not preserved")
    peak = torch.cuda.max_memory_allocated()
    checks = {}
    if interactive:
        missing = [w for w in ("mont_exp", "mont_fb_exp") if not coins.get(w)]
        checks["coinflip_launches"] = json.dumps(coins, separators=(",", ":"))
    else:
        nizkp = tmp / f"{tag}_{name}" / "P01" / f"nizkp.{tag}"
        with calls_of(K, "mont_expprod_positions", verify_calls):
            ok, verify_s = verify(params, nizkp)
        if not ok:
            raise AssertionError("port verifier rejected the k=3 transcript")
        if not tampered_rejected(params, nizkp, tmp):
            raise AssertionError("tampered k=3 transcript accepted")
        missing = [w for w in K3_KERNELS[name] if launches[w] == 0]
        checks.update(verify_ok=True, tampered_rejected=True,
                      verify_s=f"{verify_s:.3f}",
                      verify_cps=f"{n / verify_s:.1f}")
    if name in WIDE_GROUPS:
        checks.update(W=WIDE_GROUPS[name], launches_at_w=launches_at_width(
            f"{name} k=3 mix", by_width, WIDE_GROUPS[name]))
    if missing:
        raise AssertionError(f"{tag}: not launched: {missing}")
    phase(tag, group=name, k=3, threshold=2, N=n,
          parties="'3 threads of one interpreter on one card'",
          keys_agree=True, plaintexts_agree=True, multiset=True, **checks,
          keygen_s=f"{keygen_s:.3f}", mix_s=f"{mix_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}",
          naor_yung_keygen_s=f"{sum(ny_keygen.values()):.3f}",
          naor_yung_mix_s=f"{sum(ny_mix.values()):.3f}",
          max_memory_allocated=peak,
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    if name in WIDE_GROUPS:  # H4 held to its plain version at each shape
        multiexp_lines(f"{name}-k3", "mont_expprod_positions",
                       multiexp_widths(group, {"mix": mix_calls,
                                               "verify": verify_calls},
                                       check=True,
                                       checked=multiexp_checked,
                                       path=f"{name}-k3"))
    return launches, sizes, coins, mix_s


# The Montgomery kernels a k=1 path launches over the scalar ring Z_q
# (the products of exponents), beside H1-H4 and K7's combine over the
# field.
RING_KERNELS = ("mont_mul",)


def launches_at_width(run: str, by_width: dict, w: int, conv: bool = False,
                      ring_conv: bool | None = None) -> str:
    """Raises unless the Montgomery launches of a run (its launches by
    (wrapper, W, conv), K.LAUNCH_WIDTHS) were exactly each of H1-H4 and
    K7's combine at width w with conversion `conv` (the field's) and,
    with `ring_conv` (the scalar ring's conversion at w), RING_KERNELS
    with that conversion (ffc15360's q of 958 limbs converts at W' = 480
    where its field of 960 does not; at every other group the ring's
    launches are the field's); the launches by wrapper, those with the
    other conversion apart, for the run's line."""
    from vmn_tpu_torch.ops import mont_kernels as K

    want = {(k, w, conv) for k in K.KERNELS}
    if ring_conv is not None:
        want |= {(k, w, ring_conv) for k in RING_KERNELS}
    if set(by_width) != want:
        raise AssertionError(f"{run} launched at {sorted(by_width)}, "
                             f"expected {sorted(want)}")
    return json.dumps({k if c == conv else f"{k} conv={c}": n
                       for (k, _, c), n in sorted(by_width.items())},
                      separators=(",", ":"))


@contextlib.contextmanager
def calls_of(module, name: str, log: dict):
    """Counts the calls of wrapper module.name (whose first argument holds
    the batch and whose last the exponent bits) by (N, bits) into log,
    through every loaded module that holds the wrapper under that name."""
    fn = getattr(module, name)
    owners = [m for m in list(sys.modules.values())
              if getattr(m, name, None) is fn]

    def counted(*args):
        key = (int(args[0].shape[0]), int(args[-1]))
        log[key] = log.get(key, 0) + 1
        return fn(*args)

    for m in owners:
        setattr(m, name, counted)
    try:
        yield log
    finally:
        for m in owners:
            setattr(m, name, fn)


def multiexp_widths(group, calls: dict, check: bool = False,
                    checked: dict = None, path: str = "") -> list:
    """The (N, exponent bits) at which the path called its
    multi-exponentiation's positions (H4 or H6), `calls` holding the
    counts of each part by its name ("mix", "verify", ...); with `check`,
    each also run on the card on random inputs of that shape (points from
    a seeded PRG), held equal to its plain version's (exact) and timed;
    with `checked` (a dict that several paths of one group share), once
    at each shape: a shape an earlier path checked takes that check's
    result and names the path (`checked_in`), and `path` names this one.
    (Without a check there is nothing to time here:
    vmn_tpu_torch/kernel_timing.py times H4 and H6 at the paths' widths.)"""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.kernel_timing import _elements, _exponents, device_ms
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    mod = group.ctx.mod
    out = []
    for N, bits in sorted(set().union(*calls.values())):
        r = {"N": N, "bits": bits,
             **{f"{part}_calls": c.get((N, bits), 0)
                for part, c in calls.items()}}
        out.append(r)
        if not check:
            continue
        if checked is not None and (N, bits) in checked:
            r.update(checked[N, bits])
            continue
        e = _exponents(gen, N, bits, "cuda")
        if hasattr(group, "curve"):
            prg = PRGHeuristic(SHA256)
            prg.set_seed(SHA256.hash(b"smoke-multiexp-points"))
            pts = group.random_array(N, prg, 8)
            ins = (pts.x, pts.y, pts.inf, e, mod, bits)
            run = lambda: E.ec_multiexp_positions(*ins)
            plain = lambda: E.ec_multiexp_positions_plain(*ins)
        else:
            a = _elements(gen, N, mod.L, "cuda")
            run = lambda: K.mont_expprod_positions(a, e, mod, bits)
            plain = lambda: K.mont_expprod_positions_plain(a, e, mod, bits)
        got = run()
        want, plain_ms = timed(plain)
        r.update(tolerance="exact", max_abs_err=max_abs_err(got, want),
                 plain_ms=plain_ms, ms=device_ms(run))
        if checked is not None:
            checked[N, bits] = {
                **{k: r[k] for k in ("tolerance", "max_abs_err", "plain_ms",
                                     "ms")}, "checked_in": path}
    return out


# Each slice's (mix s, verify s), its party's randomness a SeededSource
SLICE_S: dict = {}


def slice_phase(name: str, n: int, tmp: Path, source=None):
    """A mix path at N ciphertexts; returns each wrapper's launches in
    its mix, H1/H2/H3/H5/H8's by batch size, and the shapes at which the
    mix and the verify called H4 (modp2048) or H6 (P-256), each timed.
    With `source` (DeviceSource) the `[devicesource]` run of the path:
    the party's randomness from `source(DEVICE_PARTY_SEED)`, bench.py's
    seed, so that every prover draw of the mix is expanded on the card
    by the ChaCha20 kernel: its launches must equal the mix's draws, the
    path's kernels must launch, and its seconds stand beside the
    SeededSource slice's (run first)."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    t0 = time.perf_counter()
    group = _group(name)
    params = _params(f"Smoke{name.replace('-', '')}", group)
    # Messages: group elements from a seeded PRG, made on the device as
    # bench.py makes them (encoding N strings would cost one Python pow
    # each, minutes of set-up at these N).
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, params.rbitlen)
    msgs = _points(group, m)
    torch.cuda.reset_peak_memory_stats()
    owner, wrapper = ((E, "ec_multiexp_positions") if name.startswith("P-")
                      else (K, "mont_expprod_positions"))
    tag = "slice" if source is None else "devicesource"
    # at ffc15360 the mix and the verify under torch.profiler: the
    # device's idle share over them goes on the line
    window, profiled = {}, contextlib.ExitStack()
    if name in FFC_GROUPS:
        profiled.enter_context(idle_window(window))
    with calls_of(owner, wrapper, {}) as mix_calls:
        nizkp, plain, mix_s, launches, sizes, draws = run_mix(
            params, m, tmp / f"{tag}_{name}", b"smoke-party"
            if source is None else DEVICE_PARTY_SEED, b"smoke-ciphs",
            source=source)
    by_width = dict(K.LAUNCH_WIDTHS)  # the mix's, before the verify's
    if sorted(_points(group, plain)) != sorted(msgs):
        raise AssertionError("plaintext multiset not preserved")
    extra = {}
    if source is not None:
        need = EC_MIX_KERNELS if name.startswith("P-") else MIX_KERNELS
        unlaunched = [k for k in need if not launches[k]]
        if unlaunched or not draws or launches["chacha20_limbs"] != draws:
            raise AssertionError(
                f"{name} DeviceSource mix: {draws} draws, "
                f"{launches['chacha20_limbs']} ChaCha20 launches, not "
                f"launched: {unlaunched}")
        extra = {"source": "DeviceSource", "party_seed": "bench-party",
                 "draws": draws, "prf_launches": launches["chacha20_limbs"],
                 "kernels_launched": ",".join(need),
                 "seeded_mix_s": f"{SLICE_S[name][0]:.3f}",
                 "seeded_verify_s": f"{SLICE_S[name][1]:.3f}"}
    if name in FILE_GROUPS:
        # every Montgomery launch of the mix at the group's width: W = 32
        # for the fresh groups, W = 192 and 256 for RFC_GROUPS, 480 for
        # FFC_GROUPS; the field and the scalar ring each converting where
        # its limbs are not 2W
        w = {**RFC_GROUPS, **FFC_GROUPS}.get(name, VOG_WORDS)
        conv = group.ctx.L != 2 * w
        extra = {"W": w, "conv": conv, "L": group.ctx.L,
                 "ring_L": group.ring.L,
                 "launches_at_w": launches_at_width(
                     f"{name} mix", by_width, w, conv,
                     group.ring.L != 2 * w)}
    with calls_of(owner, wrapper, {}) as verify_calls:
        ok, verify_s = verify(params, nizkp)
    profiled.close()
    if not ok:
        raise AssertionError("port verifier rejected the mix transcript")
    peak = torch.cuda.max_memory_allocated()
    # the fixed-base tables the mix and the verify left in the field's
    # cache (MontCtx._FB_CACHE_MAX of them at most)
    tables = list(group.ctx._fb_tables.values())
    if not tampered_rejected(params, nizkp, tmp):
        raise AssertionError("tampered transcript accepted")
    if source is None:
        SLICE_S[name] = (mix_s, verify_s)
    phase(tag, group=name, k=1, N=n, multiset=True,
          verify_ok=True, tampered_rejected=True, **extra, **window,
          mix_s=f"{mix_s:.3f}", verify_s=f"{verify_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}", verify_cps=f"{n / verify_s:.1f}",
          max_memory_allocated=peak, fb_tables=len(tables),
          fb_table_bytes=sum(t.numel() * t.element_size() for t in tables),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    widths = multiexp_widths(group, {"mix": mix_calls,
                                     "verify": verify_calls})
    if source is None:
        multiexp_lines(name, wrapper, widths)
    return launches, sizes, widths, mix_s


def matrix_slice_phase(name: str, n: int, tmp: Path):
    """modp2048, k=1 at N ciphertexts in a configuration of the check
    matrix (tests/torch_make_wide_golden.py's MATRIX; "modp2048-kw2w2":
    keywidth 2 and width 2, the product groups' paths at a deployment's
    batch): messages from a seeded PRG in each component, the first
    leaf's multiset, the verifier, one flipped byte rejected, H1-H4 and
    K7's combine launched.  Returns the mix's launches."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol.context import ProtocolParams

    U = port_util()
    import torch_make_wide_golden as W

    t0 = time.perf_counter()
    group_name, config = name.split("-", 1)
    kw, width = W.MATRIX[f"test256-{config}"]
    group = _group(group_name)
    params = ProtocolParams(pgroup=group, **{**kw, "sid": f"Smoke{config}"})
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, params.rbitlen)
    msgs = _points(group, m)
    torch.cuda.reset_peak_memory_stats()
    parties, keygen_s = keygen_k(params, lambda j: b"smoke-party",
                                 tmp / f"slice_{name}")
    ciphs = U.widened_ciphertexts(params, parties[1], m, width,
                                  SeededSource(b"smoke-ciphs"))
    outs, mix_s, launches, _ = run_mix_k(parties, ciphs, config, width)
    if sorted(_points(group, U.first_leaf(outs[1]))) != sorted(msgs):
        raise AssertionError(f"{name}: plaintext multiset not preserved")
    nizkp = tmp / f"slice_{name}" / "P01" / f"nizkp.{config}"
    ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError(f"port verifier rejected the {name} transcript")
    if not tampered_rejected(params, nizkp, tmp):
        raise AssertionError(f"{name}: tampered transcript accepted")
    missing = missing_launches(launches, MIX_KERNELS)
    if missing:
        raise AssertionError(f"{name}: not launched: {missing}")
    phase("slice", group=name, k=1, keywidth=params.keywidth, width=width,
          N=n, multiset="first leaf", verify_ok=True,
          tampered_rejected=True, keygen_s=f"{keygen_s:.3f}",
          mix_s=f"{mix_s:.3f}", verify_s=f"{verify_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}", verify_cps=f"{n / verify_s:.1f}",
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


SHARD_RANKS = 2
SHARD_TIMEOUT_S = 300
# the sharded mixes, in order, with their ciphertexts (None: the phase's
# N or EC N) and the kernels that must launch on each rank's block
SHARD_MIXES = {"test256": (5, ()),
               "modp2048": (None, ("mont_mul", "mont_exp", "mont_fb_exp",
                                   "mont_expprod_positions",
                                   "mont_expprod_combine")),
               "P-256": (None, ("ec_scalar_mul", "ec_point_add"))}
# Then the DeviceSource checks: one device draw of N rows at modp2048
# (the re-encryption exponents' shape), each rank expanding its own
# block, and the test256 golden's inputs mixed with a DeviceSource party
# (its session's draws by row range), each against the same unsharded.
SHARD_DRAW_SEED = b"smoke-shard-draw"
SHARD_DEVICE_MIX = "test256-device"


def shard_draw(group, n: int, device):
    """The DeviceSource draw of the sharded phase: n re-encryption
    exponents of `group`, this rank's rows inside a rows_scope."""
    from vmn_tpu_torch.crypto.randomsource import DeviceSource
    from vmn_tpu_torch.protocol.context import ProtocolParams

    rbitlen = ProtocolParams(sid="x", k=1, threshold=1,
                             pgroup=group).rbitlen
    return group.ring.random((n,), DeviceSource(SHARD_DRAW_SEED), rbitlen)


def limbs_digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(
        t.cpu().numpy().astype("<u4").tobytes()).hexdigest()


def shard_rank(argv) -> int:
    """`chip_smoke.py --shard-rank -- WORKDIR N EC_N`: one rank (the
    VMN_DIST_* triplet) of the sharded mixes: the test256 golden,
    modp2048 at N and P-256 at EC_N with the slice phase's seeds, the
    ciphertext axis split over the ranks
    (`vmn_tpu_torch.parallel.dist_worker.mix`); after each a JSON line
    with the rank's device, block, multiset, nizkp digest, mix seconds
    and the launches of its `session.mix` alone."""
    from vmn_tpu_torch.ops import prf_kernels as PK
    from vmn_tpu_torch.parallel import dist, dist_worker
    from vmn_tpu_torch.parallel.mesh import ciph_mesh, rows_scope

    work, n, ec_n = Path(argv[0]), int(argv[1]), int(argv[2])
    if not dist.init_from_env():
        raise SystemExit("--shard-rank needs the VMN_DIST_* triplet")
    mesh = ciph_mesh()
    for name, (count, _) in SHARD_MIXES.items():
        count = count or (ec_n if name.startswith("P-") else n)
        res = dist_worker.mix(
            dist_worker.group_of(name, mesh.device), count,
            work / f"{name}_rank{mesh.rank}", mesh,
            golden=name == "test256", sid=f"Smoke{name.replace('-', '')}",
            tag="smoke")
        print(json.dumps({"mix": name, "N": count,
                          "device": str(mesh.device), **res}), flush=True)
    group = dist_worker.group_of("modp2048", mesh.device)
    with rows_scope(mesh, n):
        shard_draw(group, 1, mesh.device)  # the F2 check, outside the count
        torch.cuda.synchronize()
        PK.reset_launches()
        block = shard_draw(group, n, mesh.device).limbs
        torch.cuda.synchronize()
    print(json.dumps({"draw": "modp2048", "N": n,
                      "rows": [block.start, block.stop],
                      "digest": limbs_digest(block.local),
                      "launches": PK.LAUNCHES["chacha20_limbs"]}),
          flush=True)
    res = dist_worker.mix(
        dist_worker.group_of("test256", mesh.device), 5,
        work / f"{SHARD_DEVICE_MIX}_rank{mesh.rank}", mesh, golden=True,
        source="device")
    print(json.dumps({"mix": SHARD_DEVICE_MIX, "N": 5,
                      "device": str(mesh.device), **res}), flush=True)
    dist.shutdown()
    return 0


def sharded_phase(n: int, ec_n: int, tmp: Path, unsharded_s: dict) -> dict:
    """The sharded mixes (`shard_rank`) in SHARD_RANKS processes on this
    card; each must equal its unsharded transcript (the golden, the
    slice phase's) byte for byte on every rank, with equal digests, the
    port's verifier accepting rank 0's, and SHARD_MIXES' kernels
    launched on every rank.  Then the DeviceSource checks: each rank's
    block of one device draw equal to those rows of the unsharded draw
    (SHA-256 of the limbs; one ChaCha20 launch a rank), and the test256
    mix with a DeviceSource party byte-equal to the same mix unsharded
    in this process, the ChaCha20 kernel launched on every rank.
    Returns {mix: [each rank's launches]}."""
    from vmn_tpu_torch.parallel import dist_worker
    from vmn_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    work = tmp / "sharded"
    port, = free_ports(1)
    with processes(work) as procs:
        # the host's cores shared out: torch's spinning CPU threads in two
        # processes would otherwise take them from each other
        threads = str(max(1, (os.cpu_count() or 2) // SHARD_RANKS))
        ranks = [procs.start([str(work), str(n), str(ec_n)], rank=True,
                             env={"VMN_DIST_COORD": f"localhost:{port}",
                                  "VMN_DIST_NPROC": str(SHARD_RANKS),
                                  "VMN_DIST_PROCID": str(i),
                                  "OMP_NUM_THREADS": threads})
                 for i in range(SHARD_RANKS)]
        outs = procs.wait(ranks, timeout=SHARD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    lines = [[json.loads(x) for x in text.splitlines()
              if x.startswith(('{"mix"', '{"draw"'))] for _, _, text in outs]
    by_name = [{ln["mix"] if "mix" in ln else f"draw {ln['draw']}": ln
                for ln in rank} for rank in lines]
    # the unsharded DeviceSource runs in this process (one-rank mesh)
    dev = torch.device("cuda", 0)
    device_mix = dist_worker.mix(
        dist_worker.group_of("test256", dev), 5, tmp / SHARD_DEVICE_MIX,
        Mesh(1, 0, dev), golden=True, source="device")
    whole = shard_draw(_group("modp2048"), n, dev).limbs
    unsharded = {"test256": GOLDEN / "nizkp_test256_k1",
                 "modp2048": tmp / "slice_modp2048" / "nizkp.smokemodp2048",
                 "P-256": tmp / "slice_P-256" / "nizkp.smokep256",
                 SHARD_DEVICE_MIX: Path(device_mix["nizkp"])}
    mixes = {**SHARD_MIXES, SHARD_DEVICE_MIX: (5, ("chacha20_limbs",))}
    launches, verify_s = {}, 0.0
    for name, (_, need) in mixes.items():
        if any(name not in ln for ln in by_name):
            raise AssertionError(f"sharded {name}: lines {lines}")
        rs = [ln[name] for ln in by_name]
        count = rs[0]["N"]
        rows = [r["rows"] for r in rs]
        if sum(rows) != count or not all(r["ok"] for r in rs):
            raise AssertionError(f"sharded {name}: rows {rows}, multiset "
                                 f"{[r['ok'] for r in rs]}")
        if len({r["digest"] for r in rs}) != 1:
            raise AssertionError(f"sharded {name}: the ranks' digests differ")
        files = {same_transcript(Path(r["nizkp"]), unsharded[name])
                 for r in rs}
        missing = [(r["pid"], k) for r in rs for k in need
                   if not r["launches"][k]]
        if missing:
            raise AssertionError(f"sharded {name}: not launched on the "
                                 f"rank's block: {missing}")
        params = _params("Golden" if name.startswith("test256")
                         else f"Smoke{name.replace('-', '')}",
                         _group(name.split("-device")[0]))
        ok, s = verify(params, Path(rs[0]["nizkp"]))
        if not ok:
            raise AssertionError(f"sharded {name}: verifier rejected it")
        verify_s += s
        launches[name] = [r["launches"] for r in rs]
        phase("sharded", mix=name, N=count, ranks=SHARD_RANKS,
              devices=",".join(r["device"] for r in rs),
              rows=",".join(map(str, rows)), byte_equal=True,
              files=files.pop(), digests_equal=True, verify_ok=True,
              verify_s=f"{s:.3f}",
              mix_s=",".join(f"{r['mix_s']:.3f}" for r in rs),
              **({"unsharded_mix_s": f"{unsharded_s[name]:.3f}"}
                 if name in unsharded_s else {}),
              **{f"launches_rank{r['pid']}": json.dumps(
                  {k: v for k, v in r["launches"].items() if v},
                  separators=(",", ":")) for r in rs})
    draws = [ln["draw modp2048"] for ln in by_name]
    blocks = [tuple(d["rows"]) for d in draws]
    if blocks != [Mesh(SHARD_RANKS, i, dev).block(n)
                  for i in range(SHARD_RANKS)]:
        raise AssertionError(f"sharded draw: blocks {blocks}")
    for d, (a, b) in zip(draws, blocks):
        if d["digest"] != limbs_digest(whole[a:b]) or d["launches"] != 1:
            raise AssertionError(f"sharded draw: rows {a}:{b} differ from "
                                 f"the unsharded draw, or {d['launches']} "
                                 "launches")
    phase("sharded", draw="modp2048 DeviceSource", N=n,
          rows=",".join(f"{a}:{b}" for a, b in blocks),
          equal_to_unsharded=True, prf_launches_a_rank=1)
    phase("sharded", ranks=SHARD_RANKS, ranks_wall_s=f"{ranks_s:.1f}",
          verify_s=f"{verify_s:.1f}",
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


def multiexp_lines(path: str, wrapper: str, widths: list) -> None:
    for r in widths:
        phase("multiexp", group=path, wrapper=wrapper,
              **{k: (f"{v:.3f}" if k.endswith("ms") else v)
                 for k, v in r.items()})


# The P-256 precomputation path's online mix at most (after a
# precomputation for headroom(PC_EC_N) = 81920): its time is the plain
# checks of its multi-exponentiations, cut so that the P-521 path fits
# the run's limit; H6 is checked at 2^17 on the P-256 path (PERF.md §6).
PC_EC_N = 1 << 16
# P-224's k=1 mix: below MULTIEXP_MIN, so its mix takes H5 and an H8
# tree where the P-224 k=3 mix at --ec-n takes H6 and the combine
P224_SLICE_N = 1 << 16


def headroom(n: int) -> int:
    """maxciph for an online mix of n: the 1.25x of tests/test_scale.py:73
    (1280 -> 1024)."""
    return n * 5 // 4


def precomp_phase(name: str, k: int, n: int, tmp: Path, plain_mix_s: float,
                  multiexp_checked=None):
    """The precomputation path: `name` group, k parties (threshold 2
    when k = 3, Fiat–Shamir, threads of this process), a precomputation
    for headroom(n) ciphertexts, then the online mix of n: the plaintext
    multiset and the parties' agreement, the verifier on party 1's
    transcript, and that transcript rejected with one flipped byte in
    its CCPoS reply and, apart, in its PoSC reply.  Prints the
    precomputation's, the online mix's and the verify's seconds beside
    `plain_mix_s` (the plain mix of the same configuration in this
    run).  At a wide group also every launch at its width; a shape in
    `multiexp_checked` (an earlier path's H4 checks) takes that check.
    Returns (launches of the precomputation, of the online mix, the
    multi-exponentiation's shapes)."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.com.board import LocalBoardHub

    t0 = time.perf_counter()
    maxciph = headroom(n)
    group = _group(name)
    tag = f"precomp{name.replace('-', '')}k{k}".lower()
    params = _params(f"Smoke{tag}", group, k=k, threshold=min(k, 2))
    prg = PRGHeuristic(SHA256)
    prg.set_seed(SHA256.hash(b"smoke-msgs"))
    m = group.random_array(n, prg, params.rbitlen)
    msgs = _points(group, m)
    parties, keygen_s = keygen_k(params, lambda j: f"smoke-party{j}".encode(),
                                 tmp / tag)
    r = group.ring.random((n,), SeededSource(b"smoke-ciphs"), 0)
    ciphs = elgamal.encrypt(parties[1].full_public_key(), m, r)
    hub = LocalBoardHub(k)
    sessions = [None]
    for j in range(1, k + 1):
        parties[j].board = hub.board(j)
        sessions.append(parties[j].session(tag, 1))
    owner, wrapper = ((E, "ec_multiexp_positions") if name.startswith("P-")
                      else (K, "mont_expprod_positions"))
    torch.cuda.reset_peak_memory_stats()
    with calls_of(owner, wrapper, {}) as pre_calls:
        _, precomp_s, pre, _ = counted(lambda: run_parties(
            k, lambda j: sessions[j].precomp(maxciph)))
    by_width = dict(K.LAUNCH_WIDTHS)
    with calls_of(owner, wrapper, {}) as mix_calls:
        outs, mix_s, mix, _ = counted(lambda: run_parties(
            k, lambda j: sessions[j].mix(ciphs)))
    for key, count in K.LAUNCH_WIDTHS.items():
        by_width[key] = by_width.get(key, 0) + count
    peak = torch.cuda.max_memory_allocated()
    if not all(outs[j].equals(outs[1]) for j in range(2, k + 1)):
        raise AssertionError(f"{tag}: the parties' plaintexts differ")
    if sorted(_points(group, outs[1])) != sorted(msgs):
        raise AssertionError(f"{tag}: plaintext multiset not preserved")
    nizkp = sessions[1].nizkp
    if not (nizkp / "proofs" / "CCPoSCommitment01.bt").exists():
        raise AssertionError(f"{tag}: the mix did not take the CCPoS chain")
    with calls_of(owner, wrapper, {}) as verify_calls:
        ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError(f"port verifier rejected the {tag} transcript")
    for reply in ("CCPoSReply01.bt", "PoSCReply01.bt"):
        if not tampered_rejected(params, nizkp, tmp, reply):
            raise AssertionError(f"{tag}: flipped byte in {reply} accepted")
    # at a wide group every launch of both parts at its width
    extra = ({"W": WIDE_GROUPS[name], "launches_at_w": launches_at_width(
        f"{tag} path", by_width, WIDE_GROUPS[name])}
        if name in WIDE_GROUPS else {})
    compact = {"separators": (",", ":")}
    phase("precomp", group=name, k=k, threshold=params.threshold, N=n,
          maxciph=maxciph, multiset=True, parties_agree=True,
          verify_ok=True, tampered_rejected="CCPoSReply01,PoSCReply01",
          **extra,
          keygen_s=f"{keygen_s:.3f}", precomp_s=f"{precomp_s:.3f}",
          mix_s=f"{mix_s:.3f}", verify_s=f"{verify_s:.3f}",
          plain_mix_s=f"{plain_mix_s:.3f}",
          mix_cps=f"{n / mix_s:.1f}", verify_cps=f"{n / verify_s:.1f}",
          max_memory_allocated=peak,
          precomp_launches=json.dumps({w: v for w, v in pre.items() if v},
                                      **compact),
          mix_launches=json.dumps({w: v for w, v in mix.items() if v},
                                  **compact),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    widths = multiexp_widths(
        group, {"precomp": pre_calls, "mix": mix_calls,
                "verify": verify_calls}, check=True,
        checked=multiexp_checked, path=f"{name}-precomp-k{k}")
    multiexp_lines(f"{name}-precomp-k{k}", wrapper, widths)
    return pre, mix, widths


# ------------------------------------------------------------- phase 10

CLI = [sys.executable, "-m", "vmn_tpu_torch.cli.main"]
VDEMO_N = 1000  # vdemo's modp2048 k=3 run


def alone(argv) -> int:
    """`chip_smoke.py --alone -- golden|slice <group> <workdir>`: one phase
    of a group in this process (the FFC_GROUPS' golden and slice, run
    beside phases that leave the card mostly idle: `Aside`): golden_phase,
    or slice_phase at FFC_N with its launches, launches by batch size,
    H4's shapes and mix seconds as the last line's JSON object."""
    kind, name, workdir = argv
    if kind == "golden":
        golden_phase(Path(workdir), name)
        return 0
    launches, sizes, widths, mix_s = slice_phase(name, FFC_N, Path(workdir))
    print(json.dumps({"launches": launches, "sizes": sizes,
                      "widths": widths, "mix_s": mix_s}))
    return 0


class Aside:
    """A phase of `alone` in a process of its own, started beside phases
    of this process that are host-bound: its work is device-bound (the
    ffc15360 powers at W = 480, over a second a full-width power of one
    element), so the card, time-shared between the two processes, runs
    both where one after the other would leave it idle.  `join` waits for
    it (raising on a failure), prints its phase lines here and returns the
    slice's JSON object; leaving its `with` kills it if it still runs (a
    phase beside it raised)."""

    def __init__(self, kind: str, name: str, tmp: Path):
        self.kind, self.name = kind, name
        work = tmp / f"aside_{kind}_{name}"
        work.mkdir(parents=True, exist_ok=True)
        self.procs = Procs(work)
        self.proc = self.procs.start([kind, name, str(work)], alone=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.procs.close()

    def join(self):
        try:
            (_, _, text), = self.procs.wait([self.proc])
        finally:
            self.procs.close()
        lines = text.splitlines()
        shown = [x for x in lines if x.startswith("[")]
        if not any(x.startswith(f"[{self.kind}] group={self.name} ")
                   for x in shown):
            raise AssertionError(f"{self.name} {self.kind}: no line:\n"
                                 + text[-3000:])
        with OUT_LOCK:
            for x in shown:
                print(x, flush=True)
        return (json.loads(next(x for x in reversed(lines)
                                if x.startswith('{"launches"')))
                if self.kind == "slice" else None)


def cli_party(argv) -> int:
    """`chip_smoke.py --cli-party -- <vmn args>`: `vmn` of the port in
    this process, on the card, with the launch counters zeroed just
    before it and read just after it.  The last line of standard output
    is {"rc", "launches", "board"}: the board figures `vmn`'s postlude
    reports (network, waiting, sent and received bytes, nizkp bytes)
    and the seconds spent signing and verifying board messages."""
    from vmn_tpu_torch.cli import vmn
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    board = {}
    postlude = vmn._postlude

    def report(party, t0, operation="operation"):
        b = party.board
        board.update(
            network_s=getattr(b, "network_time", 0.0),
            waiting_s=getattr(b, "waiting_time", 0.0),
            sent_bytes=getattr(b, "sent_bytes", 0),
            received_bytes=getattr(b, "received_bytes", 0),
            sign_s=getattr(b, "sign_time", 0.0),
            verify_s=getattr(b, "verify_time", 0.0),
            nizkp_bytes=sum(f.stat().st_size
                            for d in Path(party.directory).glob("nizkp.*")
                            for f in d.rglob("*") if f.is_file()))
        postlude(party, t0, operation)

    vmn._postlude = report
    torch.cuda.synchronize()
    K.reset_launches()
    E.reset_launches()
    try:
        rc = vmn.main(argv)
    except SystemExit as e:
        print(e.code, file=sys.stderr)
        rc = e.code if isinstance(e.code, int) else 1
    torch.cuda.synchronize()
    print(json.dumps({"rc": rc, "launches": {**K.LAUNCHES, **E.LAUNCHES},
                      "board": board}))
    return rc


class Procs:
    """Processes of one CLI run, each with its output in a log file;
    `wait` raises on a non-zero exit (unless told not to), and every
    process still running when the run ends is killed."""

    def __init__(self, workdir: Path):
        self.workdir = workdir
        self.live = []
        self.n = 0
        # one bytecode cache, in this run's temporary directory, for every
        # process of the phase: where the environment says not to write
        # bytecode, each process compiles its packages' modules from
        # source again (5-6 s of a profiled `vmn -mix` step on the H100
        # machine)
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONDONTWRITEBYTECODE"}
        self.env = {**env, "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]),
            "PYTHONPYCACHEPREFIX": str(workdir.parent / "pycache")}

    def start(self, args, cwd=None, party=False, rank=False, env=None,
              alone=False):
        """A process of `args`: a CLI tool, `--cli-party` (party),
        `--shard-rank` (rank) or `--alone` (alone) of this script, with
        `env` added."""
        self.n += 1
        tag = "rank" if rank else args[0].lstrip("-")
        log = self.workdir / f"proc{self.n:02d}_{tag}.log"
        mode = ("--cli-party" if party else "--shard-rank" if rank else
                "--alone" if alone else None)
        cmd = ([sys.executable, str(REPO / "chip_smoke.py"), mode, "--",
                *args] if mode else [*CLI, *args])
        with open(log, "w") as out:
            p = subprocess.Popen(cmd, cwd=cwd or self.workdir,
                                 env={**self.env, **(env or {})},
                                 stdout=out, stderr=subprocess.STDOUT)
        p.log, p.args, p.t0 = log, args, time.perf_counter()
        self.live.append(p)
        return p

    def wait(self, procs, check=True, timeout=900):
        """[(exit code, seconds, output)] of procs, in order."""
        res = []
        for p in procs:
            rc = p.wait(timeout=timeout)
            self.live.remove(p)
            text = p.log.read_text()
            if check and rc != 0:
                raise AssertionError(
                    f"{' '.join(map(str, p.args))} exited {rc}:\n"
                    + text[-3000:])
            res.append((rc, time.perf_counter() - p.t0, text))
        return res

    def run(self, *args, cwd=None, party=False, check=True):
        """(output, seconds) of one process; a party's output is its
        last line's JSON object."""
        (_, s, text), = self.wait([self.start(args, cwd, party)], check)
        return (json.loads(text.strip().splitlines()[-1]) if party
                else text), s

    def close(self):
        for p in self.live:
            p.kill()
            p.wait()
        self.live = []


@contextlib.contextmanager
def processes(workdir: Path):
    workdir.mkdir(parents=True, exist_ok=True)
    procs = Procs(workdir)
    try:
        yield procs
    finally:
        procs.close()


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def cli_info(procs: Procs, sid: str, group: str, k: int = 1,
             threshold: int = 1) -> dict:
    """vmni -prot, one vmni -party per party (its own directory, fixed
    signature keys and seed file; localhost HTTP and hint ports when
    k > 1), the parties' processes at once, as each server runs its own,
    vmni -merge: ({j: party directory}, {step: seconds}, the parties'
    step the wall seconds of their processes together)."""
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.crypto.signature import SignatureKeyPair

    w = procs.workdir
    _, s = procs.run("vmni", "-prot", "-sid", sid, "-nopart", str(k),
                     "-thres", str(threshold), "-pgroup", f"named:{group}",
                     "-stub", "stub.xml")
    steps = {"vmni_prot": s}
    ports = free_ports(2 * k)
    dirs, started = {}, []
    t0 = time.perf_counter()
    for j in range(1, k + 1):
        d = dirs[j] = w / f"Party{j:02d}"
        d.mkdir()
        (d / "seed").write_bytes(f"{sid}-party-{j}".encode())
        kp = SignatureKeyPair.generate(SeededSource(f"{sid}-sig-{j}".encode()))
        net = (["-http", f"http://127.0.0.1:{ports[2 * j - 2]}",
                "-hint", f"127.0.0.1:{ports[2 * j - 1]}"] if k > 1 else [])
        started.append(procs.start(
            ["vmni", "-party", "-name", f"Party{j:02d}",
             "-stub", str(w / "stub.xml"), "-dir", str(d),
             "-seed", str(d / "seed"), "-pkey", kp.public.to_hex(),
             "-skey", kp.to_hex(), *net, "-out", "local.xml"], cwd=d))
    procs.wait(started)
    steps["vmni_party"] = time.perf_counter() - t0
    _, s = procs.run("vmni", "-merge",
                     *[str(dirs[j] / "local.xml") for j in dirs],
                     "-out", "protInfo.xml")
    steps["vmni_merge"] = s
    return dirs, steps


def cli_parties(procs: Procs, dirs: dict, *args) -> list:
    """`vmn <args>` of every party at once, each in its own process
    from its directory; [(party report, seconds)] by party."""
    ps = [procs.start([args[0], str(dirs[j] / "privInfo.xml"),
                       str(procs.workdir / "protInfo.xml"), *args[1:]],
                      cwd=dirs[j], party=True) for j in sorted(dirs)]
    return [(json.loads(text.strip().splitlines()[-1]), s)
            for _, s, text in procs.wait(ps)]


def cli_vmnd(procs: Procs, group: str, n: int, pk: Path):
    """vmnd -ciphs of n counter messages: (seconds, encoding seconds)."""
    out, s = procs.run("vmnd", "-ciphs", str(pk), "ciphertexts.bt",
                       "-N", str(n), "-pgroup", f"named:{group}")
    enc = re.search(r"encoding ([0-9.]+) s", out)
    return s, float(enc.group(1))


def cli_vmnv(procs: Procs, nizkp: Path, *extra, expect_ok=True):
    """vmnv -mix on a transcript: (output, seconds); raises unless it
    accepts (or, with expect_ok=False, rejects)."""
    p = procs.start(["vmnv", str(procs.workdir / "protInfo.xml"),
                     str(nizkp), "-mix", *extra])
    (rc, s, text), = procs.wait([p], check=False)
    if (rc == 0) != expect_ok or (expect_ok and "Proof is valid." not in text):
        raise AssertionError(f"vmnv on {nizkp} exited {rc}:\n{text[-2000:]}")
    return text, s


def cli_tampered(procs: Procs, nizkp: Path, name: str, *extra) -> float:
    """vmnv (with `extra`) on a copy of the transcript with one byte of
    proofs/`name` flipped must exit non-zero; returns its seconds.  It runs in this
    process on the card (its kernels are loaded here already), which
    spares a process start-up for each flipped byte."""
    import io

    from vmn_tpu_torch.cli import vmnv

    bad = procs.workdir / f"tampered_{nizkp.parent.name}_{name}"
    shutil.copytree(nizkp, bad)
    reply = bad / "proofs" / name
    raw = bytearray(reply.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    reply.write_bytes(bytes(raw))
    out = io.StringIO()
    t0 = time.perf_counter()
    with OUT_LOCK, contextlib.redirect_stdout(out):
        try:
            rc = vmnv.main([str(procs.workdir / "protInfo.xml"), str(bad),
                            "-mix", *extra])
        except SystemExit as e:
            rc = e.code
    torch.cuda.synchronize()
    if rc in (0, None) or "Proof is valid." in out.getvalue():
        raise AssertionError(f"vmnv accepted {bad}:\n"
                             + out.getvalue()[-2000:])
    return time.perf_counter() - t0


def decoded(group, path: Path) -> list:
    """The messages of a plaintext file, decoded on the host."""
    from vmn_tpu_torch.eio.bytetree import ByteTree

    return sorted(group.decode_message(c.to_int_unsigned())
                  for c in ByteTree.read_file(path).children)


def tv_blocks(text: str) -> str:
    """vmnv's -t output: its TEST VECTOR blocks."""
    return text[text.index("\nTEST VECTOR"):text.rindex("Proof is valid.")]


def missing_launches(launches: dict, kernels) -> list:
    return [k for k in kernels if launches.get(k, 0) == 0]


def fmt_steps(steps: dict) -> str:
    return json.dumps({k: round(v, 3) for k, v in steps.items()},
                      separators=(",", ":"))


def cli_test256_phase(tmp: Path) -> None:
    """test256, k=1: the operator flow as processes on the card, and the
    same commands in this process with device="cpu": byte-equal nizkp
    directories, public key, ciphertexts and plaintexts, equal -t."""
    import io

    from vmn_tpu_torch.cli import vmn, vmnd, vmnv

    w = tmp / "cli_test256"
    with processes(w / "card") as procs:
        dirs, steps = cli_info(procs, "CliCard", "test256")
        d = dirs[1]
        _, steps["keygen"] = procs.run(
            "vmn", "-keygen", str(d / "privInfo.xml"), "protInfo.xml",
            "publicKey.bt")
        steps["vmnd"], _ = cli_vmnd(procs, "test256", 5, w / "card" /
                                    "publicKey.bt")
        _, steps["mix"] = procs.run(
            "vmn", "-mix", str(d / "privInfo.xml"), "protInfo.xml",
            "ciphertexts.bt", "plaintexts.bt")
        card_tv, steps["vmnv"] = cli_vmnv(procs, d / "nizkp.default",
                                          "-t", ",".join(TV_NAMES))
    # the same info files, seed and commands in this process on the CPU
    cpu = w / "cpu"
    shutil.copytree(w / "card" / "Party01", cpu / "Party01",
                    ignore=shutil.ignore_patterns("state", "nizkp.*", "log"))
    # each vmn replaced the card's seed file (F12): the CPU starts from
    # the seed cli_info wrote
    (cpu / "Party01" / "seed").write_bytes(b"CliCard-party-1")
    prot = (w / "card" / "protInfo.xml").read_text()
    (cpu / "protInfo.xml").write_text(prot)
    priv = (cpu / "Party01" / "privInfo.xml")
    priv.write_text(priv.read_text().replace(str(w / "card"), str(cpu)))
    cwd = Path.cwd()
    out = io.StringIO()
    t0 = time.perf_counter()
    OUT_LOCK.acquire()  # this thread's stdout and working directory
    try:
        os.chdir(cpu)
        with contextlib.redirect_stdout(io.StringIO()):
            for mod, argv in (
                    (vmn, ["-keygen", "Party01/privInfo.xml", "protInfo.xml",
                           "publicKey.bt", "-s"]),
                    (vmnd, ["-ciphs", "publicKey.bt", "ciphertexts.bt",
                            "-N", "5", "-pgroup", "named:test256"]),
                    (vmn, ["-mix", "Party01/privInfo.xml", "protInfo.xml",
                           "ciphertexts.bt", "plaintexts.bt", "-s"])):
                if mod.main(argv, device="cpu") != 0:
                    raise AssertionError(f"CPU {argv[0]} failed")
        with contextlib.redirect_stdout(out):
            rc = vmnv.main(["protInfo.xml", "Party01/nizkp.default", "-mix",
                            "-t", ",".join(TV_NAMES)], device="cpu")
    finally:
        os.chdir(cwd)
        OUT_LOCK.release()
    steps["cpu_in_process"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("CPU vmnv rejected the CPU transcript")
    nfiles = same_transcript(d / "nizkp.default",
                             cpu / "Party01" / "nizkp.default")
    for f in ("publicKey.bt", "ciphertexts.bt", "plaintexts.bt"):
        if (w / "card" / f).read_bytes() != (cpu / f).read_bytes():
            raise AssertionError(f"test256 CLI: {f} differs card vs CPU")
    if tv_blocks(card_tv) != tv_blocks(out.getvalue()):
        raise AssertionError("test256 CLI: vmnv -t output differs")
    phase("cli", run="test256 k=1 card vs cpu", nizkp_files=nfiles,
          bytes_equal="nizkp,publicKey.bt,ciphertexts.bt,plaintexts.bt",
          tv_equal=True, steps_s=fmt_steps(steps))


MIX_KERNELS = ("mont_mul", "mont_exp", "mont_fb_exp",
               "mont_expprod_positions", "mont_expprod_combine")
EC_MIX_KERNELS = ("ec_scalar_mul", "ec_multiexp_positions",
                  "ec_multiexp_combine", "ec_point_add")


def spill_files(directory: Path):
    """(count, bytes) of the out-of-core arrays' files in directory."""
    files = list(directory.glob("spill*.npy"))
    return len(files), sum(f.stat().st_size for f in files)


def cli_modp_phase(n: int, tmp: Path):
    """modp2048, k=1, n ciphertexts: the flow as processes, then a
    precomputation for headroom(n) and its online mix in a second
    process on a new auxsid, both with out-of-core arrays (arrays=file;
    the spill files counted after each); returns the launches of the two
    mixes."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    group = ModPGroup.named("modp2048", device="cuda")
    want = sorted(f"{i:08d}".encode() for i in range(n))
    with processes(tmp / "cli_modp2048") as procs:
        w = procs.workdir
        dirs, steps = cli_info(procs, "CliModp", "modp2048")
        priv = str(dirs[1] / "privInfo.xml")
        _, steps["keygen"] = procs.run("-keygen", priv, "protInfo.xml",
                                       "publicKey.bt", party=True)
        steps["vmnd"], encode_s = cli_vmnd(procs, "modp2048", n,
                                           w / "publicKey.bt")
        mix, steps["mix"] = procs.run("-mix", priv, "protInfo.xml",
                                      "ciphertexts.bt", "plaintexts.bt",
                                      party=True)
        _, steps["vmnv"] = cli_vmnv(procs, dirs[1] / "nizkp.default")
        steps["vmnv_tampered"] = cli_tampered(
            procs, dirs[1] / "nizkp.default", "PoSReply01.bt")
        if decoded(group, w / "plaintexts.bt") != want:
            raise AssertionError("CLI modp2048: plaintext multiset differs")
        # the precomputation and its online mix with out-of-core arrays:
        # the arrays past storage.MIN_SPILL_BYTES spill to <dir>/arrays
        info = Path(priv)
        info.write_text(info.read_text().replace("<arrays>ram</arrays>",
                                                 "<arrays>file</arrays>"))
        pre, steps["precomp"] = procs.run(
            "-precomp", priv, "protInfo.xml", "-auxsid", "pc",
            "-maxciph", str(headroom(n)), party=True)
        spills = {"precomp": spill_files(dirs[1] / "arrays")}
        pc_mix, steps["precomp_mix"] = procs.run(
            "-mix", priv, "protInfo.xml", "ciphertexts.bt", "pc_plain.bt",
            "-auxsid", "pc", party=True)
        spills["precomp_mix"] = spill_files(dirs[1] / "arrays")
        if not all(count for count, _ in spills.values()):
            raise AssertionError(f"CLI arrays=file: no spill files {spills}")
        nizkp = dirs[1] / "nizkp.pc"
        if not (nizkp / "proofs" / "CCPoSCommitment01.bt").exists():
            raise AssertionError("CLI precomp: the mix took no CCPoS chain")
        _, steps["precomp_vmnv"] = cli_vmnv(procs, nizkp, "-auxsid", "pc")
        steps["precomp_vmnv_tampered"] = cli_tampered(
            procs, nizkp, "CCPoSReply01.bt", "-auxsid", "pc")
        if decoded(group, w / "pc_plain.bt") != want:
            raise AssertionError("CLI precomp: plaintext multiset differs")
    # the precomputed path: each kernel in its precomputation or its
    # online mix (the online mix has no fixed-base power, H3)
    both = {k: pre["launches"][k] + pc_mix["launches"][k]
            for k in MIX_KERNELS}
    bad = (missing_launches(mix["launches"], MIX_KERNELS)
           + missing_launches(both, MIX_KERNELS))
    if bad:
        raise AssertionError(f"CLI modp2048 -mix: not launched: {bad}")
    compact = {"separators": (",", ":")}
    phase("cli", run="modp2048 k=1", N=n, maxciph=headroom(n),
          multiset=True, vmnv_ok="plain,precomp", precomp_arrays="file",
          spill_files_bytes=json.dumps(spills, **compact),
          tampered_rejected="PoSReply01,CCPoSReply01",
          vmnd_encode_s=f"{encode_s:.3f}", steps_s=fmt_steps(steps),
          board=json.dumps(mix["board"], **compact),
          mix_launches=json.dumps(
              {k: v for k, v in mix["launches"].items() if v}, **compact),
          precomp_launches=json.dumps(
              {k: v for k, v in pre["launches"].items() if v}, **compact),
          precomp_mix_launches=json.dumps(
              {k: v for k, v in pc_mix["launches"].items() if v}, **compact))
    return mix["launches"], pc_mix["launches"]


def cli_k3_phase(n: int, tmp: Path) -> dict:
    """modp2048, k=3, t=2, n ciphertexts: three `vmn` processes at once
    over the signed localhost HTTP board (keygen, then mix); returns the
    mixes' launches summed over the parties."""
    from vmn_tpu_torch.arith.pgroup import ModPGroup

    group = ModPGroup.named("modp2048", device="cuda")
    with processes(tmp / "cli_modp2048_k3") as procs:
        w = procs.workdir
        dirs, steps = cli_info(procs, "CliK3", "modp2048", k=3, threshold=2)
        t0 = time.perf_counter()
        keygen = cli_parties(procs, dirs, "-keygen", "publicKey.bt")
        steps["keygen"] = time.perf_counter() - t0
        pks = {(dirs[j] / "publicKey.bt").read_bytes() for j in dirs}
        if len(pks) != 1:
            raise AssertionError("CLI k=3: the parties' public keys differ")
        steps["vmnd"], encode_s = cli_vmnd(procs, "modp2048", n,
                                           dirs[1] / "publicKey.bt")
        t0 = time.perf_counter()
        mixes = cli_parties(procs, dirs, "-mix", str(w / "ciphertexts.bt"),
                            "plaintexts.bt")
        steps["mix"] = time.perf_counter() - t0
        plains = {(dirs[j] / "plaintexts.bt").read_bytes() for j in dirs}
        if len(plains) != 1:
            raise AssertionError("CLI k=3: the parties' plaintexts differ")
        if decoded(group, dirs[1] / "plaintexts.bt") != sorted(
                f"{i:08d}".encode() for i in range(n)):
            raise AssertionError("CLI k=3: plaintext multiset differs")
        t0 = time.perf_counter()
        ps = [procs.start(["vmnv", str(w / "protInfo.xml"),
                           str(dirs[j] / "nizkp.default"), "-mix"])
              for j in sorted(dirs)]
        if not all("Proof is valid." in text for _, _, text in procs.wait(ps)):
            raise AssertionError("CLI k=3: vmnv did not accept a transcript")
        steps["vmnv_3"] = time.perf_counter() - t0
        steps["vmnv_tampered"] = cli_tampered(
            procs, dirs[1] / "nizkp.default", "PoSReply01.bt")
    for j, (rep, _) in enumerate(mixes, 1):
        # parties above the threshold do not shuffle: they verify the
        # shuffles and decrypt, which takes no fixed-base power (H3)
        bad = missing_launches(rep["launches"], [
            k for k in MIX_KERNELS if j <= 2 or k != "mont_fb_exp"])
        if bad:
            raise AssertionError(f"CLI k=3 party {j} -mix: not launched: "
                                 f"{bad}")
    total = {k: sum(rep["launches"][k] for rep, _ in mixes)
             for k in mixes[0][0]["launches"]}
    compact = {"separators": (",", ":")}
    parties = {
        f"Party{j:02d}": {
            "keygen_s": round(keygen[j - 1][1], 3),
            "mix_s": round(mixes[j - 1][1], 3),
            "keygen_board": keygen[j - 1][0]["board"],
            "mix_board": mixes[j - 1][0]["board"]}
        for j in dirs}
    phase("cli", run="modp2048 k=3 t=2 http", N=n, parties_agree=True,
          multiset=True, vmnv_ok="Party01,Party02,Party03",
          tampered_rejected="PoSReply01", vmnd_encode_s=f"{encode_s:.3f}",
          steps_s=fmt_steps(steps),
          parties=json.dumps(parties, **compact),
          mix_launches=json.dumps({k: v for k, v in total.items() if v},
                                  **compact))
    return total


def cli_ec_phase(n: int, tmp: Path) -> dict:
    """P-256, k=1, n ciphertexts: vmni, vmn -keygen, the ciphertexts
    written here through the port's raw interface (vmnd encodes ModP
    groups only), vmn -mix, vmnv; returns the mix's launches."""
    from vmn_tpu_torch.crypto.hash import SHA256
    from vmn_tpu_torch.crypto.prg import PRGHeuristic
    from vmn_tpu_torch.crypto.randomsource import SeededSource
    from vmn_tpu_torch.protocol import elgamal
    from vmn_tpu_torch.protocol.interfaces import RawInterface

    group = _group("P-256")
    raw = RawInterface()
    with processes(tmp / "cli_p256") as procs:
        w = procs.workdir
        dirs, steps = cli_info(procs, "CliP256", "P-256")
        priv = str(dirs[1] / "privInfo.xml")
        _, steps["keygen"] = procs.run("-keygen", priv, "protInfo.xml",
                                       "publicKey.bt", party=True)
        t0 = time.perf_counter()
        pk = raw.read_public_key(group, w / "publicKey.bt")
        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"cli-ec-msgs"))
        m = group.random_array(n, prg, 100)
        r = group.ring.random((n,), SeededSource(b"cli-ec-ciphs"), 0)
        raw.write_ciphertexts(elgamal.encrypt(pk, m, r),
                              w / "ciphertexts.bt")
        torch.cuda.synchronize()
        steps["encrypt_here"] = time.perf_counter() - t0
        mix, steps["mix"] = procs.run("-mix", priv, "protInfo.xml",
                                      "ciphertexts.bt", "plaintexts.bt",
                                      party=True)
        _, steps["vmnv"] = cli_vmnv(procs, dirs[1] / "nizkp.default")
        steps["vmnv_tampered"] = cli_tampered(
            procs, dirs[1] / "nizkp.default", "PoSReply01.bt")
        plain = raw.read_plaintexts(group, w / "plaintexts.bt")
        if sorted(_points(group, plain)) != sorted(_points(group, m)):
            raise AssertionError("CLI P-256: plaintext multiset differs")
    bad = missing_launches(mix["launches"], EC_MIX_KERNELS)
    if bad:
        raise AssertionError(f"CLI P-256 -mix: not launched: {bad}")
    compact = {"separators": (",", ":")}
    phase("cli", run="P-256 k=1", N=n, multiset=True, vmnv_ok=True,
          tampered_rejected="PoSReply01", steps_s=fmt_steps(steps),
          board=json.dumps(mix["board"], **compact),
          mix_launches=json.dumps(
              {k: v for k, v in mix["launches"].items() if v}, **compact))
    return mix["launches"]


def cli_vdemo_phase(n: int, tmp: Path) -> None:
    """vdemo over its default localhost HTTP board at modp2048 (k=3,
    t=2, n messages), then vdemo -protocol all at test256."""
    with processes(tmp / "cli_vdemo") as procs:
        out, s = procs.run("vdemo", "-k", "3", "-t", "2", "-n", str(n),
                           "-group", "modp2048", str(procs.workdir / "demo"))
        if ("demo complete" not in out
                or "plaintext multiset preserved: True" not in out
                or "standalone verification: ok" not in out):
            raise AssertionError(f"vdemo modp2048:\n{out[-2000:]}")
        out_all, s_all = procs.run("vdemo", "-protocol", "all")
        demos = out_all.count(" ok\n")
    phase("cli", run="vdemo", modp2048_k3_n=n, vdemo_s=f"{s:.3f}",
          protocol_all_ok=demos, protocol_all_s=f"{s_all:.3f}")


def cli_phase(n: int, k3_n: int, ec_n: int, vdemo_n: int, tmp: Path):
    """Phase 10: the operator tools, each as its own process.  The five
    runs share nothing (each its own directory, free ports and
    processes), so they run at once, a thread of this process each: their
    steps' seconds are taken beside the other runs' processes, and beside
    the ffc15360 golden's (`Aside`)."""
    t0 = time.perf_counter()
    # the runs' processes share the card with this one: give back the
    # blocks this process's earlier phases left cached (a full run held
    # enough of them for a vmnv process of the runs to fail out of memory)
    gc.collect()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    with contextlib.ExitStack() as stack:
        asides = [stack.enter_context(Aside("golden", g, tmp))
                  for g in FFC_GROUPS]
        with ThreadPoolExecutor(5) as pool:
            runs = [pool.submit(cli_test256_phase, tmp),
                    pool.submit(cli_modp_phase, n, tmp),
                    pool.submit(cli_k3_phase, k3_n, tmp),
                    pool.submit(cli_ec_phase, ec_n, tmp),
                    pool.submit(cli_vdemo_phase, vdemo_n, tmp)]
            _, (modp, modp_pc), k3, ec, _ = [r.result() for r in runs]
        [a.join() for a in asides]
    phase("cli", run="all", concurrent=len(runs),
          reserved_bytes_before=reserved,
          reserved_bytes_after=torch.cuda.memory_reserved(),
          phase_s=f"{time.perf_counter() - t0:.1f}")
    return {"cli modp2048 k=1 mix": modp,
            "cli modp2048 k=1 precomp online mix": modp_pc,
            "cli modp2048 k=3 mix": k3, "cli P-256 mix": ec}


SPANS = (  # (module, class, method) timed as host spans by --profile
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "mix"),
    ("vmn_tpu_torch.protocol.mixnet.verifier", "FiatShamirVerifier",
     "verify"),
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "shuffle"),
    ("vmn_tpu_torch.protocol.mixnet.party", "MixSession", "decrypt"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "precompute"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "commit"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSProver", "reply"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "compute_AF"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "set_commitment"),
    ("vmn_tpu_torch.protocol.hvzk.pos_tw", "PoSVerifier", "verify"),
    ("vmn_tpu_torch.protocol.context", "ProtocolContext",
     "independent_generators"),
)


K3_WINDOW = "mix of the k=3 parties"  # --profile modp2048-k3's window


def busy_in(events, lo: float, hi: float, skip=frozenset()):
    """(busy µs, {kernel: [µs, launches]}, device events) of a profiler's
    device events within [lo, hi]: busy is the union of their intervals;
    events named in `skip` (annotation ranges) are left out."""
    from torch.autograd import DeviceType

    kernels, ivals = {}, []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if (e.device_type == DeviceType.CUDA and e.name not in skip
                and t > lo and s < hi):
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += t - s
            k[1] += 1
            ivals.append((max(s, lo), min(t, hi)))
    busy, end = 0.0, -1.0
    for s, t in sorted(ivals):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy, kernels, len(ivals)


@contextlib.contextmanager
def spans_on(spans=SPANS):
    """Each (module, class, method) of `spans` timed as a host span named
    class.method (torch.profiler's record_function, synchronised at entry
    and exit) for the work inside."""
    import functools
    import importlib

    from torch.profiler import record_function

    def spanned(fn, label):
        @functools.wraps(fn)
        def run(*a, **kw):
            torch.cuda.synchronize()
            with record_function(label):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return run

    saved = []
    for modname, cls, meth in spans:
        owner = getattr(importlib.import_module(modname), cls)
        saved.append((owner, meth, getattr(owner, meth)))
        setattr(owner, meth, spanned(getattr(owner, meth), f"{cls}.{meth}"))
    try:
        yield
    finally:
        for owner, meth, fn in saved:
            setattr(owner, meth, fn)


@contextlib.contextmanager
def idle_window(out: dict):
    """torch.profiler over the work inside, with MixSession.mix and
    FiatShamirVerifier.verify as host spans; after it, `out` holds the
    device's busy seconds and its idle share from the mix's start to the
    verifier's return (profile_phase's window) and the device events
    there, the `profiled` mark beside them (the profiler's host cost is
    inside the window's seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {f"{c}.{m}" for _, c, m in SPANS[:2]}
    with spans_on(SPANS[:2]), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    events = list(prof.events())
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events
              if e.device_type != DeviceType.CUDA and e.name in names}
    lo = ranges["MixSession.mix"][0]
    hi = ranges["FiatShamirVerifier.verify"][1]
    busy, _, count = busy_in(events, lo, hi, names)
    out.update(profiled=True, device_busy_s=f"{busy / 1e6:.3f}",
               idle_share=f"{1 - busy / (hi - lo):.3f}",
               device_events=count)


def profile_phase(name: str, n: int, tmp: Path) -> None:
    """One more mix + verify of a path under torch.profiler: host spans
    (synchronised at entry and exit), device time by kernel and the
    device idle share over the mix + verify window.  modp2048-k3: the
    three parties' mix in threads (keygen and encryption before the
    profiler starts), the window from this thread's span around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with spans_on():
        from vmn_tpu_torch.crypto.hash import SHA256
        from vmn_tpu_torch.crypto.prg import PRGHeuristic

        from vmn_tpu_torch.crypto.randomsource import SeededSource
        from vmn_tpu_torch.protocol import elgamal

        k3 = name == "modp2048-k3"
        group = _group("modp2048" if k3 else name)
        params = _params(f"Prof{name.replace('-', '')}", group,
                         k=3 if k3 else 1, threshold=2 if k3 else 1)
        prg = PRGHeuristic(SHA256)
        prg.set_seed(SHA256.hash(b"smoke-msgs"))
        m = group.random_array(n, prg, params.rbitlen)
        if k3:
            parties, _ = keygen_k(params,
                                  lambda j: f"smoke-party{j}".encode(),
                                  tmp / "prof_k3")
            ciphs = elgamal.encrypt(
                parties[1].full_public_key(), m,
                group.ring.random((n,), SeededSource(b"smoke-ciphs"), 0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if k3:
                _, mix_s, _, _ = run_mix_k(
                    parties, ciphs, "prof",
                    around=lambda: record_function(K3_WINDOW))
                nizkp = tmp / "prof_k3" / "P01" / "nizkp.prof"
            else:
                nizkp, _, mix_s, _, _, _ = run_mix(
                    params, m, tmp / f"prof_{name}", b"smoke-party",
                    b"smoke-ciphs")
            ok, verify_s = verify(params, nizkp)
    if not ok:
        raise AssertionError("profiled transcript rejected")
    names = {f"{c}.{m}" for _, c, m in SPANS} | {K3_WINDOW}
    spans, ranges = {}, {}
    events = list(prof.events())
    for e in events:
        if e.device_type != DeviceType.CUDA and e.name in names:
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    # the window: from the start of session.mix (of the parties' threads,
    # for k=3) to the verifier's return; the spans' own annotation ranges
    # are not device work
    lo = ranges[K3_WINDOW if k3 else "MixSession.mix"][0]
    hi = ranges["FiatShamirVerifier.verify"][1]
    busy, kernels, count = busy_in(events, lo, hi, names)
    window_us = hi - lo
    phase("profile", group=name, N=n, mix_s=f"{mix_s:.3f}",
          verify_s=f"{verify_s:.3f}", device_busy_s=f"{busy / 1e6:.3f}",
          idle_share=f"{1 - busy / window_us:.3f}",
          device_events=count)
    for name, us in sorted(spans.items(), key=lambda kv: -kv[1]):
        print(f"  span {name} s={us / 1e6:.3f}")
    # the 12 longest, and below them every kernel of the port (the
    # Montgomery ones in an anonymous namespace, as some of torch's; the EC
    # ones in vmn_ec)
    for i, (name, (us, cnt)) in enumerate(
            sorted(kernels.items(), key=lambda kv: -kv[1][0])):
        if i < 12 or "(anonymous namespace)::" in name or "vmn_ec::" in name:
            print(f"  device {name[:60]} s={us / 1e6:.4f} "
                  f"share={us / busy:.4f} launches={cnt}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    modes = {"--cli-party": cli_party, "--shard-rank": shard_rank,
             "--alone": alone}
    if argv[:1] and argv[0] in modes:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        rest = argv[2:] if argv[1:2] == ["--"] else argv[1:]
        return modes[argv[0]](rest)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000,
                    help="ciphertexts in the modp2048, modp3072, modp4096, "
                         "vog and modp6144/8192 mixes (default 10000)")
    ap.add_argument("--ec-n", type=int, default=1 << 17,
                    help="ciphertexts in the P-256, P-224, P-384 and P-521 "
                         "mixes (default 131072)")
    ap.add_argument("--k3-n", type=int, default=10000,
                    help="ciphertexts in the modp2048 k=3 mix "
                         "(default 10000)")
    ap.add_argument("--k3i-n", type=int, default=1000,
                    help="ciphertexts in the modp2048 k=3 interactive mix "
                         "(default 1000)")
    ap.add_argument("--profile", choices=["modp2048", *EC_PATH_CURVES,
                                          "modp2048-k3", "modp3072",
                                          "modp4096", *FILE_GROUPS],
                    action="append", default=[],
                    help="after the phases, profile one more mix + verify "
                         "of this path (host spans, device time by kernel, "
                         "device idle share); may be given more than once")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from vmn_tpu_torch.crypto.randomsource import DeviceSource
    from vmn_tpu_torch.ops import ec_kernels as E
    from vmn_tpu_torch.ops import mont_kernels as K

    card = card_line()
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, card=f"'{card}'",
          devices=torch.cuda.device_count(),
          dont_write_bytecode=sys.flags.dont_write_bytecode)

    so = K.build_kernels(ON_DEMAND_WIDTHS)
    phase("build", seconds=f"{K.BUILD_INFO['seconds']:.1f}", lib=so.name,
          widths=",".join(map(str, ON_DEMAND_WIDTHS)))
    for line in ptxas_summary(K.BUILD_INFO["ptxas"]):
        print("  ptxas " + line)
    # the on-demand widths, compiled beside the main library: each
    # library's own seconds (its last object, then its link)
    compiled = K.BUILD_INFO.get("compiled", {})
    for w, info in K.BUILD_INFO["widths"].items():
        lib = Path(info["path"]).name
        obj_s, link_s = compiled.get(lib, (0.0, 0.0))
        lines = ptxas_summary(info["ptxas"])
        # each instantiation's registers, and the width's spill bytes
        regs = dict(re.match(r"(\S+) regs=(\d+)", x).groups() for x in lines)
        spill = sum(int(b) for x in lines
                    for b in re.findall(r"spill_(?:st|ld)=(\d+)B", x))
        phase("build", width=w, lib=lib, built=lib in compiled,
              compile_s=f"{obj_s:.1f}", linked_s=f"{link_s:.1f}",
              tpis=json.dumps({k: list(v) for k, v in
                               K.width_tpis(w).items()},
                              separators=(",", ":")),
              regs=json.dumps({k: int(v) for k, v in regs.items()},
                              separators=(",", ":")),
              spill_bytes=spill)
        for line in lines:
            print(f"  ptxas w{w} " + line)

    t0 = time.perf_counter()
    pc_ec_n = min(args.ec_n, PC_EC_N)
    checks = check_kernels(args.n, args.ec_n, headroom(args.n))
    checks.update(check_prf_kernels(args.n, args.ec_n))
    # each curve whole at 4096 points, and at --ec-n (every curve but
    # P-256 on spread rows); P-256 also at 64-bit scalars (the
    # precomputation's)
    for curve in EC_PATH_CURVES:
        tag = curve_tag(curve)
        small = check_ec_kernels(EC_CHECK_N, curve)
        checks.update(check_ec_kernels(args.ec_n, curve))
        if curve == "P-256":
            checks["ec_scalar_mul_e64"] = check_ec_e64(headroom(pc_ec_n))
        for name, r in small.items():
            checks[name][f"at_{EC_CHECK_N}"] = r
        checks.update(check_ec_tpis(
            "ec_scalar_mul", {small[f"ec_scalar_mul{tag}"]["tpi"],
                              checks[f"ec_scalar_mul{tag}"]["tpi"]},
            b"smoke-ec-tpi", smul_case, curve))
        checks.update(check_ec_tpis(
            "ec_point_add", {small[f"ec_point_add{tag}"]["tpi"],
                             checks[f"ec_point_add{tag}"]["tpi"],
                             checks[f"ec_point_add_b1{tag}"]["tpi"]},
            b"smoke-ec-add-tpi", add_case, curve))
    phase("kernels", checked=len(checks),
          phase_s=f"{time.perf_counter() - t0:.1f}")

    with tempfile.TemporaryDirectory(prefix="vmn_smoke_") as tmpname:
        tmp = Path(tmpname)
        golden_phase(tmp, "test256")
        for curve in EC_PATH_CURVES:
            golden_phase(tmp, curve)
        golden_phase(tmp, "test256", maxciph=8)
        golden_phase(tmp, "test256", maxciph=8, arrays_file=True)
        golden_k3_phase(tmp)
        golden_k3_phase(tmp, "P-224")
        # (the FFC_GROUPS' goldens run beside the CLI runs, phase 10)
        for group in ("modp2048", *WIDE_GROUPS, *FILE_GROUPS):
            if group not in FFC_GROUPS:
                golden_phase(tmp, group)
        matrix = {name: golden_matrix_phase(tmp, name)
                  for name in MATRIX_GOLDENS}
        adversaries = adversary_phase(tmp)
        modp, modp_sizes, modp_widths, modp_s = slice_phase(
            "modp2048", args.n, tmp)
        kw2w2 = matrix_slice_phase(MATRIX_SLICE, args.n, tmp)
        # (the FFC_GROUPS' slices run beside the k=3 and precomputation
        # phases, below)
        wide_mix = {g: slice_phase(g, args.n, tmp)
                    for g in (*WIDE_GROUPS, *FILE_GROUPS)
                    if g not in FFC_GROUPS}
        # curve: (launches, by batch, H6's calls, mix seconds); P-224's
        # k=1 mix at P224_SLICE_N, its H6 at --ec-n in the k=3 mix below
        ec_paths = {curve: slice_phase(curve, min(args.ec_n, P224_SLICE_N)
                                       if curve == "P-224" else args.ec_n,
                                       tmp)
                    for curve in EC_PATH_CURVES}
        ec, ec_sizes, ec_widths, ec_s = ec_paths["P-256"]
        # the same modp2048 and P-256 mixes with bench.py's DeviceSource
        device_mix = {name: slice_phase(name, count, tmp,
                                        source=DeviceSource)[0]
                      for name, count in (("modp2048", args.n),
                                          ("P-256", args.ec_n))}
        sharded = sharded_phase(args.n, args.ec_n, tmp,
                                {"modp2048": modp_s, "P-256": ec_s})
        # the FFC_GROUPS' slices (device-bound: full-width powers at
        # W = 480) in processes of their own beside the k=3 and
        # precomputation phases (host-bound: Naor-Yung, the parties'
        # threads), this process held to ASIDE_MEMORY of the card meanwhile
        gc.collect()
        torch.cuda.empty_cache()
        with contextlib.ExitStack() as stack:
            stack.callback(torch.cuda.set_per_process_memory_fraction, 1.0)
            torch.cuda.set_per_process_memory_fraction(ASIDE_MEMORY)
            ffc_slices = {g: stack.enter_context(Aside("slice", g, tmp))
                          for g in FFC_GROUPS}
            k3, k3_sizes, _, k3_s = multiparty_phase(args.k3_n, tmp)
            ec3, ec3_sizes, _, _ = multiparty_phase(args.ec_n, tmp,
                                                    name="P-224")
            # H4's checks at W = 96, shared by modp3072's k=3 mix and its
            # precomputation path: (N, exponent bits) -> the check
            checked_3072 = {}
            k3_3072, _, _, _ = multiparty_phase(
                args.n, tmp, name="modp3072", multiexp_checked=checked_3072)
            k3i, _, coins, _ = multiparty_phase(args.k3i_n, tmp,
                                                interactive=True)
            pc, pc_mix, pc_widths = precomp_phase(
                "modp2048", 1, args.n, tmp, modp_s)
            pc3, pc3_mix, pc3_widths = precomp_phase(
                "modp2048", 3, args.k3_n, tmp, k3_s)
            _, _, pc_ec_widths = precomp_phase("P-256", 1, pc_ec_n, tmp,
                                               ec_s)
            pc_3072, pc_3072_mix, pc_3072_widths = precomp_phase(
                "modp3072", 1, args.n, tmp, wide_mix["modp3072"][3],
                multiexp_checked=checked_3072)
            for g, aside in ffc_slices.items():
                r = aside.join()
                wide_mix[g] = (r["launches"], r["sizes"], r["widths"],
                               r["mix_s"])
        cli = cli_phase(args.n, args.k3_n, args.ec_n, VDEMO_N, tmp)
        for path in args.profile:
            profile_phase(path, args.ec_n if path in EC_PATH_CURVES else
                          {"modp2048-k3": args.k3_n,
                           **dict.fromkeys(FFC_GROUPS, FFC_N)}.get(
                               path, args.n), tmp)
    compact = {"separators": (",", ":")}
    phase("launches", modp2048_mix=json.dumps(modp, **compact),
          p256_mix=json.dumps(ec, **compact),
          modp2048_k3_mix=json.dumps(k3, **compact),
          modp2048_k3_interactive_mix=json.dumps(k3i, **compact),
          modp2048_k3_interactive_coinflip=json.dumps(coins, **compact),
          modp2048_precomp=json.dumps(pc, **compact),
          modp2048_precomp_online_mix=json.dumps(pc_mix, **compact),
          modp2048_k3_precomp=json.dumps(pc3, **compact),
          modp2048_k3_precomp_online_mix=json.dumps(pc3_mix, **compact),
          modp2048_k3_by_batch=json.dumps(k3_sizes, **compact),
          p224_k3_mix=json.dumps(ec3, **compact),
          p224_k3_by_batch=json.dumps(ec3_sizes, **compact),
          modp2048_by_batch=json.dumps(modp_sizes, **compact),
          p256_by_batch=json.dumps(ec_sizes, **compact),
          **{f"{curve_key(c)}_{part}": json.dumps(r[i], **compact)
             for c, r in ec_paths.items() if c != "P-256"
             for i, part in ((0, "mix"), (1, "by_batch"))},
          **{f"{g}_mix": json.dumps(r[0], **compact)
             for g, r in wide_mix.items()},
          **{f"{g}_by_batch": json.dumps(r[1], **compact)
             for g, r in wide_mix.items()})
    missing = [k for k in K.KERNELS if modp[k] == 0 or k3[k] == 0]
    # the wide paths: each of H1-H4 and K7's combine in each mix
    missing += [f"{k} ({g})" for g, r in wide_mix.items() for k in K.KERNELS
                if r[0][k] == 0]
    # the precomputation path: each of H1-H4 and K7's combine in its
    # precomputation or its online mix
    missing += [k for k in K.KERNELS if pc[k] + pc_mix[k] == 0]
    # the curves: H5, H6, the EC combine and H8; at P-224, P-384 and
    # P-521 also H1/H2 at the curve's width (every modulus of that mix,
    # the field and the ring, has the curve's limb count)
    for curve, (launches, *_) in ec_paths.items():
        need = (*E.EC_KERNELS, *(CURVE_MONT if curve != "P-256" else ()))
        if curve == "P-224":  # H6 and its combine: the k=3 mix's, at 2^17
            launches = {**launches, **{k: ec3[k] for k in (
                "ec_multiexp_positions", "ec_multiexp_combine")}}
        missing += [k if curve == "P-256" else f"{k} ({curve})"
                    for k in need if launches[k] == 0 and k != "ec_fb_exp"]
    # the ChaCha20 kernel in both DeviceSource mixes
    missing += [f"chacha20_limbs ({path} DeviceSource)"
                for path, launches in device_mix.items()
                if launches["chacha20_limbs"] == 0]
    if missing:
        raise AssertionError(f"not launched in their path's mix: {missing}")
    for path, (launches, *_) in ec_paths.items():
        if (args.ec_n <= E.EP_SUPER and launches["ec_multiexp_combine"]
                != launches["ec_multiexp_positions"]):
            # below EP_SUPER points H6 counts one launch a
            # multi-exponentiation
            raise AssertionError(f"{path} mix: not one combine per H6 call")
    # the port ran alone: no module of JAX or of the JAX package loaded
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "vmn_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or vmn_tpu loaded: {loaded}")
    phase("done", elapsed_s=f"{time.perf_counter() - t_start:.1f}")

    torch.cuda.synchronize()
    kernels = []
    # the other curves' suffixes for the Montgomery kernels' check names
    curve_w = CURVE_W_TAG
    for name in (*K.KERNELS, *E.EC_KERNELS):
        is_ec = name in E.EC_KERNELS
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vmn_tpu_torch/csrc/"
                      + ("ec_kernels.cuh" if is_ec else "mont_kernels.cu"),
            "replaces": REPLACES[name],
            "launches": (ec if is_ec else modp)[name],
            "path": "P-256 mix" if is_ec else "modp2048 mix",
            **checks[MAIN_CHECK[name]]})
        # the same kernel at P-224 (W' = 8), P-384 (W = 12) and P-521
        # (W' = 20): its launches in that curve's mix and its check at
        # that path's batch (none where the width has no kernel)
        for curve, tag in curve_w.items():
            tag = curve_tag(curve) if is_ec else tag
            kernels[-1][curve_key(curve)] = {
                "launches": ec_paths[curve][0][name],
                **checks.get(MAIN_CHECK[name] + tag, {}),
                "checks": checks_at(checks, name, tag,
                                    (*K.KERNELS, *E.EC_KERNELS))}
        if not is_ec:
            kernels[-1]["launches_by_path"] = {
                "modp2048 mix": modp[name], "modp2048 k=3 mix": k3[name],
                "modp2048 k=3 interactive mix": k3i[name],
                "its coin flipping": coins.get(name, 0),
                "modp2048 precomp": pc[name],
                "modp2048 precomp online mix": pc_mix[name],
                "modp2048 k=3 precomp": pc3[name],
                "modp2048 k=3 precomp online mix": pc3_mix[name],
                **{path: launches[name] for path, launches in cli.items()},
                **{f"{g} mix": r[0][name] for g, r in wide_mix.items()},
                **{f"{c} mix": ec_paths[c][0][name] for c in curve_w},
                "P-224 k=3 mix": ec3[name],
                **{f"sharded modp2048 mix (rank {i})": r[name]
                   for i, r in enumerate(sharded["modp2048"])},
                "modp3072 k=3 mix": k3_3072[name],
                "modp3072 precomp": pc_3072[name],
                "modp3072 precomp online mix": pc_3072_mix[name],
                f"{MATRIX_SLICE} mix": kw2w2[name],
                **{f"golden {g} mix": r[name] for g, r in matrix.items()},
                **{f"adversary {f}": r[name]
                   for f, r in adversaries.items()}}
            # the same kernel at W = 96 and 128: its checks there; at
            # W = 192 and 256 (RFC_GROUPS, built on demand) also its
            # launches in those groups' mixes
            kernels[-1]["wide"] = {
                g: checks_at(checks, name, f"_w{W}", K.KERNELS)
                for g, W in WIDE_GROUPS.items()}
            kernels[-1]["rfc"] = {
                g: {"W": W, "launches": wide_mix[g][0][name],
                    "checks": checks_at(checks, name, f"_w{W}", K.KERNELS)}
                for g, W in RFC_GROUPS.items()}
            # past 8192 bits: at W = 480 its launches in the ffc15360 mix
            # and its checks there, at W = 512 and 288 its checks
            kernels[-1]["ffc"] = {
                **{g: {"W": W, "launches": wide_mix[g][0][name],
                       "checks": checks_at(checks, name, f"_w{W}",
                                           K.KERNELS)}
                   for g, W in FFC_GROUPS.items()},
                **{f"w{W}": {"W": W, "checks": checks_at(
                    checks, name, f"_w{W}", K.KERNELS)}
                   for W in (*FFC_WIDTHS, MID_WIDTH)
                   if W not in FFC_GROUPS.values()}}
            # at W = 32 (vog1000: W' = 32, converting): its launches in
            # the fresh groups' mixes and its checks there
            kernels[-1]["vog"] = {
                g: {"launches": wide_mix[g][0][name],
                    "checks": checks_at(checks, name, tag, K.KERNELS)}
                for g, tag in VOG_GROUPS.items()}
        else:
            kernels[-1]["launches_by_path"] = {
                **{f"{c} mix": r[0][name] for c, r in ec_paths.items()},
                "P-224 k=3 mix": ec3[name],
                "cli P-256 mix": cli["cli P-256 mix"][name],
                **{f"sharded P-256 mix (rank {i})": r[name]
                   for i, r in enumerate(sharded["P-256"])}}
    for name in ("mont_mul", "mont_exp"):
        kernels[K.KERNELS.index(name)].update(
            batch1=checks[f"{name}_b1"], w8=checks[f"{name}_w8"],
            w8_at_n=checks[f"{name}_w8_n"],
            w8_batch1=checks[f"{name}_w8_b1"],
            launches_by_batch={"modp2048 mix": modp_sizes[name],
                               **{f"{c} mix": r[1][name]
                                  for c, r in ec_paths.items()},
                               **{f"{g} mix": r[1][name]
                                  for g, r in wide_mix.items()}})
    ec_at = {name: len(K.KERNELS) + i for i, name in enumerate(E.EC_KERNELS)}
    for name in E.LAUNCH_SIZES:
        kernels[ec_at[name]]["launches_by_batch"] = {
            f"{c} mix": r[1][name] for c, r in ec_paths.items()}
    kernels[K.KERNELS.index("mont_exp")]["precomp_e64"] = checks[
        "mont_exp_e64"]
    kernels[K.KERNELS.index("mont_expprod_positions")].update(
        path_calls=modp_widths, precomp_path_calls=pc_widths,
        wide_path_calls={g: r[2] for g, r in wide_mix.items()},
        modp3072_precomp_path_calls=pc_3072_widths,
        k3_precomp_path_calls=pc3_widths,
        batch1=checks["mont_expprod_positions_b1"],
        w8=checks["mont_expprod_positions_w8"],
        at_first_n_of_tpi=[r for k, r in checks.items()
                           if k.startswith("mont_expprod_positions")
                           and "_tpi" in k])
    kernels[ec_at["ec_point_add"]].update(
        batch1=checks["ec_point_add_b1"],
        at_first_n_of_tpi=[r for k, r in checks.items()
                           if k.startswith("ec_point_add_tpi")])
    kernels[ec_at["ec_multiexp_positions"]].update(
        path_calls=ec_widths, precomp_path_calls=pc_ec_widths,
        **{f"{curve_key(c)}_path_calls": ec_paths[c][2] for c in curve_w})
    kernels[ec_at["ec_scalar_mul"]].update(
        precomp_e64=checks["ec_scalar_mul_e64"],
        at_first_n_of_tpi=[r for k, r in checks.items()
                           if k.startswith("ec_scalar_mul_tpi")])
    kernels[K.KERNELS.index("mont_fb_exp")].update(
        window=8, batch1=checks["mont_fb_exp8_b1"],
        window4={"replaces": "vmn_tpu/ops/mont_kernels.py:487",
                 "exponent_bits": 256, **checks["mont_fb_exp4"]},
        w8_window4=checks["mont_fb_exp4_w8"],
        w8_window4_batch1=checks["mont_fb_exp4_w8_b1"],
        at_first_n_of_tpi=[r for k, r in checks.items()
                           if k.startswith("mont_fb_exp") and "_tpi" in k])
    kernels[ec_at["ec_fb_exp"]].update(
        note="off the mix path, as in vmn_tpu (arith/ec.py _exp_impl)")
    # the device PRF: its launches in the DeviceSource modp2048 mix, its
    # check at that mix's draw (N rows of 2147 bits), and the same at
    # P-256's (--ec-n rows of 356 bits)
    kernels.append({
        "name": "chacha20_limbs", "route": "cuda",
        "source": "vmn_tpu_torch/csrc/prf_kernels.cu",
        "replaces": PRF_REPLACES,
        "launches": device_mix["modp2048"]["chacha20_limbs"],
        "path": "modp2048 DeviceSource mix",
        **checks["chacha20_limbs"],
        "p256": {"launches": device_mix["P-256"]["chacha20_limbs"],
                 **checks["chacha20_limbs_p256"]},
        "mid_block_range": checks["chacha20_limbs_range"],
        "p256_mid_block_range": checks["chacha20_limbs_p256_range"],
        "launches_by_path": {
            **{f"{p} DeviceSource mix": r["chacha20_limbs"]
               for p, r in device_mix.items()},
            **{f"sharded {SHARD_DEVICE_MIX} mix (rank {i})":
               r["chacha20_limbs"]
               for i, r in enumerate(sharded[SHARD_DEVICE_MIX])}}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
