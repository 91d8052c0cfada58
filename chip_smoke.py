#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (libecc_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The script imports the package from its own directory, so it may also be
started by its path from another directory; alone, without the package
beside it, it exits 2 at once and says so.

It builds the port's CUDA kernels from libecc_tpu_torch/csrc with nvcc,
checks each kernel bitwise against its plain PyTorch version on the card,
and drives these paths at batch 8192, bytes in:

1. batched ECDSA verification on P-256 (K = 8 kernels), P-384 (K = 12,
   a = -3), BrainpoolP512r1 and GOST512 (K = 16, generic a) and P-521
   (K = 17, a = -3, hashed with SHA-512), through verify_batch,
   verify_digests_batch, verify_batch_async and verify_batches (accept
   mask out), with the P-256 and P-384 Wycheproof rows and the P-384,
   BrainpoolP512r1 and P-521 KAT rows under SHA-224/256/384/512 and
   SHA3-384/512;
2. batched Ed25519 verification, through eddsa.verify_batch (accept mask
   out);
3. batched Ed448 verification (K = 14 kernels, a = 1), through
   eddsa.verify_batch("ed448") (accept mask out), and the Ed448 and
   Ed448ph vectors;
4. batch verification (one accept for the whole batch), through
   batch_verify.ecfsdsa_verify_batch (P-256), bip0340_verify_batch
   (secp256k1) and eddsa_verify_batch (Ed25519);
5. batch verification on the large-K curves: ecfsdsa_verify_batch on
   P-384 (SHA-384, kernel 6 at K = 12) and BrainpoolP512r1 (SHA-512,
   kernel 6 at K = 16), eddsa_verify_batch("ed448" and "ed448ph",
   kernel 6-ed at K = 14), with the ECFSDSA and Ed448 KAT rows as
   batches;
6. the rest of the cofactor-1 registry (kernels 1-4 and 6 at K = 6, 7
   and 10, at K = 12 with generic a, at K = 16 with a = -3; kernel 6 at
   K = 17): ECDSA verify through verify_batch_async on one curve of each
   (K, a), P-192, BrainpoolP192r1, secp192k1, P-224 (SHA-224),
   BrainpoolP224r1, secp224k1, BrainpoolP320r1/t1 and BrainpoolP384r1
   (SHA-384) and BrainpoolP512t1 (SHA-512), and at batch 256 on the six
   curves that share an instance; ecfsdsa_verify_batch on P-521
   (SHA-512), P-224, BrainpoolP384r1 and BrainpoolP512t1, and at batch
   1024 on the other new kernel-6 instances (whose kernel-6 rows are
   timed and checked on the batch's tables and digits tiled to 8192);
7. the cofactor > 1 curves (kernels 2-4 and 6 at K = 14, generic a, on
   WEI448): the q*P subgroup check of key import (WEI448 at batch 8192,
   timed; WEI25519, GOST 2012 256 A and 512 C at 256: keys d*G + T, T
   of small order, and the curve's point (x, 0) of order 2 itself are
   refused, lane for lane as the host oracle says), ECDSA verify through
   verify_batch_async (WEI448 under SHA-512 at 8192, timed; the others at
   256), whose affine accept test reduces x(W) mod q, and
   ecfsdsa_verify_batch (WEI448 at 8192, timed; the others at 256);
8. the joint-table Straus straus_double_mul_public against the
   separate-table one, on every curve above whose (K, a) has kernel 5 or
   8c built: P-256 and Ed25519 (K = 8), P-384, BrainpoolP512r1, GOST512,
   BrainpoolP512t1, P-521, WEI448 and Ed448.

For each path it checks the results (valid lanes or batches, corrupted
ones, the Wycheproof and KAT rows), counts the kernel launches of the
path's own run, and times the batch, its stages and each kernel. It
imports neither JAX nor the JAX package. Any failed phase makes it exit
non-zero before the result lines; without a CUDA device it exits 1.

The last lines of standard output are one JSON object per path, one
listing the kernels and one JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

BATCH = 8192            # the verify batch of the headline (bench.py:413)
UNIQUE = 1024           # unique (key, message, signature) tuples, tiled
MONT_N = 65536
POINT_N = 8192
WINDOWED_N = 1024

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak bandwidth
# 32-bit integer multiply-add issue slots per second: the H100 SXM's 67 TFLOP/s
# float32 rate counts an FMA as 2 operations at 128 lanes/SM/clock; sm_90
# issues 32-bit IMAD at 64 lanes/SM/clock, so 67e12 / 4.
IMAD_PER_S = 67e12 / 4


def fmul_slots(k: int) -> int:
    """Multiply-add slots of one K-limb Montgomery product (wide products
    count 2)."""
    return 2 * (2 * k * k) + k


def fsqr_slots(k: int) -> int:
    return 2 * (k * (k - 1) // 2 + k + k * k) + k


K = 8
FMUL_SLOTS = fmul_slots(K)
FSQR_SLOTS = fsqr_slots(K)
# per window (squares, products) of kernel 4 (one pair) and kernel 6 (two
# pairs: one complete add more), w = 4, by formula set: 4 dbl-2001-b, the
# to_jac / from_jac pair and one RCB add a pair; a doubling is 5S + 3M at
# a = -3, 6S + 2M at a = 0 and 7S + 3M for generic a, an add 14 products
# (18 for generic a: the products by a and a^2)
W_PER_WINDOW = {"m3": ((22, 30), (22, 44)), "a0": ((26, 26), (26, 40)),
                "ga": ((30, 34), (30, 52))}
# the products of kernel 2 (an add) and kernel 3 (a double, besides its
# three squares) by formula set
ADD_DBL_PRODUCTS = {"m3": (14, 10), "a0": (14, 10), "ga": (18, 14)}
# kernels 7 and 6-ed, the products the function needs: 4 dbl-2008-hwcd
# (4 squares, 4 products) and add-2008-hwcd-3 (a = -1, 9 products) or
# add-2008-hwcd (a = 1, 10) a pair. T (one product) is needed only before
# an add and at the output: no doubling but the last of a window, and not
# the window's last add, whose T the next window's doubling does not read,
# so 13 + 8 (+ 9) or 13 + 9 (+ 10); the output's one T a lane is left out
ED_PER_WINDOW = (16, 21)                # kernel 7, K = 8, a = -1
ED448_PER_WINDOW = (16, 22)             # kernel 7, K = 14, a = 1
ED_ADD_PRODUCTS = 9                     # add-2008-hwcd-3 (a = -1)
ED448_ADD_PRODUCTS = 10                 # add-2008-hwcd: one product more
ED_STRAUS_PER_WINDOW = (16, 30)         # kernel 6-ed: one more extended add
ED448_STRAUS_PER_WINDOW = (16, 32)      # kernel 6-ed with add-2008-hwcd
JOINT_NDBL = 2                          # the joint Straus step: 2^2*acc + T
# kernel 5 per lane: (squares, products) of one doubling and the products
# outside the doublings (the complete add and the Jacobian conversions);
# two squares besides
JOINT_PER_DBL = {"m3": ((5, 3), 18), "ga": ((7, 3), 22)}
# the ECDSA paths: curve -> label (P-256 at K = 8, P-384 at K = 12, the
# 512-bit curves at K = 16, P-521 at K = 17), the hash of each path's
# fixture and batch (SHA-256 unless named: P-521 with SHA-512, as JWS
# ES512), and the curves with Wycheproof rows
W_CURVES = {"SECP256R1": "P-256", "SECP384R1": "P-384",
            "BRAINPOOLP512R1": "BrainpoolP512r1", "GOST512": "GOST512",
            "SECP521R1": "P-521"}
W_HASH = {"SECP521R1": "SHA512"}
W_WYCHEPROOF = ("SECP256R1", "SECP384R1")
# kernels 1-4: base name -> the TPU kernel in libecc_tpu/ops/pallas
W_KERNELS = {"mont_mul": "mont.py:297", "mont_sqr": "mont.py:297",
             "point_add": "point.py:470", "point_dbl": "point.py:489",
             "windowed_mul": "megamul.py:161"}
# the rest of the cofactor-1 registry: one curve of each later (K, a)
# instance of kernels 2-4 and 6 -> (label, the hash its users pair with
# it), ECDSA at batch 8192; the curves that share an instance, ECDSA at
# SHARED_BATCH; ECFSDSA at batch 8192 (P-521 from the ECDSA paths above)
# and at FSDSA_SMALL on the other new kernel-6 instances
R_CURVES = {"SECP192R1": ("P-192", "SHA256"),
            "BRAINPOOLP192R1": ("BrainpoolP192r1", "SHA256"),
            "SECP192K1": ("secp192k1", "SHA256"),
            "SECP224R1": ("P-224", "SHA224"),
            "BRAINPOOLP224R1": ("BrainpoolP224r1", "SHA256"),
            "SECP224K1": ("secp224k1", "SHA256"),
            "BRAINPOOLP320R1": ("BrainpoolP320r1", "SHA384"),
            "BRAINPOOLP320T1": ("BrainpoolP320t1", "SHA384"),
            "BRAINPOOLP384R1": ("BrainpoolP384r1", "SHA384"),
            "BRAINPOOLP512T1": ("BrainpoolP512t1", "SHA512")}
R_SHARED = {"BRAINPOOLP192T1": "BrainpoolP192t1",
            "SM2P192TEST": "SM2P192TEST",
            "BRAINPOOLP224T1": "BrainpoolP224t1", "BIGN512V1": "BIGN512V1",
            "GOST_R3410_2012_512_PARAMSETA": "GOST 2012 512 A",
            "GOST_R3410_2012_512_PARAMSETB": "GOST 2012 512 B"}
SHARED_BATCH = 256
FSDSA_FULL = ("SECP521R1", "SECP224R1", "BRAINPOOLP384R1", "BRAINPOOLP512T1")
FSDSA_SMALL = 1024
# ECFSDSA on each new kernel-6 instance: curve -> (label, hash), the
# FSDSA_FULL ones first
F_CURVES = {cn: ({"SECP521R1": ("P-521", "SHA512")} | R_CURVES)[cn]
            for cn in (*FSDSA_FULL, *R_CURVES)}
# the cofactor > 1 curves -> (label, hash): WEI448 (kernels 2-4 and 6 at
# K = 14, generic a) at BATCH, timed: its keys' q*P check, ECDSA and
# ECFSDSA; the other three (instances built before) at COF_BATCH,
# correctness only. Their key batches get a point of small order on the
# lanes COF_BAD (below COF_BATCH) and, at BATCH, COF_BAD_FULL too.
COF_CURVES = {"WEI448": ("WEI448", "SHA512"),
              "WEI25519": ("WEI25519", "SHA256"),
              "GOST_R3410_2012_256_PARAMSETA": ("GOST 2012 256 A", "SHA256"),
              "GOST_R3410_2012_512_PARAMSETC": ("GOST 2012 512 C", "SHA512")}
COF_BATCH = 256
COF_BAD = (3, 77, 130, 255)
COF_BAD_FULL = (4097, 8191)
COF_ORDER2 = 200        # the lane whose key is the point (x, 0) of order 2
# this script's directory: the root of a checkout (__file__ is unset when
# the script is piped on standard input; the directory is then the cwd)
HERE = os.path.dirname(os.path.abspath(globals().get("__file__",
                                                     "chip_smoke.py")))
VEC = os.path.join(HERE, "tests", "vectors")


def _fail(msg: str):
    raise RuntimeError(msg)


def _check(cond, msg: str):
    if not cond:
        _fail(msg)


def _run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    return (out.stdout or out.stderr).strip()


class Timer:
    """CUDA-event timing of a callable: warm-up, then reps launches."""

    def __init__(self, torch):
        self.torch = torch

    def ms(self, fn, reps: int, warm: int = 2):
        """(ms per call, the last call's result)."""
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out


def _bound_ms(nbytes: float, slots: float):
    tb = nbytes / HBM_BYTES_PER_S
    to = slots / IMAD_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def _profile(torch, fn, label: str):
    """Device busy share of one call of fn, from the profiler's kernel
    times over the host wall time of the synchronised call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
    kernels_us = {}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels_us[evt.name] = kernels_us.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us()
            n_kernels += 1
    busy_us = sum(kernels_us.values())
    if busy_us <= 0:
        print(f"profile of one {label} batch: the profiler recorded no "
              "device time (busy share not measured)")
        return None
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    share = busy_us / wall_us
    print(f"profile of one {label} batch: wall {wall_us / 1e3:.3f} ms under "
          f"the profiler, device kernels {busy_us / 1e3:.3f} ms in "
          f"{n_kernels} launches, busy share {share:.4f}")
    for name_, us in top:
        print(f"  {us / 1e3:9.4f} ms  {name_[:90]}")
    return share


def _device_ms(torch, fn, reps: int, event_ms: float):
    """Device time of one call of fn with its launches back to back on the
    card. CUDA events over back-to-back calls time the host's launch
    interval wherever the kernel is shorter than it. So the stream first
    sleeps while the host queues all reps calls, and events around the
    queued calls time the card alone. None, with the reason printed, when
    the host had not queued them all before the card woke, or when the
    reading exceeds the back-to-back event time event_ms (the card cannot
    take longer with the host out of the way)."""
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for sleep_ms in (2 * host_ms + 5, 8 * host_ms + 20):
        # at most 2 GHz, so the sleep lasts at least sleep_ms
        torch.cuda._sleep(int(sleep_ms * 2e6))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            break
    if not queued:
        print(f"  device time not measured: the host queued {reps} calls "
              f"in more than the stream's sleep ({sleep_ms:.1f} ms)")
        return None
    dms = a.elapsed_time(b) / reps
    if dms > 1.05 * event_ms:
        print(f"  device time not measured: {dms:.5f} ms queued exceeds "
              f"{event_ms:.5f} ms back to back")
        return None
    return round(dms, 5)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "libecc_tpu_torch")):
        print(f"chip_smoke: the package libecc_tpu_torch is not beside the "
              f"script in {HERE}; run the script from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions and the entry points issue many small tensor
    # operations: inference mode spares each its autograd bookkeeping
    with torch.inference_mode():
        return run(torch)


def run(torch) -> int:
    """Build, check and measure on the card (see the module's docstring)."""
    import numpy as np
    from libecc_tpu_torch import stages
    from libecc_tpu_torch.nn import core as nn
    from libecc_tpu_torch.curves import edwards, params, scalar_mul, shortw
    from libecc_tpu_torch.curves.edwards import ExtPoint
    from libecc_tpu_torch.curves.shortw import PrjPoint
    from libecc_tpu_torch.ops.cuda import build, edpoint, mont, point, \
        megamul
    from libecc_tpu_torch.ref import hostref as H
    from libecc_tpu_torch.sig import batch_verify as bv, ecdsa, eddsa, \
        keys as K_

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def lap(what):
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s at the end of "
              f"{what}")
    timer = Timer(torch)

    # 1. the card -------------------------------------------------------
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print("nvcc:", _run([build.nvcc_path(), "--version"]).splitlines()[-1])
    print(smi)                            # the card's name and power limit
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # 2. build: nvcc (one process a source) runs from a thread of its own
    # while the host makes the fixtures and combs below, which need no
    # kernel; wait_for_build() joins it before the first launch
    nvcc_pool = ThreadPoolExecutor(1)
    built = nvcc_pool.submit(build.library, "mont")

    def wait_for_build():
        built.result()
        nvcc_pool.shutdown()
        print(f"build: {build.build_seconds:.1f} s for "
              f"{sorted(build.build_log) or 'cached libraries'}; each nvcc "
              "done at (s): " + json.dumps({k_: round(v, 1) for k_, v in
                                            build.build_file_seconds.items()}))
        for stem, log in sorted(build.build_log.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    print(f"ptxas[{stem}]: {line.strip()}")
        lap("the build")

    ec = edwards.get_edwards_curve("ED25519")
    ectx = ec.fp_ctx
    ep, eq = ectx.p_int, ec.q
    hc = H.EdCurve(ep, ec.a, ec.d, ec.gx, ec.gy, eq, ec.h)
    rng = np.random.RandomState(2026)
    results = {}
    reps = BATCH // UNIQUE
    N = BATCH

    def rand_ints(n, mod):
        """n random residues mod `mod` from 30-bit words: 9 words (270
        bits) for the 256-bit moduli, up to 18 (540 bits) for the 512-bit
        ones."""
        words = max(9, -(-(mod.bit_length() + 14) // 30))
        raw = rng.randint(0, 1 << 30, size=(n, words)).astype(object)
        return [int(sum(int(v) << (30 * i) for i, v in enumerate(row)) % mod)
                for row in raw]

    def cmp(name, got, want, n, where=""):
        got = [g.to(torch.int64) for g in got]
        want = [w.to(torch.int64) for w in want]
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        _check(err == 0, f"{name} at N={n}: kernel differs from its plain "
                         f"version (max abs limb difference {err})")
        prev = results.setdefault(name, {}).get("max_abs_err", 0)
        results[name]["max_abs_err"] = max(prev, err)
        print(f"check {name} at N={n}{where}: bitwise equal to the plain "
              "version")
        return err

    def staged(fn, reps=3):
        """Run fn() reps times with the device synchronised at every stage
        mark of the verify path (libecc_tpu_torch.stages). Returns the
        median host ms of each stage ("return" is the time from the last
        mark to fn's return), the last run's marked values and its
        result."""
        runs, vals, out = [], {}, None
        for _ in range(reps):
            names, t = [], []

            def on_mark(name, *v):
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                names.append(name)
                vals[name] = v

            torch.cuda.synchronize()
            t.append(time.perf_counter())
            with stages.on_mark(on_mark):
                out = fn()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            names.append("return")
            runs.append(dict(zip(names, [(b - a) * 1e3
                                         for a, b in zip(t, t[1:])])))
        return ({name: round(statistics.median(r[name] for r in runs), 4)
                 for name in runs[0]}, vals, out)

    counts = [mont.launches, point.launches, megamul.launches,
              edpoint.launches]

    def reset():
        for d in counts:
            for key in d:
                d[key] = 0

    def snapshot():
        return {k_: v for d in counts for k_, v in d.items()}

    def time_batch(fn, label, marks, check):
        """Time one batch of a path: the median of 7 CUDA-event timings
        after 2 warm-ups (check(result) must hold on each), the host time,
        the peak device memory, the launches of one batch, the stage
        breakdown (stage marks in the order marks) and the busy share.
        Returns the report and the staged run's marked values."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev_ms, host_ms, ret_ms = [], [], []
        for _ in range(7):
            a_ = torch.cuda.Event(enable_timing=True)
            b_ = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            a_.record()
            out = fn()
            b_.record()
            ret_ms.append((time.perf_counter() - h0) * 1e3)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - h0) * 1e3)
            ev_ms.append(a_.elapsed_time(b_))
            _check(check(out), f"{label}: a timed batch gives a wrong result")
        peak = torch.cuda.max_memory_allocated()
        reset()
        fn()
        torch.cuda.synchronize()
        per = snapshot()
        bd, marked, out = staged(fn)
        _check(check(out), f"{label}: the staged batch gives a wrong result")
        _check(list(bd) == marks, f"{label} stage marks: {list(bd)}")
        med = statistics.median(ev_ms)
        print(f"{label} batch {BATCH}: median {med:.3f} ms over 7 (events), "
              f"host {statistics.median(host_ms):.3f} ms, of which the call "
              f"itself {statistics.median(ret_ms):.3f} ms before the "
              f"synchronise; {BATCH / (med / 1e3):.1f} per s; all {ev_ms}; "
              f"peak device memory {peak} bytes")
        print(f"{label} launches per batch:", json.dumps(per))
        print(f"{label} stage ms (host clock, device synchronised at each "
              "stage mark):", json.dumps(bd))
        return {"batch": BATCH, "median_ms": round(med, 4),
                "per_s": round(BATCH / (med / 1e3), 1),
                "host_median_ms": round(statistics.median(host_ms), 4),
                "all_ms": [round(x, 4) for x in ev_ms],
                "busy_share": _profile(torch, fn, label),
                "launches_per_batch": per, "stage_ms": bd,
                "peak_bytes": peak}, marked

    source, replaces, lines = {}, {}, []

    def measure(name, kfn, pfn, kreps, preps, nbytes, slots, n=N):
        """Time a kernel and its plain version on the same inputs, hold the
        two bitwise, and compute the bound of the work."""
        kms, kout = timer.ms(kfn, kreps)
        dms = _device_ms(torch, kfn, kreps, kms)
        pms, pout = timer.ms(pfn, preps, warm=1 if preps > 1 else 0)
        err = cmp(name, kout if isinstance(kout, tuple) else [kout],
                  pout if isinstance(pout, tuple) else [pout], n)
        bms, by = _bound_ms(nbytes, slots)
        print(f"kernel {name}: {kms:.4f} ms at N={n} (device {dms} ms "
              f"queued; plain {pms:.3f} ms, bound {bms:.6f} ms by {by})")
        return {"n": n, "max_abs_err": err, "ms": round(kms, 5),
                "device_ms": dms, "plain_ms": round(pms, 4),
                "bound_ms": round(bms, 6), "bound_by": by}

    def row_shape(name):
        """The shape a kernel row runs in, from groupfield.cuh's tables:
        "t{TPI}x{threads}" (with "i" where products are inlined) on the
        group field, "t1" on one thread a lane: kernels 2, 3, 8a and 8b in
        AddShape, kernels 4, 6, 7 and 6-ed in GroupShape, kernels 1, 5 and
        8c "t1"."""
        for (k_, _, _, _), (kname, _, _) in megamul._KERNELS.items():
            if kname == name:
                return build.shape("GroupShape", k_)
        for base in ("point_add", "point_dbl"):
            for (k_, _), (_, _, tag) in point.BUILT.items():
                if name == point._count_name(base, k_, tag):
                    return build.shape("AddShape", k_)
        for base in ("ed_add", "ed_dbl"):
            for k_ in edpoint.BUILT[base]:
                if name == build.kernel_name(base, k_):
                    return build.shape("AddShape", k_)
        return "t1"

    def time_kernels(kern, path_counts, batch_counts, path, n=N):
        for name, args in kern.items():
            lines.append({
                "name": name, "route": "cuda", "shape": row_shape(name),
                "source": f"libecc_tpu_torch/csrc/{source[name]}",
                "replaces": replaces[name], "path": path,
                "launches": path_counts[name],
                "launches_per_batch": batch_counts[name],
                **measure(name, *args, n=n),
                # over every comparison of this kernel in the run
                "max_abs_err": results[name]["max_abs_err"],
                "library_ms": None})

    def check_mont(ctx, label, n=MONT_N):
        """Kernel 1 under one modulus m against its plain version, bitwise,
        the edge operands 0, 1, m - 2 and m - 1 first, and its first lanes
        against Python integers. Returns each product's difference."""
        m, k_ = ctx.p_int, ctx.k
        xs = [0, 1, m - 1, m - 1, 1, m - 2] + rand_ints(n - 6, m)
        ys = [m - 1, m - 1, m - 1, 0, 1, m - 1] + rand_ints(n - 6, m)
        a = nn.upload(nn.batch_to_limbs(xs, k_), dev)
        b = nn.upload(nn.batch_to_limbs(ys, k_), dev)
        where = f" under {label}"
        errs = {"mont_mul": cmp(build.kernel_name("mont_mul", k_),
                                [mont.mont_mul(a, b, ctx)],
                                [nn.mont_mul(a, b, ctx)], n, where),
                "mont_sqr": cmp(build.kernel_name("mont_sqr", k_),
                                [mont.mont_sqr(a, ctx)],
                                [nn.mont_sqr(a, ctx)], n, where)}
        rinv = pow(ctx.R, -1, m)
        got = nn.batch_from_limbs(mont.mont_mul(a, b, ctx)[:, :64])
        _check(got == [x * y * rinv % m for x, y in zip(xs[:64], ys[:64])],
               f"kernel 1 at K = {k_}{where} disagrees with Python integers")
        return errs

    # 3. ECDSA verify on the short-Weierstrass curves: P-256 (K = 8,
    # a = -3), P-384 (K = 12, a = -3), BrainpoolP512r1 and GOST512 (K = 16,
    # generic a) ----------------------------------------------------------
    def a_tag(cv):
        return "m3" if cv.a_is_m3 else "a0" if cv.a_is_0 else "ga"

    def w_names(cv):
        """The names of the curve's kernels 1-4 (its K and a) in the launch
        counts."""
        k_ = cv.fp_ctx.k
        return {"mont_mul": build.kernel_name("mont_mul", k_),
                "mont_sqr": build.kernel_name("mont_sqr", k_),
                "point_add": point.instance_name("point_add", cv),
                "point_dbl": point.instance_name("point_dbl", cv),
                "windowed_mul": megamul.kernel_name_of(cv, 1)}

    def note_sources(cv):
        """Record the source and the TPU kernel of the curve's kernels 1-4
        and 6 for the rows."""
        stem = point.BUILT[(cv.fp_ctx.k, point.a_kind(cv))][0]
        for base, name in w_names(cv).items():
            source[name] = ("mont.cu" if base.startswith("mont") else
                            f"{megamul.instance(cv, 'w', 1)[2]}.cu"
                            if base == "windowed_mul" else f"{stem}.cu")
            replaces[name] = f"libecc_tpu/ops/pallas/{W_KERNELS[base]}"
        straus = megamul.instance(cv, "w", 2)
        if straus is not None:
            source[straus[0]] = f"{straus[2]}.cu"
            replaces[straus[0]] = "libecc_tpu/ops/pallas/megamul.py:224"

    def w_points(cv, cw, n, uniq=64):
        """n affine points of cv, uniq distinct ones repeated."""
        pts = [H.ec_base_mul(cw, 1 + v % (cv.q - 1))
               for v in rand_ints(uniq, cv.q)]
        return [pts[i % uniq] for i in range(n)]

    def projective(cv, pts):
        """Affine points (None: the identity) -> PrjPoint on the card, each
        lane scaled by a random lambda."""
        pc = cv.fp_ctx.p_int
        lams = [1 + v % (pc - 1) for v in rand_ints(len(pts), pc)]
        cols = [[], [], []]
        for P_, lam in zip(pts, lams):
            for col, v in zip(cols, (0, lam, 0) if P_ is None else
                              (P_[0] * lam, P_[1] * lam, lam)):
                col.append(v % pc)
        return PrjPoint(*[cv.fp_ctx.from_ints(col, dev) for col in cols])

    def affine_of(cv, P, i):
        ctx_, pc = cv.fp_ctx, cv.fp_ctx.p_int
        z = ctx_.to_ints(P.z[:, i:i + 1])[0]
        if z == 0:
            return None
        zi = pow(z, -1, pc)
        return (ctx_.to_ints(P.x[:, i:i + 1])[0] * zi % pc,
                ctx_.to_ints(P.y[:, i:i + 1])[0] * zi % pc)

    def check_w_kernels(cv, cw, label, compare, mont_n=MONT_N):
        """Kernels 1-4 of one curve against their plain versions, bitwise,
        and their first lanes against the host oracle: kernel 1 under p and
        q; kernels 2 and 3 with the lanes P + O, O + Q, O + O, P = Q and
        P = -Q; kernel 4 at N lanes with the window edge scalars, two short
        scalars and the identity on lane 7 (against its plain version here
        with compare, else in the kernel's timed row, on the same inputs).
        Kernel 1 runs at mont_n lanes.
        Returns the point pairs (affine A, B and projective PA, PB) of
        kernels 2 and 3 and kernel 4's table and digits."""
        names = w_names(cv)
        check_mont(cv.fp_ctx, f"{label}'s p", mont_n)
        check_mont(cv.q_ctx, f"{label}'s q", mont_n)
        A, B = w_points(cv, cw, POINT_N), w_points(cv, cw, POINT_N)
        B[0], A[1] = None, None                         # identity lanes
        A[2] = B[2] = None
        B[3] = A[3]                                     # P = Q
        B[4] = H.ec_neg(cw, A[4])                       # P = -Q
        PA, PB = projective(cv, A), projective(cv, B)
        S, D = point.point_add(cv, PA, PB), point.point_dbl(cv, PA)
        cmp(names["point_add"], S, point.point_add_plain(cv, PA, PB),
            POINT_N, f" ({label})")
        cmp(names["point_dbl"], D, point.point_dbl_plain(cv, PA), POINT_N,
            f" ({label})")
        for i in range(8):
            _check(affine_of(cv, S, i) == H.ec_add(cw, A[i], B[i]),
                   f"{names['point_add']} ({label}) lane {i} disagrees with "
                   "the host oracle")
            _check(affine_of(cv, D, i) == H.ec_add(cw, A[i], A[i]),
                   f"{names['point_dbl']} ({label}) lane {i} disagrees with "
                   "the host oracle")
        wpts = w_points(cv, cw, N)
        wpts[7] = None
        ms = H.window_edge_scalars(cv.q) + [5, (1 << 37) + 3]
        ms += rand_ints(N - len(ms), cv.q)
        table = scalar_mul._build_mul_table(cv, projective(cv, wpts))
        digs = scalar_mul._window_digits(
            nn.upload(nn.batch_to_limbs(ms, cv.q_ctx.k), dev),
            cv.scalar_bits())
        name = names["windowed_mul"]
        got = megamul.windowed_mul(cv, table, digs, PrjPoint)
        if compare:
            t0 = time.perf_counter()
            want = megamul.windowed_mul_plain(cv, table, digs, PrjPoint)
            print(f"{name} plain ({label}) at N={N}: "
                  f"{time.perf_counter() - t0:.1f} s")
            cmp(name, got, want, N, f" ({label}, {digs.shape[0]} windows)")
        for i in range(8):
            _check(affine_of(cv, got, i) == H.ec_mul(cw, ms[i], wpts[i]),
                   f"{name} ({label}) lane {i} disagrees with the host "
                   "oracle")
        return A, B, PA, PB, (table, digs)

    def ecdsa_fixture(cv, cw, label, hname, unique=UNIQUE, batch=BATCH):
        """unique signatures from the host signer (hash hname of 32-byte
        messages) tiled to the batch, their keys, and the corrupted batch:
        r + 1, s = 0, s = q, another message, r = q, and r = 12345 + i
        (where q < p, below p - q: the r + q candidate is tried and
        rejects) on lanes 0-59, and a key batch with off-curve keys on
        lanes 60-69. Where ceil(p/q) > 2 (the affine accept test: the
        cofactor > 1 curves) lanes 70-79 are valid signatures whose x(W)
        is at or above q (70-74 in [q, 2q), 75-79 in [2q, p)), r = x(W)
        mod q, which the corrupted batch carries with the unreduced x(W)
        as r, and the corrupted batch flips a bit of s on lanes 80-89.
        The keys are imported without the q*P check (the cofactor > 1
        curves run it on these keys in their own phase)."""
        qv, pc = cv.q, cv.fp_ctx.p_int
        copies = batch // unique
        nbq = (qv.bit_length() + 7) // 8
        digest = getattr(hashlib, hname.lower())
        affine = (pc - 1) // qv + 1 > 2
        t0 = time.perf_counter()
        ds = [1 + v % (qv - 1) for v in rand_ints(unique, qv)]
        pubs = [H.ec_base_mul(cw, d) for d in ds]
        msgs = [rng.bytes(32) for _ in range(unique)]
        sigs = []
        for d, msg in zip(ds, msgs):
            e = H.trunc_msb_mod_q(digest(msg).digest(), qv)
            r, s = H.ecdsa_sign_ref(cw, d, e, 1 + rand_ints(1, qv - 1)[0])
            sigs.append(r.to_bytes(nbq, "big") + s.to_bytes(nbq, "big"))
        wx = {}
        for i in range(70, 80) if affine else ():
            # W = k*G with x(W) in the lane's range, r = x(W) mod q, and
            # the key Y = v^-1 (W - u*G) under which (r, s) verifies
            lo, hi = (qv, 2 * qv) if i < 75 else (2 * qv, pc)
            while True:
                W = H.ec_base_mul(cw, 1 + rand_ints(1, qv - 1)[0])
                if lo <= W[0] < hi:
                    break
            r, s = W[0] % qv, 1 + rand_ints(1, qv - 1)[0]
            si = pow(s, -1, qv)
            e = H.trunc_msb_mod_q(digest(msgs[i]).digest(), qv)
            u, v = e * si % qv, r * si % qv
            pubs[i] = H.ec_mul(cw, pow(v, -1, qv), H.ec_add(
                cw, W, H.ec_neg(cw, H.ec_base_mul(cw, u))))
            sigs[i] = r.to_bytes(nbq, "big") + s.to_bytes(nbq, "big")
            wx[i] = W[0]
        pubs, msgs, sigs = pubs * copies, msgs * copies, sigs * copies
        kb = K_.pubkey_batch_from_affine_ints(
            cv, "ECDSA", [P_[0] for P_ in pubs], [P_[1] for P_ in pubs],
            check_order=False)
        print(f"{label} fixture: {unique} unique host signatures ({hname}) "
              f"tiled to {batch} in {time.perf_counter() - t0:.1f} s")
        bad_m, bad_s = list(msgs), list(sigs)

        def put(i, r=None, s=None):
            r = int.from_bytes(sigs[i][:nbq], "big") if r is None else r
            s = int.from_bytes(sigs[i][nbq:], "big") if s is None else s
            bad_s[i] = r.to_bytes(nbq, "big") + s.to_bytes(nbq, "big")

        for i in range(0, 10):                          # r + 1
            put(i, r=int.from_bytes(sigs[i][:nbq], "big") + 1)
        for i in range(10, 20):                         # s = 0
            put(i, s=0)
        for i in range(20, 30):                         # s = q
            put(i, s=qv)
        for i in range(30, 40):                         # another message
            bad_m[i] = bytes([msgs[i][0] ^ 0x5A]) + msgs[i][1:]
        for i in range(40, 50):                         # r = q
            put(i, r=qv)
        for i in range(50, 60):          # r < p - q: the r + q candidate
            put(i, r=12345 + i)          # is tried and rejects
        want_bad = np.ones(batch, bool)
        want_bad[:60] = False
        for i, x in wx.items():                         # r = x(W) >= q
            put(i, r=x)
            want_bad[i] = False
        for i in range(80, 90) if affine else ():       # a flipped bit of s
            put(i, s=int.from_bytes(sigs[i][nbq:], "big") ^ 1)
            want_bad[i] = False
        # the affine accept test's lanes against the host oracle: two of
        # each corruption, lanes 70-89 and two valid ones
        for i in ({0, 1, 10, 11, 20, 21, 30, 31, 40, 41, 50, 51, 90, 91,
                   *range(70, 90)} if affine else ()):
            e = H.trunc_msb_mod_q(digest(bad_m[i]).digest(), qv)
            r, s = (int.from_bytes(bad_s[i][j:j + nbq], "big")
                    for j in (0, nbq))
            _check(H.ecdsa_verify_ref(cw, pubs[i], e, r, s) == want_bad[i],
                   f"{label} fixture: lane {i} is not what the host oracle "
                   "says")
        off = list(range(60, 70))                       # off-curve keys
        bad_pub = PrjPoint(*[t.clone() for t in kb.pub])
        bad_pub.y[:, off] = cv.fp_ctx.from_ints(
            [(pubs[i][1] + 1) % pc for i in off], dev)
        want_off = np.ones(batch, bool)
        want_off[off] = False
        return SimpleNamespace(
            hname=hname, digest=digest, pubs=pubs,
            kb=kb, msgs=msgs, sigs=sigs, bad_m=bad_m, bad_s=bad_s,
            want_bad=want_bad, want_off=want_off,
            kb_off=K_.KeyBatch(curve=cv, alg="ECDSA", n=batch, pub=bad_pub))

    def ecdsa_entry_points(cv, fx, label):
        """The four ECDSA entry points on the valid, the corrupted and the
        off-curve batches, the counts set to 0 first. Returns the launches
        of this run; each of kernels 1-4 must be among them."""
        hn = fx.hname
        reset()
        acc = ecdsa.verify_batch(fx.kb, fx.msgs, fx.sigs, hn)
        _check(acc.all(), f"{label}: verify_batch rejected "
                          f"{int((~acc).sum())} valid lanes")
        acc = ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hn)
        _check(acc.device.type == "cuda" and bool(acc.all()),
               f"{label}: verify_batch_async rejected valid lanes")
        bad_digs = [fx.digest(m_).digest() for m_ in fx.bad_m]
        for what, acc, want in (
                ("verify_batch", ecdsa.verify_batch(fx.kb, fx.bad_m,
                                                    fx.bad_s, hn),
                 fx.want_bad),
                ("verify_batch_async", ecdsa.verify_batch_async(
                    fx.kb, fx.bad_m, fx.bad_s, hn).cpu().numpy(),
                 fx.want_bad),
                ("verify_digests_batch", ecdsa.verify_digests_batch(
                    fx.kb, bad_digs, fx.bad_s, hn), fx.want_bad),
                ("verify_batch (off-curve keys)", ecdsa.verify_batch(
                    fx.kb_off, fx.msgs, fx.sigs, hn), fx.want_off)):
            _check((acc == want).all(),
                   f"{label}: {what}: corrupted lanes wrong "
                   f"({np.flatnonzero(acc != want)[:20].tolist()})")
        stream = [(fx.msgs, fx.sigs), (fx.bad_m, fx.bad_s)] * 2
        outs = list(ecdsa.verify_batches(fx.kb, stream, hn, depth=3))
        expect = [np.ones(BATCH, bool), fx.want_bad] * 2
        _check(len(outs) == 4 and all((o == w).all()
                                      for o, w in zip(outs, expect)),
               f"{label}: verify_batches: wrong accept masks")
        path = snapshot()
        print(f"{label} path launches:",
              json.dumps({k_: v for k_, v in path.items() if v}))
        for name in w_names(cv).values():
            _check(path[name] >= 1,
                   f"kernel {name} was not launched on the {label} path")
        print(f"{label} path ({hn}): valid lanes accept; r + 1, s = 0, "
              "s = q, another message, r = q, r < p - q and off-curve keys "
              "reject (verify_batch, verify_batch_async, "
              "verify_digests_batch, verify_batches)")
        return path

    def wycheproof_ecdsa(cv, cname, label):
        """The curve's 36 Wycheproof ECDSA rows (SHA-256) through
        verify_batch, verify_batch_async and verify_batches; the
        well-formed ones also through the fused bytes-in path, grouped by
        message length and tiled to 64 lanes; the malformed ones raise
        ValueError."""
        nb = (cv.q.bit_length() + 7) // 8
        with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
            rows = [v for v in map(json.loads, f)
                    if v["scheme"] == "ECDSA" and v["curve"] == cname]
        _check(len(rows) == 36, f"expected 36 {label} Wycheproof rows, got "
                                f"{len(rows)}")
        good = [v for v in rows if len(bytes.fromhex(v["sig"])) == 2 * nb]
        wkb = K_.import_pub_raw(cv, "ECDSA", [bytes.fromhex(v["pub"])
                                              for v in good])
        wm = [bytes.fromhex(v["msg"]) for v in good]
        ws = [bytes.fromhex(v["sig"]) for v in good]
        want_w = np.array([v["result"] == "valid" for v in good])
        for g in (ecdsa.verify_batch(wkb, wm, ws),
                  ecdsa.verify_batch_async(wkb, wm, ws).cpu().numpy(),
                  next(iter(ecdsa.verify_batches(wkb, [(wm, ws)])))):
            _check((g == want_w).all(),
                   f"Wycheproof {label} rows: wrong results")
        fused_rows = 0
        for mlen in sorted({len(m_) for m_ in wm}):
            idx = [i for i, m_ in enumerate(wm) if len(m_) == mlen]
            idx = idx * -(-64 // len(idx))
            gkb = K_.import_pub_raw(cv, "ECDSA", [
                bytes.fromhex(good[i]["pub"]) for i in idx])
            gm, gs = [wm[i] for i in idx], [ws[i] for i in idx]
            _check(ecdsa._fused_applicable(gm, gs, nb),
                   f"Wycheproof rows of {mlen}-byte messages: not fused")
            for g in (ecdsa.verify_batch_async(gkb, gm, gs).cpu().numpy(),
                      next(iter(ecdsa.verify_batches(gkb, [(gm, gs)])))):
                _check((g == want_w[idx]).all(),
                       f"Wycheproof {label} rows of {mlen}-byte messages: "
                       "wrong results on the fused bytes-in path")
            fused_rows += len(set(idx))
        _check(fused_rows == len(good), "Wycheproof rows left out of the "
                                        "fused check")
        for v in rows:
            if v in good:
                continue
            one = K_.import_pub_raw(cv, "ECDSA", [bytes.fromhex(v["pub"])])
            try:
                ecdsa.verify_batch(one, [bytes.fromhex(v["msg"])],
                                   [bytes.fromhex(v["sig"])])
                _fail(f"Wycheproof tcId {v['tcId']}: malformed signature "
                      "accepted by the API")
            except ValueError:
                _check(v["result"] != "valid", "malformed row is valid")
        print(f"Wycheproof: {len(rows)} {label} rows give their recorded "
              f"results ({int(want_w.sum())} valid); the {fused_rows} "
              "well-formed rows also through the fused bytes-in path, "
              "tiled to 64 lanes")

    def w_kern(cv, PA, PB, wtab):
        """Kernels 1-4 of a curve at its path's shapes (N = 8192): kernel 1
        on random operands, 2 and 3 on the edge lanes, 4 on check_w_kernels'
        table and digits (edge scalars among them). Each entry: the kernel,
        its plain version, their repetitions and the bytes and multiply-add
        slots of the work."""
        ctx_, k_ = cv.fp_ctx, cv.fp_ctx.k
        fe, fmul, fsqr = 4 * k_, fmul_slots(k_), fsqr_slots(k_)
        # per window (squares, products); an add's and a double's products
        per_win = W_PER_WINDOW[a_tag(cv)][0]
        add_mu, dbl_mu = ADD_DBL_PRODUCTS[a_tag(cv)]
        a_ = nn.upload(nn.batch_to_limbs(rand_ints(N, ctx_.p_int), k_), dev)
        b_ = nn.upload(nn.batch_to_limbs(rand_ints(N, ctx_.p_int), k_), dev)
        tab, digs = wtab
        nwin = digs.shape[0]
        names = w_names(cv)
        return {
            names["mont_mul"]: (lambda: mont.mont_mul(a_, b_, ctx_),
                                lambda: nn.mont_mul(a_, b_, ctx_), 200, 20,
                                N * 3 * fe, N * fmul),
            names["mont_sqr"]: (lambda: mont.mont_sqr(a_, ctx_),
                                lambda: nn.mont_sqr(a_, ctx_), 200, 20,
                                N * 2 * fe, N * fsqr),
            names["point_add"]: (lambda: point.point_add(cv, PA, PB),
                                 lambda: point.point_add_plain(cv, PA, PB),
                                 100, 3, N * 9 * fe, N * add_mu * fmul),
            names["point_dbl"]: (lambda: point.point_dbl(cv, PA),
                                 lambda: point.point_dbl_plain(cv, PA),
                                 100, 3, N * 6 * fe,
                                 N * (3 * fsqr + dbl_mu * fmul)),
            names["windowed_mul"]: (
                lambda: megamul.windowed_mul(cv, tab, digs, PrjPoint),
                lambda: megamul.windowed_mul_plain(cv, tab, digs, PrjPoint),
                5, 1, N * (16 * 3 * fe + nwin * 4 + 3 * fe),
                N * nwin * (per_win[0] * fsqr + per_win[1] * fmul)),
        }

    def w_fixture(cw, sign, batch=BATCH):
        """min(UNIQUE, batch) keys, 32-byte messages and signatures
        sign(cw, d, m) from the host signers, tiled to the batch."""
        unique = min(UNIQUE, batch)
        ds = [1 + v % (cw.q - 1) for v in rand_ints(unique, cw.q)]
        pubs_ = [H.ec_base_mul(cw, d) for d in ds]
        msgs_ = [rng.bytes(32) for _ in range(unique)]
        sigs_ = [sign(cw, d, m_) for d, m_ in zip(ds, msgs_)]
        copies = batch // unique
        return pubs_ * copies, msgs_ * copies, sigs_ * copies

    # The host's share of the ECDSA and registry ECFSDSA paths, made while
    # the kernels build: each curve's comb of G (the host oracle's, then
    # uploaded; cached for the process) and its host-signed fixtures.
    hosts, combs, fixtures, f_fix = {}, {}, {}, {}
    e_hash = {**{cn: (lb, W_HASH.get(cn, "SHA256"))
                 for cn, lb in W_CURVES.items()},
              **R_CURVES, **COF_CURVES,
              **{cn: (lb, "SHA256") for cn, lb in R_SHARED.items()}}
    for cname, (label, hname) in e_hash.items():
        cv = params.get_curve(cname)
        cw = H.WCurve(cv.fp_ctx.p_int, cv.a, cv.b, cv.gx, cv.gy, cv.q, cv.h)
        hosts[cname] = (cv, cw)
        t0 = time.perf_counter()
        combs[cname] = (scalar_mul._comb_table_dev(cv, cv.scalar_bits(), dev),
                        time.perf_counter() - t0)
        small = cname in R_SHARED or (cname in COF_CURVES
                                      and cname != "WEI448")
        fixtures[cname] = ecdsa_fixture(
            cv, cw, label, hname,
            *((SHARED_BATCH, SHARED_BATCH) if cname in R_SHARED else
              (COF_BATCH, COF_BATCH) if small else ()))
    for cname, (label, hname) in F_CURVES.items():
        cv, cw = hosts[cname]
        pubs_, msgs_, sigs_ = w_fixture(
            cw, lambda cw_, d, m_, hn=hname: H.ecfsdsa_sign_ref(
                cw_, d, 1 + rand_ints(1, cw_.q - 1)[0], m_, hn),
            BATCH if cname in FSDSA_FULL else FSDSA_SMALL)
        f_fix[cname] = (K_.pubkey_batch_from_affine_ints(
            cv, "ECFSDSA", [P_[0] for P_ in pubs_], [P_[1] for P_ in pubs_]),
            msgs_, sigs_)
    # the cofactor > 1 curves: ECFSDSA fixtures (their keys imported, with
    # the q*P check, in their phase) and three points of small order each
    cof_ffix, cof_T = {}, {}
    for cname, (label, hname) in COF_CURVES.items():
        cv, cw = hosts[cname]
        cof_ffix[cname] = w_fixture(
            cw, lambda cw_, d, m_, hn=hname: H.ecfsdsa_sign_ref(
                cw_, d, 1 + rand_ints(1, cw_.q - 1)[0], m_, hn),
            BATCH if cname == "WEI448" else COF_BATCH)
        cof_T[cname] = [H.ec_small_order_point(cw, x0) for x0 in (2, 42, 82)]
    print(f"host fixtures and combs of {len(e_hash)} curves made while the "
          "kernels build")
    wait_for_build()

    # Per curve: its comb of G (built once per process), kernels 1-4
    # against their plain versions, the host-signed fixture, the entry
    # points on valid and corrupted batches with the path's own launch
    # counts, the Wycheproof rows where there are some, the batch's
    # measurements (verify_batch_async, bytes in, accept mask out: its
    # stage breakdown from the stage marks and the profiler's busy share)
    # and each kernel at the path's shapes. GOST512 runs BrainpoolP512r1's
    # K = 16 instances: their rows are timed on BrainpoolP512r1's path and
    # carry GOST512's launches beside. P-521's batch is hashed with SHA-512
    # (the unfused path: "digest" where the fused one marks "hash").
    w_curves, w_counts, w_report = {}, {}, {}
    for cname, label in W_CURVES.items():
        cv, cw = hosts[cname]
        comb_, comb_s = combs[cname]
        comb_bytes = comb_.numel() * comb_.element_size()
        print(f"{label} comb: {comb_.shape[0]} windows x 256 entries, "
              f"{comb_bytes} bytes on the device, first build {comb_s:.2f} s "
              "(cached for the process)")
        # GOST512's kernel 4 is compared here; the others' in their rows
        A, B, PA, PB, wtab = check_w_kernels(cv, cw, label,
                                             cname == "GOST512")
        w_curves[cname] = (cv, cw, A, B, PA, PB)
        hname = W_HASH.get(cname, "SHA256")
        fx = fixtures[cname]
        w_counts[cname] = ecdsa_entry_points(cv, fx, label)
        if cname in W_WYCHEPROOF:
            wycheproof_ecdsa(cv, cname, label)
        first = "hash" if hname in ecdsa.FUSED_HASHES else "digest"
        rep, _ = time_batch(
            lambda: ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hname),
            f"{label} ECDSA verify", [first, "scalars", "key on curve",
                                      "comb", "table", "windowed", "accept",
                                      "return"],
            lambda acc_: bool(acc_.all()))
        rep["hash"] = hname
        rep["comb_bytes"] = comb_bytes
        rep["comb_first_build_s"] = round(comb_s, 3)
        w_report[cname] = rep
        if cname == "SECP256R1":
            nb = 8
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            for o in ecdsa.verify_batches(fx.kb, [(fx.msgs, fx.sigs)] * nb,
                                          depth=3):
                _check(o.all(), "verify_batches rejected valid lanes")
            dt = time.perf_counter() - h0
            piped = nb * BATCH / dt
            print(f"verify_batches {nb} x {BATCH} at depth 3: "
                  f"{dt * 1e3:.1f} ms, {piped:.1f} verifies/s")
        if cname == "GOST512":
            continue
        note_sources(cv)
        time_kernels(w_kern(cv, PA, PB, wtab), w_counts[cname],
                     rep["launches_per_batch"], f"{label} ECDSA verify")
    for row in lines:
        if row["name"] in w_names(w_curves["GOST512"][0]).values():
            row["gost512_launches"] = w_counts["GOST512"][row["name"]]
    print("ECDSA verify: kernels 1-4 at K = 8 (P-256), K = 12 (P-384), "
          "K = 16 (BrainpoolP512r1 and GOST512) and K = 17 (P-521) are "
          "bitwise equal to their plain versions and agree with the host "
          "oracle")

    # the KAT rows on the card: the P-384, BrainpoolP512r1 and P-521 ECDSA
    # and DECDSA rows under every hash they name
    kat_curves = ("SECP384R1", "BRAINPOOLP512R1", "SECP521R1")
    kat_groups = {}
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        for r in map(json.loads, f):
            if r.get("alg") in ("ECDSA", "DECDSA") and r.get("curve") in (
                    kat_curves):
                kat_groups.setdefault((r["curve"], r["hash"]), []).append(
                    (bytes.fromhex(r["pub"]), bytes.fromhex(r["msg_hex"]),
                     bytes.fromhex(r["sig"])))
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        for r in map(json.loads, f):
            if r["alg"] in ("ECDSA", "DECDSA") and r["curve"] in kat_curves:
                kat_groups.setdefault((r["curve"], r["hash"]), []).append(
                    (bytes.fromhex(r["pub"]), r["msg"].encode(),
                     bytes.fromhex(r["sig"])))
    n_kat = 0
    for (cname, hname), krows in sorted(kat_groups.items()):
        cv = w_curves[cname][0]
        pc = cv.fp_ctx.p_int
        xs_, ys_, ms_, ss_, want_ = [], [], [], [], []
        for pub, msg, sig in krows:
            nbp = len(pub) // 3
            X, Y, Z = [int.from_bytes(pub[nbp * i:nbp * (i + 1)], "big")
                       for i in range(3)]
            zi = pow(Z, -1, pc)
            xs_ += [X * zi % pc] * 3
            ys_ += [Y * zi % pc] * 3
            ms_ += [msg, msg + b"x", msg]
            ss_ += [sig, sig, bytes([sig[0] ^ 1]) + sig[1:]]
            want_ += [True, False, False]
        kbk = K_.pubkey_batch_from_affine_ints(cv, "ECDSA", xs_, ys_)
        acc = ecdsa.verify_batch(kbk, ms_, ss_, hname)
        _check(acc.tolist() == want_, f"KAT rows {cname} {hname}: wrong "
                                      f"accept mask {acc.tolist()}")
        n_kat += len(krows)
    n_p521 = sum(len(v) for (cn, _), v in kat_groups.items()
                 if cn == "SECP521R1")
    _check(n_p521 == 11, f"expected 11 SECP521R1 KAT rows, got {n_p521}")
    print(f"ECDSA KATs: {n_kat} ECDSA / DECDSA rows of P-384, "
          f"BrainpoolP512r1 and P-521 ({n_p521}) under "
          f"{sorted({h for _, h in kat_groups})} accept, and reject with "
          "another message or a flipped bit")
    c, wc, A, B, PA, PB = w_curves["SECP256R1"]

    lap("the ECDSA paths")

    # 4. the Ed25519 path: kernels 1 (under p = 2^255 - 19), 8a, 8b and 7
    # against their plain versions, then eddsa.verify_batch at batch 8192 --
    ed_check_err = check_mont(ectx, "Ed25519's p")

    def ed_points(n, uniq=64):
        pts = [H.ed_base_mul(hc, v % eq) for v in rand_ints(uniq, eq)]
        return [pts[i % uniq] for i in range(n)]

    def extended(pts, cv=ec):
        ctx_, pc = cv.fp_ctx, cv.fp_ctx.p_int
        lams = [1 + v % (pc - 1) for v in rand_ints(len(pts), pc)]
        cols = [[], [], [], []]
        for (x, y), lam in zip(pts, lams):
            for col, v in zip(cols, (x * lam, y * lam, lam, x * y * lam)):
                col.append(v % pc)
        return ExtPoint(*[ctx_.from_ints(col, dev) for col in cols])

    def ed_affine_of(P, i, cv=ec):
        ctx_, pc = cv.fp_ctx, cv.fp_ctx.p_int
        zi = pow(ctx_.to_ints(P.z[:, i:i + 1])[0], -1, pc)
        return (ctx_.to_ints(P.x[:, i:i + 1])[0] * zi % pc,
                ctx_.to_ints(P.y[:, i:i + 1])[0] * zi % pc)

    EA = ed_points(POINT_N)
    EB = ed_points(POINT_N)
    ident = (0, 1)
    EB[0], EA[1] = ident, ident                         # P + O, O + Q
    EA[2] = EB[2] = ident
    EB[3] = EA[3]                                       # P = Q
    EB[4] = ((-EA[4][0]) % ep, EA[4][1])                # P = -Q
    XA, XB = extended(EA), extended(EB)
    cmp("ed_add", edpoint.ed_add(ec, XA, XB),
        edpoint.ed_add_plain(ec, XA, XB), POINT_N)
    cmp("ed_dbl", edpoint.ed_dbl(ec, XA), edpoint.ed_dbl_plain(ec, XA),
        POINT_N)
    S_ = edpoint.ed_add(ec, XA, XB)
    D_ = edpoint.ed_dbl(ec, XA)
    for i in range(8):
        _check(ed_affine_of(S_, i) == H.ed_add(hc, EA[i], EB[i]),
               f"ed_add lane {i} disagrees with the host oracle")
        _check(ed_affine_of(D_, i) == H.ed_add(hc, EA[i], EA[i]),
               f"ed_dbl lane {i} disagrees with the host oracle")

    ewpts = ed_points(WINDOWED_N)
    ems = rand_ints(WINDOWED_N, eq)
    ems[0] = ems[1] = 0                                 # all-zero scalars
    ems[2], ems[3], ems[4] = 1, 5, (1 << 37) + 3        # leading zeros
    emt = nn.upload(nn.batch_to_limbs(ems, ec.q_ctx.k), dev)
    etable = scalar_mul._build_mul_table(ec, extended(ewpts))
    edigs = scalar_mul._window_digits(emt, ec.scalar_bits())
    t0 = time.perf_counter()
    want = megamul.windowed_mul_plain(ec, etable, edigs, ExtPoint)
    print(f"windowed_mul_ed plain at N={WINDOWED_N}: "
          f"{time.perf_counter() - t0:.1f} s")
    got = megamul.windowed_mul(ec, etable, edigs, ExtPoint)
    cmp("windowed_mul_ed", got, want, WINDOWED_N)
    for i in range(6):
        _check(ed_affine_of(got, i) == H.ed_mul(hc, ems[i], ewpts[i]),
               f"windowed_mul_ed lane {i} disagrees with the host oracle")

    # fixture: 1024 unique (seed, 32-byte message, signature), tiled
    t0 = time.perf_counter()
    e_pubs, e_msgs, e_sigs = [], [], []
    for _ in range(UNIQUE):
        seed, msg = rng.bytes(32), rng.bytes(32)
        pub, sig = H.ed25519_sign(hc, seed, msg)
        e_pubs.append(pub), e_msgs.append(msg), e_sigs.append(sig)
    e_pubs, e_msgs, e_sigs = e_pubs * reps, e_msgs * reps, e_sigs * reps
    print(f"Ed25519 fixture: {UNIQUE} unique tuples from the host signer, "
          f"tiled to {BATCH}, in {time.perf_counter() - t0:.1f} s")
    bad_pk, bad_em, bad_es = list(e_pubs), list(e_msgs), list(e_sigs)
    for i in range(0, 10):                              # R with a bit flipped
        bad_es[i] = bytes([e_sigs[i][0] ^ 1]) + e_sigs[i][1:]
    for i in range(10, 20):                             # S + q
        sv = int.from_bytes(e_sigs[i][32:], "little") + eq
        bad_es[i] = e_sigs[i][:32] + sv.to_bytes(32, "little")
    for i in range(20, 30):                             # S = q
        bad_es[i] = e_sigs[i][:32] + eq.to_bytes(32, "little")
    for i in range(30, 40):                             # another message
        bad_em[i] = bytes([e_msgs[i][0] ^ 0x5A]) + e_msgs[i][1:]
    no_x = next(y for y in range(2, 100) if pow(
        (y * y - 1) * pow(ec.d * y * y + 1, -1, ep) % ep, (ep - 1) // 2,
        ep) != 1)
    for i in range(40, 50):                             # y has no x
        bad_pk[i] = no_x.to_bytes(32, "little")
    for i in range(50, 60):                             # y >= p (y = p + 1)
        bad_pk[i] = (ep + 1).to_bytes(32, "little")
    e_want_bad = np.ones(BATCH, bool)
    e_want_bad[:60] = False

    reset()
    acc = eddsa.verify_batch("ed25519", e_pubs, e_msgs, e_sigs)
    _check(acc.all(), f"eddsa.verify_batch rejected {int((~acc).sum())} "
                      "valid lanes")
    acc = eddsa.verify_batch("ed25519", bad_pk, bad_em, bad_es)
    _check((acc == e_want_bad).all(),
           "eddsa.verify_batch: corrupted lanes wrong "
           f"({np.flatnonzero(acc != e_want_bad)[:20].tolist()})")
    ed_counts = snapshot()
    print("Ed25519 path launches:", json.dumps(ed_counts))
    ed_kernels = ["mont_mul", "mont_sqr", "ed_add", "ed_dbl",
                  "windowed_mul_ed"]
    for name in ed_kernels:
        _check(ed_counts[name] >= 1,
               f"kernel {name} was not launched on the Ed25519 path")
    print("Ed25519 path: valid lanes accept; R bit flip, S + q, S = q, "
          "another message, y without x and y >= p reject")

    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        erows = [v for v in map(json.loads, f)
                 if v["scheme"] == "EDDSA" and v["curve"] == "ED25519"]
    _check(len(erows) == 15, f"expected 15 Ed25519 Wycheproof rows, got "
                             f"{len(erows)}")
    acc = eddsa.verify_batch("ed25519", [bytes.fromhex(v["pub"])
                                         for v in erows],
                             [bytes.fromhex(v["msg"]) for v in erows],
                             [bytes.fromhex(v["sig"]) for v in erows])
    _check(acc.tolist() == [v["result"] == "valid" for v in erows],
           "Wycheproof Ed25519 rows: wrong results")
    variants = {"EDDSA25519": "ed25519", "EDDSA25519CTX": "ed25519ctx",
                "EDDSA25519PH": "ed25519ph"}
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        kats = [r for r in map(json.loads, f) if r.get("alg") in variants]
    _check(len(kats) == 8, f"expected 8 EDDSA25519 KAT rows, got {len(kats)}")
    for r in kats:
        ctx_ = bytes.fromhex(r["adata_hex"]) if r["adata_hex"] else b""
        seed, msg = bytes.fromhex(r["priv"]), bytes.fromhex(r["msg_hex"])
        sig = bytes.fromhex(r["sig"])
        pub, mine = H.ed25519_sign(hc, seed, msg, variants[r["alg"]], ctx_)
        _check(mine == sig, f"{r['name']}: the host signer differs")
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        acc = eddsa.verify_batch(variants[r["alg"]], [pub] * 3,
                                 [msg, msg + b"x", msg], [sig, sig, bad],
                                 context=ctx_)
        _check(acc.tolist() == [True, False, False],
               f"{r['name']}: wrong accept mask {acc.tolist()}")
    print(f"Ed25519 vectors: {len(erows)} Wycheproof rows and {len(kats)} "
          "KAT rows give their recorded results on the card")

    # measurements of the Ed25519 batch (eddsa.verify_batch, bytes in,
    # accept mask out)
    ed25519, e_marked = time_batch(
        lambda: eddsa.verify_batch("ed25519", e_pubs, e_msgs, e_sigs),
        "Ed25519 verify", ["parse", "challenge", "decode", "comb", "table",
                           "windowed", "accept", "return"],
        lambda acc_: bool(acc_.all()))
    e_per_batch = ed25519["launches_per_batch"]

    # kernels 8a, 8b and 7 at the Ed25519 path's shapes (N = 8192)
    XA8 = ExtPoint(*[t[:, :N].contiguous() for t in XA])
    XB8 = ExtPoint(*[t[:, :N].contiguous() for t in XB])
    etab8, edigs8 = e_marked["table"]     # the verify batch's own
    ed_kern = {
        "ed_add": (lambda: edpoint.ed_add(ec, XA8, XB8),
                   lambda: edpoint.ed_add_plain(ec, XA8, XB8), 100, 3,
                   N * 384, N * 9 * FMUL_SLOTS),
        "ed_dbl": (lambda: edpoint.ed_dbl(ec, XA8),
                   lambda: edpoint.ed_dbl_plain(ec, XA8), 100, 3,
                   N * 224, N * (4 * FSQR_SLOTS + 4 * FMUL_SLOTS)),
        "windowed_mul_ed": (
            lambda: megamul.windowed_mul(ec, etab8, edigs8, ExtPoint),
            lambda: megamul.windowed_mul_plain(ec, etab8, edigs8, ExtPoint),
            10, 1, N * (16 * 128 + 64 * 4 + 128),
            N * 64 * (ED_PER_WINDOW[0] * FSQR_SLOTS
                      + ED_PER_WINDOW[1] * FMUL_SLOTS)),
    }
    source.update({"ed_add": "edpoint.cu", "ed_dbl": "edpoint.cu",
                   "windowed_mul_ed": "windowed.cu"})
    replaces.update({
        "ed_add": "libecc_tpu/ops/pallas/edpoint.py:110",
        "ed_dbl": "libecc_tpu/ops/pallas/edpoint.py:126",
        "windowed_mul_ed": "libecc_tpu/ops/pallas/megamul.py:161",
    })
    time_kernels(ed_kern, ed_counts, e_per_batch, "Ed25519 verify")

    # kernel 1 on the Ed25519 path: under p = 2^255 - 19 at N = 2 * BATCH
    # (the one decode of A and R), on the decode's own operands: x and y,
    # the factors of its last product (x*y), and y, the operand of its
    # first square. Kernel 1's rows carry these numbers under "ed25519".
    dP = e_marked["decode"][0]
    dx, dy = dP.x.contiguous(), dP.y.contiguous()
    n2 = dx.shape[1]
    _check(n2 == 2 * BATCH, f"the Ed25519 decode ran {n2} lanes")
    ed_mont = {
        "mont_mul": (lambda: mont.mont_mul(dx, dy, ectx),
                     lambda: nn.mont_mul(dx, dy, ectx), 200, 20,
                     n2 * 96, n2 * FMUL_SLOTS),
        "mont_sqr": (lambda: mont.mont_sqr(dy, ectx),
                     lambda: nn.mont_sqr(dy, ectx), 200, 20,
                     n2 * 64, n2 * FSQR_SLOTS),
    }
    for row in lines:
        if row["name"] in ed_mont:
            name = row["name"]
            m = measure(name, *ed_mont[name], n=n2)
            m["max_abs_err"] = max(m["max_abs_err"], ed_check_err[name])
            row["ed25519"] = {"launches": ed_counts[name],
                              "launches_per_batch": e_per_batch[name], **m}
            row["max_abs_err"] = results[name]["max_abs_err"]

    lap("the Ed25519 path")

    # 5. the Ed448 path (K = 14, a = 1): kernels 1, 8a, 8b and 7 at K = 14
    # against their plain versions, then eddsa.verify_batch("ed448") at
    # batch 8192 -----------------------------------------------------------
    x4 = edwards.get_edwards_curve("ED448")
    xctx = x4.fp_ctx
    xp, xq, k14 = xctx.p_int, x4.q, xctx.k
    hx = H.EdCurve(xp, x4.a, x4.d, x4.gx, x4.gy, xq, x4.h)
    fmul14, fsqr14 = fmul_slots(k14), fsqr_slots(k14)
    # kernel 1 under p = 2^448 - 2^224 - 1 (top limb 0xFFFFFFFF) at the
    # decode's width
    xn = 2 * BATCH
    check_mont(xctx, "Ed448's p", xn)

    def x_points(n, uniq=64):
        pts = [H.ed_base_mul(hx, v) for v in rand_ints(uniq, xq)]
        return [pts[i % uniq] for i in range(n)]

    XA_ = x_points(POINT_N)
    XB_ = x_points(POINT_N)
    XB_[0], XA_[1] = ident, ident                       # P + O, O + Q
    XA_[2] = XB_[2] = ident                             # O + O
    XB_[3] = XA_[3]                                     # P = Q
    XB_[4] = ((-XA_[4][0]) % xp, XA_[4][1])             # P = -Q
    XA4, XB4 = extended(XA_, x4), extended(XB_, x4)
    cmp("ed_add_k14", edpoint.ed_add(x4, XA4, XB4),
        edpoint.ed_add_plain(x4, XA4, XB4), POINT_N)
    cmp("ed_dbl_k14", edpoint.ed_dbl(x4, XA4),
        edpoint.ed_dbl_plain(x4, XA4), POINT_N)
    S4 = edpoint.ed_add(x4, XA4, XB4)
    D4 = edpoint.ed_dbl(x4, XA4)
    for i in range(8):
        _check(ed_affine_of(S4, i, x4) == H.ed_add(hx, XA_[i], XB_[i]),
               f"ed_add_k14 lane {i} disagrees with the host oracle")
        _check(ed_affine_of(D4, i, x4) == H.ed_add(hx, XA_[i], XA_[i]),
               f"ed_dbl_k14 lane {i} disagrees with the host oracle")

    xwpts = x_points(WINDOWED_N)
    xms = rand_ints(WINDOWED_N, xq)
    xms[0] = xms[1] = 0                                 # all-zero scalars
    xms[2], xms[3], xms[4] = 1, 5, (1 << 37) + 3        # leading zeros
    xmt = nn.upload(nn.batch_to_limbs(xms, x4.q_ctx.k), dev)
    xtable = scalar_mul._build_mul_table(x4, extended(xwpts, x4))
    xdigs = scalar_mul._window_digits(xmt, x4.scalar_bits())
    _check(xdigs.shape[0] == 112, f"Ed448 digits: {xdigs.shape[0]} windows")
    t0 = time.perf_counter()
    want = megamul.windowed_mul_plain(x4, xtable, xdigs, ExtPoint)
    print(f"windowed_mul_ed_k14 plain at N={WINDOWED_N}: "
          f"{time.perf_counter() - t0:.1f} s")
    got = megamul.windowed_mul(x4, xtable, xdigs, ExtPoint)
    cmp("windowed_mul_ed_k14", got, want, WINDOWED_N)
    for i in range(6):
        _check(ed_affine_of(got, i, x4) == H.ed_mul(hx, xms[i], xwpts[i]),
               f"windowed_mul_ed_k14 lane {i} disagrees with the host oracle")

    # the comb of the verify path: 56 windows of 256 entries, built once on
    # the host (hostref.ed_base_comb) and kept on the device
    t0 = time.perf_counter()
    comb448 = scalar_mul._comb_table_dev(x4, x4.scalar_bits(), dev)
    comb_s = time.perf_counter() - t0
    comb_bytes = comb448.numel() * comb448.element_size()
    print(f"Ed448 comb: {comb448.shape[0]} windows x {comb448.shape[2]} "
          f"entries, {comb_bytes} bytes on the device, first build "
          f"{comb_s:.2f} s (cached for the process)")

    # fixture: 1024 unique (57-byte seed, 32-byte message, signature) from
    # the port's RFC 8032 Ed448 signer, tiled
    t0 = time.perf_counter()
    x_pubs, x_msgs, x_sigs = [], [], []
    for _ in range(UNIQUE):
        seed, msg = rng.bytes(57), rng.bytes(32)
        pub, sig = H.ed448_sign(hx, seed, msg)
        x_pubs.append(pub), x_msgs.append(msg), x_sigs.append(sig)
    x_pubs, x_msgs, x_sigs = x_pubs * reps, x_msgs * reps, x_sigs * reps
    print(f"Ed448 fixture: {UNIQUE} unique tuples from the host signer, "
          f"tiled to {BATCH}, in {time.perf_counter() - t0:.1f} s")

    def x_enc(v):
        return v.to_bytes(57, "little")

    def x_s(sg):
        return int.from_bytes(sg[57:], "little")

    bad_xp, bad_xm, bad_xs = list(x_pubs), list(x_msgs), list(x_sigs)
    for i in range(0, 10):                              # R with a bit flipped
        bad_xs[i] = bytes([x_sigs[i][0] ^ 1]) + x_sigs[i][1:]
    for i in range(10, 20):                             # S + q
        bad_xs[i] = x_sigs[i][:57] + x_enc(x_s(x_sigs[i]) + xq)
    for i in range(20, 30):                             # S = q
        bad_xs[i] = x_sigs[i][:57] + x_enc(xq)
    for i in range(30, 40):                             # S >= 2^448
        bad_xs[i] = x_sigs[i][:57] + x_enc(x_s(x_sigs[i]) + (1 << 448))
    for i in range(40, 50):                             # another message
        bad_xm[i] = bytes([x_msgs[i][0] ^ 0x5A]) + x_msgs[i][1:]
    x_no_x = next(y for y in range(2, 100) if pow(
        (y * y - 1) * pow(x4.d * y * y - 1, -1, xp) % xp, (xp - 1) // 2,
        xp) != 1)
    for i in range(50, 60):                             # y has no x
        bad_xp[i] = x_enc(x_no_x)
    for i in range(60, 70):                             # y >= p (y = p + 1)
        bad_xp[i] = x_enc(xp + 1)
    for i in range(70, 77):                             # y + 2^(448..454)
        bad_xp[i] = x_enc(int.from_bytes(x_pubs[i], "little")
                          | 1 << (448 + i - 70))
    for i in range(80, 90):                             # x = 0, sign bit set
        bad_xp[i] = x_enc(1 | 1 << 455)
    x_want_bad = np.ones(BATCH, bool)
    x_want_bad[:77] = False
    x_want_bad[80:90] = False

    reset()
    acc = eddsa.verify_batch("ed448", x_pubs, x_msgs, x_sigs)
    _check(acc.all(), f"eddsa.verify_batch(ed448) rejected "
                      f"{int((~acc).sum())} valid lanes")
    acc = eddsa.verify_batch("ed448", bad_xp, bad_xm, bad_xs)
    _check((acc == x_want_bad).all(),
           "eddsa.verify_batch(ed448): corrupted lanes wrong "
           f"({np.flatnonzero(acc != x_want_bad)[:20].tolist()})")
    x_counts = snapshot()
    print("Ed448 path launches:", json.dumps(x_counts))
    x_kernels = ["mont_mul_k14", "mont_sqr_k14", "ed_add_k14", "ed_dbl_k14",
                 "windowed_mul_ed_k14"]
    for name in x_kernels:
        _check(x_counts[name] >= 1,
               f"kernel {name} was not launched on the Ed448 path")
    print("Ed448 path: valid lanes accept; R bit flip, S + q, S = q, "
          "S >= 2^448, another message, y without x, y >= p, y with a bit "
          "of 448-454 set and x = 0 with the sign bit reject")

    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        xrows = [v for v in map(json.loads, f)
                 if v.get("scheme") == "EDDSA" and v.get("curve") == "ED448"]
    _check(len(xrows) == 18, f"expected 18 Ed448 Wycheproof rows, got "
                             f"{len(xrows)}")
    for ctx_ in sorted({v.get("context", "") for v in xrows}):
        vs = [v for v in xrows if v.get("context", "") == ctx_]
        acc = eddsa.verify_batch("ed448", [bytes.fromhex(v["pub"])
                                           for v in vs],
                                 [bytes.fromhex(v["msg"]) for v in vs],
                                 [bytes.fromhex(v["sig"]) for v in vs],
                                 context=bytes.fromhex(ctx_))
        _check(acc.tolist() == [v["result"] == "valid" for v in vs],
               f"Wycheproof Ed448 rows (context {ctx_!r}): wrong results")
    x_variants = {"EDDSA448": "ed448", "EDDSA448PH": "ed448ph"}
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        xkats = [r for r in map(json.loads, f) if r.get("alg") in x_variants]
    _check(len(xkats) == 11, f"expected 11 EDDSA448 KAT rows, got "
                             f"{len(xkats)}")
    for r in xkats:
        ctx_ = bytes.fromhex(r["adata_hex"]) if r["adata_hex"] else b""
        seed, msg = bytes.fromhex(r["priv"]), bytes.fromhex(r["msg_hex"])
        sig = bytes.fromhex(r["sig"])
        pub, mine = H.ed448_sign(hx, seed, msg, x_variants[r["alg"]], ctx_)
        _check(mine == sig, f"{r['name']}: the host signer differs")
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        acc = eddsa.verify_batch(x_variants[r["alg"]], [pub] * 3,
                                 [msg, msg + b"x", msg], [sig, sig, bad],
                                 context=ctx_)
        _check(acc.tolist() == [True, False, False],
               f"{r['name']}: wrong accept mask {acc.tolist()}")
    print(f"Ed448 vectors: {len(xrows)} Wycheproof rows and {len(xkats)} KAT "
          "rows (ed448ph included) give their recorded results on the card")

    # measurements of the Ed448 batch (eddsa.verify_batch, bytes in, accept
    # mask out)
    ed448, x_marked = time_batch(
        lambda: eddsa.verify_batch("ed448", x_pubs, x_msgs, x_sigs),
        "Ed448 verify", ["parse", "challenge", "decode", "comb", "table",
                         "windowed", "accept", "return"],
        lambda acc_: bool(acc_.all()))
    x_per_batch = ed448["launches_per_batch"]

    # kernels 1, 8a, 8b and 7 at K = 14 at the Ed448 path's shapes: kernel
    # 1 on the decode's own operands at 2N lanes (x and y: the factors of
    # its last product, y: the operand of its first square), 8a and 8b on
    # the edge lanes above, 7 on the verify batch's own table and digits
    xdP = x_marked["decode"][0]
    xdx, xdy = xdP.x.contiguous(), xdP.y.contiguous()
    _check(xdx.shape[1] == 2 * BATCH, f"the Ed448 decode ran "
                                      f"{xdx.shape[1]} lanes")
    XA48 = ExtPoint(*[t[:, :N].contiguous() for t in XA4])
    XB48 = ExtPoint(*[t[:, :N].contiguous() for t in XB4])
    xtab8, xdigs8 = x_marked["table"]
    fe14 = 4 * k14                                      # bytes a coordinate
    x_kern = {
        "mont_mul_k14": (lambda: mont.mont_mul(xdx, xdy, xctx),
                         lambda: nn.mont_mul(xdx, xdy, xctx), 200, 20,
                         xn * 3 * fe14, xn * fmul14),
        "mont_sqr_k14": (lambda: mont.mont_sqr(xdy, xctx),
                         lambda: nn.mont_sqr(xdy, xctx), 200, 20,
                         xn * 2 * fe14, xn * fsqr14),
        "ed_add_k14": (lambda: edpoint.ed_add(x4, XA48, XB48),
                       lambda: edpoint.ed_add_plain(x4, XA48, XB48), 100, 3,
                       N * 12 * fe14, N * ED448_ADD_PRODUCTS * fmul14),
        "ed_dbl_k14": (lambda: edpoint.ed_dbl(x4, XA48),
                       lambda: edpoint.ed_dbl_plain(x4, XA48), 100, 3,
                       N * 7 * fe14, N * (4 * fsqr14 + 4 * fmul14)),
        "windowed_mul_ed_k14": (
            lambda: megamul.windowed_mul(x4, xtab8, xdigs8, ExtPoint),
            lambda: megamul.windowed_mul_plain(x4, xtab8, xdigs8, ExtPoint),
            5, 1, N * (16 * 4 * fe14 + xdigs8.shape[0] * 4 + 4 * fe14),
            N * xdigs8.shape[0] * (ED448_PER_WINDOW[0] * fsqr14
                                   + ED448_PER_WINDOW[1] * fmul14)),
    }
    source.update({"mont_mul_k14": "mont.cu", "mont_sqr_k14": "mont.cu",
                   "ed_add_k14": "edpoint.cu", "ed_dbl_k14": "edpoint.cu",
                   "windowed_mul_ed_k14": "windowed_ed448.cu"})
    replaces.update({
        "mont_mul_k14": "libecc_tpu/ops/pallas/mont.py:297",
        "mont_sqr_k14": "libecc_tpu/ops/pallas/mont.py:297",
        "ed_add_k14": "libecc_tpu/ops/pallas/edpoint.py:110",
        "ed_dbl_k14": "libecc_tpu/ops/pallas/edpoint.py:126",
        "windowed_mul_ed_k14": "libecc_tpu/ops/pallas/megamul.py:161",
    })
    for name, args in x_kern.items():
        lines.append({
            "name": name, "route": "cuda", "shape": row_shape(name),
            "source": f"libecc_tpu_torch/csrc/{source[name]}",
            "replaces": replaces[name], "path": "Ed448 verify",
            "launches": x_counts[name],
            "launches_per_batch": x_per_batch[name],
            **measure(name, *args, n=xn if name.startswith("mont") else N),
            # over every comparison of this kernel in the run
            "max_abs_err": results[name]["max_abs_err"],
            "library_ms": None})

    lap("the Ed448 path")

    # 6. batch verification: kernels 6 (K = 8, 12, 16) and 6-ed (K = 8,
    # 14) against their plain versions, then the batch entry points
    # at 8192 signatures: ECFSDSA on P-256, P-384 and BrainpoolP512r1,
    # BIP0340 on secp256k1, EdDSA on Ed25519, Ed448 and Ed448ph ----------
    k1 = params.get_curve("SECP256K1")
    k1w = H.WCurve(k1.fp_ctx.p_int, k1.a, k1.b, k1.gx, k1.gy, k1.q)
    def straus_check(cv, hcv, P1, P2, cls, label, compare):
        """Kernel 6 or 6-ed of cv on the lanes of P1 and P2 (identity,
        P = Q and P = -Q lanes among them): zero and short scalars, the
        window edge scalars in u and, two lanes on, in v; the special lanes
        against the host oracle's u*P + v*Q (hcv: the host curve) and, with
        compare, every lane bitwise against the plain version (else the
        special lanes go into a batch path's tables, on which the kernel's
        row is timed and compared). Returns the scalars on the card, the
        tables and digits, and the number of special lanes."""
        edges = H.window_edge_scalars(cv.q)
        us = [0, 0, 1 << 100, 1, (1 << 37) + 3] + edges + [0, 1]
        vs = [0, 1 << 100, 0, 5, 3, 0, 5] + edges
        nfix, n = len(vs), P1.x.shape[1]
        us += rand_ints(n - len(us), cv.q)
        vs += rand_ints(n - len(vs), cv.q)
        kq, nbits = cv.q_ctx.k, cv.scalar_bits()
        ut = nn.upload(nn.batch_to_limbs(us, kq), dev)
        vt = nn.upload(nn.batch_to_limbs(vs, kq), dev)
        tabs = (scalar_mul._build_mul_table(cv, P1),
                scalar_mul._window_digits(ut, nbits),
                scalar_mul._build_mul_table(cv, P2),
                scalar_mul._window_digits(vt, nbits))
        ed_ = cls is ExtPoint
        name = megamul.kernel_name_of(cv, 2, "ed" if ed_ else "w")
        got = megamul.straus_mul(cv, *tabs, cls)
        if compare:
            t0 = time.perf_counter()
            want = megamul.straus_mul_plain(cv, *tabs, cls)
            print(f"{name} plain ({label}) at N={n}: "
                  f"{time.perf_counter() - t0:.1f} s")
            cmp(name, got, want, n, f" ({label}, {tabs[1].shape[0]} windows)")
        for i in range(nfix):
            if ed_:
                ok = ed_affine_of(got, i, cv) == H.ed_add(
                    hcv, H.ed_mul(hcv, us[i], ed_affine_of(P1, i, cv)),
                    H.ed_mul(hcv, vs[i], ed_affine_of(P2, i, cv)))
            else:
                ok = affine_of(cv, got, i) == H.ec_add(
                    hcv, H.ec_mul(hcv, us[i], affine_of(cv, P1, i)),
                    H.ec_mul(hcv, vs[i], affine_of(cv, P2, i)))
            _check(ok, f"{name} ({label}) lane {i} disagrees with the host "
                       "oracle")
        return ut, vt, tabs, nfix

    # kernel 6 at K = 8 (a = -3), 12 (a = -3) and 16 (generic a, on
    # BrainpoolP512r1 and on GOST512's 511-bit p), 6-ed at K = 8 (a = -1)
    # and 14 (a = 1): label -> (curve, host curve, points, point class).
    # GOST512 runs BrainpoolP512r1's K = 16 instance, whose row is timed
    # on BrainpoolP512r1: it is compared with its plain version here.
    straus_cases = {
        "P-256": (c, wc, PA, PB, PrjPoint),
        "Ed25519": (ec, hc, XA, XB, ExtPoint),
        **{W_CURVES[cn]: (*w_curves[cn][:2], *w_curves[cn][4:], PrjPoint)
           for cn in ("SECP384R1", "BRAINPOOLP512R1", "GOST512")},
        "Ed448": (x4, hx, XA4, XB4, ExtPoint),
    }
    straus_in = {label: (cv, hcv, P1, P2, cls, *straus_check(
        cv, hcv, P1, P2, cls, label, label == "GOST512"))
        for label, (cv, hcv, P1, P2, cls) in straus_cases.items()}

    # fixtures: UNIQUE host-signed signatures of each scheme, tiled to the
    # batch: ECFSDSA on P-256 (SHA-256), P-384 (SHA-384) and
    # BrainpoolP512r1 (SHA-512), BIP0340 on secp256k1, Ed448ph; Ed25519
    # and Ed448 take their verify paths' own
    t0 = time.perf_counter()

    def flip_last(sg):                  # lowest bit of s (big-endian)
        return sg[:-1] + bytes([sg[-1] ^ 1])

    def flip_s_ed(sg):                  # lowest bit of S (little-endian)
        return sg[:32] + bytes([sg[32] ^ 1]) + sg[33:]

    def flip_s_448(sg):
        return sg[:57] + bytes([sg[57] ^ 1]) + sg[58:]

    def evil(ms, i=4321):
        ms = list(ms)
        ms[i] = bytes([ms[i][0] ^ 0x5A]) + ms[i][1:]
        return ms

    def swap(ss, i, fn):
        ss = list(ss)
        ss[i] = fn(ss[i])
        return ss

    def batch_call(fn, keys, hname):
        return lambda ms, ss: fn(keys, ms, ss, hname)

    paths, inputs = {}, {}
    for name, cname, hname in (("ecfsdsa_p256", "SECP256R1", "SHA256"),
                               ("ecfsdsa_p384", "SECP384R1", "SHA384"),
                               ("ecfsdsa_bp512", "BRAINPOOLP512R1",
                                "SHA512")):
        cv, cw = w_curves[cname][:2]
        pubs_, msgs_, sigs_ = w_fixture(
            cw, lambda cw_, d, m_, hn=hname: H.ecfsdsa_sign_ref(
                cw_, d, 1 + rand_ints(1, cw_.q - 1)[0], m_, hn))
        kb_ = K_.pubkey_batch_from_affine_ints(
            cv, "ECFSDSA", [P_[0] for P_ in pubs_], [P_[1] for P_ in pubs_])
        paths[name] = batch_call(bv.ecfsdsa_verify_batch, kb_, hname)
        inputs[name] = (msgs_, sigs_, flip_last)
    pubs_, msgs_, sigs_ = w_fixture(k1w, lambda cw, d, m_: H.bip0340_sign_ref(
        cw, d, m_, rng.bytes(32)))
    kb_ = K_.pubkey_batch_from_affine_ints(
        k1, "BIP0340", [P_[0] for P_ in pubs_], [P_[1] for P_ in pubs_])
    paths["bip0340_secp256k1"] = batch_call(bv.bip0340_verify_batch, kb_,
                                            "SHA256")
    inputs["bip0340_secp256k1"] = (msgs_, sigs_, flip_last)
    ph_pubs, ph_msgs, ph_sigs = [], [], []
    for _ in range(UNIQUE):
        seed, msg = rng.bytes(57), rng.bytes(32)
        pub, sig = H.ed448_sign(hx, seed, msg, "ed448ph")
        ph_pubs.append(pub), ph_msgs.append(msg), ph_sigs.append(sig)
    print(f"batch-verify fixtures: {UNIQUE} unique ECFSDSA (P-256, P-384, "
          "BrainpoolP512r1), BIP0340 and Ed448ph signatures from the host "
          f"signers, tiled to {BATCH}, in {time.perf_counter() - t0:.1f} s")
    for name, pubs_, ms, ss, flip in (
            ("ed25519", e_pubs, e_msgs, e_sigs, flip_s_ed),
            ("ed448", x_pubs, x_msgs, x_sigs, flip_s_448),
            ("ed448ph", ph_pubs * reps, ph_msgs * reps, ph_sigs * reps,
             flip_s_448)):
        paths[name] = (lambda ms_, ss_, v=name, pk=pubs_:
                       bv.eddsa_verify_batch(v, pk, ms_, ss_))
        inputs[name] = (ms, ss, flip)

    reset()
    for name, fn in paths.items():
        ms, ss, flip = inputs[name]
        _check(fn(ms, ss) is True, f"{name}: the valid batch rejects")
        _check(fn(ms, swap(ss, 777, flip)) is False,
               f"{name}: a batch with one flipped bit of s accepts")
        _check(fn(evil(ms), ss) is False,
               f"{name}: a batch with one changed message accepts")
    bv_counts = snapshot()
    print("batch-verify path launches:",
          json.dumps({k_: v for k_, v in bv_counts.items() if v}))
    straus_names = [megamul.kernel_name_of(cv, 2, model) for cv, model in (
        (c, "w"), (ec, "ed"), (w_curves["SECP384R1"][0], "w"),
        (w_curves["BRAINPOOLP512R1"][0], "w"), (x4, "ed"))]
    for name in straus_names + [
            "mont_mul", "mont_sqr", "point_add", "point_dbl", "ed_add",
            "ed_dbl", "point_add_k12", "point_dbl_k12", "point_add_k16",
            "point_dbl_k16", "ed_add_k14", "ed_dbl_k14", "mont_mul_k14",
            "mont_sqr_k14", "mont_mul_k12", "mont_mul_k16"]:
        _check(bv_counts[name] >= 1,
               f"kernel {name} was not launched on the batch-verify path")
    print(f"batch-verify path: the valid {BATCH}-signature batches accept "
          f"({', '.join(paths)}); one flipped bit of s or one changed "
          "message rejects each")

    # the KAT rows as batches, each (label, call, messages, signatures,
    # corruption): ECFSDSA SECP256R1 and BIP0340 SECP256K1 (sig_kats.jsonl)
    # and ECFSDSA SECP384R1 and BRAINPOOLP512R1 (kats_full.jsonl), public
    # key X || Y || Z, two lanes, the second message changed; the
    # EDDSA25519 and EDDSA448 rows grouped by variant and context, the
    # first signature's s flipped
    def new_msg(ms, ss):
        return swap(ms, 1, lambda m_: m_ + b"x"), ss

    def flip_first(flip):
        return lambda ms, ss: (ms, swap(ss, 0, flip))

    def kat_keys(cv, alg, pub):
        pc, nbp = cv.fp_ctx.p_int, len(pub) // 3
        X, Y, Z = [int.from_bytes(pub[nbp * i:nbp * (i + 1)], "big")
                   for i in range(3)]
        zi = pow(Z, -1, pc)
        return K_.pubkey_batch_from_affine_ints(cv, alg, [X * zi % pc] * 2,
                                                [Y * zi % pc] * 2)

    kat_batches = []
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        skats = {(r["alg"], r["curve"]): r for r in map(json.loads, f)
                 if r["hash"] == "SHA256"}
    for alg, cv, fn in (("ECFSDSA", c, bv.ecfsdsa_verify_batch),
                        ("BIP0340", k1, bv.bip0340_verify_batch)):
        r = skats[(alg, "SECP256R1" if cv is c else "SECP256K1")]
        msg, sig = r["msg"].encode(), bytes.fromhex(r["sig"])
        kat_batches.append((f"{alg} {r['curve']} KAT row", batch_call(
            fn, kat_keys(cv, alg, bytes.fromhex(r["pub"])), "SHA256"),
            [msg] * 2, [sig] * 2, new_msg))
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        fkats = [r for r in map(json.loads, f) if r.get("alg") == "ECFSDSA"
                 and r["curve"] in ("SECP384R1", "BRAINPOOLP512R1")]
    _check(len(fkats) == 2, f"expected 2 ECFSDSA KAT rows, got {len(fkats)}")
    for r in fkats:
        cv, cw = w_curves[r["curve"]][:2]
        msg, sig = bytes.fromhex(r["msg_hex"]), bytes.fromhex(r["sig"])
        _check(H.ecfsdsa_sign_ref(cw, int(r["priv"], 16),
                                  int(r["nonce"], 16), msg, r["hash"]) == sig,
               f"{r['name']}: the host signer differs")
        kat_batches.append((r["name"], batch_call(
            bv.ecfsdsa_verify_batch,
            kat_keys(cv, "ECFSDSA", bytes.fromhex(r["pub"])), r["hash"]),
            [msg] * 2, [sig] * 2, new_msg))
    n_ed = {}
    for rows_, sign, vmap, flip in (
            (kats, lambda *a: H.ed25519_sign(hc, *a), variants, flip_s_ed),
            (xkats, lambda *a: H.ed448_sign(hx, *a), x_variants,
             flip_s_448)):
        groups = {}
        for r in rows_:
            ctx_ = bytes.fromhex(r["adata_hex"]) if r["adata_hex"] else b""
            var, msg = vmap[r["alg"]], bytes.fromhex(r["msg_hex"])
            pub, sig = sign(bytes.fromhex(r["priv"]), msg, var, ctx_)
            _check(sig == bytes.fromhex(r["sig"]),
                   f"{r['name']}: the host signer differs")
            g = groups.setdefault((var, ctx_), ([], [], []))
            for lst, v in zip(g, (pub, msg, sig)):
                lst.append(v)
        for (var, ctx_), (gp, gm, gs) in groups.items():
            n_ed[var] = n_ed.get(var, 0) + 1
            kat_batches.append((
                f"KAT rows {var} (context {ctx_!r})",
                lambda ms, ss, v=var, pk=gp, cx=ctx_: bv.eddsa_verify_batch(
                    v, pk, ms, ss, context=cx), gm, gs, flip_first(flip)))
    for label, fn, ms, ss, corrupt in kat_batches:
        _check(fn(ms, ss) is True, f"{label}: rejected as a batch")
        _check(fn(*corrupt(ms, ss)) is False,
               f"{label}: accepted as a batch, corrupted")
    print(f"batch-verify KATs: the ECFSDSA SECP256R1, SECP384R1 and "
          f"BRAINPOOLP512R1 rows, the BIP0340 SECP256K1 row, the {len(kats)} "
          f"EDDSA25519 and the {len(xkats)} EDDSA448 / EDDSA448PH rows "
          f"({len(kat_batches)} batches; EdDSA batches per variant: "
          f"{json.dumps(n_ed)}) accept; corrupted, they reject")

    # measurements of the batch paths
    bv_report, bv_marked = {}, {}
    for name, fn in paths.items():
        ms, ss, _ = inputs[name]
        marks = ["keys"] if name == "bip0340_secp256k1" else []
        marks += ["parse", "decode" if name.startswith("ed") else "lift",
                  "table", "straus", "reduce", "comb", "accept", "return"]
        bv_report[name], bv_marked[name] = time_batch(
            lambda fn=fn, ms=ms, ss=ss: fn(ms, ss), f"{name} batch verify",
            marks, lambda ok_: ok_ is True)

    # kernel 6 as built for a = 0 (secp256k1) on the BIP0340 batch's own
    # tables and digits
    btabs = bv_marked["bip0340_secp256k1"]["table"]
    cmp("straus_mul", megamul.straus_mul(k1, *btabs, PrjPoint),
        megamul.straus_mul_plain(k1, *btabs, PrjPoint), BATCH,
        " on the BIP0340 batch's tables (secp256k1, a = 0)")

    # kernels 6 and 6-ed at the batch paths' shapes (N = 8192), on a
    # batch's own tables and digits with straus_check's special lanes in
    # its first lanes. The batch's u digits are those of 128-bit z_i, half
    # of them 0, and the time depends on the digits: at K = 12 to 16 the
    # kernel takes 14-29% longer on an H100 when every lane's scalars are
    # full-size.
    def straus_row(label, batch_tabs, per_win, tile=1):
        """A kernel-6 or 6-ed row's arguments on a batch's own tables and
        digits (batch_tabs) with straus_in[label]'s special lanes, the
        lanes repeated tile times (a batch smaller than the path's 8192
        tiled to it, as the ECDSA fixtures are)."""
        cv, _, _, _, cls, _, _, check_tabs, nfix = straus_in[label]
        tabs = []
        for b, t in zip(batch_tabs, check_tabs):
            _check(b.shape == t.shape, f"{label}: the batch's tables "
                   f"{tuple(b.shape)} differ in shape from {tuple(t.shape)}")
            b = b.clone()
            b[..., :nfix] = t[..., :nfix]
            tabs.append(b.repeat(*[1] * (b.dim() - 1), tile))
        k_, ncoord = cv.fp_ctx.k, len(cls._fields)
        fe_, nwin, n = 4 * k_, tabs[1].shape[0], tabs[0].shape[-1]
        return (lambda: megamul.straus_mul(cv, *tabs, cls),
                lambda: megamul.straus_mul_plain(cv, *tabs, cls), 5, 1,
                n * (2 * 16 * ncoord * fe_ + 2 * nwin * 4 + ncoord * fe_),
                n * nwin * (per_win[0] * fsqr_slots(k_)
                            + per_win[1] * fmul_slots(k_)))

    bv_kern = dict(zip(straus_names, (
        straus_row("P-256", bv_marked["ecfsdsa_p256"]["table"],
                   W_PER_WINDOW["m3"][1]),
        straus_row("Ed25519", bv_marked["ed25519"]["table"],
                   ED_STRAUS_PER_WINDOW),
        straus_row("P-384", bv_marked["ecfsdsa_p384"]["table"],
                   W_PER_WINDOW["m3"][1]),
        straus_row("BrainpoolP512r1", bv_marked["ecfsdsa_bp512"]["table"],
                   W_PER_WINDOW["ga"][1]),
        straus_row("Ed448", bv_marked["ed448"]["table"],
                   ED448_STRAUS_PER_WINDOW))))
    for inst in megamul._KERNELS.values():
        if inst[0] in bv_kern:
            source[inst[0]] = f"{inst[2]}.cu"
            replaces[inst[0]] = "libecc_tpu/ops/pallas/megamul.py:224"
    per_batch_all = dict.fromkeys(bv_counts, 0)     # the seven batches
    for rep in bv_report.values():
        for k_, v in rep["launches_per_batch"].items():
            per_batch_all[k_] += v
    n_before = len(lines)
    time_kernels(bv_kern, bv_counts, per_batch_all, "batch verification")
    for row in lines[:n_before]:          # the older kernels on these paths
        row["batch_verify_launches"] = bv_counts[row["name"]]

    lap("the batch-verify paths")

    # 7. the rest of the cofactor-1 registry: kernels 1-4 and 6 at K = 6, 7
    # and 10, at K = 12 (generic a) and K = 16 (a = -3), kernel 6 at K = 17.
    # ECDSA verify through verify_batch_async at batch 8192 on one curve of
    # each (K, a): kernels 1-4 against their plain versions (kernel 1 at the
    # path's 8192 lanes; kernel 4 in its timed row), the host-signed
    # fixture, the valid, corrupted and off-curve batches with the path's
    # own launch counts, the batch's measurements and each kernel at the
    # path's shapes. On secp224k1 (q > p) a batch with a lane whose r is in
    # [p, q) and r - p = x(W) rejects that lane.
    def q_above_p_lane(cv, cw, fx, label):
        p_, q_ = cv.fp_ctx.p_int, cv.q
        xs_ = list(range(1, 65))
        ys_, ex = shortw.y_from_x(cv, cv.fp_ctx.from_ints(xs_, dev))
        i = int(torch.nonzero(ex)[0])
        W = (xs_[i], cv.fp_ctx.to_ints(ys_[:, i:i + 1])[0])
        r, s = p_ + W[0], 1 + rand_ints(1, q_ - 1)[0]
        m = rng.bytes(32)
        e = H.trunc_msb_mod_q(fx.digest(m).digest(), q_)
        si = pow(s, -1, q_)
        u, v = e * si % q_, r * si % q_
        Y = H.ec_mul(cw, pow(v, -1, q_), H.ec_add(
            cw, W, H.ec_neg(cw, H.ec_base_mul(cw, u))))
        _check(r < q_ and not H.ecdsa_verify_ref(cw, Y, e, r, s),
               f"{label}: the r in [p, q) lane is not what it should be")
        nb = (q_.bit_length() + 7) // 8
        pts = [Y] + fx.pubs[1:64]
        kb64 = K_.pubkey_batch_from_affine_ints(
            cv, "ECDSA", [P_[0] for P_ in pts], [P_[1] for P_ in pts])
        acc = ecdsa.verify_batch_async(
            kb64, [m] + fx.msgs[1:64],
            [r.to_bytes(nb, "big") + s.to_bytes(nb, "big")] + fx.sigs[1:64],
            fx.hname).cpu().numpy()
        _check(acc.tolist() == [False] + [True] * 63,
               f"{label}: r in [p, q) with r - p = x(W): {acc[:4]}")
        print(f"{label}: r = p + x(W) < q rejects on the fused path, beside "
              "63 valid lanes")

    def note_launches(names, counts, where):
        """Record the launches of another path in the rows of names."""
        for row in lines:
            if row["name"] in names and counts.get(row["name"]):
                row.setdefault("other_paths", {})[where] = counts[row["name"]]

    r_report, r_curves = {}, {}
    for cname, (label, hname) in R_CURVES.items():
        cv, cw = hosts[cname]
        comb_, comb_s = combs[cname]
        _, _, PA_, PB_, wtab = check_w_kernels(cv, cw, label, False, N)
        r_curves[cname] = (cv, cw, PA_, PB_)
        fx = fixtures[cname]
        reset()
        acc = ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hname)
        _check(bool(acc.all()), f"{label}: verify_batch_async rejected "
                                f"{int((~acc).sum())} valid lanes")
        for what, kb_, ms, want in (
                ("corrupted lanes", fx.kb, fx.bad_m, fx.want_bad),
                ("off-curve keys", fx.kb_off, fx.msgs, fx.want_off)):
            ss = fx.bad_s if kb_ is fx.kb else fx.sigs
            got = ecdsa.verify_batch_async(kb_, ms, ss, hname).cpu().numpy()
            _check((got == want).all(), f"{label}: {what} wrong "
                   f"({np.flatnonzero(got != want)[:20].tolist()})")
        path = snapshot()
        print(f"{label} path launches:",
              json.dumps({k_: v for k_, v in path.items() if v}))
        for name in w_names(cv).values():
            _check(path[name] >= 1,
                   f"kernel {name} was not launched on the {label} path")
        print(f"{label} path ({hname}): valid lanes accept; r + 1, s = 0, "
              "s = q, another message, r = q, r = 12345 + i and off-curve "
              "keys reject (verify_batch_async)")
        if cv.q > cv.fp_ctx.p_int:
            q_above_p_lane(cv, cw, fx, label)
        first = "hash" if hname in ecdsa.FUSED_HASHES else "digest"
        rep, _ = time_batch(
            lambda: ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hname),
            f"{label} ECDSA verify", [first, "scalars", "key on curve",
                                      "comb", "table", "windowed", "accept",
                                      "return"],
            lambda acc_: bool(acc_.all()))
        rep.update(hash=hname, comb_first_build_s=round(comb_s, 3),
                   comb_bytes=comb_.numel() * comb_.element_size())
        r_report[cname] = rep
        note_sources(cv)
        # a kernel that already has a row (kernel 1 at a K timed before)
        # carries this path's launches in it
        timed = {row["name"] for row in lines}
        kern = {name: args for name, args in w_kern(cv, PA_, PB_, wtab).items()
                if name not in timed}
        time_kernels(kern, path, rep["launches_per_batch"],
                     f"{label} ECDSA verify")
        note_launches(timed, path, f"{label} ECDSA verify")

    # the curves that share an instance: the valid, corrupted and off-curve
    # batches at SHARED_BATCH, each launching its instance's kernels 1-4
    shared = {}
    for cname, label in R_SHARED.items():
        cv = hosts[cname][0]
        fx = fixtures[cname]
        reset()
        for kb_, ms, ss, want in (
                (fx.kb, fx.msgs, fx.sigs, np.ones(SHARED_BATCH, bool)),
                (fx.kb, fx.bad_m, fx.bad_s, fx.want_bad),
                (fx.kb_off, fx.msgs, fx.sigs, fx.want_off)):
            got = ecdsa.verify_batch_async(kb_, ms, ss).cpu().numpy()
            _check((got == want).all(), f"{label}: wrong accept mask "
                   f"({np.flatnonzero(got != want)[:20].tolist()})")
        path = snapshot()
        for name in w_names(cv).values():
            _check(path[name] >= 1,
                   f"kernel {name} was not launched on the {label} path")
        shared[cname] = {name: path[name] for name in w_names(cv).values()}
        print(f"{label} (batch {SHARED_BATCH}): valid lanes accept, the "
              "corrupted lanes and off-curve keys reject; launches "
              + json.dumps(shared[cname]))

    lap("the registry ECDSA paths")

    # ECFSDSA batch verification on each new kernel-6 instance: P-521
    # (SHA-512), P-224 (SHA-224), BrainpoolP384r1 (SHA-384) and
    # BrainpoolP512t1 (SHA-512) at batch 8192, measured as the batch paths
    # above; the other instances at FSDSA_SMALL. Each batch accepts and
    # rejects with one flipped bit of s or one changed message; kernel 6 is
    # checked on straus_check's special lanes against the host oracle, then
    # timed and held against its plain version on the batch's own tables
    # with those lanes written in, at FSDSA_SMALL tiled to BATCH lanes.
    f_curves = {"SECP521R1": (*w_curves["SECP521R1"][:2],
                              *w_curves["SECP521R1"][4:]), **r_curves}
    f_report = {}
    for cname, (label, hname) in F_CURVES.items():
        cv, cw, P1, P2 = f_curves[cname]
        n = BATCH if cname in FSDSA_FULL else FSDSA_SMALL
        P1, P2 = [PrjPoint(*[t[:, :n].contiguous() for t in P_])
                  for P_ in (P1, P2)]
        straus_in[label] = (cv, cw, P1, P2, PrjPoint, *straus_check(
            cv, cw, P1, P2, PrjPoint, label, False))
        kb_, msgs_, sigs_ = f_fix[cname]
        fn = batch_call(bv.ecfsdsa_verify_batch, kb_, hname)
        reset()
        _check(fn(msgs_, sigs_) is True, f"ECFSDSA {label}: the valid "
                                         "batch rejects")
        _check(fn(msgs_, swap(sigs_, n // 2 + 1, flip_last)) is False,
               f"ECFSDSA {label}: one flipped bit of s accepts")
        _check(fn(evil(msgs_, n // 3), sigs_) is False,
               f"ECFSDSA {label}: one changed message accepts")
        path = snapshot()
        sname = megamul.kernel_name_of(cv, 2)
        for name in (sname, w_names(cv)["point_add"],
                     w_names(cv)["point_dbl"]):
            _check(path[name] >= 1, f"kernel {name} was not launched on "
                                    f"the ECFSDSA {label} path")
        print(f"ECFSDSA {label} ({hname}, batch {n}): the valid batch "
              "accepts; one flipped bit of s or one changed message "
              "rejects; launches " + json.dumps(
                  {k_: v for k_, v in path.items() if v}))
        fmarks = ["parse", "lift", "table", "straus", "reduce", "comb",
                  "accept", "return"]
        if n == BATCH:
            f_report[cname], marked = time_batch(
                lambda: fn(msgs_, sigs_), f"ecfsdsa {label} batch verify",
                fmarks, lambda ok_: ok_ is True)
            per = f_report[cname]["launches_per_batch"]
        else:
            reset()
            bd, marked, ok_ = staged(lambda: fn(msgs_, sigs_), 1)
            per = snapshot()
            _check(ok_ is True and list(bd) == fmarks,
                   f"ECFSDSA {label}: the staged batch {list(bd)}, {ok_}")
            print(f"ecfsdsa {label} batch {n} stage ms:", json.dumps(bd))
        note_sources(cv)
        time_kernels({sname: straus_row(label, marked["table"],
                                        W_PER_WINDOW[a_tag(cv)][1],
                                        BATCH // n)},
                     path, per, f"ECFSDSA {label} batch verification", BATCH)
        note_launches(set(w_names(cv).values()), path,
                      f"ECFSDSA {label} batch verification")

    lap("the registry ECFSDSA paths")

    # 8. the cofactor > 1 curves (WEI448: kernels 2-4 and 6 at K = 14,
    # generic a; the others run instances built before). Per curve: the
    # q*P check of key import on the ECDSA fixture's keys with a point of
    # small order added on lanes COF_BAD (and COF_BAD_FULL), against the
    # host oracle; the clean keys through the checked import; ECDSA verify
    # through verify_batch_async on the valid, corrupted and off-curve
    # batches (the affine accept test: lanes 70-79 have x(W) >= q); ECFSDSA
    # batch verification, its keys through the checked import. On WEI448,
    # first kernels 1-4 against their plain versions (kernel 4 in its
    # timed row), and the key import,
    # the ECDSA batch and the ECFSDSA batch timed, with their kernel rows.
    cof_report, cof_counts = {}, {}
    for cname, (label, hname) in COF_CURVES.items():
        cv, cw = hosts[cname]
        full = cname == "WEI448"
        fx = fixtures[cname]
        n = len(fx.pubs)
        if full:
            _, _, PA_, PB_, wtab = check_w_kernels(cv, cw, label, False, N)
        bad = [i for i in COF_BAD + COF_BAD_FULL if i < n]
        pts = list(fx.pubs)
        for j, i in enumerate(bad):
            pts[i] = H.ec_add(cw, pts[i], cof_T[cname][j % 3])
        pts[COF_ORDER2] = H.ec_order2_point(cw)
        bad = sorted(bad + [COF_ORDER2])
        want_ok = np.ones(n, bool)
        want_ok[bad] = False
        for i in bad + [0, 1, 70, n - 1]:
            _check((H.ec_mul(cw, cv.q, pts[i]) is None) == want_ok[i],
                   f"{label}: key {i} is not what the host oracle says")
        xs, ys = [P_[0] for P_ in pts], [P_[1] for P_ in pts]
        reset()
        okm = K_.order_check_mask(cv, cv.point_from_affine_ints(xs, ys, dev))
        _check((okm == want_ok).all(), f"{label}: the q*P check differs from "
               f"the host oracle on keys "
               f"{np.flatnonzero(okm != want_ok)[:20].tolist()}")
        try:
            K_.pubkey_batch_from_affine_ints(cv, "ECDSA", xs, ys)
            _fail(f"{label}: keys with a small-order component imported")
        except ValueError as e:
            _check(str(e) == f"public key(s) {bad}: point not in the "
                   "order-q subgroup", f"{label}: {e}")
        fxs, fys = [P_[0] for P_ in fx.pubs], [P_[1] for P_ in fx.pubs]
        fx.kb = K_.pubkey_batch_from_affine_ints(cv, "ECDSA", fxs, fys)
        keys_path = snapshot()
        names = w_names(cv)
        for name in (names["windowed_mul"], names["point_add"],
                     names["point_dbl"]):
            _check(keys_path[name] >= 1, f"kernel {name} was not launched "
                                         f"on the {label} key import")
        print(f"{label} key import (batch {n}): the q*P check passes the "
              f"keys d*G and refuses the {len(bad) - 1} keys d*G + T, T of "
              f"small order, and the point of order 2 (lane {COF_ORDER2}), "
              "lane for lane as the host oracle does; launches "
              + json.dumps({k_: v for k_, v in keys_path.items() if v}))
        reset()
        acc = ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hname)
        _check(bool(acc.all()), f"{label}: verify_batch_async rejected "
                                f"{int((~acc).sum())} valid lanes")
        for what, kb_, ms, ss, want in (
                ("corrupted lanes", fx.kb, fx.bad_m, fx.bad_s, fx.want_bad),
                ("off-curve keys", fx.kb_off, fx.msgs, fx.sigs,
                 fx.want_off)):
            got = ecdsa.verify_batch_async(kb_, ms, ss, hname).cpu().numpy()
            _check((got == want).all(), f"{label}: {what} wrong "
                   f"({np.flatnonzero(got != want)[:20].tolist()})")
        path = snapshot()
        for name in names.values():
            _check(path[name] >= 1,
                   f"kernel {name} was not launched on the {label} path")
        print(f"{label} ECDSA ({hname}, batch {n}): valid lanes accept, "
              "among them lanes whose x(W) is at or above q (r = x(W) mod "
              "q); r + 1, s = 0, s = q, another message, r = q, r = 12345 "
              "+ i, r = x(W) unreduced, a flipped bit of s and off-curve "
              "keys reject (verify_batch_async); launches "
              + json.dumps({k_: v for k_, v in path.items() if v}))
        pubs_, msgs_, sigs_ = cof_ffix[cname]
        kbf = K_.pubkey_batch_from_affine_ints(
            cv, "ECFSDSA", [P_[0] for P_ in pubs_], [P_[1] for P_ in pubs_])
        fn = batch_call(bv.ecfsdsa_verify_batch, kbf, hname)
        if full:
            straus_in[label] = (cv, cw, PA_, PB_, PrjPoint, *straus_check(
                cv, cw, PA_, PB_, PrjPoint, label, False))
        reset()
        _check(fn(msgs_, sigs_) is True, f"ECFSDSA {label}: the valid "
                                         "batch rejects")
        _check(fn(msgs_, swap(sigs_, n // 2 + 1, flip_last)) is False,
               f"ECFSDSA {label}: one flipped bit of s accepts")
        _check(fn(evil(msgs_, n // 3), sigs_) is False,
               f"ECFSDSA {label}: one changed message accepts")
        fpath = snapshot()
        sname = megamul.kernel_name_of(cv, 2)
        for name in (sname, names["point_add"], names["point_dbl"]):
            _check(fpath[name] >= 1, f"kernel {name} was not launched on "
                                     f"the ECFSDSA {label} path")
        print(f"ECFSDSA {label} ({hname}, batch {n}): the valid batch "
              "accepts; one flipped bit of s or one changed message "
              "rejects; launches " + json.dumps(
                  {k_: v for k_, v in fpath.items() if v}))
        cof_counts[cname] = {"key import": keys_path, "ECDSA": path,
                             "ECFSDSA": fpath}
        note_sources(cv)
        if not full:
            for where, counts_ in cof_counts[cname].items():
                note_launches(set(names.values()) | {sname}, counts_,
                              f"{label} {where}")
            continue
        krep, _ = time_batch(
            lambda: K_.pubkey_batch_from_affine_ints(cv, "ECDSA", fxs, fys),
            f"{label} key import", ["import", "order check", "return"],
            lambda kb_: kb_.n == n)
        rep, _ = time_batch(
            lambda: ecdsa.verify_batch_async(fx.kb, fx.msgs, fx.sigs, hname),
            f"{label} ECDSA verify", ["digest", "scalars", "key on curve",
                                      "comb", "table", "windowed", "accept",
                                      "return"],
            lambda acc_: bool(acc_.all()))
        comb_, comb_s = combs[cname]
        rep.update(hash=hname, comb_first_build_s=round(comb_s, 3),
                   comb_bytes=comb_.numel() * comb_.element_size())
        frep, marked = time_batch(
            lambda: fn(msgs_, sigs_), f"ecfsdsa {label} batch verify",
            ["parse", "lift", "table", "straus", "reduce", "comb", "accept",
             "return"], lambda ok_: ok_ is True)
        cof_report = {"keys": krep, "ecdsa": rep, "ecfsdsa": frep}
        timed = {row["name"] for row in lines}
        kern = {name: args for name, args in
                w_kern(cv, PA_, PB_, wtab).items()
                if name not in timed}
        time_kernels(kern, path, rep["launches_per_batch"],
                     f"{label} ECDSA verify")
        note_launches(timed, path, f"{label} ECDSA verify")
        time_kernels({sname: straus_row(label, marked["table"],
                                        W_PER_WINDOW["ga"][1])},
                     fpath, frep["launches_per_batch"],
                     f"ECFSDSA {label} batch verification")
        for where in ("key import", "ECFSDSA"):
            note_launches(set(names.values()), cof_counts[cname][where],
                          f"{label} {where}")

    lap("the cofactor > 1 curves")

    # 9. the joint-table Straus (kernels 5 and 8c) on every curve of
    # straus_in whose (K, a) has kernel 5 or 8c built: P-256 and Ed25519
    # (K = 8), P-384, BrainpoolP512r1, GOST512, Ed448, P-521,
    # BrainpoolP512t1 and WEI448. Once an instance, on its first curve:
    # the kernel bitwise against its plain version (n = 0, 2, 4) on the
    # straus_check points (the identity, P = Q and P = -Q lanes among
    # them) and, at n = 4, against the host oracle. Then, the counts set
    # to 0 first, straus_double_mul_public on every lane of each curve's
    # straus_check points and scalars, against straus_double_mul_public_w4
    # in affine form; then each instance's row at n = 2.
    def joint_names(cv, cls):
        """Kernel 5's or 8c's count name for cv (None where it is not
        built) and those of the add and double of its joint table."""
        k_ = cv.fp_ctx.k
        if cls is PrjPoint:
            return [point.instance_name(b, cv) for b in point.BASES[::-1]]
        if k_ not in edpoint.BUILT["ed_dbln_add"]:
            return [None]
        return [build.kernel_name(b, k_)
                for b in ("ed_dbln_add", "ed_add", "ed_dbl")]

    joint_in, joint_kern = {}, {}
    for label, (cv, hcv, P1, P2, cls, *_) in straus_in.items():
        name = joint_names(cv, cls)[0]
        if name is None:
            continue
        joint_in[label] = name
        if name in joint_kern:          # GOST512: BrainpoolP512r1's instance
            continue
        ed_, k_, n = cls is ExtPoint, cv.fp_ctx.k, P1.x.shape[1]
        kfn, pfn = ((edpoint.ed_dbln_add, edpoint.ed_dbln_add_plain) if ed_
                    else (point.point_dbln_add, point.point_dbln_add_plain))
        for nd in (0, JOINT_NDBL, 4):
            cmp(name, kfn(cv, P1, P2, nd), pfn(cv, P1, P2, nd), n,
                f" ({label}), n = {nd}")
        G4 = kfn(cv, P1, P2, 4)
        for i in range(8):
            if ed_:
                ok = ed_affine_of(G4, i, cv) == H.ed_add(
                    hcv, H.ed_mul(hcv, 16, ed_affine_of(P1, i, cv)),
                    ed_affine_of(P2, i, cv))
            else:
                ok = affine_of(cv, G4, i) == H.ec_add(
                    hcv, H.ec_mul(hcv, 16, affine_of(cv, P1, i)),
                    affine_of(cv, P2, i))
            _check(ok, f"{name} ({label}) lane {i} disagrees with the host "
                       "oracle")
        if ed_:                         # 4 squares and 4 products a doubling
            nsq, nmu = 4 * JOINT_NDBL, 4 * JOINT_NDBL + (
                ED448_ADD_PRODUCTS if cv.a == 1 else ED_ADD_PRODUCTS)
        else:
            (dsq, dmu), other = JOINT_PER_DBL[a_tag(cv)]
            nsq, nmu = 2 + dsq * JOINT_NDBL, other + dmu * JOINT_NDBL
        ncoord = len(cls._fields)
        joint_kern[name] = (n, (
            lambda cv=cv, A_=P1, B_=P2, f=kfn: f(cv, A_, B_, JOINT_NDBL),
            lambda cv=cv, A_=P1, B_=P2, f=pfn: f(cv, A_, B_, JOINT_NDBL),
            100, 3, n * 3 * ncoord * 4 * k_,
            n * (nsq * fsqr_slots(k_) + nmu * fmul_slots(k_))))
        source[name] = ("edpoint.cu" if ed_ else
                        f"{point.BUILT[(k_, point.a_kind(cv))][0]}.cu")
        replaces[name] = ("libecc_tpu/ops/pallas/edpoint.py:140" if ed_
                          else "libecc_tpu/ops/pallas/point.py:507")
    reset()
    joint = {label: scalar_mul.straus_double_mul_public(cv, ut, P1, vt, P2)
             for label, (cv, _, P1, P2, _, ut, vt, _, _) in straus_in.items()
             if label in joint_in}
    torch.cuda.synchronize()
    joint_counts = snapshot()
    print("joint-table Straus launches:",
          json.dumps({k_: v for k_, v in joint_counts.items() if v}))
    for label in joint_in:
        cv, _, _, _, cls = straus_in[label][:5]
        for name in joint_names(cv, cls):
            _check(joint_counts[name] >= 1, f"kernel {name} was not "
                   f"launched on the joint-table Straus ({label})")
    # ... gives the separate-table Straus's points (kernels 6 and 6-ed) on
    # every lane
    for label, pts in joint.items():
        cv, _, P1, P2, cls, ut, vt, _, _ = straus_in[label]
        w4 = scalar_mul.straus_double_mul_public_w4(cv, ut, P1, vt, P2)
        aff = (shortw.to_affine_plain if cls is PrjPoint
               else edwards.to_affine_plain)
        for a_, b_ in zip(aff(cv, w4), aff(cv, pts)):
            _check(torch.equal(a_, b_), f"{label}: straus_double_mul_public "
                   "and straus_double_mul_public_w4 differ in affine form")
    print("joint-table Straus equals the separate-table one on every lane "
          f"of {', '.join(joint)}")
    note_launches({row["name"] for row in lines}, joint_counts,
                  "joint-table Straus")
    for name, (n, args) in joint_kern.items():
        time_kernels({name: args}, joint_counts, joint_counts,
                     "joint-table Straus", n)

    lap("the joint-table Straus")
    for row in lines:
        if re.search(r"_k1[467](_|$)", row["name"]):
            # the large-K body backend these instances stand for
            row["also_replaces"] = "libecc_tpu/ops/pallas/rows.py:129"

    def rated(rep, key):
        rep = dict(rep)
        rep[key] = rep.pop("per_s")
        rep["launches_per_batch"] = {k_: v for k_, v in
                                     rep["launches_per_batch"].items() if v}
        return {**rep, "card": smi}

    print(json.dumps({"batch_verify": {
        name: rated(rep, "signatures_per_s")
        for name, rep in bv_report.items()}}))
    print(json.dumps({"verify": {
        **rated(w_report["SECP256R1"], "verifies_per_s"),
        "pipelined_verifies_per_s": round(piped, 1)}}))
    print(json.dumps({"verify_ed25519": rated(ed25519, "verifies_per_s")}))
    print(json.dumps({"verify_ed448": {
        **rated(ed448, "verifies_per_s"), "comb_bytes": comb_bytes,
        "comb_first_build_s": round(comb_s, 3)}}))
    print(json.dumps({"verify_wide": {
        name: rated(rep, "verifies_per_s")
        for name, rep in w_report.items() if name != "SECP256R1"}}))
    print(json.dumps({"verify_registry": {
        **{name: rated(rep, "verifies_per_s")
           for name, rep in r_report.items()},
        "shared_instance_launches": shared}}))
    print(json.dumps({"batch_verify_registry": {
        name: rated(rep, "signatures_per_s")
        for name, rep in f_report.items()}}))
    print(json.dumps({"cofactor": {
        "key_import_WEI448": rated(cof_report["keys"], "keys_per_s"),
        "ecdsa_WEI448": rated(cof_report["ecdsa"], "verifies_per_s"),
        "ecfsdsa_WEI448": rated(cof_report["ecfsdsa"], "signatures_per_s"),
        "launches": {cn: {w: {k_: v for k_, v in c_.items() if v}
                          for w, c_ in by.items()}
                     for cn, by in cof_counts.items()}}}))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
