#!/usr/bin/env python3
"""Time kernels 4 and 6 and kernels 7 and 6-ed at K = 14 (Ed448) on the
group loop (csrc/windowed.cuh, the sources as they are) against the
one-thread loop of the same C entry points (the sources with
ECC_W_ENTRY_POINT in place of ECC_WG_ENTRY_POINT and ECC_ED_ENTRY_POINT in
place of ECC_EDG_ENTRY_POINT), on one NVIDIA GPU. --shapes
TPIxTHREADS[i],... adds one build per shape, each with every K's group
shape (windowed.cuh's GroupShape: threads a lane, threads a block, "i" for
inlined products) set to it in a copy; --curves NAME,... times only those
curves' instances and builds only their sources.

Each instance runs at N = 8192 lanes on random points (64 distinct ones,
random Z) and random scalars; every build's output is held bitwise
against the group loop's (which the card-only tests and chip_smoke.py
hold against the plain versions). Times are CUDA event ms a launch,
measured in turns (the builds in order, then in reverse), and ptxas's
registers, spills and stack of each build's kernels are printed, each
kernel keyed by (K, a_kind, pairs) and its shape (t1: one thread a lane).
The builds go under libecc_tpu_torch/_build/group_loop/.

    python3 scripts/time_group_loop.py [--out FILE] [--shapes 2x64,4x128i]
        [--curves NAME,...]
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N = 8192
REPS = 3
# one curve for each (K, a) of kernels 4 and 6, and Ed448
CURVES = ["P-192", "BRAINPOOLP192R1", "SECP192K1", "P-224",
          "BRAINPOOLP224R1", "SECP224K1", "P-256", "SECP256K1",
          "BRAINPOOLP256R1", "BRAINPOOLP320T1", "BRAINPOOLP320R1", "P-384",
          "BRAINPOOLP384R1", "WEI448", "BRAINPOOLP512T1", "BRAINPOOLP512R1",
          "P-521", "ED448"]
# windowed.cuh's group shapes: the default (K None) and each K's own
SHAPE_RE = re.compile(r"struct GroupShape(?:<(\d+)>)? : "
                      r"Shape<(\d+), (\d+), (true|false)>")


def shapes_of(text: str) -> dict:
    """K (None: every other K) -> "t{TPI}x{threads}" with "i" where the
    products are inlined, from windowed.cuh's GroupShape lines."""
    return {int(k) if k else None: f"t{t}x{b}" + ("i" if i == "true" else "")
            for k, t, b, i in SHAPE_RE.findall(text)}


def build_variant(build, label, edit, workdir, stems):
    """nvcc each source of stems, its text passed through edit(name, text)
    for itself and for windowed.cuh (a quoted include finds the copy
    beside it first), into workdir/label; returns {stem: (.so, log)}."""
    vdir = Path(workdir) / label
    vdir.mkdir(parents=True)
    (vdir / "windowed.cuh").write_text(
        edit("windowed.cuh", (build.CSRC / "windowed.cuh").read_text()))

    def one(stem):
        src, so = vdir / f"{stem}.cu", vdir / f"{stem}.so"
        src.write_text(edit(src.name, (build.CSRC / src.name).read_text()))
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                            "-I", str(build.CSRC), "-o", str(so), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {label} {stem}:\n{r.stdout}{r.stderr}")
        return stem, (str(so), r.stdout + r.stderr)

    with ThreadPoolExecutor(len(stems)) as ex:
        return dict(ex.map(one, stems))


def variants(shapes):
    """Label -> edit(name, text) of each build."""
    def one_thread(name, text):
        if name == "windowed.cuh":
            return text
        return (text.replace("ECC_WG_ENTRY_POINT(", "ECC_W_ENTRY_POINT(")
                .replace("ECC_EDG_ENTRY_POINT(", "ECC_ED_ENTRY_POINT("))

    def shaped(spec):
        m = re.fullmatch(r"(\d+)x(\d+)(i?)", spec)
        if not m:
            raise SystemExit(f"--shapes: {spec!r} is not TPIxTHREADS[i]")
        tpi, threads, inl = m.groups()

        def edit(name, text):
            if name != "windowed.cuh":
                return text
            assert SHAPE_RE.search(text), "no GroupShape in windowed.cuh"
            return SHAPE_RE.sub(
                lambda g: g.group(0).split(" : ")[0] + f" : Shape<{tpi}, "
                f"{threads}, {'true' if inl else 'false'}>",
                text)
        return edit

    out = {"group": lambda name, text: text, "one-thread": one_thread}
    for spec in filter(None, shapes.split(",")):
        out["t" + spec] = shaped(spec)
    return out


def ptxas_summary(log: str, shapes: dict) -> dict:
    """Kernel (K, a_kind, pairs and shape; "ed_" before the Edwards ones)
    -> [registers, spill store bytes, stack frame bytes]; shapes is the
    build's shapes_of."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            km = re.search(r"kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            ed = "ed_" if "_ed_" in m.group(1) else ""
            if km:
                k = int(km.group(1))
                shape = (shapes.get(k, shapes[None])
                         if "group_kernel" in m.group(1) else "t1")
                key = ed + "k{}_a{}_p{}_".format(*km.groups()) + shape
            else:
                key = None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            out.setdefault(key, [None, 0, 0])[1:] = [int(m.group(2)),
                                                     int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, [None, 0, 0])[0] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--curves", default=",".join(CURVES))
    args = ap.parse_args()
    edits = variants(args.shapes)
    import ctypes
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from libecc_tpu_torch.curves import edwards, params, scalar_mul
    from libecc_tpu_torch.curves.edwards import ExtPoint
    from libecc_tpu_torch.curves.shortw import PrjPoint
    from libecc_tpu_torch.nn import core as nn
    from libecc_tpu_torch.ops.cuda import build, megamul
    from libecc_tpu_torch.ref import hostref as H

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    curves = {}
    for name in args.curves.split(","):
        ed = name.startswith("ED")
        curves[name] = (edwards.get_edwards_curve(name) if ed
                        else params.get_curve(name), ed)
    stems = sorted({megamul.instance(c, "ed" if ed else "w", npairs)[2]
                    for c, ed in curves.values() for npairs in (1, 2)})
    t0 = time.perf_counter()
    wd = build.BUILD_DIR / "group_loop"
    shutil.rmtree(wd, ignore_errors=True)
    with ThreadPoolExecutor(len(edits) + 1) as ex:
        # the package's own build (the kernels that make the tables) beside
        # the variants
        base = ex.submit(build.library, stems[0])
        futs = {lb: ex.submit(build_variant, build, lb, e, wd, stems)
                for lb, e in edits.items()}
        builds = {lb: f.result() for lb, f in futs.items()}
        base.result()
    libs = {lb: {s: ctypes.CDLL(so) for s, (so, _) in b.items()}
            for lb, b in builds.items()}
    print(f"builds: {time.perf_counter() - t0:.1f} s")
    regs = {lb: ptxas_summary(
        "\n".join(log for _, log in b.values()),
        shapes_of((wd / lb / "windowed.cuh").read_text()))
        for lb, b in builds.items()}
    print(json.dumps({"ptxas": regs}))
    rng = np.random.RandomState(9)
    order = [*edits, *reversed(list(edits))]
    first = order[0]
    rows = []
    for name, (c, ed) in curves.items():
        p, q = c.fp_ctx.p_int, c.q
        cls, model = (ExtPoint, "ed") if ed else (PrjPoint, "w")
        if ed:
            hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, q, c.h)
            base_mul = lambda k: H.ed_base_mul(hc, k)  # noqa: E731
        else:
            wc = H.WCurve(p, c.a, c.b, c.gx, c.gy, q, c.h)
            base_mul = lambda k: H.ec_base_mul(wc, k)  # noqa: E731

        def rand(mod, n):
            nb = (mod.bit_length() + 7) // 8 + 8
            return [int.from_bytes(rng.bytes(nb), "big") % mod
                    for _ in range(n)]

        def points():
            """N points (64 distinct ones) with random Z: (mX : mY : m),
            or (mx : my : m : mxy) on an Edwards curve."""
            base = [base_mul(1 + v % (q - 1)) for v in rand(q, 64)]
            lam = [1 + v % (p - 1) for v in rand(p, N)]
            pts = [base[i % 64] for i in range(N)]
            cols = [[P_[0] * m % p for P_, m in zip(pts, lam)],
                    [P_[1] * m % p for P_, m in zip(pts, lam)], lam]
            if ed:
                cols.append([P_[0] * P_[1] * m % p
                             for P_, m in zip(pts, lam)])
            return cls(*[c.fp_ctx.from_ints(col, dev) for col in cols])

        tabs = [scalar_mul._build_mul_table(c, points()) for _ in range(2)]
        digs = [scalar_mul._window_digits(nn.upload(nn.batch_to_limbs(
            rand(q, N), c.q_ctx.k), dev), c.scalar_bits()) for _ in range(2)]
        for npairs in (1, 2):
            kname, _, stem = megamul.instance(c, model, npairs)
            times, outs = {lb: [] for lb in libs}, {}
            for lb in order:
                saved = build._LIBS[stem]
                build._LIBS[stem] = libs[lb][stem]
                try:
                    def run():
                        return megamul._launch(c, tabs[:npairs],
                                               digs[:npairs], cls)
                    outs[lb] = run()
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(REPS):
                        run()
                    b.record()
                    torch.cuda.synchronize()
                    times[lb].append(a.elapsed_time(b) / REPS)
                finally:
                    build._LIBS[stem] = saved
            same = {lb: all(torch.equal(x, y) for x, y in
                            zip(outs[lb], outs[first])) for lb in outs}
            row = {"name": kname, "k": c.fp_ctx.k, "curve": name,
                   "npairs": npairs, "n": N,
                   "nwin": digs[0].shape[0], "bitwise_equal": same,
                   "ms": {lb: round(sum(v) / len(v), 5)
                          for lb, v in times.items()},
                   "ms_each": {lb: [round(x, 5) for x in v]
                               for lb, v in times.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    ok = all(all(r["bitwise_equal"].values()) for r in rows)
    result = {"device": smi, "n": N, "reps": REPS,
              "builds": list(edits),
              "ptxas": regs,
              "rows": rows, "all_bitwise_equal": ok}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"all_bitwise_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
