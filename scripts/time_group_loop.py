#!/usr/bin/env python3
"""Time the port's kernels on the group field (csrc/groupfield.cuh, the
sources as they are) against the one-thread build of the same C entry
points, on one NVIDIA GPU: kernels 2 and 3 (the complete add and double,
csrc/groupfield.cuh's formula_group_kernel with csrc/point.cuh's PointAdd
and PointDbl) at every built (K, a), kernels 8a and 8b (the Edwards add
and double, the same kernel with csrc/edpoint.cu's EdAdd and EdDbl) at
K = 8 and 14, kernels 4 and 6 at every (K, a) and kernels 7 and 6-ed at
K = 8 (Ed25519) and 14 (Ed448). The one-thread build is the sources with
ECC_W_ENTRY_POINT in place of ECC_WG_ENTRY_POINT, ECC_ED_ENTRY_POINT in
place of ECC_EDG_ENTRY_POINT, launch_add in place of launch_group's
PointAdd and EdAdd instances, and launch_dbl in place of its PointDbl and
EdDbl instances (ONE_THREAD).

--shapes TPIxTHREADS[i],... adds one build per shape, each with every
shape table's lines in groupfield.cuh (GroupShape, AddShape:
threads a lane, threads a block, "i" for inlined products) set to it in a
copy; --curves NAME,... times only those curves' instances; --kernels
add,dbl,mul times the adds (add: kernel 2, and 8a on the Edwards
curves), the doubles (dbl: kernel 3, and 8b on the Edwards curves) or
the window loops (mul) alone, and builds only their sources.

Each instance runs at N = 8192 lanes on random points (64 distinct ones,
random Z) and, for the window loops, random scalars; every build's output
is held bitwise against the group build's (which the card-only tests and
chip_smoke.py hold against the plain versions). Times are device ms a
launch: the stream sleeps while the host queues the launches, and CUDA
events around them time the card alone. They are measured in turns (the
builds in order, then in reverse). ptxas's registers, spills and stack of
each build's kernels are printed, each kernel keyed by its base name (a
formula kernel's by its formula: point_add for PointAdd), K, a_kind,
pairs and shape (t1: one thread a lane). The builds go under
libecc_tpu_torch/_build/group_loop/.

    python3 scripts/time_group_loop.py [--out FILE] [--shapes 2x64,4x128i]
        [--curves NAME,...] [--kernels add,dbl,mul]
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

from libecc_tpu_torch.ops.cuda import build  # noqa: E402
from libecc_tpu_torch.ops.cuda.build import (SHAPE_RE,  # noqa: E402
                                             SHAPES_HEADER, shape_at,
                                             shapes_of)

N = 8192
# launches a turn: the window loops take milliseconds, an add or a
# double tens of us
REPS = {"mul": 3, "add": 200, "dbl": 200}
# one curve for each (K, a) of kernels 2, 4 and 6, then Ed25519 and Ed448
CURVES = ["P-192", "BRAINPOOLP192R1", "SECP192K1", "P-224",
          "BRAINPOOLP224R1", "SECP224K1", "P-256", "SECP256K1",
          "BRAINPOOLP256R1", "BRAINPOOLP320T1", "BRAINPOOLP320R1", "P-384",
          "BRAINPOOLP384R1", "WEI448", "BRAINPOOLP512T1", "BRAINPOOLP512R1",
          "P-521", "ED25519", "ED448"]
KERNELS = ("add", "dbl", "mul")
# group entry point or launcher -> its one-thread form; "#define" lines
# keep their names
ONE_THREAD = ((r"(?<!#define )\bECC_WG_ENTRY_POINT\(", "ECC_W_ENTRY_POINT("),
              (r"(?<!#define )\bECC_EDG_ENTRY_POINT\(", "ECC_ED_ENTRY_POINT("),
              (r"\blaunch_group<(?:ecc::)?PointAdd, ", "launch_add<"),
              (r"\blaunch_group<(?:ecc::)?EdAdd, ", "launch_add<"),
              (r"\blaunch_group<(?:ecc::)?PointDbl, ", "launch_dbl<"),
              (r"\blaunch_group<(?:ecc::)?EdDbl, ", "launch_dbl<"))
# the kernel families' shape tables, by base name (see kernel_base)
TABLE_OF = {"point_add": "AddShape", "point_dbl": "AddShape",
            "ed_add": "AddShape", "ed_dbl": "AddShape",
            "windowed_mul": "GroupShape", "windowed_mul_ed": "GroupShape"}
ED_ADD_STEM = "edpoint"      # kernels 8a and 8b's source, csrc/edpoint.cu


def one_thread(name, text):
    """The one-thread build's text of a source or header."""
    for pat, rep in ONE_THREAD:
        text = re.sub(pat, rep, text)
    return text


def shaped(spec):
    """edit(name, text) that sets every shape line of groupfield.cuh to
    spec ("TPIxTHREADS" or "TPIxTHREADSi")."""
    m = re.fullmatch(r"(\d+)x(\d+)(i?)", spec)
    if not m:
        raise SystemExit(f"--shapes: {spec!r} is not TPIxTHREADS[i]")
    tpi, threads, inl = m.groups()

    def edit(name, text):
        if name != SHAPES_HEADER:
            return text
        assert SHAPE_RE.search(text), f"no shape line in {SHAPES_HEADER}"
        return SHAPE_RE.sub(
            lambda g: g.group(0).split(" : ")[0] + f" : Shape<{tpi}, "
            f"{threads}, {'true' if inl else 'false'}>",
            text)
    return edit


def variants(shapes):
    """Label -> edit(name, text) of each build."""
    out = {"group": lambda name, text: text, "one-thread": one_thread}
    for spec in filter(None, shapes.split(",")):
        out["t" + spec] = shaped(spec)
    return out


def stems_for(curves, kernels):
    """The sources (csrc/<stem>.cu) that hold the curves' kernels: curve
    name -> ([(kernel, npairs, stem)]) and the sorted stems."""
    from libecc_tpu_torch.curves import edwards, params
    from libecc_tpu_torch.ops.cuda import megamul, point
    plan = {}
    for name in curves:
        ed = name.startswith("ED")
        c = edwards.get_edwards_curve(name) if ed else params.get_curve(name)
        rows = []
        for kind in ("add", "dbl"):
            if kind in kernels:
                rows.append((kind, 0, ED_ADD_STEM if ed else point.BUILT[
                    (c.fp_ctx.k, point.a_kind(c))][0]))
        if "mul" in kernels:
            for npairs in (1, 2):
                rows.append(("mul", npairs,
                             megamul.instance(c, "ed" if ed else "w",
                                              npairs)[2]))
        plan[name] = (c, ed, rows)
    stems = sorted({s for _, _, rows in plan.values() for *_, s in rows})
    return plan, stems


def build_variant(label, edit, workdir, stems):
    """nvcc each source of stems, its text and every header's passed
    through edit(name, text) (a quoted include finds the copy beside it
    first), into workdir/label; returns {stem: (.so, log)}."""
    vdir = Path(workdir) / label
    vdir.mkdir(parents=True)
    for h in build.CSRC.glob("*.cuh"):
        (vdir / h.name).write_text(edit(h.name, h.read_text()))

    def one(stem):
        src, so = vdir / f"{stem}.cu", vdir / f"{stem}.so"
        src.write_text(edit(src.name, (build.CSRC / src.name).read_text()))
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                            "-o", str(so), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {label} {stem}:\n{r.stdout}{r.stderr}")
        return stem, (str(so), r.stdout + r.stderr)

    with ThreadPoolExecutor(len(stems)) as ex:
        return dict(ex.map(one, stems))


# a kernel's mangled name: its name, then its formula type where it takes
# one, then its integer template arguments (K, a_kind[, pairs])
KERNEL_RE = re.compile(r"_ZN3ecc\d+(\w+?_kernel)I(?:NS_\d+([A-Za-z]+)E)?"
                       r"((?:Li\d+E)+)")


def kernel_base(name, op=None):
    """The base name that keys a kernel in TABLE_OF and ptxas_summary:
    its formula's name in snake case where it takes one (PointAdd ->
    point_add), else its name without _group_kernel or _kernel."""
    if op:
        return re.sub(r"(?<!^)(?=[A-Z])", "_", op).lower()
    return name.replace("_group_kernel", "").replace("_kernel", "")


def ptxas_summary(log: str, shapes: dict) -> dict:
    """Kernel ("{base}_k{K}_a{a_kind}[_p{pairs}]_{shape}") -> [registers,
    spill store bytes, stack frame bytes]; shapes is the build's
    shapes_of."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            km = KERNEL_RE.search(m.group(1))
            key = None
            if km:
                name = km.group(1)
                base = kernel_base(name, km.group(2))
                args = [int(v) for v in re.findall(r"Li(\d+)E", km.group(3))]
                shape = (shape_at(shapes, TABLE_OF[base], args[0])
                         if "group_kernel" in name else "t1")
                key = (f"{base}_k{args[0]}_a{args[1]}"
                       + (f"_p{args[2]}" if len(args) > 2 else "")
                       + f"_{shape}")
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


def device_ms(torch, fn, reps):
    """Device ms of one call of fn, its launches queued behind a sleep of
    the stream so that the card, not the host's launch interval, is
    timed."""
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
        torch.cuda._sleep(int(sleep_ms * 2e6))     # >= sleep_ms at 2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
    raise RuntimeError(f"the host did not queue {reps} calls within the "
                       f"stream's sleep of {sleep_ms:.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--curves", default=",".join(CURVES))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    edits = variants(args.shapes)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: {args.kernels!r}: add, dbl, mul")
    import ctypes
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from libecc_tpu_torch.curves import scalar_mul
    from libecc_tpu_torch.curves.edwards import ExtPoint
    from libecc_tpu_torch.curves.shortw import PrjPoint
    from libecc_tpu_torch.nn import core as nn
    from libecc_tpu_torch.ops.cuda import edpoint, megamul, point
    from libecc_tpu_torch.ref import hostref as H

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    plan, stems = stems_for(args.curves.split(","), kernels)
    t0 = time.perf_counter()
    wd = build.BUILD_DIR / "group_loop"
    shutil.rmtree(wd, ignore_errors=True)
    with ThreadPoolExecutor(len(edits) + 1) as ex:
        # the package's own build (the kernels that make the tables) beside
        # the variants
        base = ex.submit(build.library, stems[0])
        futs = {lb: ex.submit(build_variant, lb, e, wd, stems)
                for lb, e in edits.items()}
        builds = {lb: f.result() for lb, f in futs.items()}
        base.result()
    libs = {lb: {s: ctypes.CDLL(so) for s, (so, _) in b.items()}
            for lb, b in builds.items()}
    print(f"builds: {time.perf_counter() - t0:.1f} s")
    regs = {lb: ptxas_summary(
        "\n".join(log for _, log in b.values()),
        shapes_of((wd / lb / SHAPES_HEADER).read_text()))
        for lb, b in builds.items()}
    print(json.dumps({"ptxas": regs}))
    rng = np.random.RandomState(9)
    order = [*edits, *reversed(list(edits))]
    first = order[0]
    rows = []
    for name, (c, ed, todo) in plan.items():
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

        for kind, npairs, stem in todo:
            if kind in ("add", "dbl"):
                fn = ("ed_" if ed else "point_") + kind
                # the add takes two points, the double X, Y, Z of one
                ins = ([*points(), *points()] if kind == "add"
                       else [*points()][:3])
                kname = (build.kernel_name(fn, c.fp_ctx.k) if ed
                         else point.instance_name(fn, c))
                launch = edpoint._launch if ed else point._launch

                def run():
                    return launch(fn, c, ins)
            else:
                tabs = [scalar_mul._build_mul_table(c, points())
                        for _ in range(npairs)]
                digs = [scalar_mul._window_digits(nn.upload(
                    nn.batch_to_limbs(rand(q, N), c.q_ctx.k), dev),
                    c.scalar_bits()) for _ in range(npairs)]
                kname = megamul.instance(c, model, npairs)[0]

                def run():
                    return megamul._launch(c, tabs, digs, cls)
            times, outs = {lb: [] for lb in libs}, {}
            for lb in order:
                saved = build._LIBS[stem]
                build._LIBS[stem] = libs[lb][stem]
                try:
                    outs[lb] = run()
                    times[lb].append(device_ms(torch, run, REPS[kind]))
                finally:
                    build._LIBS[stem] = saved
            same = {lb: all(torch.equal(x, y) for x, y in
                            zip(outs[lb], outs[first])) for lb in outs}
            row = {"name": kname, "k": c.fp_ctx.k, "curve": name,
                   "kernel": kind, "npairs": npairs, "n": N,
                   "bitwise_equal": same,
                   "ms": {lb: round(sum(v) / len(v), 5)
                          for lb, v in times.items()},
                   "ms_each": {lb: [round(x, 5) for x in v]
                               for lb, v in times.items()}}
            if kind == "mul":
                row["nwin"] = digs[0].shape[0]
            rows.append(row)
            print(json.dumps(row), flush=True)
    ok = all(all(r["bitwise_equal"].values()) for r in rows)
    result = {"device": smi, "n": N, "reps": REPS, "builds": list(edits),
              "ptxas": regs, "rows": rows, "all_bitwise_equal": ok}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"all_bitwise_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
