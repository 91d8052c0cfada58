"""The text edits of scripts/time_group_loop.py, which times the group
builds of kernels 2, 3, 4, 6, 7, 6-ed, 8a and 8b against their one-thread
builds: a
swap that matched nothing would time the group build against itself, and
a shape line the parser missed would time the default shape under another
name. No CUDA needed: the edits are plain text."""

import importlib.util
import re
from pathlib import Path

import pytest

from libecc_tpu_torch.ops.cuda import build, edpoint, megamul, point

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "time_group_loop", ROOT / "scripts" / "time_group_loop.py")
tgl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tgl)

_, STEMS = tgl.stems_for(tgl.CURVES, tgl.KERNELS)
GROUP_FORMS = (r"^ECC_WG_ENTRY_POINT\(", r"^ECC_EDG_ENTRY_POINT\(",
               r"\blaunch_group<")


def _text(name):
    return (build.CSRC / name).read_text()


def _uses(text, pats):
    """Uses (not #define lines) of the patterns in text."""
    return sum(len(re.findall(p, text, re.M)) for p in pats)


def _entry_points():
    """Every C entry point of kernels 2 and 3 (point.BUILT), 8a and 8b
    (edpoint.BUILT) and 4, 6, 7 and 6-ed (megamul's table) -> its source
    stem."""
    out = {point._entry(base, k, tag): stem
           for (k, _), (stem, bases, tag) in point.BUILT.items()
           for base in ("point_add", "point_dbl") if base in bases}
    out.update({f"{base}_k{k}": tgl.ED_ADD_STEM
                for base in ("ed_add", "ed_dbl") for k in edpoint.BUILT[base]})
    out.update({cname: stem for _, cname, stem in megamul._KERNELS.values()})
    return out


def test_the_script_builds_every_source_of_kernels_2_4_6_7_and_6ed():
    assert set(_entry_points().values()) <= set(STEMS)


@pytest.mark.parametrize("stem", STEMS)
def test_one_thread_edit_rewrites_every_group_entry_point(stem):
    """Each source's group entry points and launcher calls are all
    rewritten and none is left. A source's kernel-2 and kernel-3 entry
    points made by point.cuh's ECC_POINT_ENTRY_POINTS call the launchers
    in the macro, which the header's edit rewrites (test below)."""
    text = _text(f"{stem}.cu")
    edited = tgl.one_thread(f"{stem}.cu", text)
    n_group = _uses(text, GROUP_FORMS)
    n_macro = _uses(text, (r"^ECC_POINT_ENTRY_POINTS\(",))
    assert n_group + n_macro >= 1, f"{stem}.cu has no group entry point"
    assert _uses(edited, GROUP_FORMS) == 0
    one = (r"^ECC_W_ENTRY_POINT\(", r"^ECC_ED_ENTRY_POINT\(",
           r"\blaunch_add<", r"\blaunch_dbl<")
    assert _uses(edited, one) == _uses(text, one) + n_group
    changed = sum(a != b for a, b in zip(text.splitlines(),
                                         edited.splitlines()))
    assert changed >= min(n_group, 1)
    # each group-built entry point of this source is now one-thread: its
    # statement (from its line to the next blank or comment line) holds a
    # one-thread form and no group form
    for cname, s in _entry_points().items():
        if s != stem:
            continue
        at = re.search(rf"\b{cname}\b", edited)
        if at is None:         # an ECC_POINT_ENTRY_POINTS(K, AK, TAG) use
            assert n_macro, cname
            continue
        start = edited.rfind("\n", 0, at.start()) + 1
        ends = [i for i in (edited.find("\n\n", start),
                            edited.find("\n//", start)) if i >= 0]
        stmt = edited[start:min(ends, default=len(edited))]
        assert not re.search(r"ECC_WG_|ECC_EDG_|launch_group<", stmt), cname
        assert re.search(r"ECC_W_ENTRY_POINT\(|ECC_ED_ENTRY_POINT\(|"
                         r"launch_(add|dbl)<", stmt), cname


@pytest.mark.parametrize("rule", range(len(tgl.ONE_THREAD)))
def test_each_one_thread_swap_changes_lines(rule):
    """Each swap of the one-thread edit changes at least one line of the
    sources and headers the script builds."""
    pat, rep = tgl.ONE_THREAD[rule]
    names = [f"{s}.cu" for s in STEMS] + [h.name for h in
                                          build.CSRC.glob("*.cuh")]
    changed = 0
    for name in names:
        text = _text(name)
        edited = re.sub(pat, rep, text)
        changed += sum(a != b for a, b in zip(text.splitlines(),
                                              edited.splitlines()))
    assert changed >= 1, pat


def test_one_thread_edit_of_the_headers():
    """point.cuh's entry-point macro calls the one-thread launchers after
    the edit; the group launcher's definition in groupfield.cuh and the
    macros' definitions in windowed.cuh keep their names."""
    pt = tgl.one_thread("point.cuh", _text("point.cuh"))
    macro = pt[pt.index("#define ECC_POINT_ENTRY_POINTS"):]
    macro = macro[:macro.index("\n\n")]
    for fn in ("add", "dbl"):
        assert f"ecc::launch_{fn}<K, AK>" in macro
    assert "launch_group<" not in pt
    gf = _text("groupfield.cuh")
    assert tgl.one_thread("groupfield.cuh", gf) == gf
    assert "int launch_group(" in gf        # the definition stays
    w = _text("windowed.cuh")
    assert tgl.one_thread("windowed.cuh", w) == w
    for h in build.CSRC.glob("*.cuh"):
        assert _uses(tgl.one_thread(h.name, h.read_text()),
                     GROUP_FORMS) == 0, h.name


def test_shape_parser_reads_every_table():
    """groupfield.cuh's shape lines: GroupShape and AddShape, a default
    each, every K's own line."""
    text = _text(tgl.SHAPES_HEADER)
    shapes = tgl.shapes_of(text)
    lines = re.findall(r"^(?:template <> )?struct \w+Shape(?:<\d+>)? : "
                       r"Shape<", text, re.M)
    assert sum(len(v) for v in shapes.values()) == len(lines)
    assert None in shapes["GroupShape"] and None in shapes["AddShape"]
    for table in ("GroupShape", "AddShape"):
        for k in (6, 7, 8, 10, 12, 14, 16, 17):
            assert re.fullmatch(r"t\d+x\d+i?",
                                tgl.shape_at(shapes, table, k))


@pytest.mark.parametrize("spec", ["2x64", "4x128i", "8x256"])
def test_shape_edit_sets_every_table(spec):
    text = _text(tgl.SHAPES_HEADER)
    edited = tgl.shaped(spec)(tgl.SHAPES_HEADER, text)
    want = "t" + spec
    shapes = tgl.shapes_of(edited)
    assert {tuple(v) for v in shapes.values()} == \
        {tuple(v) for v in tgl.shapes_of(text).values()}
    for table in ("GroupShape", "AddShape"):
        for k in (6, 7, 8, 10, 12, 14, 16, 17):
            assert tgl.shape_at(shapes, table, k) == want
    assert tgl.shaped(spec)("point.cuh", "x") == "x"


def test_ptxas_summary_keys_each_kernel_by_its_shape():
    shapes = tgl.shapes_of(_text(tgl.SHAPES_HEADER))
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN3ecc20formula_group_"
        "kernelINS_8PointAddELi17ELi1EEEvNT_3CtxIXT0_EEENS_6InRowsIXsrS2_3kIn"
        "EEENS_7OutRowsIXsrS2_4kOutEEEx'",
        "ptxas info    : Used 96 registers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_ZN3ecc16point_add_kernelILi17ELi1EEEvNS_8CurveCtxIXT_EEE'",
        "    200 bytes stack frame, 180 bytes spill stores, 180 bytes spill",
        "ptxas info    : Used 255 registers",
        "ptxas info    : Compiling entry function '_ZN3ecc28windowed_mul_"
        "ed_group_kernelILi8ELi0ELi2EEEvNS_10EdCurveCtxIXT_EEE'",
        "ptxas info    : Used 80 registers",
        "ptxas info    : Compiling entry function '_ZN3ecc20formula_group_"
        "kernelINS_5EdAddELi14ELi2EEEvNT_3CtxIXT0_EEENS_6InRowsIXsrS2_3kInEEE"
        "NS_7OutRowsIXsrS2_4kOutEEEx'",
        "ptxas info    : Used 72 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN3ecc13ed_add_kernelILi14ELi2EEEvNS_10EdCurveCtxIXT_EEE'",
        "ptxas info    : Used 168 registers"])
    got = tgl.ptxas_summary(log, shapes)
    add = tgl.shape_at(shapes, "AddShape", 17)
    ed = tgl.shape_at(shapes, "GroupShape", 8)
    ed_add = tgl.shape_at(shapes, tgl.TABLE_OF["ed_add"], 14)
    assert got == {f"point_add_k17_a1_{add}": [96, 0, 0],
                   "point_add_k17_a1_t1": [255, 180, 200],
                   f"windowed_mul_ed_k8_a0_p2_{ed}": [80, 0, 0],
                   f"ed_add_k14_a2_{ed_add}": [72, 0, 0],
                   "ed_add_k14_a2_t1": [168, 0, 0]}


@pytest.mark.parametrize("kind", ["add", "dbl"])
@pytest.mark.parametrize("name,k", [("ED25519", 8), ("ED448", 14)])
def test_add_kernels_plan_the_edwards_add(name, k, kind):
    """--kernels add (dbl) on an Edwards curve times kernel 8a (8b), built
    from its own source alone."""
    plan, stems = tgl.stems_for([name], (kind,))
    c, ed, rows = plan[name]
    assert ed and c.fp_ctx.k == k
    assert rows == [(kind, 0, tgl.ED_ADD_STEM)]
    assert stems == [tgl.ED_ADD_STEM]


def test_every_group_kernel_has_a_shape_table():
    """ptxas_summary keys each group kernel by the shape of its family's
    table: every *_group_kernel of the sources, and every formula that
    launch_group runs, has one, and it is a table of groupfield.cuh."""
    tables = tgl.shapes_of(_text(tgl.SHAPES_HEADER))
    text = "\n".join(p.read_text() for p in build.CSRC.glob("*.cu*"))
    ops = set(re.findall(r"\blaunch_group<(?:ecc::)?(\w+),", text))
    bases = ({tgl.kernel_base(k) for k in
              re.findall(r"\b(\w+_group_kernel)\b", text)}
             - {"formula"}) | {tgl.kernel_base("", op) for op in ops}
    assert {"point_add", "point_dbl", "ed_add", "ed_dbl", "windowed_mul",
            "windowed_mul_ed"} <= bases
    for base in bases:
        assert tgl.TABLE_OF[base] in tables, base
