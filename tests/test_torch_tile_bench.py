"""tools/torch_tile_bench.py's SASS census on a made-up listing in
cuobjdump's format: what it counts per cell-substep is the yardstick of the
tile kernels' constant loads (PERF.md), so it must cut a kernel into its
substep forms, leave out the last substep's stores and classify the rest.
Runs on the CPU; imports no CUDA."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "torch_tile_bench", ROOT / "tools" / "torch_tile_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def listing(code):
    """cuobjdump -sass lines of one function from (label, instruction)
    pairs; a branch operand `@label` becomes that instruction's address."""
    where = {label: 16 * i for i, (label, _) in enumerate(code) if label}
    lines = ["\t\tFunction : _Z11tile_kernelI16BeelerReuterCellEvv"]
    for i, (_, ins) in enumerate(code):
        for label, addr in where.items():
            ins = ins.replace(f"@{label}", hex(addr))
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"    /* 0x000fe40000000f00 */")
        lines.append("                                         "
                     "/* 0x000fe40000000f00 */")
    return "\n".join(lines)


def row(ffma, edge, skip):
    """One row of a substep form: its loads, the division's reciprocal, the
    fits, the shared store of V and the last substep's stores."""
    return ([(None, "VIMNMX R1, R2, 0x1, !PT")] if edge else []) + [
        (None, "ULDC.64 UR4, c[0x0][0x210]"),
        (None, "LDC.64 R2, c[0x0][0x218]"),
        (None, "MUFU.RCP R5, R6"),
        *[(None, "FFMA R7, R2, UR4, R7")] * ffma,
        (None, "@P0 STS [R8+0x100], R7"),
        (None, f"@P0 BRA @{skip}"),
        (None, "STG.E desc[UR8][R10.64], R7"),
        (None, "STG.E desc[UR8][R12.64], R3"),
    ]


def kernel():
    return [
        (None, "BAR.SYNC.DEFER_BLOCKING 0x0"),
        (None, "STS [UR6+0x40], R0"),           # the walk's, not a row's
        ("head", "LOP3.LUT P0, RZ, R28, UR50, RZ, 0xc0, !PT"),
        (None, "@!P0 BRA @frozen"),
        *row(120, False, "r1"),
        ("r1", "IADD3 R9, R9, 0x10, RZ"),
        *row(120, False, "slow_end"),
        ("slow_end", "BRA @join"),
        ("frozen", "ISETP.GT.AND P0, PT, R56, R3, PT"),
        *row(60, True, "f1"),
        ("f1", "IADD3 R9, R9, 0x10, RZ"),
        *row(60, True, "join"),
        ("join", "BSYNC B2"),
        (None, "LDGSTS.E [R25], desc[UR8][R12.64]"),
        (None, "LDGSTS.E [R25+0xc000], desc[UR8][R10.64]"),
        (None, "@!P1 BRA @head"),
        (None, "EXIT"),
    ]


def test_cell_substeps_cut_a_kernel_into_its_substep_forms(bench):
    (lines,) = bench.sass_functions(listing(kernel()), lines=True).values()
    kinds = bench.per_kind(bench.cell_substeps(bench.sass_instructions(
        lines)))
    assert set(kinds) == {"slow_clamp_free", "frozen_edge"}
    slow, frozen = kinds["slow_clamp_free"], kinds["frozen_edge"]
    assert slow["rows"] == frozen["rows"] == 2
    # per row: one ULDC.64 and one LDC.64, the reciprocal, the FFMAs, one
    # STS; the last substep's two STG are left out
    for form, ffma in ((slow, 120), (frozen, 60)):
        assert (form["const_load"], form["ldc"]) == (2, 1)
        assert (form["mufu"], form["shared"], form["float"]) == (1, 1, ffma)
    # the SLOW form: the loop head's 2, each row's 125, the IADD3 between
    # them and its closing jump; the frozen one's ISETP, VIMNMX and IADD3
    assert slow["total"] == (2 + 2 * 125 + 1 + 1) / 2
    assert frozen["other"] == (1 + 2 + 1) / 2


def test_sass_functions_ignore_column_padding(bench):
    text = listing(kernel())
    padded = text.replace("                   ", "                      ")
    assert (bench.sass_functions(text, lines=True)
            == bench.sass_functions(padded, lines=True))
    (ops,) = bench.sass_functions(text).values()
    assert ops[:3] == ["BAR.SYNC.DEFER_BLOCKING", "STS", "LOP3.LUT"]


@pytest.mark.parametrize("op, cls", [
    ("ULDC.64", "const_load"), ("LDC", "const_load"), ("FFMA", "float"),
    ("FMUL", "float"), ("MUFU.RCP", "mufu"), ("LDS.128", "shared"),
    ("BAR.SYNC.DEFER_BLOCKING", "control"), ("BRA", "control"),
    ("IMAD.MOV.U32", "other"), ("LDGSTS.E", "other")])
def test_op_class(bench, op, cls):
    assert bench.op_class(op) == cls
