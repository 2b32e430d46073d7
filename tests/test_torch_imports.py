"""The port's import rule and its kernel builder, checked without a GPU.

The rule: fib_tf_tpu_torch and chip_smoke.py import no JAX and nothing of
the JAX package fib_tf_tpu, not even a module that does not import JAX
(importing fib_tf_tpu.config runs fib_tf_tpu/__init__.py).  An import-time
check cannot show it (jax may already be imported in the process), so
this scans the sources."""

import ast
import os
from pathlib import Path

import pytest

from fib_tf_tpu_torch.kernels import build
from test_torch_fixtures import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "fib_tf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level:
                raise AssertionError(f"{path}: relative import {node.module}")
            if node.module == "fib_tf_tpu":
                yield from (f"fib_tf_tpu.{a.name}" for a in node.names)
            else:
                yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "fib_tf_tpu"), (
            f"{path.name} imports {name}")


def test_scan_sees_the_package():
    names = {p.name for p in SOURCES}
    assert {"cuda_step.py", "simulation.py", "build.py", "config.py",
            "stencil3d.py", "volume.py", "cuda_volume.py",
            "cuda_volume_tiled.py", "chip_smoke.py", "cuda_block.py",
            "cuda_volume_block.py", "sharding.py", "halo.py", "spmd.py",
            "volume_spmd.py"} <= names


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    monkeypatch.setattr(build, "_DEFAULT_CUDA_HOME", str(tmp_path / "none"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("br_substep", [build.CSRC_DIR / "br_substep.cu"])


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return home


def test_build_invokes_nvcc_and_caches_by_source_hash(monkeypatch, tmp_path):
    # a stand-in compiler that writes its arguments as the "library"
    home = _fake_nvcc(tmp_path, 'for a; do case "$p" in -o) out=$a;; esac; '
                      'p=$a; done\necho "$@" > "$out"\n'
                      'echo "ptxas info : Used 8 registers"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    lib = build.build("k", [src])
    args = lib.read_text()
    assert "arch=compute_90a,code=sm_90a" in args and "-O3" in args
    assert "use_fast_math" not in args
    assert "Used 8 registers" in lib.with_name(lib.name + ".log").read_text()
    assert build.build("k", [src]) == lib            # cached
    src.write_text("// v2\n")
    assert build.library_path("k", [src]) != lib     # edited source rebuilds
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_edited_header_changes_the_library_path(monkeypatch, tmp_path):
    # headers are hashed into the name but not put on nvcc's command line
    home = _fake_nvcc(tmp_path, 'for a; do case "$p" in -o) out=$a;; esac; '
                      'p=$a; done\necho "$@" > "$out"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src, hdr = tmp_path / "k.cu", tmp_path / "cell.cuh"
    src.write_text('#include "cell.cuh"\n')
    hdr.write_text("// v1\n")
    lib = build.build("k", [src])
    assert str(src) in lib.read_text() and "cell.cuh" not in lib.read_text()
    assert build.library_path("k", [src]) == lib
    hdr.write_text("// v2\n")
    edited = build.library_path("k", [src])
    assert edited != lib and not edited.exists()
    assert build.build("k", [src]) == edited


def test_defines_reach_nvcc_and_the_library_path(monkeypatch, tmp_path):
    """A library built with -D macros (kernels 2 and 3's GEOM entries) is
    another library of the same source."""
    home = _fake_nvcc(tmp_path, 'for a; do case "$p" in -o) out=$a;; esac; '
                      'p=$a; done\necho "$@" > "$out"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    plain = build.build("k", [src])
    geom = build.build("k_geom", [src], defines=("FIBTORCH_GEOM_ENTRIES",))
    assert geom != plain
    assert "-DFIBTORCH_GEOM_ENTRIES" in geom.read_text()
    assert "-D" not in plain.read_text().split()
    assert (build.library_path("k", [src], defines=("X",))
            != build.library_path("k", [src]))


def test_geom_libraries_are_the_sources_with_a_define():
    """The tile skeleton's GEOM entries are a second library of their
    source; kernel 3's large bodies keep both forms in the library of their
    body (csrc/large_block.cu)."""
    from fib_tf_tpu_torch.ops import bodies, cuda_block, cuda_step, cuda_tiled
    for mod, name in ((cuda_tiled, "br_tiled"), (cuda_block, "br_block")):
        for body, kernel in mod.GEOM_KERNELS.items():
            assert kernel.entry == f"{body}_{name[3:]}_geom"
            if mod is cuda_block and cuda_block.large_body(body):
                lib = bodies.BODIES[body].library
                assert kernel.library_name == lib.name("block")
                assert kernel.defines == mod.KERNELS[body].defines
                assert kernel.library_name == mod.KERNELS[body].library_name
                continue
            assert kernel.library_name == f"{name}_geom"
            assert kernel.defines == ("FIBTORCH_GEOM_ENTRIES",)
            assert mod.KERNELS[body].defines == ()
        assert "FIBTORCH_GEOM_ENTRIES" in mod.SOURCE.read_text()
    assert all(k.entry.endswith("_substep_geom")
               for k in cuda_step.GEOM_KERNELS.values())


def _quoted_includes(path):
    return {line.split('"')[1] for line in path.read_text().splitlines()
            if line.startswith('#include "')}


BINDINGS = ("cuda_step", "cuda_tiled", "cuda_volume", "cuda_volume_tiled",
            "cuda_block", "cuda_volume_block")


def _bindings():
    """Every kernel binding of the port, GEOM forms included."""
    import importlib
    for name in BINDINGS:
        mod = importlib.import_module(f"fib_tf_tpu_torch.ops.{name}")
        yield from getattr(mod, "KERNELS", {"br": mod.KERNEL}).values()
        yield from getattr(mod, "GEOM_KERNELS", {}).values()


def test_bindings_hash_every_header_their_sources_include():
    """A source names every header it depends on, also those that reach it
    through another header, and its binding hashes them all: the headers
    build.includes finds, which are the source's own includes."""
    from fib_tf_tpu_torch.ops import cuda_block
    sources = {k.source for k in _bindings()}
    assert cuda_block.LARGE_SOURCE in sources and len(sources) == 7
    for source in sources:
        headers = build.includes([source])
        included = _quoted_includes(source)
        assert included == {h.name for h in headers}, source.name
        assert list(headers) == sorted(headers)
        for hdr in headers:
            assert hdr.parent == source.parent and hdr.is_file()
            assert _quoted_includes(hdr) <= included, hdr.name


def test_includes_is_the_closure_of_the_quoted_includes(tmp_path):
    """A nested include is found, one reached through two paths is listed
    once, a cycle ends, an angle-bracket include is the compiler's, and
    the headers hash into the library's name."""
    (tmp_path / "sub").mkdir()
    files = {
        "k.cu": '#include "a.cuh"\n#include "b.cuh"\n#include <cstdio>\n',
        "a.cuh": '#include "sub/c.cuh"\n',
        "b.cuh": '#include "sub/c.cuh"\n#include "a.cuh"\n',
        "sub/c.cuh": '#include "d.cuh"\n',
        "sub/d.cuh": '#include "../a.cuh"\n',
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    src = tmp_path / "k.cu"
    got = build.includes([src])
    assert [h.resolve() for h in got] == sorted(
        (tmp_path / n).resolve() for n in files if n != "k.cu")
    assert len(got) == 4
    path = build.library_path("k", [src])
    (tmp_path / "sub" / "d.cuh").write_text('#include "../a.cuh"\n// v2\n')
    assert build.library_path("k", [src]) != path


def test_block_kernels_share_the_earlier_kernels_headers():
    """Kernel 3 hosts kernel 2's cell bodies on the tile skeleton and
    Courtemanche's two, Luo-Rudy's and tp06's, which kernel 2 does not
    host, in csrc/large_block.cu with kernel 1's bodies; kernel 6 hosts
    every body of kernel 4, with its headers."""
    from fib_tf_tpu_torch.ops import (cuda_block, cuda_step, cuda_tiled,
                                      cuda_volume, cuda_volume_block)

    def headers(source):
        return set(build.includes([source]))

    assert headers(cuda_block.SOURCE) == headers(cuda_tiled.SOURCE)
    bodies = {build.CSRC_DIR / name for name in (
        "br_cell.cuh", "br_variant_cell.cuh", "fenton_cell.cuh",
        "ms_cell.cuh")}
    assert bodies <= headers(cuda_volume.SOURCE)
    large = {build.CSRC_DIR / name for name in (
        "court_cell.cuh", "lr1_cell.cuh", "tp06_cell.cuh",
        "torch_rounding.cuh")}
    assert (large <= headers(cuda_block.LARGE_SOURCE)
            <= headers(cuda_step.SOURCE))
    assert headers(cuda_volume_block.SOURCE) == headers(cuda_volume.SOURCE)
    assert set(cuda_volume_block.KERNELS) == set(cuda_volume.KERNELS)
    large_bodies = {"court", "court_ultra", "lr1", "tp06"}
    assert set(cuda_block.KERNELS) == set(cuda_tiled.KERNELS) | large_bodies
    assert not large_bodies & set(cuda_tiled.KERNELS)


def test_failed_build_raises_with_log(monkeypatch, tmp_path):
    home = _fake_nvcc(tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("broken")
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build("k", [src])
    assert not build.library_path("k", [src]).exists()


def test_kernel_sources_ship_with_the_package():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"fib_tf_tpu_torch.csrc"' in text
    for name in ("br_substep.cu", "br_tiled.cu", "br_volume.cu",
                 "br_volume_tiled.cu", "br_cell.cuh", "br_block.cu",
                 "br_volume_block.cu", "br_tile.cuh", "br_volume_cell.cuh",
                 "br_variant_cell.cuh", "fenton_cell.cuh", "ms_cell.cuh",
                 "geometry.cuh", "cell_traits.cuh", "court_cell.cuh",
                 "large_block.cu"):
        assert (build.CSRC_DIR / name).is_file()
    assert os.path.commonpath([build.BUILD_DIR, ROOT]) == str(ROOT)
