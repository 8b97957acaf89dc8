"""vireo_tpu_torch.ops._build: what the name of a built kernel library
hashes. A library is rebuilt whenever its source, a header it includes
from csrc/ (directly or through another header) or the flags change;
no nvcc is needed to check that."""

from vireo_tpu_torch.ops import _build


def _tree(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n# include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")


def test_compiled_files_follow_local_includes(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    assert [p.name for p in _build.compiled_files("k")] == [
        "a.cuh", "b.cuh", "k.cu"]


def test_library_path_changes_with_an_included_header(tmp_path,
                                                      monkeypatch):
    _tree(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert first.name.startswith("libk_") and first.parent == _build.BUILD_DIR
    (tmp_path / "other.cuh").write_text("int other = 1;\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("#pragma once\nint b = 2;\n")
    second = _build.library_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("k") != second


def test_kernel_sources_share_the_hopper_header():
    for name in ("fused_estep", "packed_counts"):
        names = {p.name for p in _build.compiled_files(name)}
        assert names == {"hopper_gemm.cuh", name + ".cu"}
