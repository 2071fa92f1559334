"""The kernel build cache (avsum_torch.build): a library's cached name
follows its source and every ``csrc`` header the source includes, so an
edited header is never served by a stale library. No nvcc is needed."""

import pytest

from avsum_torch import build


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <math.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n// v1\n')
    (tmp_path / "c.cuh").write_text("// not included\n")
    first = build.library_path("k")
    assert first.parent == tmp_path / "out" and first.name.startswith("libk-")
    (tmp_path / "c.cuh").write_text("// edited, still not included\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n// v2\n')
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", build.KERNELS)
def test_kernel_sources_hash_their_headers(name):
    src = build.CSRC_DIR / f"{name}.cu"
    data = build._source_bytes(src)
    header = (build.CSRC_DIR / "mma_tf32.cuh").read_bytes()
    assert data.startswith(src.read_bytes())
    assert (header in data) == (b'#include "mma_tf32.cuh"' in src.read_bytes())
    assert build.library_path(name).name.startswith(f"lib{name}-")
