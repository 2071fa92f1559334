"""The kernel build cache (avsum_torch.build): a library's cached name
follows its source and every ``csrc`` header the source includes, so an
edited header is never served by a stale library. No nvcc is needed."""

import re

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
    """The hashed bytes hold every csrc header the source reaches through
    its includes (flash_fwd.cu and flash_bwd.cu reach mma_tf32.cuh through
    flash_tiles.cuh), and no other."""
    src = build.CSRC_DIR / f"{name}.cu"
    data = build._source_bytes(src)
    assert data.startswith(src.read_bytes())
    reached, todo = set(), [src]
    while todo:
        for inc in re.findall(rb'#include "([^"]+)"', todo.pop().read_bytes()):
            header = build.CSRC_DIR / inc.decode()
            if header not in reached:
                reached.add(header)
                todo.append(header)
    assert build.CSRC_DIR / "mma_tf32.cuh" in reached
    for header in build.CSRC_DIR.glob("*.cuh"):
        assert (header.read_bytes() in data) == (header in reached), header
    assert build.library_path(name).name.startswith(f"lib{name}-")
