"""The port's kernel build cache (`paddle_tpu_torch.ops._build`): the
tag that names a built library covers the source and every header it
includes, so an edited header is never served from a stale library.
No nvcc needed: only the tag is computed."""
import shutil

import pytest

from paddle_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc/ plus a small tree of its own: a.cu
    including one.cuh, which includes two.cuh; three.cuh included by
    nothing."""
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    (d / "two.cuh").write_text("#pragma once\nconstexpr int kTwo = 2;\n")
    (d / "one.cuh").write_text('#pragma once\n#include "two.cuh"\n'
                               "constexpr int kOne = 1;\n")
    (d / "three.cuh").write_text("constexpr int kThree = 3;\n")
    (d / "a.cu").write_text('#include <cstdint>\n#include "one.cuh"\n'
                            "int f() { return kOne + kTwo; }\n")
    return d


def test_tag_changes_with_an_included_header(csrc):
    before = _build.source_tag(csrc / "a.cu")
    assert before == _build.source_tag(csrc / "a.cu")
    (csrc / "one.cuh").write_text((csrc / "one.cuh").read_text() + "// x\n")
    after_one = _build.source_tag(csrc / "a.cu")
    assert after_one != before
    # a header included through another one counts too
    (csrc / "two.cuh").write_text("#pragma once\nconstexpr int kTwo = 3;\n")
    assert _build.source_tag(csrc / "a.cu") not in (before, after_one)


def test_tag_ignores_headers_not_included(csrc):
    before = _build.source_tag(csrc / "a.cu")
    (csrc / "three.cuh").write_text("constexpr int kThree = 4;\n")
    assert _build.source_tag(csrc / "a.cu") == before


@pytest.mark.parametrize("name", ["qkv_proj", "flash_attention"])
def test_kernel_sources_are_tagged_with_hopper_cuh(csrc, name):
    """The two wgmma sources include hopper.cuh: editing it changes
    their tags, and the tag is the library's name."""
    before = _build.source_tag(csrc / f"{name}.cu")
    assert before == _build.source_tag(_build.CSRC / f"{name}.cu")
    hdr = csrc / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build.source_tag(csrc / f"{name}.cu") != before
    assert len(before) == 12 and int(before, 16) >= 0
