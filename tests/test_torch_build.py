"""The kernel build's cache key (`ops/_build.py`): the library is keyed
by a hash of every file under `csrc/`, so an edited header rebuilds as an
edited source does. Runs on the CPU; nothing is compiled."""
import os
import shutil

import pytest

from skypilot_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, 'CSRC', str(copy))
    return copy


def test_sources_include_the_shared_header():
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            assert '#include "hopper.cuh"' in f.read()


@pytest.mark.parametrize('name', ['hopper.cuh', *_build.SOURCES])
def test_digest_changes_when_a_csrc_file_changes(csrc_copy, name):
    before = _build._digest()
    assert _build._digest() == before            # stable for one tree
    with open(csrc_copy / name, 'a') as f:
        f.write('\n// edited\n')
    assert _build._digest() != before


def test_digest_sees_a_new_header(csrc_copy):
    before = _build._digest()
    (csrc_copy / 'extra.cuh').write_text('#pragma once\n')
    assert _build._digest() != before
