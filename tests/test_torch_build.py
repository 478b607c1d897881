"""The port's kernel build cache, without nvcc: a library is named by a hash
of its source, of every shared header in ``csrc/`` and of the flags, so an
edited header or source is rebuilt and a stale library is never loaded."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import importlib
import shutil

import pytest

_build = importlib.import_module("cron_operator_tpu_torch.ops._build")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _names():
    return sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def test_every_source_has_its_own_library(csrc_copy):
    paths = {_build._library_path(n) for n in _names()}
    assert len(paths) == len(_names()) >= 4
    assert all(p.parent == _build.BUILD_DIR for p in paths)


@pytest.mark.parametrize("header", ["sm90.cuh"])
def test_editing_a_header_renames_every_library(csrc_copy, header):
    before = {n: _build._library_path(n) for n in _names()}
    path = csrc_copy / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _names()}
    assert all(before[n] != after[n] for n in _names())


def test_a_new_header_renames_every_library(csrc_copy):
    before = {n: _build._library_path(n) for n in _names()}
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert all(_build._library_path(n) != before[n] for n in _names())


def test_editing_a_source_renames_only_its_library(csrc_copy):
    names = _names()
    before = {n: _build._library_path(n) for n in names}
    edited = csrc_copy / "flash_fwd_sm90.cu"
    edited.write_text(edited.read_text() + "\n// edited\n")
    for n in names:
        assert (_build._library_path(n) != before[n]) == (n == "flash_fwd_sm90")


def test_flags_are_in_the_name(csrc_copy, monkeypatch):
    before = _build._library_path("flash_fwd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._library_path("flash_fwd") != before


def test_unchanged_tree_keeps_its_names(csrc_copy):
    assert ([_build._library_path(n) for n in _names()]
            == [_build._library_path(n) for n in _names()])
