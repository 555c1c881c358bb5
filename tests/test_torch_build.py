"""The port's kernel build orchestration (ops/_build.py), with a stand-in
compiler: the CPU has no nvcc, but which sources build, where the library
lands, when a build is reused and how a failed build is reported are plain
Python."""

import os
import stat
import sys
import textwrap

import pytest

from galvatron_tpu_torch.ops import _build
import _torch_threads  # noqa: F401

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import sys
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    src = args[-1]
    if "{fail}" and src.endswith("{fail}"):
        print("error: cannot compile " + src)
        sys.exit(1)
    print("ptxas info    : Used 32 registers")
    with open(out, "w") as f:
        f.write(" ".join(args))
""")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def make(fail=""):
        path = tmp_path / f"nvcc{fail.replace('.', '_')}"
        path.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(path))
        return str(path)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    return make


def test_every_source_builds_for_sm90a_and_is_reused(fake_nvcc):
    nvcc = fake_nvcc()
    assert _build.sources() == ["flash_bwd", "flash_fwd", "flash_grid_bwd", "flash_grid_fwd",
                                "fused_norm", "paged_decode"]
    log = _build.build_all()
    targets = {name: _build._target(name, nvcc) for name in _build.sources()}
    for name, target in targets.items():
        assert log[name]["path"] == str(target) and target.exists()
        assert "arch=compute_90a,code=sm_90a" in target.read_text()
        assert "registers" in log[name]["ptxas"]
    # one library per source and no temp left
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        t.name for t in targets.values())
    mtime = os.path.getmtime(targets["paged_decode"])
    _build.BUILD_LOG.clear()
    assert _build.build_all()["paged_decode"]["ptxas"] == "(cached)"
    assert os.path.getmtime(targets["paged_decode"]) == mtime


def test_the_library_name_follows_source_and_compiler(fake_nvcc):
    a = _build._target("paged_decode", "cuda-12/bin/nvcc")
    b = _build._target("paged_decode", "cuda-13/bin/nvcc")
    assert a != b and a.name.startswith("libpaged_decode-") and a.suffix == ".so"


def test_a_failed_build_raises_with_the_compiler_output(fake_nvcc):
    fake_nvcc(fail="paged_decode.cu")
    with pytest.raises(RuntimeError, match="cannot compile"):
        _build.build_all()
    # nothing half-written is left to load: only the sources that built
    assert sorted(p.name.split("-")[0] for p in _build.BUILD_DIR.iterdir()) == [
        "libflash_bwd", "libflash_fwd", "libflash_grid_bwd", "libflash_grid_fwd",
        "libfused_norm"]


def test_a_shared_header_change_rebuilds_every_source(fake_nvcc, tmp_path, monkeypatch):
    nvcc = fake_nvcc()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n, nvcc) for n in ("a", "b")}
    (csrc / "common.cuh").write_text("// edited\n")
    after = {n: _build._target(n, nvcc) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
