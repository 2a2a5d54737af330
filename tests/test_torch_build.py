"""The kernels' build directory: its name hashes the nvcc flags and every
file under ``csrc/``, so a changed source, a changed or new shared header,
or a changed flag (an include path) builds anew.  Pure Python: nothing
is compiled here."""
import shutil

from repro_torch.kernels import build


def test_build_dir_hashes_every_csrc_file_and_the_flags(tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build._build_dir()
    assert first == build._build_dir() and first.parent == build.BUILD_ROOT
    seen = {first}

    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    seen.add(build._build_dir())
    (csrc / "extra.cuh").write_text("// a new shared header\n")
    seen.add(build._build_dir())
    source = csrc / "segment_sum.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    seen.add(build._build_dir())
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ["-I/usr/local/cutlass/include"])
    seen.add(build._build_dir())
    assert len(seen) == 5


def test_the_shared_header_is_under_csrc_and_included():
    assert (build.CSRC / "hopper.cuh").is_file()
    assert '#include "hopper.cuh"' in (
        build.CSRC / "flash_attention.cu").read_text()
