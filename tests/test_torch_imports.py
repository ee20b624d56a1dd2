"""The PyTorch port's package boundary: it imports without JAX, its kernel
build targets sm_90a into a git-ignored directory, and a kernel wrapper
handed CPU tensors runs the plain version without touching the CUDA
library."""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dvo_tpu_torch.config import MapperConfig, TrackerConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build, epipolar, framebuild, gn, regularize

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with ``jax``
    unimportable, as on the GPU machine, which has no JAX."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, dvo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dvo_tpu_torch.__path__, 'dvo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'dvo_tpu_torch.models.odometry' in names and 'dvo_tpu_torch.ops.cuda.gn' in names\n"
        "assert 'dvo_tpu_torch.run' in names and 'dvo_tpu_torch.utils.runner' in names\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 26


def test_build_command_targets_sm90a_in_ignored_dir(monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    out = _build.library_path()
    cmd = _build.nvcc_command(out)
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in cmd and "-fmad=false" in cmd and "--use_fast_math" not in cmd
    assert {Path(c).name for c in cmd if c.endswith(".cu")} == {
        "gn.cu", "epipolar.cu", "regularize.cu", "framebuild.cu"}
    assert Path(cmd[cmd.index("-o") + 1]).parent == _build.BUILD_DIR
    ignored = (REPO / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.relative_to(REPO).as_posix() + "/" in ignored


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    """A changed source gets a new library file, so a stale build is never
    loaded."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    first = _build.library_path()
    (src / "k.cu").write_text("// two\n")
    assert _build.library_path() != first


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: sys.executable)  # rejects nvcc's flags
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


@pytest.mark.parametrize("device,expect", [("cpu", "plain"), ("cuda", "cuda"),
                                           (torch.device("cuda", 0), "cuda")])
def test_resolve_device(device, expect):
    assert resolve_device(device) == expect


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")


def _gn_inputs(rng, h=12, w=16):
    f = lambda: torch.from_numpy(rng.uniform(0.2, 1.0, (h, w)).astype(np.float32))
    b = lambda: torch.ones((h, w), dtype=torch.bool)
    K = torch.tensor([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    return (f(), b(), f() + 1.0, f() * 0.3, f(), b(), f() - 0.5, f() - 0.5, b(), K,
            torch.eye(4), 1, TrackerConfig())


def _epi_inputs(rng, h=10, w=12, c=2):
    fields = torch.from_numpy(rng.uniform(0.0, 1.0, (epipolar.N_FIELDS, h, w)).astype(np.float32))
    fields[epipolar.F_SLOT] = torch.from_numpy(rng.integers(0, c, (h, w)).astype(np.float32))
    fields[epipolar.F_LENGTH] *= 20.0
    ring = torch.from_numpy(rng.uniform(0, 1, (3, c, h, w)).astype(np.float32))
    return fields, ring[0], ring[1], ring[2], torch.ones((c, h, w), dtype=torch.bool), MapperConfig()


def _reg_inputs(rng, h=10, w=12):
    return (torch.from_numpy((1 + rng.random((h, w))).astype(np.float32)),
            torch.from_numpy((0.1 + 0.4 * rng.random((h, w))).astype(np.float32)),
            MapperConfig())


def _build_inputs(rng, h=11, w=13):
    return (torch.from_numpy(rng.random((h, w), np.float32)),
            torch.from_numpy(rng.random((h, w)) > 0.1),
            torch.from_numpy(rng.random((h, w), np.float32) + 0.5),
            torch.from_numpy(rng.random((h, w), np.float32) * 0.3), 3)


def _pair_inputs(rng):
    _, _, d, s, levels = _build_inputs(rng)
    return d, s, levels


def _flat(out):
    """Tensors of a kernel's output, in order (tuples, lists, per-level dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return []


@pytest.mark.parametrize("name,wrapper,plain,make", [
    ("gn", gn.gn_terms, gn.gn_terms_plain, _gn_inputs),
    ("epipolar", epipolar.epipolar_update, epipolar.epipolar_update_plain, _epi_inputs),
    ("regularize", regularize.regularize, regularize.regularize_plain, _reg_inputs),
    ("framebuild", framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
     _build_inputs),
    ("framebuild_pair", framebuild.cull_pyramid_pair, framebuild.cull_pyramid_pair_plain,
     _pair_inputs),
    ("framebuild_one", framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
     lambda rng: _pair_inputs(rng)[::2]),
])
def test_cpu_tensors_take_the_plain_path(name, wrapper, plain, make, rng, monkeypatch):
    def no_cuda(*_, **__):
        raise AssertionError("the CPU path touched the CUDA library")

    monkeypatch.setattr(_build, "library", no_cuda)
    monkeypatch.setattr(ctypes, "CDLL", no_cuda)
    _build.reset_launches()
    args = make(rng)
    got, want = _flat(wrapper(*args)), _flat(plain(*args))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _build.LAUNCHES == {"gn": 0, "epipolar": 0, "regularize": 0, "framebuild": 0}


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((4, 5), dtype=torch.float64), "dtype"),
    (torch.zeros((5, 4), dtype=torch.float32), "shape"),
    (torch.zeros((5, 4), dtype=torch.float32).T, "contiguous"),
    (torch.zeros((4, 5), dtype=torch.float32, device="meta"), "expected cpu"),
])
def test_kernel_inputs_are_checked(bad, match):
    with pytest.raises(ValueError, match=match):
        _build.require(bad, "x", torch.float32, (4, 5), torch.device("cpu"))


@pytest.mark.parametrize("call,match", [
    (lambda g, m, d, s: framebuild.build_pyramid_planes(g.double(), m, d, s, 3), "dtype"),
    (lambda g, m, d, s: framebuild.build_pyramid_planes(g, m.float(), d, s, 3), "mask: dtype"),
    (lambda g, m, d, s: framebuild.build_pyramid_planes(g, m, d[:, :-1], s, 3), "shape"),
    (lambda g, m, d, s: framebuild.build_pyramid_planes(g, m, d, s.T.contiguous().T, 3),
     "contiguous"),
    (lambda g, m, d, s: framebuild.cull_pyramid_pair(d, s[1:], 3), "shape"),
    (lambda g, m, d, s: framebuild.cull_pyramid_one(d.half(), 3), "dtype"),
    (lambda g, m, d, s: framebuild.cull_pyramid_one(d, 0), "levels"),
])
def test_framebuild_launch_checks_its_inputs(call, match, rng, monkeypatch):
    """On the launch route every input is checked before the library is
    touched (the kernel takes raw pointers)."""
    def no_library():
        raise AssertionError("reached the library with a bad input")

    monkeypatch.setattr(framebuild, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", no_library)
    g, m, d, s, _ = _build_inputs(rng, 12, 12)
    with pytest.raises(ValueError, match=match):
        call(g, m, d, s)
