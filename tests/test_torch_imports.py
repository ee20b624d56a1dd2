"""The PyTorch port's package boundary: it imports without JAX and without
``dvo_tpu``, its kernel build targets sm_90a into a git-ignored directory,
and a kernel wrapper handed CPU tensors runs the plain version without
touching the CUDA library."""

import ast
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import MapperConfig, TrackerConfig, resolve_device
from dvo_tpu_torch.models import frame, mapper
from dvo_tpu_torch.ops.cuda import _build, epipolar, framebuild, gn, gn_level, pose, regularize

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with ``jax`` and
    ``dvo_tpu`` unimportable: the port keeps its own copy of what it needs."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dvo_tpu'] = None\n"
        "import importlib, pkgutil, dvo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dvo_tpu_torch.__path__, 'dvo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'dvo_tpu_torch.models.odometry' in names and 'dvo_tpu_torch.ops.cuda.gn' in names\n"
        "assert 'dvo_tpu_torch.run' in names and 'dvo_tpu_torch.utils.runner' in names\n"
        "assert 'dvo_tpu_torch.native' in names and 'dvo_tpu_torch.utils.datasets' in names\n"
        "assert {'dvo_tpu_torch.models.ba', 'dvo_tpu_torch.models.posegraph',\n"
        "        'dvo_tpu_torch.utils.oracle', 'dvo_tpu_torch.utils.record'} <= set(names)\n"
        "assert {'dvo_tpu_torch.models.graphed', 'dvo_tpu_torch.parallel',\n"
        "        'dvo_tpu_torch.parallel.mesh', 'dvo_tpu_torch.parallel.distributed',\n"
        "        'dvo_tpu_torch.parallel.streams', 'dvo_tpu_torch.parallel.tracking',\n"
        "        'dvo_tpu_torch.parallel.mapping', 'dvo_tpu_torch.parallel.ba'} <= set(names)\n"
        "assert not [m for m in sys.modules if m.startswith('dvo_tpu.')]\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 42


# ROADMAP's "not to port": a one-hot-matmul sampler for the TPU's matrix unit.
NOT_TO_PORT = {"bilinear_dense_mxu"}


@pytest.mark.parametrize("package", ["models", "ops"])
def test_package_exports_dvo_tpu_names(package):
    """Every name of ``dvo_tpu.<package>.__all__`` but those not to port is
    exported by ``dvo_tpu_torch.<package>`` (a fresh interpreter, ``jax``
    and ``dvo_tpu`` unimportable), and importing them builds no kernel."""
    import importlib

    want = sorted(set(importlib.import_module(f"dvo_tpu.{package}").__all__) - NOT_TO_PORT)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dvo_tpu'] = None\n"
        f"from dvo_tpu_torch.{package} import {', '.join(want)}\n"
        f"import dvo_tpu_torch.{package} as m\n"
        f"assert sorted(m.__all__) == {want!r}, m.__all__\n"
        "from dvo_tpu_torch.ops.cuda import _build\n"
        "assert _build._library is None\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _port_files():
    return sorted((REPO / "dvo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_file_imports_nothing_of_dvo_tpu_or_jax(path):
    """No import statement, at any depth of any file of the port, names
    ``dvo_tpu`` or ``jax`` (or a module below them)."""
    banned = ("dvo_tpu", "jax")
    hits = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        hits += [(node.lineno, n) for n in names
                 if any(n == b or n.startswith(b + ".") for b in banned)]
    assert not hits, hits


def test_build_command_targets_sm90a_in_ignored_dir(monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    out = _build.library_path()
    objs = [_build.BUILD_DIR / f"{src.stem}.o" for src in _build.sources()]
    cmds = [_build.compile_command(src, obj) for src, obj in zip(_build.sources(), objs)]
    link = _build.link_command(objs, out)
    for cmd in cmds + [link]:
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
        assert "--use_fast_math" not in cmd
        assert Path(cmd[cmd.index("-o") + 1]).parent == _build.BUILD_DIR
    assert all("-fmad=false" in cmd and "-c" in cmd for cmd in cmds)
    assert "-shared" in link and link[-len(objs):] == [str(o) for o in objs]
    assert {Path(c).name for cmd in cmds for c in cmd if c.endswith(".cu")} == {
        "gn.cu", "gn_level.cu", "epipolar.cu", "regularize.cu", "framebuild.cu", "floor.cu",
        "stage.cu", "pose.cu", "graph_if.cu"}
    assert {p.name for p in _build._headers()} == {
        "dvo_kernels.h", "gn_pixel.cuh", "gn_step.cuh", "epipolar_pixel.cuh",
        "regularize_pixel.cuh", "framebuild_cull.cuh"}
    assert all(cmd[cmd.index("-I") + 1] == str(_build.SOURCE_DIR) for cmd in cmds)
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
    second = _build.library_path()
    assert second != first
    # ... and so does a changed or added header (*.h, *.cuh).
    (src / "k_pixel.cuh").write_text("// one\n")
    third = _build.library_path()
    assert third != second
    (src / "k_pixel.cuh").write_text("// two\n")
    assert _build.library_path() != third


@pytest.mark.parametrize("entry,pointers,ints,floats", [
    ("dvo_epipolar", 9, 5, 10), ("dvo_epipolar_fused", 17, 10, 11),
    ("dvo_regularize_cull", 3, 4, 2), ("dvo_regularize", 3, 2, 2), ("dvo_framebuild", 9, 5, 0),
    ("dvo_gn_step", 6, 1, 3), ("dvo_pose_warm", 3, 0, 1), ("dvo_pose_track", 6, 0, 0),
    ("dvo_pose_table", 5, 1, 0), ("dvo_pose_emit", 6, 0, 0),
])
def test_entry_signatures(entry, pointers, ints, floats):
    """The ctypes signature of each entry: its pointers, then its ints, then
    its floats, then the stream; an int result (cudaError)."""
    argtypes, restype = _build._SIGNATURES[entry]
    assert restype is ctypes.c_int
    assert argtypes == ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                        + [ctypes.c_float] * floats + [ctypes.c_void_p])


def test_every_entry_is_defined_in_a_source():
    """Each bound name is an ``extern "C"`` function of some ``csrc/*.cu``."""
    text = "".join(src.read_text() for src in _build.sources())
    for name in _build._SIGNATURES:
        assert f'extern "C" int {name}(' in text, name


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


def _gn_level_inputs(rng, h=12, w=16):
    *planes, K, _, level, cfg = _gn_inputs(rng, h, w)
    return tuple(planes), K, torch.tensor([0.01, 0.0, 0.0, 0.0, 0.002, 0.0]), level, cfg


def _gn_launch(launcher):
    """The 29 sums of a linearisation at a 4x4 T_inv and at the state a
    step left, through ``terms_launcher``'s launch (``launcher``) or the
    plain version packed."""
    def run(*args):
        *planes, K, _, level, cfg = args
        xi = torch.tensor([0.01, 0.0, 0.0, 0.0, 0.002, 0.0])
        T = lie.se3_exp(-xi)
        state = torch.cat([torch.eye(4)[:3].reshape(12), xi, torch.zeros(1)])
        if launcher:
            launch = gn.terms_launcher(tuple(planes), K, level, cfg)
            return [launch(T, torch.empty(gn.N_SUMS)), launch(state, torch.empty(gn.N_SUMS))]
        return [gn.pack_sums(*gn.gn_terms_plain(*planes, K, T_inv, level, cfg))
                for T_inv in (T, torch.eye(4))]
    return run


def _gn_steps(launcher):
    """The seed and three steps of a level from fixed sums, through
    ``step_launcher``'s step (``launcher``) or ``step_plain``: the state and
    the statistics."""
    def run(sums, xi0, cfg):
        state = torch.zeros(gn_level.STATE)
        stats = torch.zeros(2 * cfg.max_iterations)
        counts = torch.zeros(cfg.max_iterations, dtype=torch.int32)
        outs = (state, xi0, stats[:cfg.max_iterations], stats[cfg.max_iterations:], counts)
        step = gn_level.step_launcher(sums, xi0, state, *outs[2:], cfg)
        for it in range(gn_level.SEED, 3):
            if launcher:
                step(it)
            else:
                gn_level.step_plain(sums, xi0, state, *outs[2:], it, cfg)
        return [state, stats, counts]
    return run


def _step_inputs(rng):
    A = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32))
    sums = gn.pack_sums(A @ A.T + torch.eye(6), torch.from_numpy(
        rng.standard_normal(6).astype(np.float32)) * 0.1, torch.tensor(3.0),
        torch.tensor(400, dtype=torch.int32))
    return sums, torch.tensor([0.01, 0.0, -0.02, 0.001, 0.0, 0.002]), TrackerConfig(
        max_iterations=4)


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


def _scene_frame(rng, h=12, w=16, levels=2):
    from dvo_tpu_torch.models.frame import build_frame_with_depth

    g, m, d, s, _ = _build_inputs(rng, h, w)
    return build_frame_with_depth(g, m, d, s, torch.eye(3), levels, 0, 0)


def _regularized_inputs(rng):
    frame = _scene_frame(rng)
    _, _, d, s, _ = _build_inputs(rng, 12, 16)
    return frame, d, s, torch.ones((12, 16), dtype=torch.int32), MapperConfig()


def _depth_update_inputs(rng, h=12, w=16, c=2):
    from dvo_tpu_torch.models.history import KeyframeHistory, push

    hist = KeyframeHistory.create(c, h, w)
    for _ in range(c):
        hist = push(hist, _scene_frame(rng, h, w))
    obj = _scene_frame(rng, h, w).base
    f = lambda: torch.from_numpy(rng.uniform(0.5, 1.5, (h, w)).astype(np.float32))
    return (obj, torch.tensor([0.02, 0, 0, 0, 0, 0.0]), torch.tensor([0.01, 0, 0, 0, 0, 0.0]),
            f(), f() * 0.2, torch.zeros((h, w), dtype=torch.int32), hist, f(),
            MapperConfig(crop_x=(1, 14), crop_y=(1, 10)))


def _twist(rng):
    return torch.from_numpy((0.1 * rng.standard_normal(6)).astype(np.float32))


def _flat(out):
    """Tensors of a kernel's output, in order (tuples, lists, per-level
    dicts, dataclasses)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        out = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return []


@pytest.mark.parametrize("name,wrapper,plain,make", [
    ("gn", gn.gn_terms, gn.gn_terms_plain, _gn_inputs),
    ("gn_level", gn_level.gn_level, gn_level.gn_level_plain, _gn_level_inputs),
    ("gn_terms_launcher", _gn_launch(True), _gn_launch(False), _gn_inputs),
    ("gn_step", _gn_steps(True), _gn_steps(False), _step_inputs),
    ("epipolar", epipolar.epipolar_update, epipolar.epipolar_update_plain, _epi_inputs),
    ("regularize", regularize.regularize, regularize.regularize_plain, _reg_inputs),
    ("framebuild", framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
     _build_inputs),
    ("framebuild_pair", framebuild.cull_pyramid_pair, framebuild.cull_pyramid_pair_plain,
     _pair_inputs),
    ("framebuild_one", framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
     lambda rng: _pair_inputs(rng)[::2]),
    ("regularize_cull", framebuild.regularize_cull_pyramid,
     framebuild.regularize_cull_pyramid_plain, lambda rng: _pair_inputs(rng) + (MapperConfig(),)),
    ("with_regularized_depth", frame.with_regularized_depth, frame.with_regularized_depth_plain,
     _regularized_inputs),
    ("depth_update", mapper.depth_update, mapper.depth_update_by_fields, _depth_update_inputs),
    ("pose_warm", pose.warm, pose.warm_plain, lambda rng: (_twist(rng), 0.5, _twist(rng))),
    ("pose_track", pose.track, pose.track_plain,
     lambda rng: (_twist(rng), _twist(rng), _twist(rng), True)),
    ("pose_table", pose.table, pose.table_plain,
     lambda rng: (torch.eye(3), _twist(rng), _twist(rng), torch.stack([_twist(rng)] * 3))),
    ("pose_emit", pose.emit, pose.emit_plain,
     lambda rng: (torch.tensor(False), _twist(rng), _twist(rng), _twist(rng))),
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
    assert _build.LAUNCHES == {"gn": 0, "gn_step": 0, "gn_level": 0, "epipolar": 0,
                               "regularize": 0, "framebuild": 0, "regularize_cull": 0,
                               "pose": 0, "ba": 0}


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
    (lambda g, m, d, s: framebuild.regularize_cull_pyramid(d.double(), s, 3), "depth: dtype"),
    (lambda g, m, d, s: framebuild.regularize_cull_pyramid(d, s[1:], 3), "sigma: shape"),
    (lambda g, m, d, s: framebuild.regularize_cull_pyramid(d, s.T.contiguous().T, 3),
     "sigma: not contiguous"),
    (lambda g, m, d, s: framebuild.regularize_cull_pyramid(d, s, 17), "levels"),
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


@pytest.mark.parametrize("change,match", [
    (lambda a: a["planes"].__setitem__(0, a["planes"][0].double()), "obj_gray: dtype"),
    (lambda a: a["planes"].__setitem__(1, a["planes"][1].float()), "obj_mask: dtype"),
    (lambda a: a["planes"].__setitem__(4, a["planes"][4][:, :-1]), "ref_gray: shape"),
    (lambda a: a["planes"].__setitem__(6, a["planes"][6].T.contiguous().T), "ref_gx: not contiguous"),
    (lambda a: a["planes"].pop(), "8 planes"),
    (lambda a: a.__setitem__("K", a["K"][:2]), "K: shape"),
    (lambda a: a.__setitem__("xi0", a["xi0"].double()), "xi0: dtype"),
    (lambda a: a.__setitem__("xi0", torch.zeros(12)[::2]), "xi0: not contiguous"),
])
def test_gn_level_launch_checks_its_inputs(change, match, rng, monkeypatch):
    """On the launch route every input is checked before the library is
    touched (the kernel takes raw pointers)."""
    def no_library():
        raise AssertionError("reached the library with a bad input")

    monkeypatch.setattr(gn_level, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", no_library)
    planes, K, xi0, level, cfg = _gn_level_inputs(rng)
    args = {"planes": list(planes), "K": K, "xi0": xi0}
    change(args)
    with pytest.raises(ValueError, match=match):
        gn_level.gn_level(tuple(args["planes"]), args["K"], args["xi0"], level, cfg)
