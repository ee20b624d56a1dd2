"""The port's own copies of the host-side utilities against their
``dvo_tpu`` counterparts on the same inputs, made from a seed with numpy:
datasets (calibration, undistortion, decode, sequence parsers), trajectory
IO and ATE, the numpy colourisations, the metrics logger, the directory
watcher and the native loader.  Tolerance 0 everywhere: the copies run the
same numpy and C++ arithmetic."""

import json
import os
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from dvo_tpu import native as jnative
from dvo_tpu.utils import datasets as jdata
from dvo_tpu.utils import metrics as jmetrics
from dvo_tpu.utils import stream as jstream
from dvo_tpu.utils import trajectory as jtraj
from dvo_tpu.utils import viz as jviz
from dvo_tpu_torch import native as tnative
from dvo_tpu_torch.utils import datasets as tdata
from dvo_tpu_torch.utils import metrics as tmetrics
from dvo_tpu_torch.utils import stream as tstream
from dvo_tpu_torch.utils import trajectory as ttraj
from dvo_tpu_torch.utils import viz as tviz


def write_png(path, img):
    """(H, W) uint8/uint16 gray or (H, W, 3) uint8 RGB, filter 0."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    bits = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if bits == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data)))
    header = struct.pack(">IIBBBBB", w, h, bits, 2 if img.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _same_calibration(a, b):
    np.testing.assert_array_equal(a.K, b.K)
    assert (a.distortion is None) == (b.distortion is None) and a.resolution == b.resolution
    if a.distortion is not None:
        np.testing.assert_array_equal(a.distortion, b.distortion)


# ------------------------------------------------------------------ datasets

@pytest.mark.parametrize("preset", ["logicool", "tum_freiburg1", "tum_freiburg2", "euroc_cam0"])
def test_calibration_presets_and_undistort_map(preset):
    t, j = getattr(tdata.Calibration, preset)(), getattr(jdata.Calibration, preset)()
    _same_calibration(t, j)
    np.testing.assert_array_equal(tdata.build_undistort_map(t), jdata.build_undistort_map(j))


def test_kinect_calibration_preset_and_yaml(tmp_path):
    t, j = tdata.KinectCalibration.kinect_v2(), jdata.KinectCalibration.kinect_v2()
    _same_calibration(t.rgb, j.rgb)
    _same_calibration(t.depth, j.depth)
    np.testing.assert_array_equal(t.invT, j.invT)
    np.testing.assert_array_equal(tdata.build_undistort_map(t.rgb),   # no distortion
                                  jdata.build_undistort_map(j.rgb))
    rng = np.random.default_rng(0)
    fmt = lambda a: ", ".join(repr(float(v)) for v in a)
    path = tmp_path / "k.yaml"
    path.write_text(
        f"rgb:\n  K: [{fmt(rng.random(9))}]\n  resolution: [64, 48]\n"
        f"depth:\n  K: [{fmt(rng.random(9))}]\n  D: [{fmt(rng.random(5))}]\n"
        f"  resolution: [32, 24]\nextrinsic:\n  invT: [{fmt(rng.random(16))}]\n"
        f"monocular:\n  K: [{fmt(rng.random(9))}]\n  D: [{fmt(rng.random(5))}]\n")
    t, j = tdata.KinectCalibration.from_yaml(str(path)), jdata.KinectCalibration.from_yaml(str(path))
    _same_calibration(t.rgb, j.rgb)
    _same_calibration(t.depth, j.depth)
    np.testing.assert_array_equal(t.invT, j.invT)
    _same_calibration(tdata.Calibration.from_yaml(str(path)), jdata.Calibration.from_yaml(str(path)))
    with pytest.raises(ValueError):
        tdata.Calibration.from_yaml(str(path), "missing")


@pytest.mark.parametrize("border", [None, 0.0])
def test_remap_nearest(border):
    rng = np.random.default_rng(1)
    img = rng.random((40, 56), np.float32)
    srcmap = (rng.random((30, 44, 2)) * [70, 50] - 6).astype(np.float32)   # some out of range
    kw = {} if border is None else {"border": border}
    (to, tv), (jo, jv) = tdata.remap_nearest(img, srcmap, **kw), jdata.remap_nearest(img, srcmap, **kw)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tv, jv)
    assert not tv.all() and tv.any()
    assert tdata.TUM_DEPTH_SCALE == jdata.TUM_DEPTH_SCALE


@pytest.mark.parametrize("kind", ["gray", "depth", "color"])
def test_decode_and_loaders(kind, tmp_path):
    rng = np.random.default_rng(2)
    img = {"gray": rng.integers(0, 256, (24, 32), dtype=np.uint8),
           "depth": rng.integers(0, 65536, (24, 32), dtype=np.uint16),
           "color": rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)}[kind]
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(tdata.decode_gray(path), jdata._decode_gray(path))
    np.testing.assert_array_equal(tdata.load_gray_normalized(path), jdata.load_gray_normalized(path))
    np.testing.assert_array_equal(tdata.load_depth_meters(path), jdata.load_depth_meters(path))


def _items(seq):
    return [(it.timestamp, it.gray_path, it.depth_path) for it in seq]


def test_sequence_parsers(tmp_path):
    rng = np.random.default_rng(3)
    info = tmp_path / "info.txt"
    info.write_text("a.png\n\nb.png d.png\nc.png\n")
    t, j = tdata.InfoSequence(str(info)), jdata.InfoSequence(str(info))
    assert _items(t) == _items(j) and len(t) == len(j) == 3

    tum = tmp_path / "tum"
    tum.mkdir()
    ts = np.sort(rng.random(6)) * 10
    (tum / "rgb.txt").write_text("# header\n" + "".join(f"{v:.4f} rgb/{i}.png\n"
                                                         for i, v in enumerate(ts)))
    (tum / "depth.txt").write_text("".join(f"{v + 0.03 * (i % 2):.4f} depth/{i}.png\n"
                                           for i, v in enumerate(ts)))
    t, j = tdata.TUMSequence(str(tum)), jdata.TUMSequence(str(tum))
    assert _items(t) == _items(j) and 0 < len(t) < 6

    cam = tmp_path / "euroc" / "mav0" / "cam0"
    cam.mkdir(parents=True)
    (cam / "data.csv").write_text("#timestamp,filename\n1000000000,1.png\n\n2500000000,2.png\n")
    gt = tmp_path / "euroc" / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir()
    (gt / "data.csv").write_text("#t,x,y,z\n" + "".join(
        f"{int(1e9 * (i + 1))},{','.join(repr(float(v)) for v in rng.random(7))}\n"
        for i in range(4)))
    root = str(tmp_path / "euroc")
    t, j = tdata.EuRoCSequence(root), jdata.EuRoCSequence(root)
    assert _items(t) == _items(j) and len(t) == 2
    for a, b in zip(tdata.EuRoCSequence.read_groundtruth(root),
                    jdata.EuRoCSequence.read_groundtruth(root)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- trajectory

def _poses(rng, n):
    """n rigid poses with rotations from all four quaternion branches."""
    out = []
    for i in range(n):
        q = rng.standard_normal(4)
        q[i % 4] += 3.0 * (1 if i % 8 < 4 else -1)   # dominant w, x, y or z in turn
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rng.standard_normal(3)
        out.append(T)
    return np.stack(out)


def test_trajectory_io(tmp_path):
    rng = np.random.default_rng(4)
    poses, ts = _poses(rng, 12), np.sort(rng.random(12)) * 100
    for T in poses:
        np.testing.assert_array_equal(ttraj.rotation_to_quaternion(T[:3, :3]),
                                      jtraj.rotation_to_quaternion(T[:3, :3]))
    assert [ttraj.tum_line(t, T) for t, T in zip(ts, poses)] == \
        [jtraj.tum_line(t, T) for t, T in zip(ts, poses)]
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ttraj.write_tum(a, ts, poses)
    jtraj.write_tum(b, ts, poses)
    assert open(a).read() == open(b).read()
    for x, y in zip(ttraj.read_tum(a), jtraj.read_tum(a)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_and_alignment(with_scale):
    rng = np.random.default_rng(5)
    gt = rng.standard_normal((30, 3))
    t_gt = np.arange(30) * 0.1
    est = 1.7 * gt @ _poses(rng, 1)[0, :3, :3].T + 0.01 * rng.standard_normal((30, 3)) + 2.0
    t_est = t_gt + 0.004 * rng.standard_normal(30)
    for a, b in zip(ttraj.associate(t_est, t_gt), jtraj.associate(t_est, t_gt)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttraj.align_umeyama(est, gt, with_scale), jtraj.align_umeyama(est, gt, with_scale)):
        np.testing.assert_array_equal(a, b)
    assert ttraj.ate_rmse(t_est, est, t_gt, gt, with_scale=with_scale) == \
        jtraj.ate_rmse(t_est, est, t_gt, gt, with_scale=with_scale)


# ----------------------------------------------------------------------- viz

@pytest.mark.parametrize("name,args", [
    ("visualize_gray", ("gray", "mask")), ("visualize_gray", ("gray",)),
    ("visualize_depth", ("depth", "sigma")), ("visualize_depth", ("depth",)),
    ("visualize_sigma", ("sigma",)), ("visualize_age", ("age",)),
    ("visualize_gradient", ("grad",)),
])
def test_colourisations(name, args):
    rng = np.random.default_rng(6)
    planes = dict(gray=rng.random((20, 28), np.float32) * 1.2 - 0.1, mask=rng.random((20, 28)) > 0.2,
                  depth=rng.random((20, 28), np.float32) * 8, sigma=rng.random((20, 28), np.float32) * 1.3,
                  age=rng.integers(0, 12, (20, 28)), grad=rng.standard_normal((20, 28)).astype(np.float32))
    got = getattr(tviz, name)(*(planes[a] for a in args))
    want = getattr(jviz, name)(*(planes[a] for a in args))
    assert got.dtype == np.uint8 and got.shape == (20, 28, 3)
    np.testing.assert_array_equal(got, want)


def test_merge_save_and_plot(tmp_path):
    rng = np.random.default_rng(7)
    panels = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((12, 9), (8, 5), (12, 3))]
    np.testing.assert_array_equal(tviz.merge(panels), jviz.merge(panels))
    np.testing.assert_array_equal(tviz.merge(panels, pad=0), jviz.merge(panels, pad=0))
    a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tviz.save_panels(a, *panels)
    jviz.save_panels(b, *panels)
    assert open(a, "rb").read() == open(b, "rb").read()
    pytest.importorskip("matplotlib")
    poses = _poses(rng, 9)
    tviz.plot_trajectory(poses, a, gt=rng.random((9, 3)))
    jviz.plot_trajectory(poses, b, gt=rng.random((9, 3)))
    assert os.path.getsize(a) > 1000 and os.path.getsize(b) > 1000


# ------------------------------------------------------------------- metrics

def test_metrics_logger_log_and_timer(tmp_path):
    """``log`` writes the reference's line; a closed or path-less logger
    writes nothing; ``Timer`` measures its block (``log_frame`` is held
    against the reference in test_torch_runner)."""
    a, b = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    for mod, path in ((tmetrics, a), (jmetrics, b)):
        log = mod.MetricsLogger(path)
        log.log(frame=3, xi=[0.5, -1.25], note="x")
        log.close()
        log.log(frame=4)
        log.close()
        mod.MetricsLogger(None).log(frame=1)
    assert open(a).read() == open(b).read()
    assert json.loads(open(a).read()) == {"frame": 3, "xi": [0.5, -1.25], "note": "x"}
    assert tmetrics.MetricsLogger(None).enabled is False
    with tmetrics.Timer() as t:
        time.sleep(0.01)
    assert t.ms >= 10.0


# -------------------------------------------------------------------- stream

@pytest.mark.parametrize("mod", [tstream, jstream], ids=["port", "reference"])
def test_watch_directory_yields_stable_files_in_order(mod, tmp_path):
    """Both watchers give the same list: sorted names, other suffixes
    skipped, a file that appears later picked up, the end after the idle
    timeout or the stop flag."""
    for name in ("b.png", "a.png", "x.txt"):
        (tmp_path / name).write_bytes(b"12345")

    def late():
        time.sleep(0.15)
        (tmp_path / "c.png").write_bytes(b"1")

    th = threading.Thread(target=late)
    th.start()
    got = list(mod.watch_directory(str(tmp_path), poll_s=0.01, idle_timeout_s=0.6))
    th.join()
    assert [os.path.basename(p) for p in got] == ["a.png", "b.png", "c.png"]
    assert list(mod.watch_directory(str(tmp_path), poll_s=0.01, stop=lambda: True)) == []
    assert list(mod.watch_directory(str(tmp_path / "none"), poll_s=0.01, idle_timeout_s=0.05)) == []


# -------------------------------------------------------------------- native

def _native_or_skip(mod):
    try:
        mod.load_library()
    except mod.NativeUnavailable as e:
        pytest.skip(f"no native loader here: {e}")


def test_native_loader_matches_the_reference(tmp_path):
    """The port's build of its own ``loader.cpp`` (into the git-ignored
    build directory) decodes, remaps and prefetches as ``dvo_tpu.native``."""
    _native_or_skip(tnative)
    _native_or_skip(jnative)
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.name == ".build" and tnative.library_path().exists()
    rng = np.random.default_rng(8)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"{i}.png"))
        write_png(paths[-1], rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    assert tnative.png_info(paths[0]) == jnative.png_info(paths[0]) == (32, 24, 8)
    np.testing.assert_array_equal(tnative.decode_png_f32(paths[0], 1 / 255.0),
                                  jnative.decode_png_f32(paths[0], 1 / 255.0))
    srcmap = (rng.random((12, 16, 2)) * [40, 30] - 4).astype(np.float32)
    img = rng.random((24, 32), np.float32)
    for a, b in zip(tnative.remap_nearest(img, srcmap, 0.0), jnative.remap_nearest(img, srcmap, 0.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tnative.remap_nearest(img, srcmap, 0.0), tdata.remap_nearest(img, srcmap, 0.0)):
        np.testing.assert_array_equal(a, b)
    loaders = [m.PrefetchLoader(paths, 1.0, map_xy=srcmap, border=0.0, threads=2)
               for m in (tnative, jnative)]
    try:
        for (i, a, va), (k, b, vb) in zip(*loaders):
            assert i == k
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(va, vb)
    finally:
        for ld in loaders:
            ld.close()
    with pytest.raises(IOError):
        tnative.png_info(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("kind", ["mono", "rgbd", "stream"])
def test_recorder_writes_what_the_reference_writes(kind, tmp_path):
    """``utils/record.py`` (``record``, ``record_rgbd``, ``record_stream``)
    against ``dvo_tpu.utils.record`` on the same frames: the same file
    names, ``info.txt`` and PNG bytes; a directory that is no prior
    recording is never deleted."""
    from dvo_tpu.utils import record as jrecord
    from dvo_tpu_torch.utils import record as trecord

    rng = np.random.default_rng(0)
    grays = [rng.random((12, 16)).astype(np.float32) for _ in range(4)]
    depths = [(1.0 + rng.random((12, 16))).astype(np.float32) for _ in range(4)]
    outs = []
    for mod, name in ((jrecord, "ref"), (trecord, "port")):
        out = str(tmp_path / name)
        if kind == "mono":
            n = mod.record(iter(grays), out, limit=3)
        elif kind == "rgbd":
            n = mod.record_rgbd(zip(grays, depths), out)
        else:
            src = tmp_path / f"src_{name}"
            jrecord.record(iter(grays), str(src))
            os.remove(src / "info.txt")
            n = mod.record_stream(str(src), out, idle_timeout_s=0.3)
        assert n == (3 if kind == "mono" else 4)
        outs.append(out)
    assert sorted(os.listdir(outs[0])) == sorted(os.listdir(outs[1]))
    for fname in os.listdir(outs[0]):
        with open(os.path.join(outs[0], fname), "rb") as a, \
                open(os.path.join(outs[1], fname), "rb") as b:
            assert a.read() == b.read(), fname
    assert trecord.DEPTH_SCALE == jrecord.DEPTH_SCALE
    other = tmp_path / "not_a_recording"
    other.mkdir()
    (other / "keep.txt").write_text("x")
    with pytest.raises(FileExistsError):
        trecord.record(iter(grays), str(other))
    assert (other / "keep.txt").exists()
