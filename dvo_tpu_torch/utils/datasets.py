"""Host-side dataset pipeline: reference ``info.txt`` sequences, TUM RGB-D
sequences, undistortion, and normalization — the port's own copy of
``dvo_tpu.utils.datasets`` (numpy only; held equal to it in
``tests/test_torch_utils.py``).

Reference: src/core/loader.cpp — ``Core::Loader`` (mono, one filename per
line, loader.hpp:38-47), ``Core::KinectLoader`` (paired "rgb depth" lines,
loader.hpp:87-98), gray normalized to [0,1] (loader.cpp:61), 16-bit depth
PNG / 5000 -> meters (TUM convention, loader.cpp:145), undistortion via a
precomputed nearest-neighbour remap with INVALID border fill
(loader.cpp:39-41).

The decode path uses PIL here; ``dvo_tpu_torch.native`` provides a C++
decode/remap/prefetch fast path with the same semantics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dvo_tpu_torch.config import INVALID

TUM_DEPTH_SCALE = 5000.0  # loader.cpp:145


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Camera intrinsics + distortion (the reference's camera-calibration
    submodule interface, SURVEY.md §2 #23)."""

    K: np.ndarray                      # (3, 3)
    distortion: Optional[np.ndarray] = None  # (5,) OpenCV k1 k2 p1 p2 k3
    resolution: Optional[Tuple[int, int]] = None  # (width, height)

    @staticmethod
    def logicool() -> "Calibration":
        """Hard-coded fallback for the logicool webcam (loader.cpp:17-18)."""
        K = np.array([[780.0, 0, 378], [0, 796.0, 220], [0, 0, 1]], np.float32)
        D = np.array([-0.0462, 0.152, -0.00429, 0.0117, -0.0725], np.float32)
        return Calibration(K=K, distortion=D, resolution=(640, 480))

    @staticmethod
    def tum_freiburg1() -> "Calibration":
        """TUM fr1 published intrinsics (ROS default-calibrated)."""
        K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]], np.float32)
        D = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633], np.float32)
        return Calibration(K=K, distortion=D, resolution=(640, 480))

    @staticmethod
    def tum_freiburg2() -> "Calibration":
        K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
        D = np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172], np.float32)
        return Calibration(K=K, distortion=D, resolution=(640, 480))

    @staticmethod
    def euroc_cam0() -> "Calibration":
        """EuRoC MAV cam0 published intrinsics (radtan k1 k2 p1 p2; the ASL
        sensor.yaml values for MH/V sequences)."""
        K = np.array(
            [[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]], np.float32
        )
        D = np.array(
            [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0], np.float32
        )
        return Calibration(K=K, distortion=D, resolution=(752, 480))

    @staticmethod
    def from_yaml(path: str, section: str = "monocular") -> "Calibration":
        """Minimal YAML intrinsics loader (the reference reads a calibration
        YAML through its absent submodule, loader.cpp:50-51).  Expects
        ``section: {K: [9 floats], D: [5 floats], resolution: [w, h]}``."""
        import re

        with open(path) as f:
            text = f.read()
        block = re.search(rf"{section}:\s*\n((?:\s+.*\n?)*)", text)
        if not block:
            raise ValueError(f"section {section!r} not found in {path}")
        body = block.group(1)

        def vec(name):
            m = re.search(rf"{name}:\s*\[([^\]]*)\]", body)
            return np.asarray([float(v) for v in m.group(1).split(",")], np.float32) if m else None

        K = vec("K")
        D = vec("D")
        res = vec("resolution")
        return Calibration(
            K=K.reshape(3, 3),
            distortion=D,
            resolution=tuple(int(v) for v in res) if res is not None else None,
        )


@dataclasses.dataclass(frozen=True)
class KinectCalibration:
    """Dual-camera Kinect v2 rig: color + depth intrinsics and the
    depth->color extrinsic (the reference reads these from its
    camera-calibration submodule's YAML: RGB/DEPTH/EXT at loader.hpp:73-74,
    101-108; invT applied at transform.cpp:70)."""

    rgb: Calibration
    depth: Calibration
    invT: np.ndarray  # (4, 4) depth-camera -> color-camera transform

    @staticmethod
    def kinect_v2() -> "KinectCalibration":
        """Nominal Kinect v2 factory intrinsics (the reference's per-device
        YAML is in an absent submodule; these are the published sensor
        defaults) with the ~52 mm color<-depth baseline along -x."""
        rgb = Calibration(
            K=np.array([[1081.37, 0, 959.5], [0, 1081.37, 539.5], [0, 0, 1]], np.float32),
            distortion=None,
            resolution=(1920, 1080),
        )
        depth = Calibration(
            K=np.array([[365.456, 0, 254.878], [0, 365.456, 205.395], [0, 0, 1]], np.float32),
            distortion=np.array([0.0905, -0.2697, 0.0, 0.0, 0.0973], np.float32),
            resolution=(512, 424),
        )
        invT = np.eye(4, dtype=np.float32)
        invT[0, 3] = -0.052
        return KinectCalibration(rgb=rgb, depth=depth, invT=invT)

    @staticmethod
    def from_yaml(path: str) -> "KinectCalibration":
        """Sections ``rgb``/``depth`` (K, D, resolution) + ``extrinsic``
        with ``invT: [16 floats]`` row-major."""
        import re

        rgb = Calibration.from_yaml(path, "rgb")
        depth = Calibration.from_yaml(path, "depth")
        with open(path) as f:
            text = f.read()
        m = re.search(r"invT:\s*\[([^\]]*)\]", text)
        invT = (
            np.asarray([float(v) for v in m.group(1).split(",")], np.float32).reshape(4, 4)
            if m
            else np.eye(4, dtype=np.float32)
        )
        return KinectCalibration(rgb=rgb, depth=depth, invT=invT)


def decode_gray(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("I;16", "I"):
        return np.asarray(img, np.float32)
    return np.asarray(img.convert("L"), np.float32)


def load_gray_normalized(path: str) -> np.ndarray:
    """8-bit image -> gray in [0, 1] (loader.cpp:55-63)."""
    return decode_gray(path) / 255.0


def load_depth_meters(path: str, scale: float = TUM_DEPTH_SCALE) -> np.ndarray:
    """16-bit depth PNG -> meters; 0 stays 0 = missing (loader.cpp:137-147)."""
    return decode_gray(path) / scale


# ---------------------------------------------------------------- undistortion

def build_undistort_map(calib: Calibration) -> np.ndarray:
    """Precompute the (H, W, 2) source-coordinate map equivalent to
    cv::initUndistortRectifyMap with identity R and newK = K
    (loader.cpp:20-30): for each undistorted pixel, apply the distortion
    model forward to find where to sample the raw image."""
    w, h = calib.resolution
    K = calib.K.astype(np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if calib.distortion is None:
        xs, ys = np.meshgrid(np.arange(w), np.arange(h))
        return np.stack([xs, ys], axis=-1).astype(np.float32)
    k1, k2, p1, p2, k3 = [float(v) for v in calib.distortion]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    mapx = (xd * fx + cx).astype(np.float32)
    mapy = (yd * fy + cy).astype(np.float32)
    return np.stack([mapx, mapy], axis=-1)


def remap_nearest(img: np.ndarray, srcmap: np.ndarray, border: float = INVALID):
    """cv::remap with INTER_NEAREST + constant INVALID border
    (loader.cpp:39-41).  Returns (remapped, valid_mask)."""
    h, w = srcmap.shape[:2]
    x = np.rint(srcmap[..., 0]).astype(np.int64)
    y = np.rint(srcmap[..., 1]).astype(np.int64)
    valid = (x >= 0) & (x < img.shape[1]) & (y >= 0) & (y < img.shape[0])
    xc = np.clip(x, 0, img.shape[1] - 1)
    yc = np.clip(y, 0, img.shape[0] - 1)
    out = img[yc, xc]
    out = np.where(valid, out, border).astype(img.dtype)
    return out, valid


# ------------------------------------------------------------------- sequences

@dataclasses.dataclass(frozen=True)
class SequenceItem:
    timestamp: float
    gray_path: str
    depth_path: Optional[str] = None


class InfoSequence:
    """Reference ``info.txt`` sequence: one image filename per line (mono)
    or "rgb depth" pairs (Kinect) relative to the file's directory
    (loader.hpp:38-47, 87-98)."""

    def __init__(self, info_path: str):
        base = os.path.dirname(info_path)
        self.items: List[SequenceItem] = []
        with open(info_path) as f:
            for i, line in enumerate(f):
                parts = line.split()
                if not parts:
                    continue
                gray = os.path.join(base, parts[0])
                depth = os.path.join(base, parts[1]) if len(parts) > 1 else None
                self.items.append(SequenceItem(float(i), gray, depth))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[SequenceItem]:
        return iter(self.items)


class EuRoCSequence:
    """EuRoC MAV ASL-format sequence (BASELINE config 5): grayscale camera
    frames listed in ``mav0/<cam>/data.csv`` (``timestamp_ns,filename``)
    with images under ``mav0/<cam>/data/``.  Monocular (no depth).

    ``read_groundtruth`` parses ``mav0/state_groundtruth_estimate0/data.csv``
    (timestamp_ns, p_xyz, q_wxyz, ...) into (timestamps_s, positions) for
    ATE evaluation."""

    def __init__(self, root: str, cam: str = "cam0"):
        base = os.path.join(root, "mav0", cam)
        csv = os.path.join(base, "data.csv")
        self.items: List[SequenceItem] = []
        with open(csv) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                if len(parts) < 2:
                    continue
                t = float(parts[0]) * 1e-9  # ns -> s
                self.items.append(
                    SequenceItem(t, os.path.join(base, "data", parts[1].strip()))
                )

    @staticmethod
    def read_groundtruth(root: str) -> Tuple[np.ndarray, np.ndarray]:
        path = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
        ts, xyz = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                if len(parts) < 4:
                    continue
                ts.append(float(parts[0]) * 1e-9)
                xyz.append([float(parts[1]), float(parts[2]), float(parts[3])])
        return np.asarray(ts), np.asarray(xyz, np.float32)

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[SequenceItem]:
        return iter(self.items)


class TUMSequence:
    """TUM RGB-D sequence: rgb.txt/depth.txt with timestamps, associated by
    nearest timestamp within max_difference (the dataset's associate.py
    convention)."""

    def __init__(self, root: str, max_difference: float = 0.02):
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        depth = self._read_list(os.path.join(root, "depth.txt"))
        self.items: List[SequenceItem] = []
        d_keys = np.asarray([t for t, _ in depth])
        for t, rgb_path in rgb:
            j = int(np.argmin(np.abs(d_keys - t)))
            if abs(d_keys[j] - t) <= max_difference:
                self.items.append(
                    SequenceItem(t, os.path.join(root, rgb_path), os.path.join(root, depth[j][1]))
                )

    @staticmethod
    def _read_list(path: str) -> List[Tuple[float, str]]:
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    out.append((float(parts[0]), parts[1]))
        return out

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[SequenceItem]:
        return iter(self.items)
