"""Dataset recorder — ``dvo_tpu.utils.record`` copied (NumPy and PIL): the
reference capture tool's role.

The reference's ``test/record.cpp:21-54`` opens a webcam, shows a preview
window, and on toggle writes ``recorded/%04d.png`` (the numbered-PNG layout
its ``info.txt`` loaders consume).  This environment has no camera or GUI;
the capability that matters to the framework is the *producer side of the
dataset contract*: turn any frame source — a live directory stream
(``utils/stream.watch_directory``), an in-memory iterator, a replayed
sequence — into a reference-layout dataset (numbered PNGs + ``info.txt``,
``loader.hpp:38-47``) that ``InfoSequence`` / ``run.py`` / the native
prefetch loader can consume directly.

Mono frames record as ``%04d.png``; RGB-D pairs record as
``rgb_%03d.png`` / ``depth_%03d.png`` with two-column ``info.txt`` lines
(the ``kinectv2_*`` layout).  Depth is written as 16-bit PNG at the TUM
1/5000 m scale (``loader.cpp:145``).
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

DEPTH_SCALE = 5000.0  # TUM convention: uint16 counts per metre


def _to_u8(gray: np.ndarray) -> np.ndarray:
    gray = np.asarray(gray)
    if gray.dtype == np.uint8:
        return gray
    return np.clip(np.asarray(gray, np.float32) * 255.0, 0, 255).astype(np.uint8)


def _prepare_dir(out_dir: str, overwrite: bool) -> None:
    """record.cpp:23-27 removes and recreates its output directory; here a
    non-empty directory is only ever removed when it is recognizably a
    prior recording (it contains an ``info.txt``) — a mistyped output path
    must not delete arbitrary data."""
    if os.path.isdir(out_dir) and os.listdir(out_dir):
        if not overwrite:
            raise FileExistsError(
                f"{out_dir!r} exists and is not empty; pass overwrite=True "
                "(--overwrite) to replace a prior recording"
            )
        if not os.path.isfile(os.path.join(out_dir, "info.txt")):
            raise FileExistsError(
                f"refusing to delete {out_dir!r}: it is not a prior "
                "recording (no info.txt)"
            )
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)


def record(
    frames: Iterable[np.ndarray],
    out_dir: str,
    overwrite: bool = True,
    limit: Optional[int] = None,
) -> int:
    """Write grayscale frames as ``%04d.png`` + ``info.txt``
    (the ``logicool*`` layout).  ``frames`` yields (H, W) arrays, uint8 or
    float in [0, 1].  Returns the number of frames written."""
    import itertools

    from PIL import Image

    _prepare_dir(out_dir, overwrite)
    names = []
    # islice (not a break-on-count) so the (limit+1)-th frame is never
    # pulled from a potentially blocking live source.
    for i, frame in enumerate(itertools.islice(frames, limit)):
        name = f"{i:04d}.png"
        Image.fromarray(_to_u8(frame)).save(os.path.join(out_dir, name))
        names.append(name)
    with open(os.path.join(out_dir, "info.txt"), "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))
    return len(names)


def record_rgbd(
    frames: Iterable[Tuple[np.ndarray, np.ndarray]],
    out_dir: str,
    overwrite: bool = True,
    limit: Optional[int] = None,
) -> int:
    """Write (gray, depth_m) pairs in the ``kinectv2_*`` layout:
    ``rgb_%03d.png`` (8-bit) + ``depth_%03d.png`` (16-bit, 1/5000 m) and a
    two-column ``info.txt``.  Returns the number of pairs written."""
    import itertools

    from PIL import Image

    _prepare_dir(out_dir, overwrite)
    lines = []
    for i, (gray, depth) in enumerate(itertools.islice(frames, limit)):
        g_name = f"rgb_{i:03d}.png"
        d_name = f"depth_{i:03d}.png"
        Image.fromarray(_to_u8(gray)).save(os.path.join(out_dir, g_name))
        d16 = np.clip(
            np.round(np.asarray(depth, np.float32) * DEPTH_SCALE), 0, 65535
        ).astype(np.uint16)
        # dtype-inferred mode (uint16 -> I;16): the explicit ``mode`` arg is
        # deprecated and scheduled for removal in Pillow 13.
        Image.fromarray(d16).save(os.path.join(out_dir, d_name))
        lines.append(f"{g_name} {d_name}")
    with open(os.path.join(out_dir, "info.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


def record_stream(
    src_dir: str,
    out_dir: str,
    idle_timeout_s: float = 5.0,
    overwrite: bool = True,
    limit: Optional[int] = None,
) -> int:
    """Re-record a live directory stream (``stream.watch_directory``
    producer convention) into a reference-layout dataset — the closest
    counterpart of record.cpp's camera loop: frames arrive asynchronously,
    the recorder persists them with dataset numbering as they do."""
    from PIL import Image

    from dvo_tpu_torch.utils.stream import watch_directory

    def frames() -> Iterator[np.ndarray]:
        for path in watch_directory(src_dir, idle_timeout_s=idle_timeout_s):
            yield np.asarray(Image.open(path).convert("L"), np.uint8)

    return record(frames(), out_dir, overwrite=overwrite, limit=limit)


def _main(argv=None):  # pragma: no cover - thin CLI shim over record_stream
    import argparse

    p = argparse.ArgumentParser(
        description="Re-record a live frame directory into a reference-"
        "layout dataset (numbered PNGs + info.txt)."
    )
    p.add_argument("src", help="directory a producer drops frames into")
    p.add_argument("out", help="output dataset directory")
    p.add_argument("--idle-timeout", type=float, default=5.0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--overwrite", action="store_true",
                   help="replace an existing recording at OUT (only a "
                        "directory containing info.txt is ever deleted)")
    a = p.parse_args(argv)
    n = record_stream(a.src, a.out, idle_timeout_s=a.idle_timeout,
                      limit=a.limit, overwrite=a.overwrite)
    print(f"recorded {n} frames -> {a.out}")


if __name__ == "__main__":  # pragma: no cover
    _main()
