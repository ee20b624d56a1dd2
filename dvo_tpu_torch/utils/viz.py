"""The keyframe-ring gallery — ``dvo_tpu.utils.viz.keyframe_gallery`` for
the port's ``KeyframeHistory``.  The colourisations, ``save_png`` and
``plot_trajectory`` are ``dvo_tpu.utils.viz``'s own (numpy only)."""

from __future__ import annotations

import numpy as np

from dvo_tpu.utils.viz import merge, visualize_depth, visualize_gray, visualize_sigma


def keyframe_gallery(history) -> np.ndarray:
    """The ring's live slots, newest first — the reference's SHOW_KEYFRAME
    panel (system.hpp:7,34-42) as an image.  Each row: gray | depth(sigma)
    | sigma of one keyframe.  One host copy of each plane stack."""
    count, head, cap = history.count, history.head, history.capacity
    gray, mask, depth, sigma = (t.detach().cpu().numpy() for t in
                                (history.gray, history.mask, history.depth, history.sigma))
    rows = []
    for age in range(count):
        slot = (head - age) % cap
        rows.append(merge([
            visualize_gray(gray[slot], mask[slot]),
            visualize_depth(depth[slot], sigma[slot]),
            visualize_sigma(sigma[slot]),
        ]))
    if not rows:
        return np.zeros((1, 1, 3), np.uint8)
    out = []
    for r in rows:   # one ring: every row has the same width
        out.append(r)
        out.append(np.zeros((2, r.shape[1], 3), np.uint8))
    return np.concatenate(out[:-1], axis=0)
