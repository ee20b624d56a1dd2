"""Checkpoint / resume of the port's states — ``dvo_tpu.utils.checkpoint``
ported.

A ``VOState`` or ``RGBDState`` round-trips through one ``.npz`` file whose
keys are ``dvo_tpu``'s own leaf paths (``history/depth``,
``ref/scenes/0/gray``, ``frame_count``, ...), so a checkpoint that
``dvo_tpu`` wrote loads here too.  ``dvo_tpu``'s PRNG ``key`` is not read
(torch cannot continue a ``jax.random`` stream); the port stores its
generator's state under a key of its own, ``torch_generator``.

Loading builds an attribute tree from the keys and hands it to
``state_from_reference`` / ``rgbd_state_from_reference``.  Of the leaves a
state needs, only those in ``_FORWARD_COMPAT_LEAVES`` (fields added after
checkpoints were first written) may be missing: they take their init value
with a warning.  Any other missing leaf raises.
"""

from __future__ import annotations

import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory
from dvo_tpu_torch.models.odometry import rgbd_state_from_reference, state_from_reference

_FORWARD_COMPAT_LEAVES = {"kf_id"}   # KeyframeHistory.kf_id
GENERATOR_KEY = "torch_generator"
_HISTORY = tuple(f.name for f in dataclasses.fields(KeyframeHistory))
_SCENE = tuple(f.name for f in dataclasses.fields(Scene))
_FRAME = ("xi", "relative_xi", "age", "frame_id")


def _leaves(tree, prefix=""):
    """(key, value) for every leaf of a state, keyed as ``dvo_tpu`` keys
    its pytree paths; None leaves are left out, as in a pytree."""
    if isinstance(tree, torch.Generator):
        return
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{prefix}{f.name}/")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value, np.int32)   # head, count, frame_count, frame_id


def save_state(path: str, state) -> None:
    """Write a ``VOState`` or ``RGBDState`` to ``path`` (.npz)."""
    data = {key: _host(value) for key, value in _leaves(state)}
    generator = getattr(state, "generator", None)
    if generator is not None:
        data[GENERATOR_KEY] = generator.get_state().numpy()
    np.savez_compressed(path, **data)


def _required(keys) -> list:
    """The leaves a state with these keys needs (its ``ref`` pyramid has as
    many levels as the file holds)."""
    levels = {int(k.split("/")[2]) for k in keys if k.startswith("ref/scenes/")}
    need = [f"ref/scenes/{i}/{name}" for i in range(max(levels, default=0) + 1)
            for name in _SCENE]
    need += [f"ref/{name}" for name in _FRAME] + ["frame_count", "vel"]
    if any(k.startswith("history/") for k in keys):
        need += [f"history/{name}" for name in _HISTORY] + ["prev_rel"]
    return need


def _tree(flat: dict):
    """Nested ``SimpleNamespace``s from "a/b/c" keys; a level whose keys
    are all digits becomes a tuple."""
    nested: dict = {}
    for key, value in flat.items():
        node = nested
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(build(node[k]) for k in sorted(node, key=int))
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(nested)


def load_state(path: str, device="cuda"):
    """The state saved at ``path`` (by this module or by ``dvo_tpu``), on
    ``device`` (the card unless ``"cpu"`` is asked for): a ``VOState`` when the file holds a keyframe ring, else an
    ``RGBDState``.  A ``VOState`` draws from a generator on ``device``
    restored from the file's ``torch_generator`` state, or (a ``dvo_tpu``
    file) from a new one seeded 0."""
    device = torch.device(device)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k not in ("key", GENERATOR_KEY)}
        saved_generator = data[GENERATOR_KEY] if GENERATOR_KEY in data.files else None
    for key in _required(flat):
        if key in flat:
            continue
        if key.split("/")[-1] not in _FORWARD_COMPAT_LEAVES:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        warnings.warn(f"checkpoint {path} missing leaf {key!r}; using the init value "
                      "(the checkpoint predates the field)")
        capacity = flat["history/gray"].shape[0]
        flat[key] = np.full((capacity,), -1, np.int32)
    obj = _tree(flat)
    if not hasattr(obj, "history"):
        return rgbd_state_from_reference(obj, device)
    generator = None
    if saved_generator is not None:
        generator = torch.Generator(device=device)
        try:
            generator.set_state(torch.from_numpy(saved_generator))
        except RuntimeError as e:
            raise ValueError(f"checkpoint {path}: its generator state does not fit a "
                             f"{device.type} generator (it was saved on another device "
                             "type)") from e
    return state_from_reference(obj, device, generator)

