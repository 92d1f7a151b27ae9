"""The benchmark's inputs, made from the seed at set-up.

A small pool of distinct scenes (``synth.py``) is drawn on; every input is
a seeded variant of one of them, made in worker processes: a crop to the
target's aspect ratio that keeps 85-100 % of the scene, a bilinear resize
to the target size and, for half of them, a mirror image. Every seed gets
the same set of sizes, in another order.

Imports numpy and PIL only (the workers start from a fresh interpreter).
"""

from __future__ import annotations

import multiprocessing as mp
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

from inputs import synth


def seed_words(seed: int, *salt: int) -> List[int]:
    """32-bit words for ``np.random.RandomState`` from any whole ``seed``
    (the driver's seeds pass 2**31) and a salt."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(seed) // 2**64, *salt])
    return [int(w) for w in ss.generate_state(4)]


def scene_size(i: int) -> Tuple[int, int]:
    """(w, h) of scene ``i`` of a pool: 900x600, every fourth 600x900."""
    return (600, 900) if i % 4 == 3 else (900, 600)


@lru_cache(maxsize=8)
def _scene(words: Tuple[int, ...], w: int, h: int) -> np.ndarray:
    img, _ = synth.render_image(np.random.RandomState(list(words)), width=w, height=h)
    return img


def variant(scene: np.ndarray, rng: np.random.RandomState, w: int, h: int) -> np.ndarray:
    """A crop of ``scene`` to ``w``:``h`` keeping 85-100 % of what fits,
    resized to (h, w), mirrored for half of the draws."""
    sh, sw = scene.shape[:2]
    aspect = w / h
    cw, ch = (sw, sw / aspect) if sw / sh < aspect else (sh * aspect, sh)
    keep = rng.uniform(0.85, 1.0)
    cw, ch = int(cw * keep), int(ch * keep)
    x0 = rng.randint(0, sw - cw + 1)
    y0 = rng.randint(0, sh - ch + 1)
    crop = Image.fromarray(scene[y0:y0 + ch, x0:x0 + cw]).resize((w, h), Image.BILINEAR)
    out = np.asarray(crop)
    return np.ascontiguousarray(out[:, ::-1]) if rng.rand() < 0.5 else out


def _variant_task(args) -> np.ndarray:
    scene_words, sw, sh, words, w, h = args
    return variant(_scene(scene_words, sw, sh), np.random.RandomState(words), w, h)


def variants(seed: int, scenes: int, sizes: Sequence[Tuple[int, int]],
             workers: int) -> List[np.ndarray]:
    """One variant per (w, h) of ``sizes``, in a seeded order, of one of
    ``scenes`` distinct scenes of the target's orientation, as RGB arrays.
    Every draw has a generator of its own, so
    the result does not depend on the workers; a worker renders each scene
    it needs once (the tasks go out grouped by scene)."""
    order = np.random.RandomState(seed_words(seed, 2)).permutation(len(sizes))
    tasks = []
    for i, k in enumerate(order):
        w, h = sizes[k]
        same = [j for j in range(scenes)
                if (scene_size(j)[0] >= scene_size(j)[1]) == (w >= h)] or list(range(scenes))
        j = same[np.random.RandomState(seed_words(seed, 4, i)).randint(len(same))]
        tasks.append((tuple(seed_words(seed, 1, j)), *scene_size(j),
                      seed_words(seed, 3, i), w, h))
    by_scene = sorted(range(len(tasks)), key=lambda i: tasks[i][0])
    if workers <= 1:
        done = [_variant_task(tasks[i]) for i in by_scene]
    else:
        with mp.get_context("spawn").Pool(workers) as procs:
            chunk = max(1, len(tasks) // (2 * workers))
            done = procs.map(_variant_task, [tasks[i] for i in by_scene], chunksize=chunk)
    out = [None] * len(tasks)
    for i, d in zip(by_scene, done):
        out[i] = d
    return out


def bgr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[..., ::-1])
