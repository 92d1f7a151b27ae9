"""Synthetic scene-text dataset generator (port of ``ctpn_tpu.data.synth``:
the same seed gives the same files, byte for byte, where both packages see
the same fonts).

Renders text lines onto procedural backgrounds and emits ICDAR/MLT-style
``gt_<stem>.txt`` 8-coordinate polygon files — the exact input format of the
data-prep pipeline (`ctpn_tpu_torch/data/prepare.py`, reference `split_label.py`).
Used for:

* end-to-end training validation without external datasets (the reference
  requires a multi-GB VOC tree that is not shipped);
* training smoke/convergence tests and demo artifacts.

Rendering variety (round 2): real TTF fonts (all DejaVu faces found in the
matplotlib data dir), word-like strings, sizes 14-72 px, small rotations,
paragraph blocks, gradient/texture backgrounds, low-contrast cases, and
optional blur — aimed at weights that transfer to real photographs.
Ground truth is PER WORD (ICDAR-style): line-level boxes spanning wide
spaces are unreachable for the text connector by construction
(`text_proposal_graph_builder.py:10-20` caps gaps at 50 px).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import string
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFilter, ImageFont


@lru_cache(maxsize=1)
def _font_files() -> Tuple[str, ...]:
    """Discover usable TTF faces (DejaVu ships with matplotlib)."""
    try:
        import matplotlib

        ttf_dir = osp.join(
            osp.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf"
        )
        faces = sorted(glob.glob(osp.join(ttf_dir, "DejaVu*.ttf")))
        if faces:
            return tuple(faces)
    except Exception:
        pass
    return ()


@lru_cache(maxsize=256)
def _font(path: Optional[str], size: int):
    if path:
        try:
            return ImageFont.truetype(path, size=size)
        except Exception:
            pass
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL: fixed-size bitmap font
        return ImageFont.load_default()


def _pick_font(rng: np.random.RandomState, size: int):
    faces = _font_files()
    path = faces[rng.randint(len(faces))] if faces else None
    return _font(path, size)


_WORD_CHARS = string.ascii_lowercase


def _word(rng: np.random.RandomState) -> str:
    w = "".join(rng.choice(list(_WORD_CHARS))
                for _ in range(rng.randint(2, 10)))
    style = rng.rand()
    if style < 0.15:
        return w.upper()
    if style < 0.45:
        return w.capitalize()
    if style < 0.55:
        return str(rng.randint(0, 10000))
    return w


def _line_text(rng: np.random.RandomState) -> str:
    return " ".join(_word(rng) for _ in range(rng.randint(1, 5)))


def _background(
    rng: np.random.RandomState, width: int, height: int
) -> Image.Image:
    """Procedural background: gradient / blurred blocks / noise texture."""
    kind = rng.rand()
    if kind < 0.35:  # vertical-ish gradient between two random colors
        c0 = rng.randint(0, 256, 3).astype(np.float32)
        c1 = rng.randint(0, 256, 3).astype(np.float32)
        t = np.linspace(0, 1, height)[:, None, None]
        arr = (c0 * (1 - t) + c1 * t) + rng.randn(height, width, 3) * 6
    elif kind < 0.7:  # low-res color blocks upsampled (photo-ish regions)
        small = rng.randint(0, 256, (rng.randint(2, 7), rng.randint(2, 7), 3))
        img = Image.fromarray(small.astype(np.uint8)).resize(
            (width, height), Image.BILINEAR
        )
        arr = np.asarray(img).astype(np.float32) + rng.randn(height, width, 3) * 8
    else:  # flat tone + noise (round-1 style)
        base = rng.randint(0, 200)
        arr = base + rng.randn(height, width, 3) * 18
    img = Image.fromarray(arr.clip(0, 255).astype(np.uint8))

    draw = ImageDraw.Draw(img)
    for _ in range(rng.randint(2, 8)):  # clutter: outlines and bars
        x0, y0 = rng.randint(0, width - 40), rng.randint(0, height - 40)
        x1, y1 = x0 + rng.randint(20, 240), y0 + rng.randint(8, 200)
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        shape = rng.rand()
        if shape < 0.4:
            draw.rectangle([x0, y0, x1, y1], outline=color,
                           width=rng.randint(1, 4))
        elif shape < 0.7:
            draw.ellipse([x0, y0, x1, y1], outline=color,
                         width=rng.randint(1, 4))
        else:
            draw.line([x0, y0, x1, y1], fill=color, width=rng.randint(1, 5))
    for _ in range(rng.randint(0, 3)):  # hard negatives (no ground truth)
        _draw_textlike_distractor(draw, rng, width, height)
    for _ in range(rng.randint(0, 3)):  # photographic clutter (round 5)
        _draw_photo_clutter(draw, rng, width, height)
    return img


def _draw_textlike_distractor(
    draw: "ImageDraw.ImageDraw",
    rng: np.random.RandomState,
    width: int,
    height: int,
) -> None:
    """Non-text pattern with text-LIKE local statistics (hard negative).

    At the model's 16-px stride, rows of short high-contrast strokes —
    barcodes, fences, brick courses, dotted leaders — look like text
    strokes; these patterns carry NO ground truth, so the classifier must
    learn to reject stroke texture that lacks glyph structure.
    """
    x0 = rng.randint(0, max(1, width - 120))
    y0 = rng.randint(0, max(1, height - 60))
    color = tuple(int(c) for c in rng.randint(0, 255, 3))
    kind = rng.rand()
    if kind < 0.35:  # barcode: dense vertical bars, text-height band
        h = rng.randint(10, 40)
        x = x0
        for _ in range(rng.randint(15, 45)):
            w = rng.randint(1, 4)
            if x + w >= width:
                break
            if rng.rand() < 0.6:
                draw.rectangle([x, y0, x + w, y0 + h], fill=color)
            x += w + rng.randint(1, 3)
    elif kind < 0.6:  # fence/comb: spaced vertical dashes in a row
        h = rng.randint(8, 28)
        step = rng.randint(6, 16)
        for x in range(x0, min(width - 2, x0 + rng.randint(80, 300)), step):
            draw.line([x, y0, x, y0 + h], fill=color,
                      width=rng.randint(1, 3))
    elif kind < 0.85:  # brick courses: stacked rows of short dashes
        bw, bh = rng.randint(14, 40), rng.randint(6, 14)
        rows = rng.randint(2, 5)
        for r in range(rows):
            y = y0 + r * (bh + 2)
            if y + bh >= height:
                break
            off = (bw // 2) if r % 2 else 0
            for x in range(x0 + off,
                           min(width - 2, x0 + rng.randint(60, 260)),
                           bw + 3):
                draw.line([x, y + bh, x + bw, y + bh], fill=color,
                          width=rng.randint(1, 2))
                draw.line([x, y, x, y + bh], fill=color, width=1)
    else:  # dotted leader line (table-of-contents style)
        y = y0
        for x in range(x0, min(width - 3, x0 + rng.randint(100, 400)),
                       rng.randint(5, 10)):
            draw.ellipse([x, y, x + 2, y + 2], fill=color)


def _draw_photo_clutter(
    draw: "ImageDraw.ImageDraw",
    rng: np.random.RandomState,
    width: int,
    height: int,
) -> None:
    """Photographic non-text clutter (hard negative, no ground truth).

    Targets the false-positive classes measured on the reference demo
    photos in round 5 (docs/TRAINING.md): weathered signage reads as text
    to a corpus-trained classifier — rows of bolt/rivet heads, rust
    streaks and stains along sign edges, and overhead wires all produce
    short high-contrast horizontal structure at the 16-px stride. None of
    these carry ground truth, so the classifier must learn to reject them.
    """
    kind = rng.rand()
    if kind < 0.35:  # rivet/bolt row: dark discs with an offset highlight
        n = rng.randint(2, 8)
        r = rng.randint(4, 14)
        x = rng.randint(0, max(1, width - n * 4 * r))
        y = rng.randint(0, max(1, height - 2 * r))
        step = rng.randint(int(2.5 * r), 6 * r)
        shade = int(rng.randint(15, 80))
        for _ in range(n):
            if x + 2 * r >= width:
                break
            draw.ellipse([x, y, x + 2 * r, y + 2 * r],
                         fill=(shade, shade, shade))
            hl = int(min(255, shade + rng.randint(60, 140)))
            draw.ellipse(
                [x + r // 2, y + r // 3, x + r, y + (2 * r) // 3],
                fill=(hl, hl, hl),
            )
            x += step
    elif kind < 0.75:  # rust streak / stain band: overlapping earth blobs
        cx = rng.randint(0, width)
        cy = rng.randint(0, height)
        horiz = rng.rand() < 0.7  # streaks hug sign edges -> mostly bands
        spread_x = rng.randint(40, 260) if horiz else rng.randint(10, 50)
        spread_y = rng.randint(6, 30) if horiz else rng.randint(40, 160)
        # darker reds/browns only: pale-yellow tones are reserved for the
        # positive class (low-contrast signage paint, _text_fill)
        base = np.array([rng.randint(70, 140), rng.randint(30, 80),
                         rng.randint(5, 45)])
        for _ in range(rng.randint(6, 22)):
            bx = cx + int(rng.randn() * spread_x * 0.5)
            by = cy + int(rng.randn() * spread_y * 0.5)
            bw = rng.randint(3, max(4, spread_x // 3))
            bh = rng.randint(2, max(3, spread_y))
            c = (base + rng.randint(-30, 30, 3)).clip(0, 255)
            draw.ellipse([bx, by, bx + bw, by + bh],
                         fill=tuple(int(v) for v in c))
    else:  # overhead wires: long thin near-horizontal lines
        for _ in range(rng.randint(1, 4)):
            y0 = rng.randint(0, height)
            y1 = y0 + rng.randint(-height // 4, height // 4)
            shade = int(rng.randint(10, 90))
            draw.line([0, y0, width, y1], fill=(shade, shade, shade),
                      width=rng.randint(1, 3))


def _mean_color(img: Image.Image, box) -> np.ndarray:
    x0, y0, x1, y1 = [int(v) for v in box]
    region = np.asarray(img)[max(y0, 0):max(y1, y0 + 1),
                             max(x0, 0):max(x1, x0 + 1)]
    if region.size == 0:
        return np.array([128.0, 128.0, 128.0])
    return region.reshape(-1, 3).mean(axis=0)


def _text_fill(
    rng: np.random.RandomState, bg_mean: np.ndarray
) -> Tuple[int, int, int]:
    """Contrast against the local background; 20% low-contrast cases,
    of which some are PALE-WARM tints (cream/yellow signage paint on
    mid-tone scenes — the round-5 rust-stain negatives share that hue
    band, so the positive class must cover it or the classifier learns
    color, not glyph structure; docs/TRAINING.md round 5)."""
    bright_bg = bg_mean.mean() > 127
    lo_contrast = rng.rand() < 0.2
    if lo_contrast and not bright_bg and rng.rand() < 0.5:
        # pale warm tint, modestly brighter than the mid/dark background
        base = int(min(235, bg_mean.mean() + rng.randint(45, 90)))
        return (base, int(base - rng.randint(5, 25)),
                max(0, int(base - rng.randint(50, 110))))
    if bright_bg:
        lo, hi = (60, 130) if lo_contrast else (0, 70)
    else:
        lo, hi = (130, 200) if lo_contrast else (185, 256)
    return tuple(int(c) for c in rng.randint(lo, hi, 3))


def _word_boxes(probe, text: str, font, x: float, y: float, chars=None):
    """Axis-aligned bbox of every word of ``text`` drawn at (x, y).

    Ground truth is per WORD (ICDAR-style, the labeling the CTPN family is
    designed for): the text connector splits lines at horizontal gaps >
    ``MAX_HORIZONTAL_GAP`` (`text_proposal_graph_builder.py:10-20`), so a
    line-level box spanning wide spaces is unreachable by construction.

    ``chars``, a list, gets for each word kept the bboxes of its
    characters (the glyphs with ink, each at its advance in the word).
    """
    out = []
    prefix = ""
    for word in text.split(" "):
        off = probe.textlength(prefix, font=font) if prefix else 0.0
        b = probe.textbbox((x + off, y), word, font=font)
        if b[2] > b[0] and b[3] > b[1]:
            out.append(b)
            if chars is not None:
                chars.append(_char_boxes(probe, word, font, x + off, y) or [b])
        prefix += word + " "
    return out


def _char_boxes(probe, word: str, font, x: float, y: float):
    """The bbox of each character of ``word`` drawn at (x, y) that has ink."""
    out = []
    for j, c in enumerate(word):
        off = probe.textlength(word[:j], font=font) if j else 0.0
        b = probe.textbbox((x + off, y), c, font=font)
        if b[2] > b[0] and b[3] > b[1]:
            out.append(b)
    return out


def _corners(box) -> Tuple[float, ...]:
    x0, y0, x1, y1 = box
    return (x0, y0, x1, y0, x1, y1, x0, y1)


def _render_line(
    img: Image.Image,
    rng: np.random.RandomState,
    y_hint: Optional[int] = None,
    size: Optional[int] = None,
    chars: Optional[list] = None,
) -> Optional[List[Tuple[float, ...]]]:
    """Draw one text line (possibly rotated); returns per-word 8-coord
    polygons (None if the line did not fit). ``chars``, a list, gets one
    list of character polygons per word returned."""
    width, height = img.size
    # include display sizes (96-150 px): the reference demo set has
    # signage/headline text far above body-text scale
    size = size or int(rng.choice(
        [14, 16, 20, 24, 28, 32, 40, 48, 56, 72, 96, 120, 150],
        p=[0.07, 0.09, 0.13, 0.13, 0.12, 0.11, 0.1, 0.08, 0.06, 0.04,
           0.03, 0.02, 0.02],
    ))
    font = _pick_font(rng, size)
    text = _line_text(rng)
    probe = ImageDraw.Draw(img)
    bbox = probe.textbbox((0, 0), text, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if tw >= width - 12 or th >= height - 12:
        return None
    x = rng.randint(4, max(5, width - tw - 8))
    y = (y_hint if y_hint is not None
         else rng.randint(4, max(5, height - th - 8)))
    if y + th >= height - 4:
        return None
    angle = float(rng.uniform(-8, 8)) if rng.rand() < 0.3 else 0.0

    fill = _text_fill(rng, _mean_color(img, (x, y, x + tw, y + th)))

    word_chars = [] if chars is not None else None
    if abs(angle) < 0.5:
        d = ImageDraw.Draw(img)
        boxes = _word_boxes(d, text, font, x, y, word_chars)
        d.text((x, y), text, font=font, fill=fill)
        if boxes and chars is not None:
            chars.extend([_corners(c) for c in w] for w in word_chars)
        return [
            (x0, y0, x1, y0, x1, y1, x0, y1) for x0, y0, x1, y1 in boxes
        ] or None

    # rotated: render on a transparent layer, rotate about the line center
    pad = 8
    layer = Image.new("RGBA", (tw + 2 * pad, th + 2 * pad), (0, 0, 0, 0))
    ld = ImageDraw.Draw(layer)
    ld.text((pad - bbox[0], pad - bbox[1]), text, font=font,
            fill=fill + (255,))
    rot = layer.rotate(angle, expand=True, resample=Image.BICUBIC)
    cx, cy = x + tw / 2.0, y + th / 2.0
    px = int(round(cx - rot.width / 2.0))
    py = int(round(cy - rot.height / 2.0))
    if px < 0 or py < 0 or px + rot.width >= width or py + rot.height >= height:
        return None
    img.paste(rot, (px, py), rot)
    # rotate each word's corners about the line center
    # (PIL rotates counter-clockwise for angle > 0)
    rad = np.deg2rad(angle)
    c, s = np.cos(rad), np.sin(rad)
    rotm = np.array([[c, s], [-s, c]])
    center = np.array([cx, cy])
    line_origin = np.array([x + tw / 2.0, y + th / 2.0])
    def turned(box):
        x0, y0, x1, y1 = box
        corners = np.array(
            [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], dtype=np.float64
        )
        pts = (corners - line_origin) @ rotm.T + center
        return tuple(float(v) for v in pts.reshape(-1))

    polys = [turned(b) for b in _word_boxes(probe, text, font, x, y, word_chars)]
    if polys and chars is not None:
        chars.extend([turned(c) for c in w] for w in word_chars)
    return polys or None


def _render_edge_clipped_line(
    img: Image.Image,
    rng: np.random.RandomState,
    chars: Optional[list] = None,
) -> Optional[List[Tuple[float, ...]]]:
    """One text line straddling an image border, GT clipped to the canvas.

    Real photos crop text at the frame (006.jpg's top line occupies
    y 0-30 in the reference goldens); `_render_line` always keeps a >=4 px
    margin, so without this mode the detector never sees partially
    visible glyphs at an edge and rejects them. PIL clips the off-canvas
    part of the drawing; the GT keeps only the visible portion of each
    word (>=40% of the line height or it is dropped)."""
    width, height = img.size
    size = int(rng.choice([24, 28, 32, 40, 48, 56, 72],
                          p=[0.15, 0.15, 0.2, 0.18, 0.14, 0.1, 0.08]))
    font = _pick_font(rng, size)
    text = _line_text(rng)
    probe = ImageDraw.Draw(img)
    bbox = probe.textbbox((0, 0), text, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if tw >= width - 12 or th >= height - 12:
        return None
    edge = rng.choice(["top", "bottom", "left", "right"],
                      p=[0.45, 0.25, 0.15, 0.15])
    hidden = rng.uniform(0.2, 0.5)  # fraction of the line off-canvas
    if edge in ("top", "bottom"):
        x = rng.randint(4, max(5, width - tw - 8))
        y = (-int(th * hidden) - bbox[1] if edge == "top"
             else height - int(th * (1.0 - hidden)) - bbox[1])
    else:
        y = rng.randint(4, max(5, height - th - 8))
        x = (-int(tw * hidden) if edge == "left"
             else width - int(tw * (1.0 - hidden)))
    fill = _text_fill(
        rng, _mean_color(img, (max(x, 0), max(y, 0),
                               min(x + tw, width), min(y + th, height)))
    )
    d = ImageDraw.Draw(img)
    word_chars = [] if chars is not None else None
    word_boxes = _word_boxes(d, text, font, x, y, word_chars)
    d.text((x, y), text, font=font, fill=fill)
    polys, kept_chars = [], []

    def clipped(box):
        x0, y0, x1, y1 = box
        return max(x0, 0.0), max(y0, 0.0), min(x1, float(width)), min(y1, float(height))

    for k, (x0, y0, x1, y1) in enumerate(word_boxes):
        cx0, cy0, cx1, cy1 = clipped((x0, y0, x1, y1))
        word_h = max(y1 - y0, 1.0)
        if cx1 - cx0 < 4 or cy1 - cy0 < max(6.0, 0.4 * word_h):
            continue
        polys.append((cx0, cy0, cx1, cy0, cx1, cy1, cx0, cy1))
        if chars is not None:
            inside = [clipped(c) for c in word_chars[k]]
            inside = [c for c in inside if c[2] > c[0] and c[3] > c[1]]
            kept_chars.append([_corners(c) for c in inside] or [polys[-1]])
    if polys and chars is not None:
        chars.extend(kept_chars)
    return polys or None


def _render_glyph_line(
    img: Image.Image,
    rng: np.random.RandomState,
    y_hint: Optional[int] = None,
    chars: Optional[list] = None,
) -> Optional[List[Tuple[float, ...]]]:
    """One line of procedural stroke glyphs (CJK-like texture).

    No CJK fonts exist in this environment, but the reference's demo set
    includes dense ideograph text (008.jpg); square glyphs of random
    strokes teach the classifier that texture. Ground truth is ONE
    polygon for the whole line (ICDAR CJK convention: no word gaps).
    """
    width, height = img.size
    size = int(rng.choice([16, 20, 26, 32, 40], p=[0.2, 0.25, 0.25, 0.2, 0.1]))
    n_glyphs = rng.randint(4, max(5, min(18, (width - 20) // int(size * 1.15))))
    gap = max(1, int(size * 0.12))
    tw = n_glyphs * size + (n_glyphs - 1) * gap
    th = size
    if tw >= width - 12:
        return None
    x = rng.randint(4, max(5, width - tw - 8))
    y = (y_hint if y_hint is not None
         else rng.randint(4, max(5, height - th - 8)))
    if y + th >= height - 4:
        return None
    fill = _text_fill(rng, _mean_color(img, (x, y, x + tw, y + th)))
    d = ImageDraw.Draw(img)
    gx = float(x)
    for _ in range(n_glyphs):
        w_stroke = max(1, size // 14)
        for _s in range(rng.randint(3, 8)):
            # strokes biased axis-aligned like real ideographs
            if rng.rand() < 0.7:
                if rng.rand() < 0.5:  # horizontal
                    sy = y + rng.uniform(0.1, 0.9) * size
                    x0 = gx + rng.uniform(0.0, 0.3) * size
                    x1 = gx + rng.uniform(0.6, 1.0) * size
                    d.line([x0, sy, x1, sy], fill=fill, width=w_stroke)
                else:  # vertical
                    sx = gx + rng.uniform(0.1, 0.9) * size
                    y0 = y + rng.uniform(0.0, 0.3) * size
                    y1 = y + rng.uniform(0.6, 1.0) * size
                    d.line([sx, y0, sx, y1], fill=fill, width=w_stroke)
            else:  # diagonal tick
                x0 = gx + rng.uniform(0.1, 0.5) * size
                y0 = y + rng.uniform(0.1, 0.5) * size
                d.line([x0, y0, x0 + rng.uniform(0.2, 0.5) * size,
                        y0 + rng.uniform(0.2, 0.5) * size],
                       fill=fill, width=w_stroke)
        gx += size + gap
    if chars is not None:  # the line is one word of square glyphs
        chars.append([_corners((x + k * (size + gap), y, x + k * (size + gap) + size, y + th))
                      for k in range(n_glyphs)])
    return [(x, y, x + tw, y, x + tw, y + th, x, y + th)]


def render_image(
    rng: np.random.RandomState,
    width: int = 900,
    height: int = 600,
    max_lines: int = 6,
    chars: Optional[list] = None,
) -> Tuple[np.ndarray, List[Tuple[float, ...]]]:
    """One RGB uint8 image + list of 8-coord per-word text polygons.

    ``chars``, a list, gets for each polygon, in order, the list of its
    characters' 8-coord polygons (a glyph line's glyphs). It draws nothing
    more and takes nothing more from ``rng``: the image and the polygons
    are those of a call without it."""
    img = _background(rng, width, height)
    polys: List[Tuple[float, ...]] = []

    if rng.rand() < 0.3:  # paragraph block: stacked lines, one size
        size = int(rng.randint(16, 36))
        y = rng.randint(8, height // 3)
        for _ in range(rng.randint(2, 6)):
            p = _render_line(img, rng, y_hint=y, size=size, chars=chars)
            if p is not None:
                polys.extend(p)
            y += int(size * rng.uniform(1.3, 1.9))
            if y > height - size - 10:
                break

    if rng.rand() < 0.25:  # dense glyph block: stacked CJK-like lines
        y = rng.randint(8, height // 2)
        for _ in range(rng.randint(2, 7)):
            p = _render_glyph_line(img, rng, y_hint=y, chars=chars)
            if p is not None:
                polys.extend(p)
                y = int(p[0][7] + rng.uniform(0.2, 0.7) * (p[0][7] - p[0][1]))
            else:
                y += 30
            if y > height - 44:
                break

    n_lines = rng.randint(1, max_lines + 1)
    for _ in range(n_lines):
        for _attempt in range(6):
            p = (_render_glyph_line(img, rng, chars=chars) if rng.rand() < 0.15
                 else _render_line(img, rng, chars=chars))
            if p is not None:
                polys.extend(p)
                break

    if rng.rand() < 0.25:  # border-clipped line: text cut by the frame
        p = _render_edge_clipped_line(img, rng, chars=chars)
        if p is not None:
            polys.extend(p)

    if rng.rand() < 0.25:
        img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0.4, 1.2)))
    arr = np.asarray(img).astype(np.float32)
    if rng.rand() < 0.35:  # photometric jitter: global contrast/brightness
        gain = rng.uniform(0.7, 1.25)
        bias = rng.uniform(-25, 25)
        arr = arr * gain + bias
    return arr.clip(0, 255).astype(np.uint8), polys


def generate_dataset(
    out_dir: str,
    n_images: int = 100,
    seed: int = 3,
    width: int = 900,
    height: int = 600,
) -> Tuple[str, str]:
    """Write images + gt files; returns (image_dir, label_dir)."""
    img_dir = osp.join(out_dir, "image")
    gt_dir = osp.join(out_dir, "label")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        # vary canvas geometry so multiple shape buckets are exercised
        if rng.rand() < 0.25:
            w_i, h_i = height, width  # portrait
        else:
            w_i, h_i = width, height
        arr, polys = render_image(rng, width=w_i, height=h_i)
        stem = f"synth_{i:05d}"
        Image.fromarray(arr).save(
            osp.join(img_dir, stem + ".jpg"), quality=int(rng.randint(70, 96))
        )
        with open(osp.join(gt_dir, f"gt_{stem}.txt"), "w") as f:
            for p in polys:
                f.write(",".join(str(int(round(v))) for v in p) + ",text\n")
    return img_dir, gt_dir
