"""Offline training-data preparation: strip splitting and the VOC tree
(port of ``ctpn_tpu.data.prepare``; it writes the same files, byte for byte).

Equivalent of the reference's `lib/prepare_training_data/split_label.py` and
`ToVoc.py` pipeline (SURVEY.md §3.5), driven as library functions / one CLI
instead of edit-the-paths scripts:

1. :func:`split_labels` — resize raw images (short side 600, long capped
   1200), scale the 8-coordinate polygon ground truth, axis-align, and cut
   into 16-px-wide strips aligned to the 16-px grid
   (`split_label.py:84-104` grid semantics preserved: first strip starts at
   xmin, interior strips on ceil-to-16 boundaries, zero-width strips
   dropped);
2. :func:`to_voc` — write the strips as a Pascal-VOC 2007 tree
   (Annotations/ JPEGImages/ ImageSets/Main train-val-trainval lists) with
   the reference's +1 pixel offset into 1-based VOC coordinates
   (`ToVoc.py:50-51`) and its `_is_hard` rule (`ToVoc.py:73-84`).

Ground-truth input format: ``gt_<stem>.txt`` beside each image, one
``x1,y1,x2,y2,x3,y3,x4,y4[,label]`` polygon per line (ICDAR/MLT style).
"""

from __future__ import annotations

import math
import os
import os.path as osp
from typing import List, Sequence, Tuple
from xml.sax.saxutils import escape

import numpy as np
from PIL import Image

from ctpn_tpu_torch.utils.image import load_image_bgr


def split_polygon_to_strips(
    poly_xy: Sequence[float], im_h: int, im_w: int
) -> List[Tuple[int, int, int, int]]:
    """One scaled 8-coord polygon -> list of (x1, y1, x2, y2) strips."""
    xs = np.array(poly_xy[0::2], dtype=np.int64)
    ys = np.array(poly_xy[1::2], dtype=np.int64)
    order = np.argsort(xs, kind="stable")
    xs, ys = xs[order], ys[order]
    # left pair / right pair, top before bottom
    if ys[0] < ys[1]:
        pt1, pt3 = (xs[0], ys[0]), (xs[1], ys[1])
    else:
        pt1, pt3 = (xs[1], ys[1]), (xs[0], ys[0])
    if ys[2] < ys[3]:
        pt2, pt4 = (xs[2], ys[2]), (xs[3], ys[3])
    else:
        pt2, pt4 = (xs[3], ys[3]), (xs[2], ys[2])
    xmin = max(0, int(min(pt1[0], pt2[0])))
    ymin = max(0, int(min(pt1[1], pt2[1])))
    xmax = min(im_w - 1, int(max(pt2[0], pt4[0])))
    ymax = min(im_h - 1, int(max(pt3[1], pt4[1])))
    if xmax <= xmin or ymax <= ymin:
        return []

    x_left = [xmin]
    start = int(math.ceil(xmin / 16.0) * 16.0)
    if start == xmin:
        start = xmin + 16
    x_left.extend(range(start, xmax, 16))
    x_right = [start - 1]
    for i in range(1, len(x_left) - 1):
        x_right.append(x_left[i] + 15)
    x_right.append(xmax)
    return [
        (int(l), int(ymin), int(r), int(ymax))
        for l, r in zip(x_left, x_right)
        if l != r
    ]


def split_labels(
    image_dir: str,
    gt_dir: str,
    out_image_dir: str,
    out_label_dir: str,
    scale: int = 600,
    max_scale: int = 1200,
) -> List[str]:
    """Stage 1: resized images + per-image strip label files. Returns stems."""
    os.makedirs(out_image_dir, exist_ok=True)
    os.makedirs(out_label_dir, exist_ok=True)
    stems = []
    for fname in sorted(os.listdir(image_dir)):
        stem, ext = osp.splitext(fname)
        if ext.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        gt_file = osp.join(gt_dir, f"gt_{stem}.txt")
        if not osp.exists(gt_file):
            continue
        im = load_image_bgr(osp.join(image_dir, fname))
        h0, w0 = im.shape[:2]
        f = float(scale) / min(h0, w0)
        if round(f * max(h0, w0)) > max_scale:
            f = float(max_scale) / max(h0, w0)
        new_w, new_h = int(w0 * f), int(h0 * f)
        pil = Image.fromarray(im[..., ::-1])  # save as RGB
        resized = pil.resize((new_w, new_h), Image.BILINEAR)
        resized.save(osp.join(out_image_dir, stem + ".jpg"), quality=95)

        strips: List[Tuple[int, int, int, int]] = []
        with open(gt_file, encoding="utf-8-sig") as fh:
            for line in fh:
                parts = line.strip().lower().split(",")
                if len(parts) < 8:
                    continue
                poly = []
                for i in range(8):
                    v = float(parts[i])
                    # scale via the resized/original ratio like the reference
                    if i % 2 == 0:
                        poly.append(int(v / w0 * new_w))
                    else:
                        poly.append(int(v / h0 * new_h))
                strips.extend(split_polygon_to_strips(poly, new_h, new_w))
        with open(osp.join(out_label_dir, stem + ".txt"), "w") as out:
            for x1, y1, x2, y2 in strips:
                out.write(f"text\t{x1}\t{y1}\t{x2}\t{y2}\n")
        stems.append(stem)
    return stems


def _is_hard(y1: int, y2: int) -> bool:
    """Reference `_is_hard` with its constant occlusion/truncation inputs
    (`ToVoc.py:50-55` passes occlusion=0, truncation=0) — never hard."""
    return False


def _voc_xml(stem: str, lines: List[str], im_h: int, im_w: int) -> str:
    objs = []
    for line in lines:
        parts = line.strip().lower().split()
        if not parts or parts[0] != "text":
            continue
        # +1: VOC uses 1-based pixel coordinates (`ToVoc.py:50-51`)
        x1, y1, x2, y2 = (int(float(v) + 1) for v in parts[1:5])
        difficult = 1 if _is_hard(y1, y2) else 0
        objs.append(
            "  <object>\n"
            "    <name>text</name>\n"
            "    <pose>none</pose>\n"
            "    <truncated>0</truncated>\n"
            f"    <difficult>{difficult}</difficult>\n"
            "    <bndbox>\n"
            f"      <xmin>{x1}</xmin>\n      <ymin>{y1}</ymin>\n"
            f"      <xmax>{x2}</xmax>\n      <ymax>{y2}</ymax>\n"
            "    </bndbox>\n"
            "  </object>"
        )
    body = "\n".join(objs)
    return (
        "<annotation>\n"
        "  <folder>text</folder>\n"
        f"  <filename>{escape(stem)}.jpg</filename>\n"
        "  <source><database>coco_text_database</database></source>\n"
        f"  <size><width>{im_w}</width><height>{im_h}</height>"
        "<depth>3</depth></size>\n"
        "  <segmented>0</segmented>\n"
        f"{body}\n"
        "</annotation>\n"
    )


def to_voc(
    label_dir: str,
    image_dir: str,
    out_dir: str,
    val_fraction: float = 0.0,
    seed: int = 3,
) -> None:
    """Stage 2: strips + images -> VOC2007 tree with ImageSets lists."""
    ann_dir = osp.join(out_dir, "Annotations")
    img_dir = osp.join(out_dir, "JPEGImages")
    set_dir = osp.join(out_dir, "ImageSets", "Main")
    for d in (ann_dir, img_dir, set_dir):
        os.makedirs(d, exist_ok=True)

    stems = sorted(
        osp.splitext(f)[0] for f in os.listdir(label_dir) if f.endswith(".txt")
    )
    kept = []
    for stem in stems:
        src_img = osp.join(image_dir, stem + ".jpg")
        if not osp.exists(src_img):
            continue
        with Image.open(src_img) as img:
            im_w, im_h = img.size
        with open(osp.join(label_dir, stem + ".txt")) as f:
            lines = f.readlines()
        if not lines:
            continue
        with open(osp.join(ann_dir, stem + ".xml"), "w") as f:
            f.write(_voc_xml(stem, lines, im_h, im_w))
        dst = osp.join(img_dir, stem + ".jpg")
        if not osp.exists(dst):
            try:
                os.link(src_img, dst)  # hardlink when possible
            except OSError:
                import shutil

                shutil.copyfile(src_img, dst)
        kept.append(stem)

    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(kept))
    n_val = int(len(kept) * val_fraction)
    val = sorted(kept[i] for i in perm[:n_val])
    train = sorted(kept[i] for i in perm[n_val:])
    for name, items in (
        ("train", train),
        ("val", val),
        ("trainval", sorted(kept)),
    ):
        with open(osp.join(set_dir, name + ".txt"), "w") as f:
            f.write("".join(s + "\n" for s in items))
