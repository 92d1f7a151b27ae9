"""Pascal-VOC-format dataset (port of ``ctpn_tpu.data.voc``; the reference's
training data layout).

Re-implementation of `lib/datasets/imdb.py` + `lib/datasets/pascal_voc.py` +
`lib/datasets/factory.py`: two classes ('__background__', 'text'), XML
annotations under ``Annotations/``, image ids from ``ImageSets/Main/
<split>.txt``, gt roidb with a pickle cache. The CTPN training tree is
produced by `ctpn_tpu_torch/data/prepare.py` (equivalent of the reference's
`lib/prepare_training_data/`), symlinked as ``data/VOCdevkit2007``
(reference README.md:50-53).

Simplifications vs the reference: the legacy fast-rcnn paths that CTPN never
exercises (selective-search roidbs, VOC eval-server writers —
`pascal_voc.py:104-197`) are not carried over; overlaps are stored dense
(G x num_classes is tiny for 2 classes) instead of scipy.sparse.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional

import numpy as np
from PIL import Image

from ctpn_tpu_torch.config import cfg

CACHE_PREFIX = "torch_"


class PascalVOC:
    """imdb for VOC-format text detection data."""

    def __init__(self, image_set: str, year: str, devkit_path: Optional[str] = None):
        self.name = f"voc_{year}_{image_set}"
        self._image_set = image_set
        self._year = year
        self._devkit_path = devkit_path or self._default_path()
        self._data_path = osp.join(self._devkit_path, f"VOC{year}")
        self.classes = ("__background__", "text")
        self.num_classes = 2
        self._class_to_ind = {c: i for i, c in enumerate(self.classes)}
        self._image_ext = ".jpg"
        self.image_index = self._load_image_set_index()
        self._roidb: Optional[List[dict]] = None

    def _default_path(self) -> str:
        return osp.join(cfg.ROOT_DIR, "data", f"VOCdevkit{self._year}")

    def _load_image_set_index(self) -> List[str]:
        path = osp.join(
            self._data_path, "ImageSets", "Main", self._image_set + ".txt"
        )
        if not osp.exists(path):
            raise FileNotFoundError(f"image set file missing: {path}")
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def image_path_at(self, i: int) -> str:
        return self.image_path_from_index(self.image_index[i])

    def image_path_from_index(self, index: str) -> str:
        path = osp.join(self._data_path, "JPEGImages", index + self._image_ext)
        if not osp.exists(path):  # data prep may emit .png
            alt = osp.splitext(path)[0] + ".png"
            if osp.exists(alt):
                return alt
        return path

    @property
    def num_images(self) -> int:
        return len(self.image_index)

    @property
    def cache_path(self) -> str:
        p = osp.join(cfg.ROOT_DIR, "data", "cache")
        os.makedirs(p, exist_ok=True)
        return p

    @property
    def roidb(self) -> List[dict]:
        if self._roidb is None:
            self._roidb = self.gt_roidb()
        return self._roidb

    def gt_roidb(self) -> List[dict]:
        """Per-image gt dicts, pickle-cached like `pascal_voc.py:83-102`.

        Unlike the reference, the cache key is salted with the devkit path
        AND the split-file content + annotation mtimes — two datasets
        sharing a name (e.g. in tests) must not collide, and REGENERATED
        data at the same path must not serve a stale cache (the reference
        requires a manual `rm data/cache/*` there).
        """
        import hashlib

        h = hashlib.sha1(osp.abspath(self._devkit_path).encode())
        split_file = osp.join(
            self._data_path, "ImageSets", "Main", self._image_set + ".txt"
        )
        if osp.exists(split_file):
            with open(split_file, "rb") as f:
                h.update(f.read())
        ann_dir = osp.join(self._data_path, "Annotations")
        if osp.isdir(ann_dir):
            stamps = sorted(
                f"{e.name}:{e.stat().st_mtime_ns}"
                for e in os.scandir(ann_dir)
            )
            h.update("|".join(stamps).encode())
        salt = h.hexdigest()[:10]
        # the port's own prefix: never the JAX package's pickle of one tree
        cache_file = osp.join(
            self.cache_path, f"{CACHE_PREFIX}{self.name}_{salt}_gt_roidb.pkl"
        )
        if osp.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        roidb = [self._load_annotation(idx) for idx in self.image_index]
        # write aside, then rename: data-parallel ranks build the same cache
        # at once, and none may read another's half-written file
        tmp = f"{cache_file}.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_file)
        return roidb

    def _load_annotation(self, index: str) -> dict:
        """Parse one VOC XML into the roidb record (`pascal_voc.py:124-166`)."""
        filename = osp.join(self._data_path, "Annotations", index + ".xml")
        tree = ET.parse(filename)
        objs = tree.findall("object")
        num_objs = len(objs)
        boxes = np.zeros((num_objs, 4), dtype=np.float32)
        gt_classes = np.zeros(num_objs, dtype=np.int32)
        overlaps = np.zeros((num_objs, self.num_classes), dtype=np.float32)
        ishards = np.zeros(num_objs, dtype=np.int32)
        seg_areas = np.zeros(num_objs, dtype=np.float32)
        for ix, obj in enumerate(objs):
            bbox = obj.find("bndbox")
            # VOC pixel indexes are 1-based (reference subtracts 1)
            x1 = float(bbox.find("xmin").text) - 1
            y1 = float(bbox.find("ymin").text) - 1
            x2 = float(bbox.find("xmax").text) - 1
            y2 = float(bbox.find("ymax").text) - 1
            diff = obj.find("difficult")
            ishards[ix] = 0 if diff is None else int(diff.text)
            clsname = obj.find("name").text.lower().strip()
            cls_i = self._class_to_ind.get(clsname, 1)
            boxes[ix] = [x1, y1, x2, y2]
            gt_classes[ix] = cls_i
            overlaps[ix, cls_i] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)
        return {
            "boxes": boxes,
            "gt_classes": gt_classes,
            "gt_ishard": ishards,
            "gt_overlaps": overlaps,
            "dontcare_areas": np.zeros((0, 4), dtype=np.float32),
            "flipped": False,
            "seg_areas": seg_areas,
        }

    def append_flipped_images(self) -> None:
        """Double the dataset with x-mirrored copies (`imdb.py:84-113`)."""
        num = self.num_images
        widths = [
            Image.open(self.image_path_at(i)).size[0] for i in range(num)
        ]
        roidb = self.roidb
        for i in range(num):
            entry = roidb[i]
            boxes = entry["boxes"].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - oldx2 - 1
            boxes[:, 2] = widths[i] - oldx1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            dc = entry["dontcare_areas"].copy()
            if len(dc):
                ox1 = dc[:, 0].copy()
                ox2 = dc[:, 2].copy()
                dc[:, 0] = widths[i] - ox2 - 1
                dc[:, 2] = widths[i] - ox1 - 1
            roidb.append(
                {
                    **{k: entry[k] for k in ("gt_classes", "gt_ishard",
                                             "gt_overlaps", "seg_areas")},
                    "boxes": boxes,
                    "dontcare_areas": dc,
                    "flipped": True,
                }
            )
        self.image_index = self.image_index * 2


_REGISTRY: Dict[str, Callable[[], PascalVOC]] = {}


def _register_defaults() -> None:
    for year in ("2007", "2012", "0712"):
        for split in ("train", "val", "trainval", "test"):
            name = f"voc_{year}_{split}"
            _REGISTRY[name] = (
                lambda split=split, year=year: PascalVOC(split, year)
            )


_register_defaults()


def get_imdb(name: str) -> PascalVOC:
    """Factory dispatch (`datasets/factory.py:15-24`)."""
    if name not in _REGISTRY:
        raise KeyError(f"Unknown dataset: {name}")
    return _REGISTRY[name]()


def list_imdbs() -> List[str]:
    return sorted(_REGISTRY)
