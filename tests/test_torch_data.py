"""The port's data layer against ``ctpn_tpu.data`` on the same inputs.

Everything here is host code, so the comparisons are exact: the files
``split_labels``/``to_voc`` and ``generate_dataset`` write are identical
byte for byte, the roidb entries and the minibatch arrays are equal, and
``RoIDataLayer`` visits the entries in the same order for one seed.
"""

import filecmp
import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.data import minibatch as jmb
from ctpn_tpu.data import prepare as jprep
from ctpn_tpu.data import synth as jsynth
from ctpn_tpu.data.roidb import get_training_roidb as jax_training_roidb
from ctpn_tpu.data.voc import PascalVOC as JVOC
from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.data import minibatch as mb
from ctpn_tpu_torch.data import prepare, synth
from ctpn_tpu_torch.data.pipeline import PrefetchLoader
from ctpn_tpu_torch.data.roidb import get_training_roidb
from ctpn_tpu_torch.data.voc import CACHE_PREFIX, PascalVOC


@pytest.fixture(autouse=True)
def _roots(tmp_path):
    """Both packages' ROOT_DIR (roidb pickle cache) under the test's tmp."""
    reset_cfg()
    cfg.ROOT_DIR = jcfg.ROOT_DIR = str(tmp_path)
    yield
    reset_cfg()


def _raw_dataset(root, rng, n=3):
    """Raw images (two sizes, one portrait) and ICDAR-style polygons."""
    img_dir, gt_dir = osp.join(root, "image"), osp.join(root, "label")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    for i in range(n):
        w, h = (320, 240) if i % 3 else (200, 300)
        arr = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(osp.join(img_dir, f"img{i}.jpg"))
        with open(osp.join(gt_dir, f"gt_img{i}.txt"), "w") as f:
            f.write("20,30,180,30,180,60,20,60,hello\n")
            f.write("40,100,190,105,190,140,40,135,world\n")
            f.write("17,150,33,150,33,170,17,170\n")
    return img_dir, gt_dir


def _same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, the same bytes."""
    files = []
    for top in (a, b):
        files.append(sorted(osp.relpath(osp.join(d, f), top)
                            for d, _, fs in os.walk(top) for f in fs))
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        assert filecmp.cmp(osp.join(a, rel), osp.join(b, rel), shallow=False), rel
    return files[0]


def _voc(pkg_prepare, root, img_dir, gt_dir):
    stems = pkg_prepare.split_labels(img_dir, gt_dir, osp.join(root, "re_image"),
                                     osp.join(root, "label_tmp"))
    devkit = osp.join(root, "VOCdevkit2007")
    pkg_prepare.to_voc(osp.join(root, "label_tmp"), osp.join(root, "re_image"),
                       osp.join(devkit, "VOC2007"), val_fraction=0.34)
    return stems, devkit


@pytest.fixture
def trees(tmp_path, rng):
    img_dir, gt_dir = _raw_dataset(str(tmp_path / "raw"), rng)
    j = _voc(jprep, str(tmp_path / "jax"), img_dir, gt_dir)
    t = _voc(prepare, str(tmp_path / "port"), img_dir, gt_dir)
    return tmp_path, j, t


def test_prepare_writes_the_same_files(trees):
    tmp, (jstems, _), (stems, _) = trees
    assert stems == jstems == ["img0", "img1", "img2"]
    names = _same_tree(str(tmp / "jax"), str(tmp / "port"))
    assert "VOCdevkit2007/VOC2007/ImageSets/Main/val.txt" in names
    assert prepare.split_polygon_to_strips([10, 5, 75, 5, 75, 40, 10, 40], 100, 200) == \
        jprep.split_polygon_to_strips([10, 5, 75, 5, 75, 40, 10, 40], 100, 200)


def _assert_entries_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_roidb_entries_equal_and_caches_apart(trees):
    tmp, _, (_, devkit) = trees
    want = jax_training_roidb(JVOC("trainval", "2007", devkit_path=devkit))
    got = get_training_roidb(PascalVOC("trainval", "2007", devkit_path=devkit))
    assert len(got) == 6 and got[3]["flipped"]
    _assert_entries_equal(got, want)
    cache = sorted(os.listdir(tmp / "data" / "cache"))
    assert cache == [CACHE_PREFIX + cache[1], cache[1]], cache
    # the port reads back its own pickle
    again = PascalVOC("trainval", "2007", devkit_path=devkit).gt_roidb()
    _assert_entries_equal(again, JVOC("trainval", "2007", devkit_path=devkit).gt_roidb())


def test_data_layer_order_and_batches(trees):
    """Same RandomState(RNG_SEED) shuffle with aspect grouping: the same
    entries batch after batch across epochs, the same padded arrays."""
    _, _, (_, devkit) = trees
    roidb = get_training_roidb(PascalVOC("trainval", "2007", devkit_path=devkit))
    jroidb = jax_training_roidb(JVOC("trainval", "2007", devkit_path=devkit))
    layer, jlayer = mb.RoIDataLayer(roidb, batch_size=2), jmb.RoIDataLayer(jroidb, batch_size=2)
    for i in range(7):  # more than two epochs of 6 entries
        entries, bucket, jitter = layer.next_entries()
        jentries, jbucket = jlayer.next_entries()
        assert jitter is None and bucket == jbucket
        assert [(e["image"], e["flipped"]) for e in entries] == \
            [(e["image"], e["flipped"]) for e in jentries]
        if i < 3:
            got = mb.assemble_batch(entries, bucket)
            want = jmb.assemble_batch(jentries, jbucket)
            for name, g, w in zip(want._fields, got, want):
                assert g.numpy().dtype == w.dtype, name
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_random_downsample_takes_an_explicit_draw(trees):
    """The JAX package draws the jitter from the global np.random; the port
    from the generator it is given: the same draw, the same arrays."""
    _, _, (_, devkit) = trees
    entry = get_training_roidb(PascalVOC("trainval", "2007", devkit_path=devkit))[1]
    bucket = tuple(cfg.TPU.BUCKETS[-1])
    cfg.TRAIN.RANDOM_DOWNSAMPLE = jcfg.TRAIN.RANDOM_DOWNSAMPLE = True
    with pytest.raises(ValueError, match="RANDOM_DOWNSAMPLE"):
        mb.sample_to_arrays(entry, bucket)
    np.random.seed(7)
    want = jmb.sample_to_arrays(entry, bucket)
    got = mb.sample_to_arrays(entry, bucket,
                              jitter=mb.downsample_jitter(np.random.RandomState(7)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[1][2] < 0.99 * got[1][2] / (0.6 + 0.4 * np.random.RandomState(7).rand())
    # the layer draws one factor per entry from its own generator
    layer = mb.RoIDataLayer([entry] * 4, batch_size=2, seed=1)
    entries, bucket, jitter = layer.next_entries()
    assert len(jitter) == 2 and all(0.6 <= j < 1.0 for j in jitter)
    assert mb.assemble_batch(entries, bucket, jitter).images.shape[0] == 2


def test_synth_dataset_byte_identical(tmp_path):
    j = jsynth.generate_dataset(str(tmp_path / "jax"), n_images=3, seed=5)
    t = synth.generate_dataset(str(tmp_path / "port"), n_images=3, seed=5)
    assert [osp.relpath(p, tmp_path / "port") for p in t] == ["image", "label"]
    assert j[0].endswith("image")
    assert len(_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 6


def test_prefetch_loader_surfaces_worker_errors():
    calls = []

    def sample():
        calls.append(1)
        if len(calls) == 3:
            raise OSError("corrupt image")
        return len(calls)

    loader = PrefetchLoader(sample_fn=sample, build_fn=lambda x: x * 10, workers=1, depth=2)
    try:
        assert [loader.get(), loader.get()] == [10, 20]
        with pytest.raises(OSError, match="corrupt image"):
            loader.get()
    finally:
        loader.close()
    with pytest.raises(ValueError, match="sample_fn"):
        PrefetchLoader(sample_fn=sample)
    # the one-callable form (sampling and building under the lock)
    loader = PrefetchLoader(iter(range(5)).__next__, workers=1, depth=1)
    try:
        assert [loader.get() for _ in range(5)] == [0, 1, 2, 3, 4]
        with pytest.raises(StopIteration):
            loader.get()
    finally:
        loader.close()

