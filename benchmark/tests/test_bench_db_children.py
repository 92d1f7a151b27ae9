"""The readers of DB's decoder children (the stage clock's ``neck.*`` and
``head.*`` stages) on made-up stage times: each reads its own children,
the four split ``db_decoder_ms_per_img`` without remainder when the
children cover their parents, and each reads nothing where the program
stamps no child."""

import pytest

from harness.core import load_module

CHILDREN = {"db_neck_conv_ms_per_img": ("neck.lateral", "neck.smooth"),
            "db_neck_resample_ms_per_img": ("neck.topdown", "neck.fuse"),
            "db_head_conv_ms_per_img": ("head.conv",),
            "db_head_map_ms_per_img": ("head.map",)}


def _reader(name):
    import run as R

    return load_module(R.reader_path(name), "metric_" + name.replace(".", "_"))


class _Run:
    def __init__(self, readings):
        self.readings = readings


def _stages():
    stages = {f"dcn{k:02d}_{s}": 0.1 for k in range(1, 14) for s in ("in", "out")}
    stages.update({"trunk": 0.3, "neck.lateral": 0.07, "neck.topdown": 0.125,
                   "neck.smooth": 0.09, "neck.fuse": 0.0625, "head.conv": 0.11,
                   "head.map": 0.0525, "label": 0.2, "boxes": 0.05})
    # the parents as the clock reads them: from the top-level stamp before
    stages["neck"] = sum(stages[s] for s in ("neck.lateral", "neck.topdown", "neck.smooth",
                                             "neck.fuse"))
    stages["head"] = stages["head.conv"] + stages["head.map"]
    return stages


@pytest.mark.parametrize("name", sorted(CHILDREN))
def test_each_reader_sums_its_children(name):
    stages = _stages()
    assert _reader(name).read(_Run({"stage_ms_per_img": stages})) == pytest.approx(
        sum(stages[s] for s in CHILDREN[name]))


def test_the_four_partition_the_decoder():
    run = _Run({"stage_ms_per_img": _stages()})
    parts = {name: _reader(name).read(run) for name in CHILDREN}
    assert parts == pytest.approx({"db_neck_conv_ms_per_img": 0.16,
                                   "db_neck_resample_ms_per_img": 0.1875,
                                   "db_head_conv_ms_per_img": 0.11,
                                   "db_head_map_ms_per_img": 0.0525})
    assert sum(parts.values()) == pytest.approx(
        _reader("db_decoder_ms_per_img").read(run))
    # the parents' readers read the parents alone: a child's time is not
    # counted twice
    assert _reader("db_decoder_ms_per_img").read(run) == pytest.approx(0.51)
    assert _reader("db_trunk_ms_per_img").read(run) == pytest.approx(26 * 0.1 + 0.3)
    assert _reader("db_post_ms_per_img").read(run) == pytest.approx(0.25)


@pytest.mark.parametrize("name", sorted(CHILDREN))
def test_readers_find_nothing_without_the_children(name):
    """The parent's program stamps ``neck`` and ``head`` and no child: the
    readers return None and do not raise; so without a stage clock, and
    with one child of two."""
    reader = _reader(name)
    assert reader.read(_Run({})) is None
    assert reader.read(_Run({"stage_ms_per_img": {}})) is None
    old = {k: v for k, v in _stages().items() if "." not in k}
    assert reader.read(_Run({"stage_ms_per_img": old})) is None
    for child in CHILDREN[name]:
        got = reader.read(_Run({"stage_ms_per_img": dict(old, **{child: 0.1})}))
        assert got is None if len(CHILDREN[name]) > 1 else got == pytest.approx(0.1)
