"""The port's orbax IO (``utils/orbax_io.py``) and its zstd decoder
(``ops/csrc/zstd_decode.cpp`` through ``utils/zstd.py``) against the real
thing: ``zstandard``, tensorstore and the JAX package's orbax code.

* The decoder equals ``zstandard`` on seeded inputs (sizes around the 128
  KiB block, f16-origin floats, text, random bytes, long runs; levels 1 to
  19; with and without content size and checksum; concatenated and
  skippable frames), refuses corrupt input, and meets every mode it counts.
* Every leaf the port reads from the JAX package's ``export_params`` of the
  shipped artifact, and from a JAX solver step, equals orbax's restore bit
  for bit; the JAX package's ``load_params`` reads the port's
  ``export_params`` bit for bit (float32 and bfloat16 leaves).
* Tensorstore-written zarr arrays of several chunks (either separator, one
  chunk absent) and OCDBT trees with interior nodes read back exactly; each
  layout the reader does not accept raises, naming the key.
* Detection records of weights loaded from a JAX-written directory equal
  those of the ``.npz`` route (tolerance 0: the same weights).
"""

import json
import os
import os.path as osp
import shutil
import time

import numpy as np
import pytest
import torch

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from ctpn_tpu.utils import weights as jax_weights  # noqa: E402
from ctpn_tpu_torch.ops import _build  # noqa: E402
from ctpn_tpu_torch.training import checkpoint  # noqa: E402
from ctpn_tpu_torch.utils import orbax_io, weights, zstd  # noqa: E402

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARTIFACT = osp.join(REPO, "data", "artifacts", "ctpn_synth_f16.npz")
FIXTURE = osp.join(REPO, "tests", "data", "orbax")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_bits_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), k


def _shipped_f32():
    with np.load(ARTIFACT) as npz:
        return {k: npz[k].astype(np.float32) for k in npz.files}


# ---- the zstd decoder --------------------------------------------------------


def _f16_floats(rng, n):
    return rng.standard_normal(n // 4 + 1).astype(np.float16).astype(np.float32).tobytes()[:n]


def _text(rng, n):
    words = [b"orbax", b"checkpoint", b"tensor", b"store", b"zarr", b"chunk", b"the",
             b"of", b"ctpn\n", b"0.0.0.0"]
    out = bytearray()
    while len(out) < n:
        out += words[rng.integers(len(words))] + b" "
    return bytes(out[:n])


def _random(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _runs(rng, n):
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 4))]) * int(rng.integers(1, 70000))
    return bytes(out[:n])


def _shifted_repeats(rng, n):
    """Matches at offset ``rep - 1`` right after a match: the optimal parser
    of the high levels codes them as the fourth repeat offset."""
    out = bytearray()
    while len(out) < n:
        r = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
        out += r + r[0:100] + r[101:300]
    return bytes(out[:n])


def _marked_pattern(rng, n):
    """One 64-byte pattern repeated, with runs of ``Z`` between the copies:
    past the first block every literal is a ``Z`` (RLE literals)."""
    pattern = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    out = bytearray(pattern)
    while len(out) < n:
        out += pattern * int(rng.integers(1, 5)) + b"Z" * int(rng.integers(1, 3))
    return bytes(out[:n])


KINDS = {"f16": _f16_floats, "text": _text, "random": _random, "runs": _runs}
SIZES = [0, 1, 131071, 131072, 131073, 1 << 20]
LEVELS = [1, 3, 9, 19]


def _compress(raw, level=3, size=True, checksum=True):
    return zstandard.ZstdCompressor(level=level, write_content_size=size,
                                    write_checksum=checksum).compress(raw)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decoder_matches_zstandard(kind, size, level):
    raw = KINDS[kind](np.random.default_rng(size + 7 * level), size)
    for with_size, with_checksum in ((True, True), (False, False)):
        frame = _compress(raw, level, with_size, with_checksum)
        got = zstd.decompress(frame, size=None if with_size else len(raw))
        assert got.tobytes() == raw, (with_size, with_checksum)


def test_decoder_concatenated_and_skippable_frames():
    rng = np.random.default_rng(3)
    a, b = _text(rng, 200000), _f16_floats(rng, 50000)
    two = _compress(a, 3) + _compress(b, 1, size=False)
    assert zstd.decompress(two, size=len(a) + len(b)).tobytes() == a + b
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    both = skip + _compress(a, 1) + skip + _compress(b, 9) + skip
    assert zstd.content_size(both) == len(a) + len(b)
    assert zstd.decompress(both).tobytes() == a + b


@pytest.mark.parametrize("corruption", ["truncated", "bit_flip", "checksum", "size",
                                        "dictionary", "magic"])
def test_decoder_rejects_corrupt_input(corruption):
    raw = _text(np.random.default_rng(4), 300000)
    frame = bytearray(_compress(raw, 3))
    if corruption == "truncated":
        for cut in (len(frame) - 1, len(frame) // 2, 10, 3):
            with pytest.raises(ValueError, match="zstd"):
                zstd.decompress(bytes(frame[:cut]), size=len(raw))
        return
    if corruption == "bit_flip":
        # a flipped bit in every tenth of the compressed blocks must not pass
        rng = np.random.default_rng(5)
        for pos in np.linspace(20, len(frame) - 8, 10).astype(int):
            bad = bytearray(frame)
            bad[pos] ^= 1 << int(rng.integers(8))
            with pytest.raises(ValueError, match="zstd"):
                zstd.decompress(bytes(bad), size=len(raw))
        return
    if corruption == "checksum":
        frame[-1] ^= 0x40
        match = "checksum"
    elif corruption == "size":
        with pytest.raises(ValueError, match="expected"):
            zstd.decompress(_compress(raw, 3, size=False), size=len(raw) - 1)
        return
    elif corruption == "dictionary":
        samples = [raw[i:i + 2000] for i in range(0, 200000, 2000)]
        trained = zstandard.train_dictionary(4096, samples)
        assert trained.dict_id() != 0
        frame = bytearray(zstandard.ZstdCompressor(dict_data=trained, level=3).compress(raw))
        match = "dictionary"
    else:
        frame[0] ^= 1
        match = "magic"
    with pytest.raises(ValueError, match=match):
        zstd.decompress(bytes(frame), size=len(raw))


def test_decoder_meets_every_mode():
    """Across inputs of the kinds above, each block, literal, sequence,
    offset and frame mode the decoder counts is met at least once."""
    rng = np.random.default_rng(6)
    zstd.MODES.clear()
    cases = [(_text(rng, 1 << 20), 19, False), (_runs(rng, 1 << 20), 1, True),
             (_random(rng, 200000), 3, True), (_f16_floats(rng, 400000), 1, True),
             (_shifted_repeats(rng, 400000), 19, True),
             (rng.integers(0, 16, 200000, dtype=np.uint8).tobytes(), 3, True),
             (bytes(5000), 3, True),
             (_marked_pattern(np.random.default_rng(8), 400000), 9, True)]
    for raw, level, with_size in cases:
        frame = _compress(raw, level, with_size)
        assert zstd.decompress(frame, size=len(raw)).tobytes() == raw
    skip = (0x184D2A50).to_bytes(4, "little") + (0).to_bytes(4, "little")
    assert zstd.decompress(skip + _compress(b"x" * 10)).tobytes() == b"x" * 10
    missing = [m for m in zstd.mode_names() if not zstd.MODES[m]]
    assert not missing, f"modes never met: {missing}"


def test_decoder_without_compiler_raises(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(_build, "cxx", lambda: None)
    with pytest.raises(RuntimeError, match="zstd_decode.cpp"):
        zstd.decompress(_compress(b"abc"))


# ---- the JAX package's artifacts ---------------------------------------------


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """``ctpn_tpu``'s ``export_params`` of the shipped artifact (float32)."""
    out = str(tmp_path_factory.mktemp("jax_export") / "artifact")
    jax_weights.export_params(jax_weights.load_params(ARTIFACT), out)
    return out


def test_reads_jax_export_of_the_shipped_artifact(jax_export, record_property):
    t0 = time.perf_counter()
    want = _flat(jax_weights.load_params(jax_export))
    orbax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = {k: v.numpy() for k, v in weights.load_params(jax_export, device="cpu").items()}
    port_s = time.perf_counter() - t0
    assert len(got) == 38
    _assert_bits_equal(got, want)
    _assert_bits_equal(got, _shipped_f32())
    record_property("read_seconds", {"port": port_s, "orbax": orbax_s})
    print(f"full artifact read: port {port_s:.3f} s, orbax {orbax_s:.3f} s")


def test_load_pretrained_into_takes_a_directory(jax_export):
    from ctpn_tpu_torch.models.factory import init_params

    got = _flat(weights.load_pretrained_into(init_params(seed=0), jax_export,
                                             ignore_missing=False))
    _assert_bits_equal(got, _shipped_f32())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_reads_port_export(tmp_path, dtype):
    params = weights.params_to_jax(weights.params_from_jax(
        weights.load_params(ARTIFACT, device="cpu")))
    tree = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in _flat(params).items()}
    out = weights.export_params(tree, str(tmp_path / "art"))
    got = _flat(jax_weights.load_params(out))
    assert len(got) == 38
    for k, t in tree.items():
        assert str(got[k].dtype) == dtype, k
        want = t.view(torch.int16).numpy() if dtype == "bfloat16" else t.numpy()
        assert got[k].tobytes() == want.tobytes(), k
    # the port reads its own directory back (bfloat16 widened exactly)
    back = weights.load_params(out, device="cpu")
    for k, t in tree.items():
        assert torch.equal(back[k], t.to(torch.float32)), k


def _jax_solver_step(out_dir, params, step):
    from ctpn_tpu.training.solver import SolverWrapper
    from ctpn_tpu.training.train_step import TrainState, make_optimizer

    state = TrainState.create(apply_fn=None, params=params, tx=make_optimizer(),
                              rng=jax.random.PRNGKey(0)).replace(step=step)
    SolverWrapper([], out_dir, data_parallel=False, batch_size=1).snapshot(state)
    return state


def test_export_ckpt_of_a_jax_solver_step(tmp_path):
    """A real ``TrainState`` of the full model saved as the JAX solver saves
    it: ``ctpn-torch-export --ckpt`` writes the ``.npz`` that
    ``ctpn_tpu.cli.export_model --ckpt`` writes."""
    from ctpn_tpu.cli.export_model import main as jax_export_main
    from ctpn_tpu_torch.cli.export_model import main as export_main

    run = str(tmp_path / "run")
    params = jax.tree_util.tree_map(jnp.asarray, jax_weights.load_params(ARTIFACT))
    _jax_solver_step(run, params, 3)
    jax_export_main(["--ckpt", run, "--out", str(tmp_path / "jax.npz")])
    export_main(["--ckpt", run, "--out", str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        _assert_bits_equal(dict(b), dict(a))
        assert len(a.files) == 38
    # the parameters, read directly, are orbax's restore of state.params
    want = _flat(ocp.CheckpointManager(osp.join(run, "checkpoints")).restore(3)["state"]["params"])
    _assert_bits_equal(_flat(checkpoint.load_jax_params(run, 3)), want)


# ---- zarr and OCDBT layouts tensorstore writes ---------------------------------


def _ts_array(kvstore, data, chunks, sep, fill, written):
    """Write ``data[written]`` to a new zarr v2 array through tensorstore;
    return what tensorstore reads back (fill where nothing was written)."""
    arr = ts.open({"driver": "zarr", "kvstore": kvstore,
                   "metadata": {"shape": list(data.shape), "chunks": chunks,
                                "dtype": "<f4", "fill_value": fill, "dimension_separator": sep,
                                "compressor": {"id": "zstd", "level": 3}}},
                  create=True).result()
    arr[written].write(data[written]).result()
    return arr[...].read().result()


@pytest.mark.parametrize("sep", [".", "/"])
@pytest.mark.parametrize("layout", ["ocdbt", "plain"])
def test_multi_chunk_array_with_an_absent_chunk(tmp_path, layout, sep):
    """A 3x2 grid of chunks whose last row is never written (its elements
    are the fill value), in an OCDBT store and in the plain file layout."""
    data = np.random.default_rng(7).standard_normal((50, 70)).astype(np.float32)
    written = np.s_[:40, :]
    if layout == "ocdbt":
        kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "a.b/"}
    else:
        kv = {"driver": "file", "path": f"{tmp_path}/a.b/"}
    want = _ts_array(kv, data, [20, 40], sep, 2.5, written)
    assert (want[40:] == 2.5).all() and np.array_equal(want[:40], data[:40])
    store = (orbax_io.OcdbtStore if layout == "ocdbt" else orbax_io.PlainStore)(str(tmp_path))
    assert store.get("a.b/2" + sep + "0") is None  # the absent chunk
    got = orbax_io.read_array(store, "a.b")
    assert got.tobytes() == want.tobytes()


def test_ocdbt_interior_nodes_and_versions(tmp_path):
    """Small nodes force a B-tree of height > 1 (keys split into subtree
    prefixes); three commits leave three versions, the newest is read."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 8}}).result()
    want = {}
    for commit in range(3):
        with ts.Transaction() as txn:
            for i in range(commit * 25, commit * 25 + 40):
                key = f"key{i:03d}/sub"
                want[key] = (f"v{commit}-{i}-" * (1 + i % 3)).encode()
                kv.with_transaction(txn)[key] = want[key]
    store = orbax_io.OcdbtStore(str(tmp_path))
    assert sorted(k.decode() for k in store.values) == sorted(want)
    for key, value in want.items():
        assert store.get(key) == value, key
    assert store.get("key999/sub") is None


def test_reads_the_plain_layout_orbax_writes(tmp_path):
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "b": jnp.arange(3, dtype=jnp.bfloat16), "m": np.array([True, False])},
            "s": np.int32(5), "i": np.arange(4, dtype=np.int64), "u": np.arange(3, dtype=np.uint8),
            "h": np.linspace(0, 1, 5).astype(np.float16)}
    path = str(tmp_path / "plain")
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(path, tree)
    got = _flat(orbax_io.read_tree(path))
    want = _flat(tree)
    want["a/b"] = np.asarray(tree["a"]["b"], np.float32)  # bfloat16 widens exactly
    _assert_bits_equal(got, want)


def _plain_leaf(tmp_path, **zarray):
    path = str(tmp_path / "ckpt")
    orbax_io.write_tree({"layer": {"kernel": np.ones((2, 3), np.float32)}}, path)
    meta_path = osp.join(path, "layer.kernel", ".zarray")
    with open(meta_path) as fh:
        meta = json.load(fh)
    meta.update(zarray)
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    return path


@pytest.mark.parametrize("case, zarray, match", [
    ("compressor", {"compressor": {"id": "blosc", "cname": "lz4"}}, "compressor"),
    ("filters", {"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ("order_f", {"order": "F"}, "order"),
    ("dtype", {"dtype": "<c8"}, "dtype"),
    ("zarr3", None, "zarr3"),
    ("key_path", None, "cannot be a checkpoint key"),
])
def test_refuses_what_it_does_not_read(tmp_path, case, zarray, match):
    path = _plain_leaf(tmp_path, **(zarray or {}))
    if case in ("zarr3", "key_path"):
        with open(osp.join(path, "_METADATA")) as fh:
            meta = json.load(fh)
        if case == "zarr3":
            meta["use_zarr3"] = True
        else:  # a key that would name a file outside the checkpoint
            (entry,) = meta["tree_metadata"].values()
            entry["key_metadata"][0]["key"] = "../layer"
        with open(osp.join(path, "_METADATA"), "w") as fh:
            json.dump(meta, fh)
    with pytest.raises(ValueError, match=match) as exc:
        orbax_io.read_tree(path)
    if case != "zarr3":
        assert "layer.kernel" in str(exc.value)


def test_refuses_a_corrupt_ocdbt_node(tmp_path):
    path = str(tmp_path / "art")
    shutil.copytree(osp.join(FIXTURE, "artifact"), path)
    root = osp.join(path, "params", "d")
    node = osp.join(root, os.listdir(root)[0])
    data = bytearray(open(node, "rb").read())
    data[20] ^= 1
    open(node, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        weights.load_params(path, device="cpu")


def test_write_is_atomic_and_replaces(tmp_path):
    path = str(tmp_path / "ckpt")
    orbax_io.write_tree({"a": np.zeros(3, np.float32)}, path)
    orbax_io.write_tree({"b": np.ones(2, np.float32)}, path)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert list(orbax_io.read_tree(path)) == ["b"]


# ---- the committed fixture (chip_smoke.py phase 22 makes the same checks) ------


def test_committed_fixture_equals_the_npz():
    shipped = _shipped_f32()
    zstd.MODES.clear()
    got = {k: v.numpy() for k, v in weights.load_params(
        osp.join(FIXTURE, "artifact"), device="cpu").items()}
    assert len(got) >= 9
    _assert_bits_equal(got, {k: shipped[k] for k in got})
    assert got["VGG16Trunk_0/conv2_1/kernel"].nbytes > 256 * 1024  # three blocks
    assert zstd.MODES["lit_huffman"] and zstd.MODES["seq_fse"], dict(zstd.MODES)
    solver = osp.join(FIXTURE, "solver")
    step = checkpoint.latest_step(solver)
    assert checkpoint.is_jax_step(solver, step)
    params = _flat(checkpoint.load_jax_params(solver, step))
    _assert_bits_equal(params, {k: shipped[k] for k in params})
    with pytest.raises(ValueError, match="ctpn-torch-export --ckpt"):
        checkpoint.load(solver)


def test_predictor_records_from_a_jax_directory(jax_export):
    from ctpn_tpu.data.synth import render_image
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor

    reset_cfg()
    try:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.BUCKETS = [[192, 288]]
        cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE = 192, 288
        cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (192,), 288
        im = render_image(np.random.RandomState(11), width=432, height=288)[0][..., ::-1].copy()
        records = []
        for source in (ARTIFACT, jax_export):
            pred = CTPNPredictor(weights.load_params(source, device="cpu"), device="cpu")
            records.append(pred.detect_image(im))
        assert len(records[0]) > 0
        assert records[0].tobytes() == records[1].tobytes()
    finally:
        reset_cfg()
