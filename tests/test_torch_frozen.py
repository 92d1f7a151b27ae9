"""The port's frozen artifact (``ctpn_tpu_torch.inference.frozen``), with
the cases of tests/test_frozen.py.

A small-bucket artifact (128x160, pre-NMS 500, post-NMS 100, 32 lines,
f32) of the shipped weights is exported on the CPU, where the kernels'
ops run their plain versions. Reloaded, it must reproduce the live port
pipeline bit for bit, run without the model code, refuse what it cannot
run, and pair within 0.5 px with the JAX package's frozen artifact of the
same weights on the same batch.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARTIFACT = osp.join(REPO, "data", "artifacts", "ctpn_synth_f16.npz")
BUCKET = (128, 160)
SMALL = {
    "TEST.RPN_PRE_NMS_TOP_N": 500, "TEST.RPN_POST_NMS_TOP_N": 100,
    "TPU.MAX_LINES": 32, "TPU.COMPUTE_DTYPE": "float32",
    "TEXT.SCALE": 96, "TEXT.MAX_SCALE": 160, "TEST.SCALES": (96,),
    "TEST.MAX_SIZE": 160, "TPU.BUCKETS": [list(BUCKET)],
}


def _set(c, pairs):
    for key, value in pairs.items():
        section, name = key.split(".")
        c[section][name] = value


def _batch():
    """Two synth renders at the bucket (text the shipped weights find)."""
    from ctpn_tpu.data.synth import render_image

    rng = np.random.RandomState(5)
    images = np.stack([render_image(rng, width=BUCKET[1], height=BUCKET[0])[0][..., ::-1]
                       for _ in range(2)]).astype(np.uint8)
    return images, np.tile(np.array([*BUCKET, 1.0], np.float32), (2, 1))


@pytest.fixture(scope="module")
def frozen_env(tmp_path_factory):
    """Export the artifact and capture the live outputs while the small cfg
    is set; the cfg is reset before the tests run, so the artifact must
    carry its own settings."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN, export_frozen
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    reset_cfg()
    _set(cfg, SMALL)
    params = load_params(ARTIFACT, device="cpu")
    images, infos = _batch()
    props, lines = CTPNPredictor(params, device="cpu").run_batch(images, infos)
    live = tuple(t.numpy() for t in (*props, *lines))
    path = str(tmp_path_factory.mktemp("frozen") / "ctpn_frozen.npz")
    out = export_frozen(params, path, shapes=[(1, *BUCKET), (2, *BUCKET)],
                        device="cpu")
    reset_cfg()
    yield {"artifact": FrozenCTPN(out, device="cpu"), "path": out,
           "images": images, "infos": infos, "live": live}
    reset_cfg()


def test_frozen_matches_live(frozen_env):
    """Reloaded program == live pipeline, bit for bit, and the batch has
    real lines."""
    out = frozen_env["artifact"].run_batch(frozen_env["images"], frozen_env["infos"])
    assert len(out) == 6
    for got, want in zip(out, frozen_env["live"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(out[5].sum()) > 0


def test_meta_records_abi_and_weights_once(frozen_env):
    art = frozen_env["artifact"]
    meta = art.meta
    assert meta["format"] == "ctpn-torch-frozen-v1"
    assert meta["abi"] == ["rois", "roi_valid", "roi_count", "recs", "line_valid",
                           "line_count"]
    assert meta["device"] == "cpu" and "device_name" not in meta
    assert meta["torch_version"] == torch.__version__
    assert meta["mode"] == "H" and meta["text_scale"] == 96
    assert art.shapes == [(1, *BUCKET), (2, *BUCKET)]
    with np.load(frozen_env["path"]) as z:
        weights = sum(z[k].nbytes for k in z.files if k.startswith("param/"))
        programs = [z[k].nbytes for k in z.files if k.startswith("program/")]
        assert len([k for k in z.files if k.startswith("param/")]) == len(meta["param_names"])
    assert len(programs) == 2 and sum(programs) < weights / 10  # weights stored once


def test_unknown_shape_rejected(frozen_env):
    bad = np.zeros((1, 64, 80, 3), np.uint8)
    info = np.array([[64, 80, 1.0]], np.float32)
    with pytest.raises(ValueError, match="no exported program"):
        frozen_env["artifact"].run_batch(bad, info)


def test_detect_image_end_to_end(frozen_env):
    """Image in, records out, with the artifact's STORED scales (the cfg is
    at its defaults here)."""
    rng = np.random.RandomState(7)
    im = rng.randint(0, 256, (100, 130, 3), np.uint8)
    recs = frozen_env["artifact"].detect_image(im)
    assert recs.ndim == 2 and recs.shape[1] == 9
    if len(recs):
        assert recs[:, 0:8:2].max() <= 130 and recs[:, 1:8:2].max() <= 100


def test_frozen_predictor_streams(frozen_env, tmp_path):
    """FrozenPredictor drives stream_detect as live weights do."""
    from PIL import Image

    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.frozen import FrozenPredictor
    from ctpn_tpu_torch.inference.streaming import stream_detect

    _set(cfg, {k: v for k, v in SMALL.items() if k.startswith(("TEXT", "TEST.SC",
                                                                "TEST.MAX", "TPU.B"))})
    rng = np.random.RandomState(11)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (100, 130, 3), np.uint8)).save(p)
        paths.append(p)
    pred = FrozenPredictor(frozen_env["artifact"])
    assert pred.device == torch.device("cpu")
    results = dict(stream_detect(paths, pred, batch_size=2, workers=2))
    assert sorted(results) == sorted(paths)
    for recs in results.values():
        assert recs.ndim == 2 and recs.shape[1] == 9
    assert BUCKET in pred.buckets_run  # recorded for /healthz


def test_frozen_predictor_guards(frozen_env):
    from ctpn_tpu_torch.inference.frozen import FrozenPredictor

    art = frozen_env["artifact"]
    with pytest.raises(ValueError, match="mode"):
        FrozenPredictor(art, mode="O")
    with pytest.raises(ValueError, match="no batch-4 program"):
        FrozenPredictor(art).warmup(batch=4)


def test_is_frozen_detects(frozen_env, tmp_path):
    from ctpn_tpu_torch.inference.frozen import is_frozen

    assert is_frozen(frozen_env["path"])
    plain = str(tmp_path / "weights.npz")
    np.savez(plain, w=np.zeros(3))
    assert not is_frozen(plain) and not is_frozen(ARTIFACT)
    assert not is_frozen("/nonexistent/artifact_dir")


def _with_meta(src, dst, **changes):
    z = dict(np.load(src))
    meta = json.loads(bytes(z["__meta__"]).decode())
    meta.update(changes)
    z["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(dst, **z)
    return dst


@pytest.fixture(scope="module")
def dp_env(tmp_path_factory):
    """A ``dp_devices=2`` artifact of the small cfg at batch 2, and the live
    ``shard_detect_fn`` outputs over two CPU replicas on the same batch."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.inference.frozen import export_frozen
    from ctpn_tpu_torch.inference.pipeline import build_detect_fn
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.parallel import replicate_model, shard_detect_fn
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

    reset_cfg()
    _set(cfg, SMALL)
    params = load_params(ARTIFACT, device="cpu")
    model = get_network("VGGnet_test", "cpu")
    model.load_state_dict(params_from_jax(params))
    replicas = replicate_model(model, ["cpu", "cpu"])
    detect = shard_detect_fn(lambda d: build_detect_fn(replicas[d]), ["cpu", "cpu"])
    images, infos = _batch()
    props, lines = detect(images, infos)
    live = tuple(t.numpy() for t in (*props, *lines))
    path = str(tmp_path_factory.mktemp("frozen_dp") / "ctpn_frozen_dp.npz")
    export_frozen(params, path, shapes=[(2, *BUCKET)], dp_devices=2, device="cpu")
    reset_cfg()
    yield {"path": path, "images": images, "infos": infos, "live": live,
           "params": params}
    reset_cfg()


def test_dp_artifact_matches_live_sharded(dp_env):
    """A ``dp_devices=2`` artifact loaded over two CPU replicas equals the
    live ``shard_detect_fn`` over two replicas bit for bit."""
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN

    art = FrozenCTPN(dp_env["path"], device="cpu")
    assert art.meta["dp_devices"] == 2 and art.shapes == [(2, *BUCKET)]
    assert art.devices == [torch.device("cpu")] * 2
    out = art.run_batch(dp_env["images"], dp_env["infos"])
    for got, want in zip(out, dp_env["live"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(out[5].sum()) > 0


def test_dp_export_batch_must_divide(dp_env, tmp_path):
    from ctpn_tpu_torch.inference.frozen import export_frozen

    with pytest.raises(ValueError, match="not divisible by dp_devices=2"):
        export_frozen(dp_env["params"], str(tmp_path / "x.npz"),
                      shapes=[(3, *BUCKET)], dp_devices=2, device="cpu")


def test_dp_artifact_matches_jax_dp_artifact(tmp_path):
    """The setting of the JAX package's
    ``test_frozen_dp_export_matches_live_sharded`` (random full-width
    weights from ``PRNGKey(1)``, 64x80, pre-NMS 200, post-NMS 50, 16
    lines, 8 devices): the port's ``dp_devices=8`` artifact over eight CPU
    replicas against the JAX package's over eight virtual devices, counts
    exact and records paired within 0.5 px."""
    import jax
    import jax.numpy as jnp

    from ctpn_tpu.config import cfg as jcfg
    from ctpn_tpu.config import reset_cfg as jreset
    from ctpn_tpu.inference.frozen import FrozenCTPN as JaxFrozen
    from ctpn_tpu.inference.frozen import export_frozen as jax_export
    from ctpn_tpu.models.factory import get_network as jax_network
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN, export_frozen

    bh, bw = 64, 80
    setting = {"TEST.RPN_PRE_NMS_TOP_N": 200, "TEST.RPN_POST_NMS_TOP_N": 50,
               "TPU.MAX_LINES": 16}
    _set(jcfg, setting)
    try:
        params = jax_network("VGGnet_test").init(
            jax.random.PRNGKey(1), jnp.zeros((1, bh, bw, 3), jnp.float32))["params"]
        jpath = jax_export(params, str(tmp_path / "jax_dp.npz"), shapes=[(8, bh, bw)],
                           mode="H", dp_devices=8)
    finally:
        jreset()
    images = np.random.RandomState(5).randint(0, 256, (8, bh, bw, 3), np.uint8)
    infos = np.tile(np.array([bh, bw, 1.0], np.float32), (8, 1))
    want = [np.asarray(x) for x in JaxFrozen(jpath).run_batch(images, infos)]
    reset_cfg()
    _set(cfg, setting)
    try:
        path = export_frozen(jax.device_get(params), str(tmp_path / "port_dp.npz"),
                             shapes=[(8, bh, bw)], mode="H", dp_devices=8, device="cpu")
    finally:
        reset_cfg()
    art = FrozenCTPN(path, device="cpu")
    assert art.meta["dp_devices"] == 8 and len(art.devices) == 8
    got = [t.numpy() for t in art.run_batch(images, infos)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[5], want[5])
    for i, n in enumerate(got[5]):
        a, b = got[3][i, :n], want[3][i, :n]
        used = np.zeros(n, bool)
        for row in a:
            d = np.abs(b - row).max(axis=1)
            d[used] = np.inf
            j = int(d.argmin())
            assert d[j] <= 0.5, d[j]
            used[j] = True


@pytest.mark.parametrize("case", ["device", "jax", "version", "dp"])
def test_loader_refuses(frozen_env, dp_env, tmp_path, case):
    """A program exported for the card is not moved to the CPU, a JAX
    (StableHLO) artifact and another torch version are refused with a
    pointer to re-export, and a data-parallel artifact needs as many
    devices as it was exported for."""
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN

    path = str(tmp_path / "a.npz")
    if case == "device":
        _with_meta(frozen_env["path"], path, device="cuda")
        with pytest.raises(RuntimeError, match="exported for device type 'cuda'"):
            FrozenCTPN(path, device="cpu")
    elif case == "jax":
        meta = json.dumps({"format": "ctpn-frozen-v1", "platforms": ["cpu"]})
        np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8))
        with pytest.raises(ValueError, match="ctpn-torch-export --frozen"):
            FrozenCTPN(path, device="cpu")
    elif case == "version":
        _with_meta(frozen_env["path"], path, torch_version="1.13.1+cpu")
        with pytest.raises(RuntimeError, match="exported by torch 1.13.1"):
            FrozenCTPN(path, device="cpu")
    else:
        with pytest.raises(RuntimeError, match="exported for 2 devices; 1 given"):
            FrozenCTPN(dp_env["path"], device="cpu", devices=["cpu"])


def test_matches_jax_frozen_artifact(frozen_env, tmp_path):
    """The JAX package's export_frozen -> FrozenCTPN.run_batch on the same
    weights and batch: counts equal, records paired within 0.5 px."""
    from ctpn_tpu.config import cfg as jcfg
    from ctpn_tpu.config import reset_cfg as jreset
    from ctpn_tpu.inference.frozen import FrozenCTPN as JaxFrozen
    from ctpn_tpu.inference.frozen import export_frozen as jax_export
    from ctpn_tpu.utils.weights import load_params as jax_load_params

    _set(jcfg, SMALL)
    try:
        path = jax_export(jax_load_params(ARTIFACT), str(tmp_path / "jax.npz"),
                          shapes=[(2, *BUCKET)])
    finally:
        jreset()
    want = [np.asarray(x) for x in
            JaxFrozen(path).run_batch(frozen_env["images"], frozen_env["infos"])]
    got = frozen_env["live"]  # == the port's artifact (test_frozen_matches_live)
    np.testing.assert_array_equal(got[5], want[5])
    assert int(got[5].sum()) > 0
    for i, n in enumerate(got[5]):
        a, b = got[3][i, :n], want[3][i, :n]
        used = np.zeros(n, bool)
        for row in a:
            d = np.abs(b - row).max(axis=1)
            d[used] = np.inf
            j = int(d.argmin())
            assert d[j] <= 0.5, d[j]
            used[j] = True


_PROBE = """
import sys
import numpy as np
sys.modules["ctpn_tpu_torch.models"] = None  # no model code may load
from ctpn_tpu_torch.inference.frozen import FrozenCTPN
z = np.load(sys.argv[2])
out = FrozenCTPN(sys.argv[1], device="cpu").run_batch(z["images"], z["infos"])
assert not any(m.startswith("ctpn_tpu_torch.models.") for m in sys.modules)
np.savez(sys.argv[3], *[t.numpy() for t in out])
"""


def test_runs_without_model_code(frozen_env, tmp_path):
    """A subprocess with ``ctpn_tpu_torch.models`` blocked loads and runs the
    artifact (torch, numpy and the ops' registrations only)."""
    batch = str(tmp_path / "batch.npz")
    np.savez(batch, images=frozen_env["images"], infos=frozen_env["infos"])
    result = str(tmp_path / "out.npz")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, frozen_env["path"], batch, result],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
    )
    assert proc.returncode == 0, proc.stderr
    with np.load(result) as z:
        for i, want in enumerate(frozen_env["live"]):
            np.testing.assert_array_equal(z[f"arr_{i}"], want)
