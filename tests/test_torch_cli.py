"""The port's weight converters, its demo, export and eval CLIs, against the
JAX package where both have the function.

Weights: the f16 ``.npz`` written by either package reads back equal in
the other; ``params_to_jax`` inverts ``params_from_jax``; the numpy
converters (``load_pretrained_into``, ``convert_tf_vars``) give the JAX
package's tree on synthetic arrays. The CLIs run as CPU subprocesses at a
tiny bucket; ``--frozen-shapes`` is validated as in tests/test_cli.py.
"""

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
RESULTS = osp.join(REPO, "docs", "demo_results")
TINY = ["TEXT.SCALE", "64", "TEXT.MAX_SCALE", "96", "TPU.BUCKETS", "[[64,96]]",
        "TEST.SCALES", "[64]", "TEST.MAX_SIZE", "96",
        "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "64"]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _port_tree():
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax, params_to_jax

    return params_to_jax(params_from_jax(load_params(ARTIFACT, device="cpu")))


def test_params_to_jax_inverts_params_from_jax():
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.utils.weights import params_from_jax, params_to_jax

    sd = get_network("VGGnet_test", "cpu").state_dict()
    back = params_from_jax(params_to_jax(sd))
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    tree = params_to_jax(sd)
    assert tree["VGG16Trunk_0"]["conv1_1"]["kernel"].shape == (3, 3, 3, 64)
    assert tree["rpn_cls_score"]["kernel"].shape == (512, 20)


def test_npz_round_trip_between_packages(tmp_path):
    """The port's ``export_params_npz`` read by the JAX ``load_params``
    equals the port's ``load_params``, and the reverse."""
    from ctpn_tpu.utils.weights import export_params_npz as jax_export
    from ctpn_tpu.utils.weights import load_params as jax_load
    from ctpn_tpu_torch.utils.weights import export_params_npz, load_params

    port_file = export_params_npz(_port_tree(), str(tmp_path / "port.npz"))
    jax_file = jax_export(jax_load(ARTIFACT), str(tmp_path / "jax.npz"))
    for path in (port_file, jax_file):
        want = dict(_flat(jax_load(path)))
        got = load_params(path, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with np.load(port_file) as a, np.load(ARTIFACT) as b:  # f16 both ways: exact
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


def _pretrained_npy(tmp_path, rng):
    layers = {
        "conv1_1": {"weights": rng.randn(3, 3, 3, 64), "biases": rng.randn(64)},
        "conv5_3": {"weights": rng.randn(3, 3, 512, 512), "biases": rng.randn(512)},
        "fc6": {"weights": rng.randn(4, 8), "biases": rng.randn(8)},  # not in model
    }
    path = str(tmp_path / "vgg.npy")
    np.save(path, layers, allow_pickle=True)
    return path


def test_load_pretrained_into_matches_jax(tmp_path, rng):
    from ctpn_tpu.utils.weights import load_params as jax_load
    from ctpn_tpu.utils.weights import load_pretrained_into as jax_into
    from ctpn_tpu_torch.utils.weights import load_pretrained_into

    npy = _pretrained_npy(tmp_path, rng)
    donor = str(tmp_path / "donor.npz")
    np.savez(donor, **{"rpn_conv/bias": rng.randn(512).astype(np.float16),
                       "bilstm/w_h_fw": rng.randn(128, 512).astype(np.float16)})
    for src in (npy, donor):
        got = load_pretrained_into(_port_tree(), src)
        want = jax_into(jax_load(ARTIFACT), src)
        _assert_trees_equal(got, want)
    with pytest.raises(KeyError):
        load_pretrained_into(_port_tree(), npy, ignore_missing=False)


def test_convert_tf_vars_matches_jax(rng):
    from ctpn_tpu.utils.weights import convert_tf_vars as jax_convert
    from ctpn_tpu.utils.weights import load_params as jax_load
    from ctpn_tpu_torch.utils.weights import convert_tf_vars

    f = np.float32
    tf_vars = {
        "conv1_2/weights": rng.randn(3, 3, 64, 64).astype(f),
        "conv1_2/biases": rng.randn(64).astype(f),
        "rpn_conv/3x3/weights": rng.randn(3, 3, 512, 512).astype(f),
        "rpn_conv/3x3/biases": rng.randn(512).astype(f),
        "lstm_o/weights": rng.randn(256, 512).astype(f),
        "lstm_o/biases": rng.randn(512).astype(f),
        "rpn_bbox_pred/weights": rng.randn(512, 40).astype(f),
        "rpn_cls_score/biases": rng.randn(20).astype(f),
    }
    for d in ("fw", "bw"):
        tf_vars[f"lstm_o/bidirectional_rnn/{d}/lstm_cell/kernel"] = rng.randn(640, 512).astype(f)
        tf_vars[f"lstm_o/bidirectional_rnn/{d}/lstm_cell/bias"] = rng.randn(512).astype(f)
    _assert_trees_equal(convert_tf_vars(_port_tree(), tf_vars),
                        jax_convert(jax_load(ARTIFACT), tf_vars))


@pytest.mark.parametrize("bad", ["608x912", "1x600x912", "1x608x900",
                                 "1x608x912x3", "axbxc", "0x608x912"])
def test_export_frozen_shapes_validation(tmp_path, bad):
    """Malformed --frozen-shapes entries fail as argparse errors (exit 2)
    before any export work, as in the JAX CLI."""
    from ctpn_tpu_torch.cli.export_model import main as export_main

    with pytest.raises(SystemExit) as exc:
        export_main(["--out", str(tmp_path / "x.npz"), "--frozen",
                     "--frozen-shapes", bad, "--device", "cpu"])
    assert exc.value.code == 2


def test_export_refuses_what_needs_the_solver(tmp_path):
    """``--ckpt`` needs a solver directory with a checkpoint; a directory
    ``--out`` writes an orbax artifact that the JAX package's
    ``load_params`` reads, bit for bit against the port's source leaves."""
    from ctpn_tpu.utils.weights import load_params as jax_load_params
    from ctpn_tpu_torch.cli.export_model import main as export_main
    from ctpn_tpu_torch.utils.weights import load_params

    with pytest.raises(SystemExit, match="no checkpoints under"):
        export_main(["--ckpt", str(tmp_path), "--out", str(tmp_path / "x.npz")])
    out = tmp_path / "orbax_dir"
    export_main(["--artifact", ARTIFACT, "--out", str(out)])
    assert (out / "params" / "_METADATA").exists()
    want = {k: v.numpy() for k, v in load_params(ARTIFACT, device="cpu").items()}
    got = dict(_flat(jax_load_params(str(out))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].tobytes() == want[k].tobytes(), k


def _cli(*args):
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_demo_and_export_clis(tmp_path):
    """export --frozen then demo --frozen give the live demo's res files;
    demo --host-postprocess --mode O writes its own."""
    from PIL import Image

    from ctpn_tpu.data.synth import render_image

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        Image.fromarray(render_image(rng, width=144, height=96)[0]).save(images / f"{i}.png")
    frozen = str(tmp_path / "frozen.npz")
    out = _cli("ctpn_tpu_torch.cli.export_model", "--artifact", ARTIFACT, "--out",
               frozen, "--frozen", "--frozen-shapes", "1x64x96", "--device", "cpu",
               "--set", *TINY)
    assert "wrote inference artifact" in out
    res = {}
    for name, extra in (("live", ["--artifact", ARTIFACT, "--set", *TINY]),
                        ("frozen", ["--frozen", frozen]),
                        ("host_o", ["--artifact", ARTIFACT, "--host-postprocess",
                                    "--mode", "O", "--set", *TINY])):
        out_dir = tmp_path / name
        log = _cli("ctpn_tpu_torch.cli.demo", "--images", str(images), "--output",
                   str(out_dir), "--device", "cpu", *extra)
        assert log.count("Detection took") == 2
        res[name] = {p: (out_dir / p).read_text() for p in ("res_0.txt", "res_1.txt")}
        assert all((out_dir / f"{i}.png").exists() for i in range(2))
    assert res["frozen"] == res["live"]


def test_compare_result_dirs_matches_jax():
    """``eval.compare_result_dirs`` of the committed host and device results,
    both modes, equal to the JAX package's."""
    from ctpn_tpu.eval import compare_result_dirs as jax_compare
    from ctpn_tpu_torch.eval import compare_result_dirs

    for mode in ("H", "O"):
        for iou in (0.5, 0.7):
            args = (osp.join(RESULTS, f"{mode}_host"), osp.join(RESULTS, mode), iou)
            got = compare_result_dirs(*args)
            assert got == jax_compare(*args)
            assert got["reference_boxes"] > 0


def test_stopwatch_and_profile_trace():
    """The demo's ``Stopwatch`` (the JAX package's, as it is)."""
    from ctpn_tpu.utils.timer import Stopwatch as JaxStopwatch
    from ctpn_tpu_torch.utils.timer import Stopwatch

    for cls in (Stopwatch, JaxStopwatch):
        sw = cls()
        for _ in range(3):
            with sw:
                pass
        assert sw.count == 3 and sw.total >= sw.last >= 0.0
        assert sw.mean == pytest.approx(sw.total / 3)


def test_export_frozen_dp_cli(tmp_path):
    """``ctpn-torch-export --frozen --frozen-dp 2 --device cpu`` writes a
    data-parallel artifact that runs over two CPU replicas and gives the
    live pipeline's outputs on the slice each replica runs; a batch that
    does not divide fails before any export."""
    from ctpn_tpu.data.synth import render_image
    from ctpn_tpu_torch.cli.export_model import main as export_main
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.frozen import FrozenCTPN
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    frozen = str(tmp_path / "frozen_dp.npz")
    out = _cli("ctpn_tpu_torch.cli.export_model", "--artifact", ARTIFACT, "--out",
               frozen, "--frozen", "--frozen-shapes", "2x64x96", "--frozen-dp", "2",
               "--device", "cpu", "--set", *TINY)
    assert "wrote inference artifact" in out
    art = FrozenCTPN(frozen, device="cpu")
    assert art.meta["dp_devices"] == 2 and art.shapes == [(2, 64, 96)]
    assert len(art.devices) == 2
    rng = np.random.RandomState(3)
    images = np.stack([render_image(rng, width=96, height=64)[0][..., ::-1]
                       for _ in range(2)]).astype(np.uint8)
    infos = np.tile(np.array([64, 96, 1.0], np.float32), (2, 1))
    got = art.run_batch(images, infos)
    reset_cfg()
    cfg_from_list(TINY)
    try:
        pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
        want = [pred.run_batch(images[k:k + 1], infos[k:k + 1]) for k in range(2)]
    finally:
        reset_cfg()
    want = [torch.cat([(*w[0], *w[1])[i] for w in want]) for i in range(6)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="not divisible by dp_devices=2"):
        export_main(["--out", str(tmp_path / "x.npz"), "--frozen", "--frozen-shapes",
                     "1x64x96", "--frozen-dp", "2", "--device", "cpu"])
