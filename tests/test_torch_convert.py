"""``ctpn-torch-convert`` (``ctpn_tpu_torch/cli/convert_reference.py``)
against the JAX converter on fabricated reference weights.

A TF1 checkpoint and a frozen GraphDef are written from a JAX parameter
tree under the reference's variable names (as ``tests/test_convert_reference.py``
does). The port's readers must give the JAX readers' arrays, its converter
the JAX converter's tree, and its ``.npz`` artifact, read back by either
package's ``load_params``, the same arrays bit for bit in float32
(tolerance 0 throughout).
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ctpn_tpu.cli import convert_reference as jax_convert  # noqa: E402
from ctpn_tpu.models.ctpn import CTPN as JaxCTPN  # noqa: E402
from ctpn_tpu.utils import weights as jax_weights  # noqa: E402
from ctpn_tpu_torch.cli import convert_reference as convert  # noqa: E402
from ctpn_tpu_torch.models.factory import get_network  # noqa: E402
from ctpn_tpu_torch.utils import weights  # noqa: E402
from tests.test_weights import _params_to_tf_vars  # noqa: E402

torch.set_num_threads(2)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Reference weights as a TF1 checkpoint (with an Adam slot that must be
    left out) and as a frozen GraphDef."""
    params = JaxCTPN(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 80, 3), jnp.float32))["params"]
    tf_vars = {k: v.astype(np.float32) for k, v in _params_to_tf_vars(params).items()}
    d = tmp_path_factory.mktemp("tf")
    prefix = str(d / "VGGnet_fast_rcnn_iter_50000.ckpt")
    with tf.compat.v1.Graph().as_default():
        g_vars = [tf.compat.v1.get_variable(n, initializer=a) for n, a in tf_vars.items()]
        g_vars.append(tf.compat.v1.get_variable(
            "conv1_1/weights/Adam", initializer=np.zeros_like(tf_vars["conv1_1/weights"])))
        saver = tf.compat.v1.train.Saver(var_list=g_vars)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, prefix)
    pb = str(d / "ctpn.pb")
    with tf.compat.v1.Graph().as_default() as g:
        for n, a in tf_vars.items():
            tf.constant(a, name=n)
    with open(pb, "wb") as f:
        f.write(g.as_graph_def().SerializeToString())
    return {"ckpt": (["--tf-ckpt", prefix], convert.vars_from_tf_checkpoint,
                     jax_convert.vars_from_tf_checkpoint, prefix),
            "pb": (["--pb", pb], convert.vars_from_frozen_pb,
                   jax_convert.vars_from_frozen_pb, pb)}


def _jax_converted(tf_vars):
    skeleton = JaxCTPN().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 80, 3), jnp.float32))["params"]
    return _flat(jax_weights.convert_tf_vars(skeleton, tf_vars))


@pytest.mark.parametrize("fmt", ["ckpt", "pb"])
def test_readers_match_jax(sources, fmt):
    _, port_reader, jax_reader, path = sources[fmt]
    got, want = port_reader(path), jax_reader(path)
    assert "conv1_1/weights/Adam" not in got
    _assert_same(got, want)


@pytest.mark.parametrize("fmt", ["ckpt", "pb"])
def test_converter_matches_jax(sources, fmt):
    """The port's skeleton (``get_network`` on the CPU) filled by the port's
    ``convert_tf_vars`` equals the JAX converter's tree, every leaf."""
    _, port_reader, jax_reader, path = sources[fmt]
    skeleton = weights.params_to_jax(get_network("VGGnet_test", "cpu").state_dict())
    got = _flat(weights.convert_tf_vars(skeleton, port_reader(path)))
    _assert_same(got, _jax_converted(jax_reader(path)))


@pytest.mark.parametrize("fmt", ["ckpt", "pb"])
def test_cli_npz_is_the_jax_conversion(sources, fmt, tmp_path, capsys):
    """``ctpn-torch-convert``'s ``.npz`` is float32 and, loaded by the
    port's and the JAX package's ``load_params``, equals the JAX
    converter's arrays bit for bit."""
    args, _, jax_reader, path = sources[fmt]
    out = str(tmp_path / "converted.npz")
    convert.main(args + ["--out", out])
    assert "wrote artifact to" in capsys.readouterr().out
    want = _jax_converted(jax_reader(path))
    with np.load(out) as raw:
        assert {raw[k].dtype for k in raw.files} == {np.dtype(np.float32)}
    got = {k: v.numpy() for k, v in weights.load_params(out, device="cpu").items()}
    _assert_same(got, want)
    _assert_same(_flat(jax_weights.load_params(out)), want)


def test_cli_refuses_what_it_cannot_write(sources, tmp_path):
    """Without a source the converter exits; a directory ``--out`` is an
    orbax artifact that the JAX package's ``load_params`` reads as the JAX
    converter's arrays, bit for bit."""
    with pytest.raises(SystemExit, match="pass --tf-ckpt or --pb"):
        convert.main(["--out", str(tmp_path / "a.npz")])
    args, _, jax_reader, path = sources["pb"]
    out = str(tmp_path / "artifact")
    convert.main(args + ["--out", out])
    _assert_same(_flat(jax_weights.load_params(out)), _jax_converted(jax_reader(path)))
