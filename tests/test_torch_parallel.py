"""Batch-sharded detection (``ctpn_tpu_torch.parallel``) against the JAX
package's ``parallel.dp.shard_detect_fn``, and the thread safety it needs.

The JAX function runs over 4 virtual XLA CPU devices (``tests/conftest.py``
provides 8), the port's over 4 replicas on the CPU, on the JAX tests' narrow
trunk (``TINY`` of ``tests/test_torch_train_step.py``) with the same weights
(``params_from_jax``) and the same seeded images. Tolerances: rois within
``rtol=1e-5, atol=1e-4`` (those of
``tests/test_training.py::test_dp_inference_sharding``), counts exact, line
records paired one-to-one within 0.5 px; against the port's one-replica
detect, counts exact and floats within 1e-5.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.inference.pipeline import build_detect_fn as jax_build_detect
from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.parallel.dp import shard_detect_fn as jax_shard_detect_fn
from ctpn_tpu.parallel.mesh import make_mesh, replicated
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.inference.pipeline import build_detect_fn
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.ops import _launches
from ctpn_tpu_torch.parallel import (data_devices, replicate_model, shard_detect_fn,
                                     split_batch)
from ctpn_tpu_torch.postprocess import connector
from ctpn_tpu_torch.utils.device import full_f32_matmul
from ctpn_tpu_torch.utils.weights import params_from_jax
from tests.test_torch_train_step import BH, BW, TINY

torch.set_num_threads(2)

N_DEV = 4
DETECT = dict(mode="H", pre_nms_top_n=150, post_nms_top_n=60, max_lines=16)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _toy_images(n):
    """Bright strips on dark noise (``toy_arrays``' content), so proposals
    and lines come from real structure, not near-tied scores."""
    rng = np.random.RandomState(3)
    images = rng.uniform(0, 60, (n, BH, BW, 3)).astype(np.uint8)
    for i in range(n):
        y = 12 + 4 * (i % 4)
        for s in range(3):
            images[i, y:y + 24, 8 + 16 * s:24 + 16 * s] = 220
    return images, np.tile(np.array([BH, BW, 1.0], np.float32), (n, 1))


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, the port's model with those weights, images, infos)."""
    model = JCTPN(dtype=jnp.float32, **TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, BH, BW, 3)))["params"]
    port = CTPN(dtype=torch.float32, **TINY)
    port.load_state_dict(params_from_jax(params))
    images, infos = _toy_images(2 * N_DEV)
    return model, params, port.eval(), images, infos


def _port_sharded(port, devices):
    replicas = replicate_model(port, devices)
    return shard_detect_fn(lambda d: build_detect_fn(replicas[d], **DETECT), devices)


def _pair(a, b, atol):
    assert a.shape == b.shape, (a.shape, b.shape)
    used = np.zeros(len(b), bool)
    for row in a:
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        assert d[j] <= atol, d[j]
        used[j] = True


def test_sharded_detect_matches_jax_shard_detect_fn(tiny):
    model, params, port, images, infos = tiny
    mesh = make_mesh(jax.devices()[:N_DEV])
    with mesh:
        jfn = jax_shard_detect_fn(jax_build_detect(model, **DETECT), mesh)
        jprops, jlines = jfn(jax.device_put(params, replicated(mesh)),
                             jnp.asarray(images.astype(np.float32)), jnp.asarray(infos))
    props, lines = _port_sharded(port, ["cpu"] * N_DEV)(images, infos)
    np.testing.assert_array_equal(props.count.numpy(), np.asarray(jprops.count))
    np.testing.assert_array_equal(lines.count.numpy(), np.asarray(jlines.count))
    np.testing.assert_allclose(props.rois.numpy(), np.asarray(jprops.rois),
                               rtol=1e-5, atol=1e-4)
    recs, jrecs = lines.recs.numpy(), np.asarray(jlines.recs)
    for i, c in enumerate(lines.count.numpy()):
        _pair(recs[i, :c], jrecs[i, :c], 0.5)
    assert int(props.count.sum()) > 0  # (random narrow weights find no lines)


def test_sharded_detect_matches_one_replica(tiny):
    _, _, port, images, infos = tiny
    want = build_detect_fn(port, **DETECT)(torch.from_numpy(images), torch.from_numpy(infos))
    got = _port_sharded(port, ["cpu"] * N_DEV)(images, infos)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_batch_that_does_not_divide_raises(tiny):
    _, _, port, images, infos = tiny
    fn = _port_sharded(port, ["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by dp_devices=3"):
        fn(images, infos)
    with pytest.raises(ValueError, match="batch 7 not divisible by dp_devices=2"):
        split_batch(np.zeros((7, 2)), 2)


def test_device_lists_raise_without_enough_cards(tiny, monkeypatch):
    _, _, port, _, _ = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_detect_fn(lambda d: None)  # devices=None: every visible card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert data_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="dp_devices=4 but only 2 devices visible"):
        data_devices(4)
    assert data_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_launch_counter_loses_nothing_under_threads():
    """8 threads x 1000 launches through the shared counter, with a short
    switch interval so that an unlocked read-modify-write would interleave."""
    class Wrapper:
        pass

    w = Wrapper()
    _launches.init(w)
    devs = [torch.device("cuda", k % 2) for k in range(8)]
    barrier = threading.Barrier(8)

    def launch(dev):
        barrier.wait()
        for _ in range(1000):
            _launches.count(w, dev)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(d,)) for d in devs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert w.LAUNCHES == 8000
    assert dict(w.LAUNCHES_BY_DEVICE) == {0: 4000, 1: 4000}


def test_full_f32_matmul_holds_while_any_thread_is_inside():
    """Thread A enters, thread B enters, A leaves: TF32 must stay off until
    B leaves too, then come back as it was found."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()

    def thread_a():
        with full_f32_matmul():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with full_f32_matmul():
            b_in.set()
            a_out.wait(10)
            seen.append(torch.backends.cuda.matmul.allow_tf32)

    try:
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_concurrent_replicas_keep_tf32_flag_and_records(tiny, monkeypatch):
    """Four replicas in four threads: the connector sees TF32 off in every
    thread, the flag is as it was found afterwards, and the records are the
    one-replica records."""
    _, _, port, images, infos = tiny
    seen = []
    fit = connector._fit

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return fit(*args, **kwargs)

    monkeypatch.setattr(connector, "_fit", spy)
    want = build_detect_fn(port, **DETECT)(torch.from_numpy(images), torch.from_numpy(infos))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen.clear()
        got = _port_sharded(port, ["cpu"] * N_DEV)(images, infos)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert len(seen) == 2 * N_DEV and not any(seen)  # two fits per replica (H mode)
    assert torch.equal(got[1].count, want[1].count)
    torch.testing.assert_close(got[1].recs, want[1].recs, rtol=0, atol=1e-5)
