"""The connector's chain walk (``ctpn_tpu_torch.ops.chain_walk``).

On the CPU the op runs its plain version, which must be the walk the
contract describes, bit for bit: a scalar walk per node below, in float64
and rounded once, with the graph's edge cases (shared tails, no edges, a
cap shorter than the chain, successors out of range, signed zeros). The
wrapper must refuse what the kernel does not take, and the fake kernel
must give the op's shapes, so that exports and captures hold it. The
kernel itself is held to the plain version on the card by
``chip_smoke.py`` phase 3. Against the JAX connector's reachability
matrix: ``tests/test_torch_connector.py``.
"""

import numpy as np
import pytest
import torch

from ctpn_tpu_torch.ops import chain_walk as CW
from ctpn_tpu_torch.postprocess import connector as TC

torch.set_num_threads(2)


def scalar_walk(succ, feats, x1, x2, steps):
    """The contract, one node at a time in NumPy."""
    n, p, k = feats.shape
    sums = np.zeros((n, p, k), np.float32)
    cnt, lo, hi = (np.zeros((n, p), np.float32) for _ in range(3))
    start = np.zeros((n, p), bool)
    for b in range(n):
        ok = (succ[b] >= 0) & (succ[b] < p)
        has_in = np.zeros(p, bool)
        has_in[succ[b][ok]] = True
        start[b] = ok & ~has_in
        for s in range(p):
            acc = feats[b, s].astype(np.float64)
            cur, m, a, z = s, 1, x1[b, s], x2[b, s]
            for _ in range(steps):
                nxt = succ[b, cur]
                if nxt < 0 or nxt >= p:
                    break
                cur, m = nxt, m + 1
                acc = acc + feats[b, cur].astype(np.float64)
                a = x1[b, cur] if x1[b, cur] < a else a
                z = x2[b, cur] if x2[b, cur] > z else z
            sums[b, s], cnt[b, s], lo[b, s], hi[b, s] = acc.astype(np.float32), m, a, z
    return sums, cnt, lo, hi, start


def forest(rng, n, p, cols=60):
    """Successor graphs as the connector builds them: each node in a
    column, a successor (or -1) a few columns to its right, so heads
    converge on shared tails; a tenth of the nodes are padding (-1)."""
    succ = np.full((n, p), -1, np.int32)
    for b in range(n):
        col = rng.randint(0, cols, p)
        for i in range(p):
            right = np.flatnonzero((col > col[i]) & (col <= col[i] + 3))
            if len(right) and rng.rand() < 0.85:
                succ[b, i] = rng.choice(right)
        succ[b, rng.rand(p) < 0.1] = -1
    return succ


def values(rng, shape):
    """Floats of mixed scale, with -0.0 and +0.0 among them."""
    a = (rng.normal(0, 1, shape) * 10.0 ** rng.randint(-2, 6, shape)).astype(np.float32)
    a.flat[::13] = -0.0
    a.flat[5::17] = 0.0
    return a


def run(succ, feats, x1, x2, steps, fn=CW.chain_walk):
    out = fn(*(torch.from_numpy(a) for a in (succ, feats, x1, x2)), steps)
    return [t.numpy() for t in out]


def same_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("n,p,k", [(2, 64, 7), (1, 1037, 6), (3, 5, 1), (1, 300, 8)],
                         ids=["h_mode", "p_not_a_multiple_of_the_cta", "one_feature",
                              "max_k"])
def test_plain_version_is_the_walk(n, p, k):
    rng = np.random.RandomState(p + k)
    succ = forest(rng, n, p)
    args = (succ, values(rng, (n, p, k)), values(rng, (n, p)), values(rng, (n, p)), 64)
    same_bits(run(*args), scalar_walk(*args))


def test_shared_tails_belong_to_every_head():
    """Heads 0 and 1 converge on 2 -> 3; 4 -> 5 is a chain of its own."""
    succ = np.array([[2, 2, 3, -1, 5, -1, -1]], np.int32)
    feats = (2.0 ** np.arange(7, dtype=np.float32))[None, :, None]
    x1 = np.array([[5, 3, 9, 1, 4, 2, 0]], np.float32)
    x2 = x1 + 10
    sums, cnt, lo, hi, start = run(succ, feats, x1, x2, 8)
    np.testing.assert_array_equal(sums[0, :, 0], [13, 14, 12, 8, 48, 32, 64])
    np.testing.assert_array_equal(cnt[0], [3, 3, 2, 1, 2, 1, 1])
    np.testing.assert_array_equal(lo[0], [1, 1, 1, 1, 2, 2, 0])
    np.testing.assert_array_equal(hi[0], [19, 19, 19, 11, 14, 12, 10])
    np.testing.assert_array_equal(start[0], [1, 1, 0, 0, 1, 0, 0])


def test_no_edges_every_row_holds_itself():
    rng = np.random.RandomState(1)
    succ = np.full((2, 33), -1, np.int32)
    feats, x1, x2 = values(rng, (2, 33, 7)), values(rng, (2, 33)), values(rng, (2, 33))
    sums, cnt, lo, hi, start = run(succ, feats, x1, x2, 64)
    same_bits([sums, lo, hi], [feats, x1, x2])
    assert np.all(cnt == 1) and not start.any()


@pytest.mark.parametrize("steps", [0, 1, 4, 9, 16])
def test_the_cap_cuts_a_longer_chain(steps):
    """A chain 0 -> 1 -> ... -> 9: node i visits min(10 - i, steps + 1)."""
    succ = np.array([list(range(1, 10)) + [-1]], np.int32)
    ones = np.ones((1, 10, 1), np.float32)
    x = np.arange(10, dtype=np.float32)[None]
    sums, cnt, lo, hi, start = run(succ, ones, x, x, steps)
    want = np.minimum(10 - np.arange(10), steps + 1)
    np.testing.assert_array_equal(cnt[0], want)
    np.testing.assert_array_equal(sums[0, :, 0], want)
    np.testing.assert_array_equal(hi[0], np.arange(10) + want - 1)
    np.testing.assert_array_equal(lo[0], np.arange(10))
    assert start[0].tolist() == [True] + [False] * 9


def test_successors_out_of_range_end_the_walk():
    succ = np.array([[1, 7, -5, 2]], np.int32)  # 7 and -5 lie outside [0, 4)
    feats = np.ones((1, 4, 2), np.float32)
    x = np.zeros((1, 4), np.float32)
    _, cnt, _, _, start = run(succ, feats, x, x, 8)
    np.testing.assert_array_equal(cnt[0], [2, 1, 1, 2])
    np.testing.assert_array_equal(start[0], [True, False, False, True])
    same_bits(run(succ, feats, x, x, 8), scalar_walk(succ, feats, x, x, 8))


def test_signed_zeros_pass():
    """No 0.0 is added: a chain of -0.0 sums to -0.0, with +0.0 to +0.0."""
    succ = np.array([[1, -1, 3, -1]], np.int32)
    feats = np.array([[[-0.0], [-0.0], [-0.0], [0.0]]], np.float32)
    x = np.zeros((1, 4), np.float32)
    sums = run(succ, feats, x, x, 4)[0]
    assert np.signbit(sums[0, :, 0]).tolist() == [True, True, False, False]


def test_cpu_dispatch_runs_the_plain_version():
    rng = np.random.RandomState(5)
    succ = forest(rng, 2, 90)
    args = (succ, values(rng, (2, 90, 7)), values(rng, (2, 90)), values(rng, (2, 90)), 64)
    before = CW.chain_walk.LAUNCHES
    op = run(*args, fn=torch.ops.ctpn_torch.chain_walk)
    same_bits(op, run(*args, fn=CW.chain_walk_ref))
    same_bits(run(*args), op)
    assert CW.chain_walk.LAUNCHES == before  # no kernel on the CPU


def test_fake_kernel_gives_the_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        succ = torch.empty((3, 50), dtype=torch.int32)
        feats = torch.empty((3, 50, 6))
        x = torch.empty((3, 50))
        out = torch.ops.ctpn_torch.chain_walk(succ, feats, x, x, 64)
        got = [(tuple(t.shape), t.dtype) for t in out]
    f32 = torch.float32
    assert got == [((3, 50, 6), f32), ((3, 50), f32), ((3, 50), f32), ((3, 50), f32),
                   ((3, 50), torch.bool)]


def _bad(case):
    succ = torch.full((2, 8), -1, dtype=torch.int32)
    feats, x = torch.zeros((2, 8, 7)), torch.zeros((2, 8))
    args = dict(succ=succ, feats=feats, x1=x, x2=x, steps=4)
    args.update({
        "succ_int64": dict(succ=succ.long()),
        "succ_three_dims": dict(succ=succ[None]),
        "feats_float64": dict(feats=feats.double()),
        "feats_rows": dict(feats=feats[:, :7]),
        "no_features": dict(feats=feats[..., :0]),
        "nine_features": dict(feats=torch.zeros((2, 8, 9))),
        "x1_shape": dict(x1=x[:1]),
        "x2_bf16": dict(x2=x.bfloat16()),
        "other_device": dict(x2=torch.zeros((2, 8), device="meta")),
        "meta_device": dict(succ=succ.to("meta"), feats=feats.to("meta"),
                            x1=x.to("meta"), x2=x.to("meta")),
        "negative_steps": dict(steps=-1),
    }[case])
    return args


@pytest.mark.parametrize("case", ["succ_int64", "succ_three_dims", "feats_float64",
                                  "feats_rows", "no_features", "nine_features", "x1_shape",
                                  "x2_bf16", "other_device", "meta_device",
                                  "negative_steps"])
def test_wrapper_refuses(case):
    with pytest.raises(ValueError):
        CW.chain_walk(**_bad(case))


@pytest.mark.parametrize("p,max_len,want", [(1000, 57, 64), (1000, None, 1024),
                                            (128, 3, 4), (7, None, 8), (1, None, 2),
                                            (1000, 64, 64), (1000, 65, 128)])
def test_walk_steps_reach_the_squarings(p, max_len, want):
    assert TC.walk_steps(p, max_len) == want


@pytest.mark.parametrize("mode", ["H", "O"])
def test_export_holds_the_walk(mode):
    """A ``torch.export`` of the connector holds one ``ctpn_torch::chain_walk``
    node and no matrix product."""
    rng = np.random.RandomState(2)
    boxes = np.sort(rng.uniform(0, 300, (2, 40, 4)).astype(np.float32), axis=-1)
    scores = rng.uniform(0.7, 1.0, (2, 40)).astype(np.float32)
    info = np.tile(np.array([320, 320, 1.0], np.float32), (2, 1))

    class Connect(torch.nn.Module):
        def forward(self, b, s, v, i):
            return tuple(TC.connect_text_lines(b, s, v, i, mode=mode, max_lines=8,
                                               max_chain_len=20))

    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.ones((2, 40), dtype=torch.bool), torch.from_numpy(info))
    exported = torch.export.export(Connect(), args)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("ctpn_torch.chain_walk" in t for t in targets) == 1
    assert not any("bmm" in t or "matmul" in t for t in targets)
    got, want = exported.module()(*args), Connect()(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
