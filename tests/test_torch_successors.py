"""The connector's successor graph (``ctpn_tpu_torch.ops.successors``).

On the CPU the op runs its plain version, the dense form that was in the
connector. It must equal the rules applied one node at a time as the
kernel applies them (valid nodes sorted by column, each node's
neighbours scanned outwards to the nearest candidate column on each side,
in float32): on strip scenes, on proposals of the program's 16-px grid,
and on scenes built for each rule (ties in the nearest column, a gap of
exactly ``max_gap``, overlap and similarity exactly at their thresholds,
no valid node, one node, P off the kernel's block). The wrapper must
refuse what the kernel does not take, hand the kernel global scratch where
an image's keys leave shared memory, and the fake must give the op's
shape. The kernel itself is held to the plain version on the card by
``chip_smoke.py`` phase 3; against the JAX connector and the NumPy
oracle: ``tests/test_torch_connector.py``.
"""

import numpy as np
import pytest
import torch

from ctpn_tpu_torch.ops import successors as SU
from ctpn_tpu_torch.postprocess import connector as TC

torch.set_num_threads(2)

F32 = np.float32


def kernel_rules(boxes, scores, valid, max_gap=50, min_v_overlaps=0.7, min_size_sim=0.7):
    """The contract, one node at a time, in the kernel's order."""
    t_ov, t_sim, one = F32(min_v_overlaps), F32(min_size_sim), F32(1.0)
    n, p = scores.shape
    out = np.full((n, p), -1, np.int32)
    for b in range(n):
        y1, y2, score = boxes[b, :, 1], boxes[b, :, 3], scores[b]
        h = (y2 - y1) + one
        col = np.floor(boxes[b, :, 0]).astype(np.int32)
        order = sorted((int(col[i]), i) for i in range(p) if valid[b, i])

        def meets(a, k):
            inter = (min(y2[a], y2[k]) - max(y1[a], y1[k])) + one
            lo, hi = min(h[a], h[k]), max(h[a], h[k])
            return max(inter, F32(0.0)) / lo >= t_ov and lo / hi >= t_sim

        def nearest(t, ct, side):
            """(column, candidates) of the nearest candidate column."""
            near, found = None, []
            for c, k in side:
                if c == ct:
                    continue
                if abs(c - ct) > max_gap or (near is not None and c != near):
                    break
                if meets(t, k):
                    near = c
                    found.append(k)
            return found

        best, prec = {}, np.full(p, -np.inf, F32)
        for r, (ct, t) in enumerate(order):
            right = nearest(t, ct, order[r + 1:])
            if right:  # best score, ties to the lowest index (ascending here)
                best[t] = max(right, key=lambda k: (score[k], -k))
            left = nearest(t, ct, order[r - 1::-1] if r else [])
            if left:
                prec[t] = max(score[k] for k in left)
        for i, j in best.items():
            if score[i] >= prec[j]:
                out[b, i] = j
    return out


def strip_scene(rng, n_lines=5, im_h=600, im_w=900, slope=0.0):
    """CTPN-like proposals: rows of 16-px strips at any x, shuffled."""
    boxes, scores = [], []
    for _ in range(n_lines):
        y = rng.uniform(40, im_h - 80)
        h = rng.uniform(20, 40)
        x_start = rng.uniform(0, 150)
        for s in range(rng.randint(3, 20)):
            x1 = x_start + s * 16
            if x1 + 15 >= im_w:
                break
            yy = y + slope * (x1 - x_start) + rng.uniform(-1.5, 1.5)
            boxes.append([x1, yy, x1 + 15, yy + h * rng.uniform(0.95, 1.05)])
            scores.append(rng.uniform(0.75, 1.0))
    perm = rng.permutation(len(boxes))
    return np.array(boxes, F32)[perm], np.array(scores, F32)[perm]


def padded(scenes, p):
    b = np.zeros((len(scenes), p, 4), F32)
    s = np.full((len(scenes), p), -1.0, F32)
    v = np.zeros((len(scenes), p), bool)
    for i, (boxes, scores) in enumerate(scenes):
        b[i, :len(boxes)], s[i, :len(boxes)], v[i, :len(boxes)] = boxes, scores, True
    return b, s, v


def grid_scene(rng, n, p, im_w=912, im_h=608):
    """Proposals as the program's connector takes them: x1 on the 16-px
    anchor grid, many per column, heights of the anchor ladder jittered,
    scores in (0.7, 1]; a random tenth invalid, as the detector's NMS
    leaves them."""
    x1 = 16.0 * rng.randint(0, im_w // 16, (n, p))
    h = rng.choice([11, 16, 23, 33, 48, 68, 97], (n, p)) * rng.uniform(0.9, 1.1, (n, p))
    y1 = rng.uniform(0, im_h - 100, (n, p))
    boxes = np.stack([x1, y1, x1 + 15, y1 + h - 1], -1).astype(F32)
    scores = rng.uniform(0.7, 1.0, (n, p)).astype(F32)
    return boxes, scores, rng.rand(n, p) > 0.1


def run(boxes, scores, valid, *args, fn=SU.successors):
    return fn(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
              *args).numpy()


def check(boxes, scores, valid, *args):
    """The plain version, the op on the CPU and the kernel's rules agree;
    returns the successors."""
    got = run(boxes, scores, valid, *args, fn=SU.successors_ref)
    assert got.dtype == np.int32 and got.shape == scores.shape
    np.testing.assert_array_equal(run(boxes, scores, valid, *args), got)
    np.testing.assert_array_equal(kernel_rules(boxes, scores, valid, *args), got)
    return got


@pytest.mark.parametrize("slope", [0.0, 0.08])
def test_plain_version_on_strip_scenes(slope):
    scenes = [strip_scene(np.random.RandomState(s), slope=slope) for s in range(4)]
    succ = check(*padded(scenes, 160))
    assert (succ >= 0).sum() > 100


@pytest.mark.parametrize("n,p,seed", [(2, 300, 0), (1, 1037, 1), (3, 128, 2)],
                         ids=["grid_300", "p_off_the_block", "grid_128"])
def test_plain_version_on_the_anchor_grid(n, p, seed):
    boxes, scores, valid = grid_scene(np.random.RandomState(seed), n, p)
    succ = check(boxes, scores, valid)
    assert (succ >= 0).any()


@pytest.mark.parametrize("max_gap,min_v_overlaps,min_size_sim",
                         [(16, 0.7, 0.7), (50, 0.5, 0.9), (0, 0.7, 0.7), (-3, 0.7, 0.7),
                          (1000, 0.7, 0.7)])
def test_plain_version_under_other_settings(max_gap, min_v_overlaps, min_size_sim):
    boxes, scores, valid = grid_scene(np.random.RandomState(7), 2, 200)
    succ = check(boxes, scores, valid, max_gap, min_v_overlaps, min_size_sim)
    assert (succ >= 0).any() == (max_gap >= 16)


def strip(x1, y1, y2):
    return [x1, y1, x1 + 15, y2]


def scene(rows, scores, valid=None):
    boxes = np.array([rows], F32)
    scores = np.array([scores], F32)
    valid = np.ones_like(scores, bool) if valid is None else np.array([valid])
    return boxes, scores, valid


def test_equal_scores_in_the_nearest_column_go_to_the_lowest_index():
    """Node 0 (column 0) has three candidates of score 0.8 in column 16,
    at indices 4, 2 and 5, and one of 0.9 in column 32: index 2 wins.
    Nodes 1 and 3 (column 32) have tied precursors 2, 4, 5: each is the
    best precursor score 0.8, so 2's edge to 1 stands, by ``>=``."""
    rows = [strip(0, 10, 40), strip(32, 10, 40), strip(16, 10, 40), strip(32, 10, 40),
            strip(16, 10, 40), strip(16, 10, 40)]
    succ = check(*scene(rows, [0.95, 0.9, 0.8, 0.9, 0.8, 0.8]))
    np.testing.assert_array_equal(succ[0], [2, -1, 1, -1, 1, 1])


def test_the_precursor_side_takes_the_nearest_column_only():
    """Node 2 (column 32) has precursors 0 (column 0, score 0.99) and 1
    (column 16, 0.8): its best precursor score is 0.8, from the nearest
    column, so 1 -> 2 stands; 0's nearest successor column is 16."""
    rows = [strip(0, 10, 40), strip(16, 10, 40), strip(32, 10, 40)]
    succ = check(*scene(rows, [0.99, 0.8, 0.9]))
    np.testing.assert_array_equal(succ[0], [1, 2, -1])


@pytest.mark.parametrize("dx,linked", [(50, True), (51, False), (50.9, True), (49.5, True)])
def test_a_gap_of_exactly_max_gap_is_a_candidate(dx, linked):
    """Columns are ``floor(x1)``: 50 and 50.9 are max_gap, 51 is past it."""
    rows = [strip(100, 10, 40), strip(100 + dx, 10, 40)]
    succ = check(*scene(rows, [0.9, 0.8]))
    np.testing.assert_array_equal(succ[0], [1 if linked else -1, -1])


@pytest.mark.parametrize("b_y1,b_y2,linked", [
    (3.0, 12.0, True),     # overlap 7 / 10 = 0.7 exactly
    (3.01, 12.01, False),  # overlap just under 0.7
    (0.0, 6.0, True),      # heights 7 and 10: similarity 0.7 exactly
    (0.0, 5.99, False),    # similarity just under 0.7
], ids=["overlap_at_0.7", "overlap_under", "similarity_at_0.7", "similarity_under"])
def test_thresholds_are_met_at_equality(b_y1, b_y2, linked):
    rows = [strip(0, 0.0, 9.0), strip(16, b_y1, b_y2)]
    succ = check(*scene(rows, [0.9, 0.8]))
    np.testing.assert_array_equal(succ[0], [1 if linked else -1, -1])


def test_no_valid_node_has_no_edge():
    boxes, scores, _ = grid_scene(np.random.RandomState(3), 2, 64)
    succ = check(boxes, scores, np.zeros((2, 64), bool))
    assert (succ == -1).all()


@pytest.mark.parametrize("valid", [True, False])
def test_one_node_has_no_edge(valid):
    succ = check(*scene([strip(0, 10, 40)], [0.9], [valid]))
    np.testing.assert_array_equal(succ, [[-1]])


def test_invalid_nodes_are_never_candidates():
    """Node 1 would be 0's successor; invalid, it is skipped for node 2."""
    rows = [strip(0, 10, 40), strip(16, 10, 40), strip(32, 10, 40)]
    succ = check(*scene(rows, [0.9, 0.95, 0.8], [True, False, True]))
    np.testing.assert_array_equal(succ[0], [2, -1, -1])


def test_build_successors_calls_the_op():
    boxes, scores, valid = grid_scene(np.random.RandomState(4), 2, 100)
    args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    assert torch.equal(TC.build_successors(*args, 40, 0.6, 0.8),
                       torch.ops.ctpn_torch.successors(*args, 40, 0.6, 0.8))


def test_cpu_dispatch_runs_the_plain_version():
    boxes, scores, valid = grid_scene(np.random.RandomState(5), 2, 90)
    before = SU.successors.LAUNCHES
    op = run(boxes, scores, valid, 50, 0.7, 0.7, fn=torch.ops.ctpn_torch.successors)
    np.testing.assert_array_equal(op, run(boxes, scores, valid, fn=SU.successors_ref))
    assert SU.successors.LAUNCHES == before  # no kernel on the CPU


def test_fake_kernel_gives_the_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = torch.ops.ctpn_torch.successors(torch.empty((3, 50, 4)), torch.empty((3, 50)),
                                              torch.empty((3, 50), dtype=torch.bool),
                                              50, 0.7, 0.7)
        got = (tuple(out.shape), out.dtype)
    assert got == ((3, 50), torch.int32)


@pytest.mark.parametrize("p,scratch", [(1000, None), (16384, None), (16385, 32768)])
def test_launch_hands_scratch_past_shared_memory(p, scratch, monkeypatch):
    """The kernel keeps up to ``SHARED_NODES`` keys an image in shared
    memory; past that the launcher gives it int64 keys for the next power
    of two and float32 precursor scores in global memory."""
    calls = []
    monkeypatch.setattr(SU, "_KERNEL", lambda device, *args: calls.append(args))
    boxes, scores = torch.zeros((2, p, 4)), torch.zeros((2, p))
    out = SU._launch(boxes, scores, torch.ones((2, p), dtype=torch.bool), 50, 0.7, 0.7)
    (_, _, _, succ, keys, prec, n, pp, gap, ov, sim), = calls
    assert succ is out and out.shape == (2, p) and out.dtype == torch.int32
    assert (n, pp, gap, ov, sim) == (2, p, 50, 0.7, 0.7)
    if scratch is None:
        assert keys is None and prec is None
    else:
        assert keys.shape == (2, scratch) and keys.dtype == torch.int64
        assert prec.shape == (2, p) and prec.dtype == torch.float32


def _bad(case):
    boxes, scores = torch.zeros((2, 8, 4)), torch.zeros((2, 8))
    valid = torch.ones((2, 8), dtype=torch.bool)
    args = dict(boxes=boxes, scores=scores, valid=valid, max_gap=50)
    args.update({
        "scores_float64": dict(scores=scores.double()),
        "scores_one_dim": dict(scores=scores[0]),
        "boxes_bf16": dict(boxes=boxes.bfloat16()),
        "boxes_five_columns": dict(boxes=torch.zeros((2, 8, 5))),
        "boxes_rows": dict(boxes=boxes[:, :7]),
        "valid_uint8": dict(valid=valid.to(torch.uint8)),
        "valid_shape": dict(valid=valid[:1]),
        "other_device": dict(valid=valid.to("meta")),
        "meta_device": dict(boxes=boxes.to("meta"), scores=scores.to("meta"),
                            valid=valid.to("meta")),
        "gap_float": dict(max_gap=50.0),
        "gap_past_int32": dict(max_gap=2 ** 31),
    }[case])
    return args


@pytest.mark.parametrize("case", ["scores_float64", "scores_one_dim", "boxes_bf16",
                                  "boxes_five_columns", "boxes_rows", "valid_uint8",
                                  "valid_shape", "other_device", "meta_device", "gap_float",
                                  "gap_past_int32"])
def test_wrapper_refuses(case):
    with pytest.raises(ValueError):
        SU.successors(**_bad(case))


@pytest.mark.parametrize("mode", ["H", "O"])
def test_export_holds_one_successors_node_and_no_pairwise_tensor(mode):
    """A ``torch.export`` of the connector holds one
    ``ctpn_torch::successors`` node, and no node's value is (N, P, P)."""
    boxes, scores, valid = grid_scene(np.random.RandomState(6), 2, 40)
    info = np.tile(np.array([608, 912, 1.0], F32), (2, 1))

    class Connect(torch.nn.Module):
        def forward(self, b, s, v, i):
            return tuple(TC.connect_text_lines(b, s, v, i, mode=mode, max_lines=8,
                                               max_chain_len=20))

    args = tuple(torch.from_numpy(a) for a in (boxes, scores, valid, info))
    exported = torch.export.export(Connect(), args)
    calls = [n for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("ctpn_torch.successors" in str(n.target) for n in calls) == 1
    shapes = [tuple(v.shape) for n in calls for v in
              (n.meta["val"] if isinstance(n.meta.get("val"), (tuple, list))
               else [n.meta.get("val")]) if isinstance(v, torch.Tensor)]
    assert shapes and (2, 40, 40) not in shapes
    for g, w in zip(exported.module()(*args), Connect()(*args)):
        assert torch.equal(g, w)
