"""Data parallel: two gloo ranks on the CPU take the update of one process
on the whole batch (the port's counterpart of
``tests/test_training.py::test_dp_step_matches_single_device``).

Each rank is a subprocess started as ``torchrun`` starts one (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in its environment), runs
two Momentum steps through ``parallel/dp.py`` and writes its metrics and
parameters. Tolerances: metrics within 1e-5 relative, parameters within
1e-6 (DDP averages the two ranks' gradients, the single process
differentiates the mean: the sums differ in order).
"""

import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import torch

from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.training.train_step import Batch, build_train_step, create_train_state
from tests.test_torch_train_step import BH, BW, FH, FW, TINY, toy_arrays

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
STEPS = 2

RANK = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.parallel.dp import init_data_parallel, shard_batch, wrap_model
from ctpn_tpu_torch.training.train_step import Batch, build_train_step, create_train_state
FH, FW, TINY = %d, %d, %r
cfg.TRAIN.SOLVER, cfg.TRAIN.LEARNING_RATE, cfg.RNG_SEED = "Momentum", 1e-3, 4
arrays = dict(np.load(sys.argv[1]))
torch.manual_seed(0)
model = CTPN(dtype=torch.float32, **TINY)
dev = torch.device("cpu")
rank, world = init_data_parallel(dev)
ddp = wrap_model(model, dev)
state = create_train_state(ddp)
step = build_train_step(ddp, FH, FW, rank, world)
batch = shard_batch(Batch.from_numpy([arrays[str(i)] for i in range(7)]), rank, world)
out = {}
for i in range(%d):
    for k, v in step(state, batch).items():
        out[f"{k}_{i}"] = float(v)
if rank == 0:
    out.update({n: p.detach().numpy() for n, p in model.named_parameters()})
    np.savez(sys.argv[2], **out)
torch.distributed.destroy_process_group()
""" % (FH, FW, TINY, STEPS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_match_one_process(tmp_path, rng):
    reset_cfg()
    arrays = toy_arrays(rng, 2)
    batch_file = tmp_path / "batch.npz"
    np.savez(batch_file, **{str(i): a for i, a in enumerate(arrays)})
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK, str(batch_file), str(tmp_path / "rank0.npz")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     OMP_NUM_THREADS="1"))
        for r in range(2)
    ]
    # the single process on the whole batch, meanwhile
    cfg.TRAIN.SOLVER, cfg.TRAIN.LEARNING_RATE, cfg.RNG_SEED = "Momentum", 1e-3, 4
    torch.manual_seed(0)
    model = CTPN(dtype=torch.float32, **TINY)
    state = create_train_state(model)
    step = build_train_step(model, FH, FW)
    want = {}
    for i in range(STEPS):
        for k, v in step(state, Batch.from_numpy(arrays)).items():
            want[f"{k}_{i}"] = float(v)
    reset_cfg()
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    got = np.load(tmp_path / "rank0.npz")
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, err_msg=k)
    assert want["grad_norm_0"] > 0 and want["update_norm_1"] > 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(got[n], p.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    assert (BH, BW) == arrays[0].shape[1:3]
