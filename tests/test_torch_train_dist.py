"""The port's trainer over torch.distributed processes (gloo on the CPU):
the JAX trainer's (data, model) mesh as a grid of torchrun processes.

Two processes at (data 2, model 1) and at (data 1, model 2), launched with
torchrun's variables, train 2 steps through the `train` command; rank 0's
checkpoint (FC shards gathered) and model are held against one process
within rtol 1e-4, atol 1e-6 (batch-norm statistics summed over the data
group and FC2's partial products over the model group change only the
order of float32 sums).  A one-rank gloo group, which runs every collective
of the trainer, is held against the run with no group with the same
tolerance.
"""
import socket

import numpy as np
import pytest
import torch.distributed as dist

from hifimeth_tpu_torch.cli import main
from hifimeth_tpu_torch.model.cnn import load_params_npz
from hifimeth_tpu_torch.parallel.mesh import TrainLayout, train_layout
from hifimeth_tpu_torch.train import data, model, trainer

from test_torch_dist import run_ranks
# one_torch_thread: autouse here too
from test_torch_train import assert_trees_close, one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6
BATCH = 32
#: each rank on one thread, as the tests in this process
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


#: the layout rules in a two-process group
RANK_LAYOUT = """
import os
import pytest
from hifimeth_tpu_torch.parallel.dist import (init_distributed,
                                              shutdown_distributed)
from hifimeth_tpu_torch.parallel.mesh import train_layout
init_distributed("cpu")
rank = int(os.environ["RANK"])
try:
    with pytest.raises(ValueError, match="does not divide"):
        train_layout(model_shards=3)
    with pytest.raises(ValueError, match="not a multiple"):
        train_layout(model_shards=1, batch_size=33)
    a = train_layout(model_shards=1, batch_size=32)
    assert (a.n_data, a.n_model, a.data_rank, a.model_rank) == (2, 1, rank, 0)
    assert a.batch_slice(32) == slice(16 * rank, 16 * rank + 16)
    b = train_layout(model_shards=2, batch_size=33)
    assert (b.n_data, b.n_model, b.data_rank, b.model_rank) == (1, 2, 0, rank)
    assert b.batch_slice(33) == slice(0, 33) and b.sharded
finally:
    shutdown_distributed()
print("layout ok")
"""


def _blob_files(tmp_path, seed=5):
    blob = data.synthetic_blob(np.random.default_rng(seed), n_reads=6,
                               read_len=200, n_samples=2 * BATCH + 3)
    paths = [str(tmp_path / f"b.{s}") for s in ("features", "samples",
                                                 "offsets")]
    data.save_feature_blob(blob, *paths)
    return blob, paths


def _train_args(paths, out, ckpt):
    return ["train", "--feature", paths[0], "--train-sample", paths[1],
            "--offsets", paths[2], "--model-out", out, "--ckpt-dir", ckpt,
            "--kmer-size", "41", "--batch-size", str(BATCH), "--epoch", "1",
            "--device", "cpu"]


def test_layout_rules_in_a_group(tmp_path):
    outs = run_ranks(["-c", RANK_LAYOUT], 2, tmp_path, ONE_THREAD)
    assert all("layout ok" in o for o in outs)


@pytest.mark.parametrize("model_shards", [1, 2], ids=["data2-model1",
                                                      "data1-model2"])
def test_two_processes_match_one(tmp_path, model_shards):
    _, paths = _blob_files(tmp_path)
    one = tmp_path / "one"
    assert main(_train_args(paths, str(one / "m.npz"), str(one))) == 0
    two = tmp_path / "two"
    outs = run_ranks(["-m", "hifimeth_tpu_torch"]
                     + _train_args(paths, str(two / "m.npz"), str(two))
                     + ["--model-shards", str(model_shards)], 2, tmp_path,
                     ONE_THREAD)
    assert all("torch.distributed initialized (gloo)" in o for o in outs)
    assert "epoch 1 step 2" in outs[0] and "epoch 1 step 2" not in outs[1]
    name = "kmer_41_epoch_1.ckpt"
    got = trainer.load_checkpoint(str(two / name))
    want = trainer.load_checkpoint(str(one / name))
    assert got[0]["fc1"]["w"].shape == want[0]["fc1"]["w"].shape
    assert_trees_close(got, want, rtol=RTOL, atol=ATOL)
    assert_trees_close(load_params_npz(str(two / "m.npz")),
                       load_params_npz(str(one / "m.npz")), rtol=RTOL,
                       atol=ATOL)
    # the run moved the weights
    init = model.init_params(42, kmer=41)
    assert not np.allclose(got[0]["fc2"]["w"], init[0]["fc2"]["w"])


def test_one_rank_group_matches_no_group(tmp_path):
    blob, _ = _blob_files(tmp_path, seed=9)
    cfg = trainer.TrainConfig(kmer=41, batch_size=BATCH, device="cpu")
    params, state = model.init_params(3, kmer=41)
    order = np.random.default_rng(0).permutation(blob.n_samples)
    batches = [order[:BATCH], order[BATCH:2 * BATCH]]

    def run(layout):
        tr = trainer.TrainStep(cfg, blob.planes_t, params, state, layout)
        with trainer.float32_scope():
            losses = [tr.step(blob, b).tolist() for b in batches]
        return losses, tr.jax_params(), tr

    plain_losses, plain, _ = run(TrainLayout())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        layout = train_layout(1, BATCH)
        assert layout.data_group is not None and layout.sharded
        losses, got, tr = run(layout)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(losses, plain_losses, rtol=RTOL, atol=ATOL)
    assert_trees_close(got, plain, rtol=RTOL, atol=ATOL)
    assert int(tr.net.bns[0].num_batches_tracked) == 2
