"""The port's trainer (train/, features/windows.gather_and_featurize) against
the JAX package's on the CPU.

Both trainers start from the same weights: the JAX package's init_params
(jax.random), carried across as numpy pytrees; the port's own init draws
from torch.Generator and cannot give the same numbers.

Tolerances, stated per check:
 - blob files, synthetic blobs, site arrays, gather_and_featurize and the
   BN fold: equal, bit for bit;
 - training-mode forward (logits, new running statistics) and eval
   forward against the JAX model: rtol 1e-3, atol 1e-4, as the JAX
   package's own torch comparison (tests/test_train.py:78-83);
 - 1 and 3 SGD steps (the third after the epoch's learning-rate decay)
   against the JAX make_train_step: loss within 1e-5 per step, every
   parameter and BN statistic rtol 1e-4, atol 1e-6 (read: at most 3e-7
   apart at both widths);
 - learning: final accuracy above 0.85, as tests/test_train.py:95-107.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifimeth_tpu.features.windows import \
    gather_and_featurize as jax_gather_and_featurize
from hifimeth_tpu.model.cnn import load_params_npz as jax_load_params_npz
from hifimeth_tpu.train import data as jax_data
from hifimeth_tpu.train import model as jax_model
from hifimeth_tpu.train import trainer as jax_trainer
from hifimeth_tpu_torch.cli import main
from hifimeth_tpu_torch.features.windows import gather_and_featurize
from hifimeth_tpu_torch.model.cnn import (load_model_npz, load_params_npz,
                                          save_params_npz)
from hifimeth_tpu_torch.train import data, model, trainer

TEST_WIDTHS = ((16, 8), (5, 3), 65)
RECIPE = (model.DEFAULT_CHANNELS, model.DEFAULT_KERNELS, 81)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test: the test workers share the
    cores, and an oversubscribed thread pool stalls on every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(channels, kernels, kmer, seed=0):
    params, state = jax_model.init_params(jax.random.PRNGKey(seed), kmer=kmer,
                                          channels=channels, kernels=kernels)
    return _np_tree(params), _np_tree(state)


def assert_trees_close(got, want, **tol):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(_np_tree(want))
    assert gdef == wdef
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **tol)


def assert_trees_equal(got, want):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(_np_tree(want))
    assert gdef == wdef
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- data ---------------------------------------------------------------------

def test_synthetic_blob_and_files_equal_jax(tmp_path):
    """One seed, the same blob; save writes the same bytes; load reads the
    same arrays in both packages."""
    blob = data.synthetic_blob(np.random.default_rng(0), n_reads=6,
                               read_len=120, n_samples=50)
    want = jax_data.synthetic_blob(np.random.default_rng(0), n_reads=6,
                                   read_len=120, n_samples=50)
    for k in ("planes_t", "read_start", "read_size", "qids", "qoffs",
              "labels"):
        a, b = getattr(blob, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    mine = [str(tmp_path / f"p.{s}") for s in ("f", "s", "o")]
    theirs = [str(tmp_path / f"j.{s}") for s in ("f", "s", "o")]
    data.save_feature_blob(blob, *mine)
    jax_data.save_feature_blob(want, *theirs)
    for a, b in zip(mine, theirs):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
    got = data.load_feature_blob(*mine)
    ref = jax_data.load_feature_blob(*mine)
    for k in ("planes_t", "read_start", "read_size", "qids", "qoffs",
              "labels"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(got.planes_t, blob.planes_t)
    with open(mine[0], "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError):
        data.load_feature_blob(*mine)


def test_site_arrays_equal_and_bad_center_raises():
    blob = data.synthetic_blob(np.random.default_rng(3), n_reads=8,
                               read_len=200, n_samples=64)
    idx = np.random.default_rng(4).permutation(64)[:40]
    got = blob.site_arrays(idx)
    want = jax_data.FeatureBlob(**vars(blob)).site_arrays(idx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(np.unique(got[1])) == {0, 1}
    blob.planes_t[blob.read_start[blob.qids[idx[0]]] + blob.qoffs[idx[0]],
                  0] = 3
    with pytest.raises(ValueError, match="not C/G"):
        blob.site_arrays(idx)


@pytest.mark.parametrize("kmer", [81, 401])
def test_gather_and_featurize_bit_equal(kmer):
    """Both strands, windows over both read edges, the blob's first and
    last positions, and codes over 3 (N) that stay uncomplemented."""
    rng = np.random.default_rng(8)
    blob = data.synthetic_blob(rng, n_reads=6, read_len=300, n_samples=96)
    planes = blob.planes_t.copy()
    planes[rng.integers(0, len(planes), 200), 0] = 15
    c, s, r0, r1, _ = blob.site_arrays(np.arange(96))
    c[:2] = (0, len(planes) - 1)
    s[:2] = (1, 0)
    r0[:2], r1[:2] = (0, len(planes) - 300), (300, len(planes))
    got = gather_and_featurize(torch.from_numpy(planes),
                               *(torch.from_numpy(a) for a in (c, s, r0, r1)),
                               kmer_size=kmer).numpy()
    want = np.asarray(jax_gather_and_featurize(planes, c, s, r0, r1,
                                               kmer_size=kmer))
    assert got.dtype == want.dtype and got.shape == (96, kmer, 8)
    assert got.tobytes() == want.tobytes()


# -- model --------------------------------------------------------------------

@pytest.mark.parametrize("widths", [TEST_WIDTHS, RECIPE],
                         ids=["test-widths", "recipe-widths"])
def test_model_matches_jax(widths, tmp_path):
    channels, kernels, kmer = widths
    params, state = jax_init(channels, kernels, kmer)
    x = np.random.default_rng(3).standard_normal((16, kmer, 8)).astype(
        np.float32)
    net = model.TrainNet.from_jax(params, state, kmer)
    assert (sum(p.numel() for p in net.parameters())
            == sum(a.size for a in jax.tree_util.tree_leaves(params)))
    # training mode: logits and the running statistics' update
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want, new_state = jax_model.apply_train(params, state, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)
    p2, s2 = model.train_params_to_jax(net)
    assert_trees_equal(p2, params)
    assert_trees_close(s2, new_state, rtol=1e-3, atol=1e-4)
    # eval mode with the updated statistics
    got = model.apply_eval(net, torch.from_numpy(x)).numpy()
    assert net.training
    want = jax_model.apply_eval(p2, s2, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)
    # the fold: bit-equal, and its npz the same arrays in both packages
    folded = model.fold_to_inference(p2, s2)
    assert_trees_equal(folded, jax_model.fold_to_inference(p2, s2))
    path = str(tmp_path / "m.npz")
    save_params_npz(path, folded)
    assert_trees_equal(load_params_npz(path), jax_load_params_npz(path))
    # the folded model in the call engine's network = eval mode
    inf = load_model_npz(path, torch.device("cpu"))
    with torch.no_grad():
        logits = inf(torch.from_numpy(x).transpose(1, 2).contiguous()).numpy()
    np.testing.assert_allclose(logits, got, rtol=1e-3, atol=1e-4)


def test_init_params_seeded():
    """The JAX init's shapes and dtypes; one seed, one draw; bounds
    1/sqrt(fan_in) (fc1.b with fc1's fan-in)."""
    a = model.init_params(7, kmer=81)
    b = model.init_params(7, kmer=81)
    assert_trees_equal(a, b)
    ref = jax_init(*RECIPE)
    ga, gdef = jax.tree_util.tree_flatten(a)
    gr, rdef = jax.tree_util.tree_flatten(ref)
    assert gdef == rdef
    assert [(x.shape, x.dtype) for x in ga] == [(x.shape, x.dtype) for x in gr]
    params = a[0]
    flat = params["fc1"]["w"].shape[0]
    assert np.abs(params["fc1"]["b"]).max() <= 1 / np.sqrt(flat)
    assert np.abs(params["fc1"]["b"]).max() > 0.9 / np.sqrt(flat)
    w0 = params["convs"][0]["w"]
    assert np.abs(w0).max() <= 1 / np.sqrt(8 * 13)
    assert not np.array_equal(model.init_params(8, kmer=81)[0]["fc2"]["w"],
                              params["fc2"]["w"])


# -- training steps -----------------------------------------------------------

def _steps(widths, batch, n_steps, steps_per_epoch, lr=0.1):
    """n_steps of both trainers from the JAX init, over the JAX trainer's
    batches; returns (losses, port tree, JAX tree, port lr)."""
    channels, kernels, kmer = widths
    params, state = jax_init(channels, kernels, kmer)
    blob = data.synthetic_blob(np.random.default_rng(1), n_reads=10,
                               read_len=300,
                               n_samples=steps_per_epoch * batch + 5)
    jcfg = jax_trainer.TrainConfig(kmer=kmer, batch_size=batch, lr=lr)
    opt = jax_trainer.make_optimizer(jcfg, steps_per_epoch)
    jstep = jax_trainer.make_train_step(opt, kmer)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, state)
    o = opt.init(p)
    tr = trainer.TrainStep(trainer.TrainConfig(kmer=kmer, batch_size=batch,
                                               lr=lr, device="cpu"),
                           blob.planes_t, params, state)
    rng = np.random.default_rng(jcfg.seed)
    losses = []
    with trainer.float32_scope():
        while len(losses) < n_steps:
            order = rng.permutation(blob.n_samples)
            for bi in range(steps_per_epoch):
                if len(losses) == n_steps:
                    break
                idx = order[bi * batch:(bi + 1) * batch]
                c, st, r0, r1, lab = blob.site_arrays(idx)
                p, s, o, loss, acc = jstep(p, s, o, c, st, r0, r1,
                                           lab.astype(np.int32),
                                           jnp.asarray(blob.planes_t))
                m = tr.step(blob, idx)
                losses.append((float(m[0]), float(loss), float(m[1]),
                               float(acc)))
            else:
                tr.end_epoch()
    return losses, tr.jax_params(), (p, s), tr.optimizer.param_groups[0]["lr"]


@pytest.mark.parametrize("n_steps,widths", [(1, TEST_WIDTHS), (3, TEST_WIDTHS),
                                            (1, RECIPE), (3, RECIPE)],
                         ids=["1-test-widths", "3-test-widths",
                              "1-recipe-widths", "3-recipe-widths"])
def test_train_steps_match_jax(n_steps, widths):
    """Two steps an epoch: the third step runs at lr 0.1 * 0.2 on both
    sides (StepLR against optax's staircase exponential_decay)."""
    losses, got, want, lr = _steps(widths, 32 if widths is TEST_WIDTHS
                                   else 64, n_steps, 2)
    for loss, jloss, acc, jacc in losses:
        assert abs(loss - jloss) <= 1e-5
        assert acc == jacc
    assert_trees_close(got, want, rtol=1e-4, atol=1e-6)
    assert lr == pytest.approx(0.1 * 0.2 if n_steps == 3 else 0.1)


def test_optimizer_decays_every_parameter():
    tr = trainer.TrainStep(trainer.TrainConfig(kmer=65, device="cpu"),
                           np.zeros((10, 5), np.uint8),
                           *jax_init(*TEST_WIDTHS))
    (group,) = tr.optimizer.param_groups
    assert len(group["params"]) == len(list(tr.net.parameters()))
    assert group["weight_decay"] == 1e-5 and group["nesterov"]
    assert group["momentum"] == 0.9


def test_float32_scope_restores_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with trainer.float32_scope():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_training_learns_synthetic_signal(tmp_path):
    blob = data.synthetic_blob(np.random.default_rng(1), n_reads=40,
                               read_len=500, n_samples=4096)
    cfg = trainer.TrainConfig(kmer=81, batch_size=256, epochs=3, lr=0.02,
                              log_every=4, device="cpu")
    out = str(tmp_path / "model.npz")
    res = trainer.train_context(blob, cfg, out)
    assert res["final_acc"] > 0.85, f"training failed to learn: {res}"
    assert res["steps"] == 48 and len(res["history"]) == 12
    assert set(res["timers"]) == set(trainer.STAGES)
    # the exported model loads in both packages
    assert_trees_equal(load_params_npz(out), jax_load_params_npz(out))
    inf = load_model_npz(out, torch.device("cpu"))
    assert inf(torch.zeros(2, 8, 81)).shape == (2, 2)


# -- checkpoints --------------------------------------------------------------

def test_checkpoints_cross_packages(tmp_path):
    """A JAX checkpoint loads in the port as the same tree and resumes
    training; the port's checkpoint loads in the JAX package."""
    params, state = jax_init(*TEST_WIDTHS)
    jpath = str(tmp_path / "jax" / "kmer_65_epoch_1.ckpt")
    jax_trainer.save_checkpoint(jpath, jax.tree_util.tree_map(
        jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state))
    p, s = trainer.load_checkpoint(jpath)
    assert_trees_equal(p, params)
    assert_trees_equal(s, state)
    tr = trainer.TrainStep(trainer.TrainConfig(kmer=65, device="cpu"),
                           np.zeros((10, 5), np.uint8), p, s)
    ppath = str(tmp_path / "port" / "0_3.ckpt")
    tr.save_checkpoint(ppath)
    jp, js = jax_trainer.load_checkpoint(ppath)
    assert_trees_equal(jp, params)
    assert_trees_equal(js, state)
    with open(ppath, "rb") as f:
        assert sorted(pickle.load(f)) == ["params", "state"]


def test_train_context_writes_checkpoints(tmp_path):
    """Names of the JAX trainer: {epoch}_{step}.ckpt every ckpt_every steps
    and kmer_{k}_epoch_{e}.ckpt after each epoch; the last one folds to the
    written model."""
    blob = data.synthetic_blob(np.random.default_rng(2), n_reads=6,
                               read_len=200, n_samples=100)
    cfg = trainer.TrainConfig(kmer=41, batch_size=32, epochs=2, ckpt_every=4,
                              device="cpu")
    ck = tmp_path / "ck"
    out = str(tmp_path / "m.npz")
    res = trainer.train_context(blob, cfg, out, str(ck))
    assert res["steps"] == 6
    assert sorted(os.listdir(ck)) == ["1_4.ckpt", "kmer_41_epoch_1.ckpt",
                                      "kmer_41_epoch_2.ckpt"]
    p, s = trainer.load_checkpoint(str(ck / "kmer_41_epoch_2.ckpt"))
    assert_trees_equal(load_params_npz(out), model.fold_to_inference(p, s))


# -- CLI ----------------------------------------------------------------------

def test_cli_train_on_cpu(tmp_path, capsys):
    blob = data.synthetic_blob(np.random.default_rng(5), n_reads=6,
                               read_len=200, n_samples=80)
    paths = [str(tmp_path / f"b.{s}") for s in ("f", "s", "o")]
    data.save_feature_blob(blob, *paths)
    out = str(tmp_path / "cli.npz")
    args = ["train", "--feature", paths[0], "--train-sample", paths[1],
            "--offsets", paths[2], "--model-out", out, "--kmer-size", "41",
            "--batch-size", "32", "--epoch", "1", "--device", "cpu"]
    assert main(args) == 0
    assert_trees_equal(load_params_npz(out), jax_load_params_npz(out))
    ref = str(tmp_path / "ref.npz")
    trainer.train_context(blob, trainer.TrainConfig(
        kmer=41, batch_size=32, epochs=1, device="cpu"), ref)
    assert_trees_equal(load_params_npz(out), load_params_npz(ref))
    with pytest.raises(ValueError, match="model-shards 2"):
        main(args + ["--model-shards", "2"])
    with pytest.raises(SystemExit):
        main(args + ["--device", "tpu"])
