"""ModelSet.cached, the port's process-level weight cache, on the CPU.

The port of tests/test_call_e2e.py's cache test (one object per key, a new
one after a model file's mtime moves), plus what the JAX cache lacks: a
file rewritten to another size with its mtime put back reloads, a
superseded entry is evicted, concurrent callers get one object, and the
cached modules are never mutated by the engines that share them.
"""
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from hifimeth_tpu_torch.engine.call import (CallConfig, CallEngine,
                                            ModelSet, default_model_dir,
                                            run_call)
from hifimeth_tpu_torch.model.cnn import load_model_npz
from hifimeth_tpu_torch.ops.fused import prepare_fused_params

from test_torch_pipeline import FORCED, _bam, _reads


@pytest.fixture
def model_dir(tmp_path):
    md = tmp_path / "models"
    shutil.copytree(default_model_dir(), md)
    return str(md)


def _entries(md):
    real = os.path.realpath(md)
    return [v for k, v in ModelSet._cache.items() if k[0] == real]


def test_modelset_cache_reuse_and_mtime_invalidation(model_dir):
    a = ModelSet.cached(model_dir, ("CpG",), "cpu")
    b = ModelSet.cached(model_dir, ("CpG",), torch.device("cpu"))
    assert a is b
    # other contexts, fused packing or dtype -> another set
    assert ModelSet.cached(model_dir, ("CHG",), "cpu") is not a
    assert ModelSet.cached(model_dir, ("CpG",), "cpu", fused=True) is not a
    assert ModelSet.cached(model_dir, ("CpG",), "cpu",
                           compute_dtype=torch.bfloat16) is not a
    # a retrain or import at the same path moves the mtime: reload
    p = os.path.join(model_dir, "CpG.npz")
    os.utime(p, (os.path.getmtime(p) + 10,) * 2)
    assert ModelSet.cached(model_dir, ("CpG",), "cpu") is not a


@pytest.mark.parametrize("name", ["kmer.txt", "CpG.npz"])
def test_rewrite_to_other_size_same_mtime_reloads(model_dir, name):
    a = ModelSet.cached(model_dir, ("CpG",), "cpu")
    p = os.path.join(model_dir, name)
    st = os.stat(p)
    if name == "kmer.txt":
        with open(p, "w") as f:
            f.write(f" {a.kmer}\n")
    else:
        with np.load(p) as z:
            arrays = {k: z[k] for k in z.files}
        for save in (np.savez, np.savez_compressed):
            with open(p, "wb") as f:      # the same arrays, stored otherwise
                save(f, **arrays)
            if os.stat(p).st_size != st.st_size:
                break
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.stat(p).st_size != st.st_size
    assert os.stat(p).st_mtime_ns == st.st_mtime_ns
    b = ModelSet.cached(model_dir, ("CpG",), "cpu")
    assert b is not a and b.kmer == a.kmer


def test_superseded_entry_evicted(model_dir):
    a = ModelSet.cached(model_dir, ("CpG",), "cpu")
    other = ModelSet.cached(model_dir, ("CHG",), "cpu")
    p = os.path.join(model_dir, "CpG.npz")
    os.utime(p, (os.path.getmtime(p) + 10,) * 2)
    b = ModelSet.cached(model_dir, ("CpG",), "cpu")
    entries = _entries(model_dir)
    assert b in entries and a not in entries
    assert other in entries                 # another setting stays
    assert len(entries) == 2


def test_concurrent_callers_get_one_object(model_dir):
    n = 8
    barrier = threading.Barrier(n)
    got = [None] * n

    def build(i):
        barrier.wait()
        got[i] = ModelSet.cached(model_dir, ("CpG", "CHH"), "cpu")

    threads = [threading.Thread(target=build, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)            # switch threads as often as can be
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(g is got[0] for g in got) and got[0] is not None
    assert len(_entries(model_dir)) == 1


def test_engines_share_one_read_only_set(tmp_path, model_dir):
    """Two engines from one config, and every replica of a device list that
    names the device three times, share one set; the runs through them
    leave its modules in eval mode, without gradients, and equal to a
    fresh load."""
    cfg = CallConfig(**{**FORCED, "model_dir": model_dir})
    e1, e2 = CallEngine(cfg), CallEngine(cfg)
    assert e1.models is e2.models
    dp = CallEngine(CallConfig(**{**FORCED, "model_dir": model_dir,
                                  "data_parallel": True}),
                    devices=["cpu"] * 3)
    assert all(r is e1.models for r in dp.replicas)
    bam = _bam(tmp_path, _reads(13))
    for impl in ("pallas", "fused"):
        run_call(bam, str(tmp_path / f"{impl}.bam"),
                 CallConfig(**{**FORCED, "model_dir": model_dir,
                               "gather_impl": impl}))
    for fused in (False, True):
        ms = ModelSet.cached(model_dir, FORCED["contexts"], "cpu",
                             fused=fused)
        for ctx, model in ms.models.items():
            fresh = load_model_npz(os.path.join(model_dir, f"{ctx}.npz"),
                                   torch.device("cpu"))
            assert not model.training
            assert not any(p.requires_grad for p in model.parameters())
            for k, v in fresh.state_dict().items():
                assert torch.equal(model.state_dict()[k], v), (ctx, k)
            if fused:
                assert torch.equal(ms.fused[ctx].buf,
                                   prepare_fused_params(fresh, "cpu").buf)
