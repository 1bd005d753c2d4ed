"""`--dtype bf16` in the port on the CPU, against the JAX package.

Arithmetic (hifimeth_tpu_torch/model/cnn.py): bn0 in float32, each conv and
FC on bf16 operands with float32 sums, bias and ReLU in float32, one
rounding to bf16 per layer, float32 logits - the JAX package's
dnamodnet_apply(compute_dtype=bfloat16) as its engine runs it, compiled
(XLA keeps the FC outputs in float32 where the eager function rounds them
to bf16).  The two then differ only in the order of float32 sums, so most
logits agree to ~1e-4; where that order moves a value across a bf16
rounding boundary (a step of 2^-8 relative) the change propagates through
the later layers, so a few logits move by up to a few hundredths.
Tolerances: logits within 0.1 absolute and 2e-3 on average of JAX's.  For u8 probabilities of an engine run, the band the JAX
package's bf16 keeps against its float32 (BENCH_r05.json: max 10, mean
0.62) bounds the port's bf16 against the JAX engine's bf16, and the port's
bf16 keeps against its own float32 a band no wider than the JAX package's
own on the same input: max 10, and a mean at most 10% above JAX's (two bf16
runs whose float32 sums differ in order end up about half as far from each
other as from float32, so either's mean moves by a few percent).  MM and MN
never change with the dtype.
"""
import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu.model.cnn import conv_spec, dnamodnet_apply
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.model.cnn import DNAModNet, params_from_jax

from util import make_kinetics_read, write_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
DATA = os.path.join(ROOT, "tests", "data")
#: the JAX package's bf16 band against its float32 (BENCH_r05.json)
BAND_MAX, BAND_MEAN = 10, 0.62


def _windows(rng, b, kmer=401):
    x = np.zeros((b, kmer, 8), np.float32)
    codes = rng.integers(0, 4, (b, kmer))
    x[np.arange(b)[:, None], np.arange(kmer)[None, :], codes] = 1.0
    x[..., 4:] = rng.random((b, kmer, 4), dtype=np.float32)
    return x


@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_bf16_logits_match_jax(ctx):
    params = jax_load(os.path.join(MODELS, f"{ctx}.npz"))
    x = _windows(np.random.default_rng(1), 64)
    jax_bf16 = jax.jit(partial(dnamodnet_apply, compute_dtype=jnp.bfloat16,
                               spec=conv_spec(params)))
    want = np.asarray(jax_bf16(params, x))
    f32 = np.asarray(dnamodnet_apply(params, x))
    model = DNAModNet.from_state_dict(params_from_jax(params))
    model.set_compute_dtype(torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 2, 1).contiguous())
        # the pallas path hands the model bf16 windows
        got_bf16_in = model(torch.from_numpy(x).permute(0, 2, 1)
                            .to(torch.bfloat16).contiguous())
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - want)
    assert d.max() <= 0.1 and d.mean() <= 2e-3, (d.max(), d.mean())
    # bf16 moves the logits off float32 (it is not a float32 run)
    assert np.abs(got.numpy() - f32).mean() > 10 * d.mean()
    # the windows' one-hot and kinetics round to bf16 before bn0
    want_in = np.asarray(jax_bf16(params, jnp.asarray(x, jnp.bfloat16)))
    d = np.abs(got_bf16_in.numpy() - want_in)
    assert d.max() <= 0.1 and d.mean() <= 2e-3, (d.max(), d.mean())
    with pytest.raises(ValueError):
        model.set_compute_dtype(torch.float16)


def _tags(path):
    return [(r.qname, r.get_tag("MM"), r.get_tag("MN"),
             None if r.get_tag("ML") is None else r.get_tag("ML")[1][1]
             .astype(int)) for r in BamReader(path)]


def _band(got, want):
    """MM/MN equal and records in the same order; returns (max, mean) of
    the ML u8 differences."""
    assert [g[:3] for g in got] == [w[:3] for w in want]
    d = np.concatenate([np.abs(g[3] - w[3]) for g, w in zip(got, want)
                        if g[3] is not None])
    return int(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def reads_bam(tmp_path_factory):
    rng = np.random.default_rng(31)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(1500, 2500)),
                               flag=16 if i % 2 else 4) for i in range(5)]
    path = str(tmp_path_factory.mktemp("bf16") / "in.bam")
    write_bam(path, recs)
    return path


@pytest.mark.parametrize("gather_impl", ["pallas", "slice"])
def test_bf16_engine_within_band(tmp_path, reads_bam, gather_impl):
    """The port's bf16 run against its float32 run and against the JAX
    engine's bf16 run on the same path (pallas in interpret mode), with a
    forced flush schedule."""
    kw = dict(site_batch=256, buffer_bases=1 << 14, flush_bases=4096,
              gather_impl=gather_impl)
    out = {}
    for dt in ("float32", "bfloat16"):
        out[dt] = str(tmp_path / f"{dt}.bam")
        run_call(reads_bam, out[dt], CallConfig(device="cpu", compute_dtype=dt,
                                                **kw))
    jax_out = {}
    for dt in ("float32", "bfloat16"):
        jax_out[dt] = str(tmp_path / f"jax.{dt}.bam")
        jax_run_call(reads_bam, jax_out[dt], JaxCallConfig(compute_dtype=dt,
                                                           **kw))
    bf16 = _tags(out["bfloat16"])
    vs_f32 = _band(bf16, _tags(out["float32"]))
    vs_jax = _band(bf16, _tags(jax_out["bfloat16"]))
    jax_own = _band(_tags(jax_out["bfloat16"]), _tags(jax_out["float32"]))
    print(f"{gather_impl}: bf16 vs f32 {vs_f32}, vs JAX bf16 {vs_jax}, "
          f"JAX bf16 vs f32 {jax_own}")
    assert 0 < vs_f32[0] <= BAND_MAX and vs_f32[1] <= 1.1 * jax_own[1]
    assert vs_jax[0] <= BAND_MAX and vs_jax[1] <= BAND_MEAN


def test_fused_ignores_bf16_with_warning(tmp_path, reads_bam, capfd):
    kw = dict(device="cpu", site_batch=256, gather_impl="fused",
              contexts=("CpG", "CHH"))
    eng = CallEngine(CallConfig(compute_dtype="bfloat16", **kw))
    assert "no effect with gather_impl=fused" in capfd.readouterr().err
    assert eng.cfg.compute_dtype == "float32"
    out = {}
    for dt in ("float32", "bfloat16"):
        out[dt] = str(tmp_path / f"{dt}.bam")
        run_call(reads_bam, out[dt], CallConfig(compute_dtype=dt, **kw))
    got, want = _tags(out["bfloat16"]), _tags(out["float32"])
    assert len(got) == len(want) and all(
        a[:3] == b[:3] and np.array_equal(a[3], b[3])
        for a, b in zip(got, want))
    with pytest.raises(ValueError, match="compute_dtype"):
        CallEngine(CallConfig(device="cpu", compute_dtype="float16"))


def test_cli_accepts_new_call_options(tmp_path):
    from hifimeth_tpu_torch.cli import main

    out = str(tmp_path / "cli.bam")
    stats = str(tmp_path / "stats.json")
    assert main(["call", "--device", "cpu", "-s", "512", "-c", "cpg",
                 "--dtype", "bf16", "--sync-emit", "--decode-workers", "2",
                 "--stats-json", stats,
                 os.path.join(DATA, "golden_call_in.bam"), out]) == 0
    with open(stats) as f:
        cfg = json.load(f)["config"]
    assert cfg["compute_dtype"] == "bfloat16"
    assert cfg["async_emit"] is False and cfg["decode_workers"] == 2
    assert any(r.get_tag("MM") is not None for r in BamReader(out))
    for bad in (["--dtype", "f16"], ["--decode-workers", "x"]):
        with pytest.raises(SystemExit):
            main(["call", "--device", "cpu", *bad, "a.bam", "b.bam"])
