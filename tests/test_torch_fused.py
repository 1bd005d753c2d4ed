"""The fused path: the port's plain fused_forward against the JAX package's
Pallas fused_forward run in interpret mode, and `call --gather-impl fused`
against the JAX engine's fused path.

Tolerances: logits within 2e-3 absolute and u8 probabilities within +-1,
the JAX package's own tolerance for its fused kernel
(tests/test_fused.py:83), because the sums are taken in another order.
Engine outputs meet the parity contract (docs/PARITY.md): MM/MN byte-equal,
ML within +-1 with at most 5% of ML bytes off.  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu.features.windows import featurize_planes_t
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu.model.cnn import logits_to_scaled_probs as jax_probs
from hifimeth_tpu.ops.fused import fused_forward as jax_fused
from hifimeth_tpu.ops.fused import prepare_fused_params as jax_prepare
from hifimeth_tpu.ops.fused import reverse_table
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.model.cnn import (DNAModNet, load_model_npz,
                                          logits_to_scaled_probs,
                                          params_from_jax)
from hifimeth_tpu_torch.ops.fused import (FusedWeights, call_sites_fused,
                                          fused_forward, fused_params_from_jax,
                                          prepare_fused_params)
from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP,
                                           group_windows_t_plain)

from test_torch_call import _assert_contract, _tags
from util import make_kinetics_read, write_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
DATA = os.path.join(ROOT, "tests", "data")
KMER = 401
CAP = 1 << 14
CPU = torch.device("cpu")


def _table(seed):
    """(8, CAP) table featurized by the JAX package from random planes with
    the engine's zero-feature margins at both ends."""
    rng = np.random.default_rng(seed)
    planes = np.zeros((5, CAP), np.uint8)
    planes[0].fill(255)
    lo, hi = KMER + 16, CAP - KMER - 16
    planes[0, lo:hi] = rng.integers(0, 4, hi - lo)
    planes[1:, lo:hi] = rng.integers(0, 256, (4, hi - lo))
    return rng, np.array(featurize_planes_t(jnp.asarray(planes)))


def _clustered_starts(rng, n_groups):
    """GROUP sorted window starts per group, clustered as real sites are
    (each group fits one 2048-lane block), in the table's interior."""
    span = 1200
    anchors = np.linspace(KMER + 24, CAP - 2 * KMER - span, n_groups)
    return np.concatenate([np.sort(int(a) + rng.choice(span, GROUP, False))
                           for a in anchors]).astype(np.int32)


def _plan(starts, n_cols):
    """One block per group: 128-aligned base of the group's first start,
    clipped to keep the block inside the table (ops/gather.plan_groups)."""
    g = starts.reshape(-1, GROUP)
    bases = np.minimum(g.min(axis=1) // 128 * 128, n_cols - BLOCK_LANES)
    return bases.astype(np.int32), (g - bases[:, None]).astype(np.int32)


@pytest.fixture(scope="module", params=["CpG", "CHH"])
def model(request):
    """(ctx, JAX params, the port's FusedWeights, the port's DNAModNet)."""
    params = jax_load(os.path.join(MODELS, f"{request.param}.npz"))
    module = DNAModNet.from_state_dict(params_from_jax(params))
    return request.param, params, fused_params_from_jax(params), module


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    d = (np.asarray(jax_probs(jnp.asarray(want))).astype(int)
         - logits_to_scaled_probs(torch.from_numpy(got)).numpy().astype(int))
    assert np.abs(d).max() <= 1


def _jax_fused_logits(params, feats, starts, rev):
    """The JAX package's fused kernel in interpret mode on the windows at
    `starts`.  It has no reverse mode: it reads the pre-reversed table at
    mirrored starts, reordered back to the forward sites' order
    (tests/test_fused.py:91-112)."""
    prep = jax_prepare(params)
    if not rev:
        bases, rels = _plan(starts, CAP)
        return np.asarray(jax_fused(prep, jnp.asarray(feats),
                                    jnp.asarray(bases), jnp.asarray(rels),
                                    interpret=True))[:, :2]
    mirrored = (CAP - 1 - (starts.astype(np.int64) + KMER - 1))
    order = np.argsort(mirrored, kind="stable")
    mb, mr = _plan(mirrored[order].astype(np.int32), CAP)
    rows = np.asarray(jax_fused(prep, reverse_table(jnp.asarray(feats)),
                                jnp.asarray(mb), jnp.asarray(mr),
                                interpret=True))[:, :2]
    want = np.empty_like(rows)
    want[order] = rows
    return want


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_plain_matches_jax_fused(model, rev):
    """(a) forward and (b) reverse strand."""
    _, params, weights, _ = model
    rng, feats = _table(seed=3)
    starts = _clustered_starts(rng, n_groups=3)
    bases, rels = _plan(starts, CAP)
    got = fused_forward(weights, torch.from_numpy(feats),
                        torch.from_numpy(bases), torch.from_numpy(rels),
                        rev=rev).numpy()
    assert got.shape == (len(starts), 2)
    _close(got, _jax_fused_logits(params, feats, starts, rev))
    assert fused_forward.launches == 0          # CPU tensors: plain version


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as cvt.rna.tf32.f32 rounds: 10 mantissa bits kept,
    ties away from zero (add half an ulp of TF32 to the magnitude bits,
    clear the 13 dropped bits)."""
    bits = x.contiguous().view(torch.int32).numpy().view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(bits.view(np.float32).copy())


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tensor_core_forward(weights, x, passes):
    """The packed network as the kernel computes it: bn0 and fc2 in float32,
    every conv and fc1 product from TF32 operands, as the 3-term split sum
    lo*hi + hi*lo + hi*hi (passes=3) or as one TF32 pass (passes=1).  A
    product of two TF32 values is exact in float32, so float32 convolutions
    of the split operands emulate the tensor cores up to the order of the
    sums."""
    t = weights.tensor

    def product(op, a, w):
        (ah, al), (wh, wl) = _split(a), _split(w)
        if passes == 1:
            return op(ah, wh)
        return op(al, wh) + op(ah, wl) + op(ah, wh)

    h = x * t("bn0.scale")[:, None] + t("bn0.shift")[:, None]
    for i in range(8):
        w = t(f"convs.{i}.w").permute(2, 1, 0).contiguous()
        h = F.relu(product(lambda a, b: F.conv1d(a, b, stride=2, padding=1),
                           h, w) + t(f"convs.{i}.b")[:, None])
    h = F.relu(product(torch.matmul, h.flatten(1).contiguous(),
                       t("fc1.w").contiguous()) + t("fc1.b"))
    return h @ t("fc2.w") + t("fc2.b")


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_3xtf32_matches_jax_fused(model, rev):
    """The CUDA kernel's arithmetic (3xTF32 on the tensor cores) holds the
    fused path's tolerance against the JAX fused kernel on the inputs of
    test_plain_matches_jax_fused.  The single-pass TF32 error is printed,
    not asserted."""
    ctx, params, weights, _ = model
    rng, feats = _table(seed=3)
    starts = _clustered_starts(rng, n_groups=3)
    bases, rels = _plan(starts, CAP)
    x = group_windows_t_plain(torch.from_numpy(feats),
                              torch.from_numpy(bases),
                              torch.from_numpy(rels), rev, KMER,
                              torch.float32)
    want = _jax_fused_logits(params, feats, starts, rev)
    with torch.inference_mode():
        got = _tensor_core_forward(weights, x, passes=3).numpy()
        one = _tensor_core_forward(weights, x, passes=1).numpy()
    _close(got, want)
    du8 = np.abs(np.asarray(jax_probs(jnp.asarray(want))).astype(int)
                 - logits_to_scaled_probs(torch.from_numpy(one)).numpy()
                 .astype(int))
    print(f"{ctx} rev={rev}: 3xTF32 max |logit err| "
          f"{np.abs(got - want).max():.3g}; single-pass TF32 max |logit err|"
          f" {np.abs(one - want).max():.3g}, max u8 diff {du8.max()}")


@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_padded_and_clipped_groups(model, rev):
    """(c) Padded groups (base 0, rels 0) read the zero margin and give the
    logits of an all-zero window; a group at the table's end has its base
    clipped to n_cols - BLOCK_LANES, which pushes rel to 1446.  Both equal
    the port's DNAModNet on the same windows."""
    _, _, weights, module = model
    rng, feats = _table(seed=5)
    end = np.sort(rng.choice(np.arange(CAP - 602 - 60, CAP - 602), GROUP,
                             False)).astype(np.int32)
    end[-1] = CAP - 602                          # the last packable start
    bases, rels = _plan(end, CAP)
    assert bases[0] == CAP - BLOCK_LANES and rels.max() == 1446
    bases = np.concatenate([bases, np.zeros(2, np.int32)])
    rels = np.concatenate([rels, np.zeros((2, GROUP), np.int32)])
    table = torch.from_numpy(feats)
    b, r = torch.from_numpy(bases), torch.from_numpy(rels)
    got = fused_forward(weights, table, b, r, rev=rev)
    with torch.inference_mode():
        want = module(group_windows_t_plain(table, b, r, rev, KMER,
                                            torch.float32))
        zero = module(torch.zeros(1, 8, KMER))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[GROUP:].numpy(),
                               zero.expand(2 * GROUP, 2).numpy(),
                               rtol=0, atol=1e-4)
    probs = call_sites_fused(weights, table, b, r, rev)
    assert probs.dtype == torch.uint8 and probs.shape == (3 * GROUP,)
    np.testing.assert_array_equal(probs.numpy(),
                                  logits_to_scaled_probs(got).numpy())


def _state(ctx="CpG"):
    return params_from_jax(jax_load(os.path.join(MODELS, f"{ctx}.npz")))


def _drop_conv(sd):
    return {k: v for k, v in sd.items() if not k.startswith("convs.7.")}


def _conv1_k9(sd):
    sd["convs.0.weight"] = sd["convs.0.weight"][:, :, :9]
    return sd


def _stride1(sd):
    sd["convs.3.geometry"] = torch.tensor([1, 1, 1])
    return sd


def _fc1_wide(sd):
    sd["fc1.weight"] = torch.zeros(256, 192)
    return sd


@pytest.mark.parametrize("mutate", [_drop_conv, _conv1_k9, _stride1,
                                    _fc1_wide])
def test_prepare_rejects_other_geometry(mutate):
    """(d) The packer takes only the geometry the kernel computes."""
    with pytest.raises(ValueError):
        prepare_fused_params(mutate(_state()), CPU)


def _bad_inputs():
    t = torch.zeros(8, 4096)
    b = torch.zeros(2, dtype=torch.int32)
    r = torch.zeros(2, GROUP, dtype=torch.int32)
    meta = torch.device("meta")
    return {
        "dtype": (t.double(), b, r),
        "shape": (t[:4], b, r),
        "bases-dtype": (t, b.long(), r),
        "rels-shape": (t, b, r[:1]),
        "contiguity": (t[:, ::2], b, r),
        "device": (t, b.to(meta), r.to(meta)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(case):
    """(d) The wrapper checks dtype, shape, device and contiguity."""
    weights = prepare_fused_params(_state(), CPU)
    with pytest.raises(ValueError):
        fused_forward(weights, *_bad_inputs()[case])


@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_weight_carry_matches_npz_loader(ctx):
    """(e) JAX params -> packed weights equals packing the port's own npz
    model; the packed buffer reads back the module's tensors."""
    a = fused_params_from_jax(jax_load(os.path.join(MODELS, f"{ctx}.npz")))
    module = load_model_npz(os.path.join(MODELS, f"{ctx}.npz"), CPU)
    b = prepare_fused_params(module)
    assert isinstance(b, FusedWeights) and b.buf.device == CPU
    assert torch.equal(a.buf, b.buf) and a.layout == b.layout
    np.testing.assert_array_equal(a.meta, b.meta)
    k1 = 13 if ctx == "CHH" else 11
    assert b.lengths[0] == (KMER + 2 - k1) // 2 + 1 and b.lengths[-1] == 2
    assert torch.equal(b.tensor("convs.1.w").permute(2, 1, 0),
                       module.convs[1].weight.detach())
    assert torch.equal(b.tensor("fc1.w").t(), module.fc1.weight.detach())
    assert b.flops_per_window() == (22_881_280 if k1 == 13 else 22_297_600)


def _split_halves(w, name, plain, kc):
    """The (2, K padded to whole chunks, N) hi and lo halves of the split
    copy `name`, read back out of the buffer's chunks of kc K-rows, each
    half in wgmma's core-matrix order [k // 4][n // 8][n % 8][k % 4]; checks
    them against TF32 hi = rna(w) and lo = rna(w - hi) of the exact copy
    `plain` (rounded as cvt.rna.tf32.f32 rounds, by the test's own
    bit-level rounding), zeros in the padding, and hi + lo within 2^-21 of
    the weight."""
    off, shape, got_kc = w.layout[name]
    assert got_kc == kc and off % 4 == 0 and shape == w.layout[plain][1]
    want = w.tensor(plain).reshape(-1, shape[-1])
    k, n = want.shape
    kp = -(-k // kc) * kc
    chunks = w.buf[off:off + 2 * kp * n].view(kp // kc, 2, kc // 4, n // 8,
                                                 8, 4)
    # (chunk, half, k // 4, n // 8, n % 8, k % 4) -> (half, K, N)
    halves = chunks.permute(1, 0, 2, 5, 3, 4).reshape(2, kp, n)
    hi, lo = halves[0, :k], halves[1, :k]
    assert torch.equal(hi, _tf32(want))
    assert torch.equal(lo, _tf32(want - hi))
    assert not halves[:, k:].any()
    assert ((hi + lo - want).abs() <= want.abs() * 2.0 ** -21).all()
    return halves


def test_weights_packed_in_k_major_chunks():
    """conv5-conv8 and fc1, which the tail kernel runs on mma.sync, are
    packed like conv1-conv4: K-major chunks of kc K-rows (K = taps x Cin,
    tap-major; 32, and 8 for fc1) split into TF32 halves, beside the exact
    weights the CPU path reads; the chunk depths and offsets are what
    `meta` tells the kernel."""
    module = load_model_npz(os.path.join(MODELS, "CHH.npz"), CPU)
    w = prepare_fused_params(module)
    assert len(w.meta) == 11 + 8 * 8
    assert w.layout["convs.4.w"][2] == 0 and w.layout["fc1.w"][2] == 0
    for name, kc in {"convs.4": 32, "convs.5": 32, "convs.6": 32,
                     "convs.7": 32, "fc1": 8}.items():
        _split_halves(w, f"{name}.split", f"{name}.w", kc)
    conv5 = module.convs[4].weight.detach()             # (Cout, Cin, K)
    halves = _split_halves(w, "convs.4.split", "convs.4.w", 32)
    # K-rows 128..159 (chunk 4): tap 1, input channels 32..63
    assert torch.equal(halves[0, 128:160], _tf32(conv5[:, 32:64, 1].t()))
    meta = w.meta.tolist()
    assert meta[3:8] == [w.layout["fc1.split"][0], w.layout["fc1.b"][0], 128,
                         256, 8]
    assert meta[11:19] == [13, 8, 128, KMER, 196,
                           w.layout["convs.0.split"][0],
                           w.layout["convs.0.b"][0], 32]
    assert meta[11 + 4 * 8:11 + 5 * 8] == [
        3, 96, 96, 25, 13, w.layout["convs.4.split"][0],
        w.layout["convs.4.b"][0], 32]


def test_head_weights_split_into_tf32_halves():
    """conv1-conv4, which the kernel runs on wgmma, are packed as chunks of
    32 K-rows split into TF32 halves in wgmma's core-matrix order; conv1's
    K is zero-padded to whole chunks."""
    module = load_model_npz(os.path.join(MODELS, "CHH.npz"), CPU)
    w = prepare_fused_params(module)
    for i, (taps, cin, cout) in enumerate([(13, 8, 128), (3, 128, 128),
                                           (3, 128, 128), (3, 128, 96)]):
        assert w.layout[f"convs.{i}.w"][1] == (taps, cin, cout)
        halves = _split_halves(w, f"convs.{i}.split", f"convs.{i}.w", 32)
        assert halves.shape[1] == -(-taps * cin // 32) * 32   # conv1: 128


def test_call_fused_matches_jax_fused_and_pallas(tmp_path):
    """(f) Multi-flush synthetic input with reverse-strand reads: the port's
    fused path against the JAX engine's fused path, and against the port's
    own pallas path."""
    rng = np.random.default_rng(11)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(1500, 2600)),
                               flag=16 if i % 2 else 4)
            for i in range(5)]
    recs.insert(2, make_kinetics_read(rng, "short", 300))
    bam = str(tmp_path / "in.bam")
    write_bam(bam, recs)
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        site_batch=128, gather_impl="fused", buffer_bases=CAP))
    outs = {}
    for impl in ("fused", "pallas"):
        outs[impl] = str(tmp_path / f"{impl}.bam")
        stats = run_call(bam, outs[impl], CallConfig(
            site_batch=128, buffer_bases=CAP, flush_bases=4096,
            device="cpu", gather_impl=impl))
        assert stats["called_reads"] == 5
    read = [(lambda p: [(r.qname, *_tags(r)) for r in BamReader(p)])(p)
            for p in (outs["fused"], jax_out, outs["pallas"])]
    _assert_contract(read[0], read[1])
    _assert_contract(read[0], read[2])


@pytest.mark.parametrize("impl,match", [
    ("slice", None), ("folded", None), ("bogus", "unknown gather_impl")])
def test_config_rejects_unported_gathers(impl, match):
    """(g) The JAX package's XLA gather paths are ported and kept as asked;
    an unknown name still raises."""
    cfg = CallConfig(device="cpu", gather_impl=impl)
    if match is None:
        assert CallEngine(cfg).cfg.gather_impl == impl
        return
    with pytest.raises(ValueError, match=match):
        CallEngine(cfg)


def test_fused_rejects_other_kmer(tmp_path):
    """(g) The fused kernel computes 401-lane windows only."""
    for ctx in ("CpG", "CHG", "CHH"):
        shutil.copy(os.path.join(MODELS, f"{ctx}.npz"), tmp_path)
    (tmp_path / "kmer.txt").write_text("201\n")
    cfg = CallConfig(device="cpu", gather_impl="fused",
                     model_dir=str(tmp_path))
    with pytest.raises(ValueError, match="kmer=401"):
        CallEngine(cfg)
    engine = CallEngine(CallConfig(device="cpu", gather_impl="auto",
                                   model_dir=str(tmp_path)))
    assert engine.cfg.gather_impl == "pallas" and not engine.models.fused


def test_cli_gather_impl_fused_on_cpu(tmp_path, capsys):
    """(g) `call --gather-impl fused --device cpu` through the CLI."""
    from hifimeth_tpu_torch.cli import main

    out = str(tmp_path / "cli.bam")
    assert main(["call", "--device", "cpu", "--gather-impl", "fused", "-s",
                 "512", "-c", "cpg,chh",
                 os.path.join(DATA, "golden_call_in.bam"), out]) == 0
    assert "gather_impl" in capsys.readouterr().err
    recs = list(BamReader(out))
    assert len(recs) == 12
    assert any(r.get_tag("MM") is not None for r in recs)
    with pytest.raises(SystemExit, match="slice"):
        main(["call", "--gather-impl", "bogus", "a.bam", "b.bam"])
