"""Window gather: the port's plain group_windows_t against the JAX package's
Pallas kernel run in interpret mode, sliced to [:kmer] and, for the reverse
strand, flipped and channel-permuted as call_sites_pallas does
(hifimeth_tpu/features/windows.py:308-312).  A pure copy, so bit-equal in
float32 and in bfloat16 (both round to nearest even).  The CUDA kernel is
held against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hifimeth_tpu.features.windows import REV_CHANNEL_PERM as JAX_PERM
from hifimeth_tpu.ops.gather import CHUNK_LANES as JAX_CHUNK
from hifimeth_tpu.ops.gather import group_windows_t as jax_gather
from hifimeth_tpu.ops.gather import plan_groups as jax_plan
from hifimeth_tpu_torch.io import native
from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP, PLAN_EXTENT,
                                           REV_CHANNEL_PERM, check_plan,
                                           group_windows_t, plan_groups)

KMER = 401
N = 8192


def _plan(starts):
    bases, rels, _ = plan_groups(starts, GROUP, BLOCK_LANES, KMER, N,
                                 extent=PLAN_EXTENT)
    b128 = (bases // 128) * 128
    rels = rels + (bases - b128)[:, None]
    # two padded groups (base 0, rels 0) as the engine appends them
    b128 = np.concatenate([b128, np.zeros(2, np.int32)])
    rels = np.concatenate([rels, np.zeros((2, GROUP), np.int32)])
    return b128.astype(np.int32), rels.astype(np.int32)


def _starts(rng):
    # dense sorted sites plus a cluster at the table's end, whose bases
    # clip to N - BLOCK_LANES; the engine keeps a read's last window start
    # at or below N - (kmer + kmer//2 + 1) (margin + half window)
    a = np.sort(rng.integers(0, 3000, 150))
    b = np.sort(rng.integers(N - 602 - 300, N - 602, 40))
    return np.concatenate([a, b]).astype(np.int32)


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_bit_equal_to_pallas(rev, dtype):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((8, N)).astype(np.float32)
    bases, rels = _plan(_starts(rng))
    assert bases[:-2].max() == N - BLOCK_LANES          # a clipped base
    check_plan(bases, rels, N, KMER)
    w = jax_gather(jnp.asarray(table), jnp.asarray(bases), jnp.asarray(rels),
                   interpret=True, out_dtype=getattr(jnp, dtype))[:, :, :KMER]
    if rev:
        w = jnp.flip(w, axis=2)[:, jnp.asarray(JAX_PERM), :]
    want = np.asarray(w.astype(jnp.float32))
    got = group_windows_t(torch.from_numpy(table), torch.from_numpy(bases),
                          torch.from_numpy(rels), rev=rev, kmer=KMER,
                          out_dtype=getattr(torch, dtype))
    assert got.shape == (len(bases) * GROUP, 8, KMER)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert group_windows_t.launches == 0        # CPU tensors: plain version


def test_rev_perm_matches_jax():
    assert tuple(int(v) for v in JAX_PERM) == REV_CHANNEL_PERM


@pytest.mark.parametrize("case", ["dense", "split", "tail"])
def test_plan_groups_equals_jax(case):
    rng = np.random.default_rng(5)
    if case == "dense":
        starts = np.sort(rng.integers(0, 20000 - KMER, 1000))
    elif case == "split":       # gaps wider than a block force greedy cuts
        starts = np.sort(np.concatenate([rng.integers(0, 500, 45),
                                         rng.integers(5000, 5600, 70),
                                         rng.integers(9000, 9100, 3)]))
    else:
        starts = np.sort(rng.integers(20000 - 2000, 20000 - KMER, 77))
    starts = starts.astype(np.int32)
    assert PLAN_EXTENT == JAX_CHUNK + 127
    got = plan_groups(starts, GROUP, BLOCK_LANES, KMER, 20000,
                      extent=PLAN_EXTENT)
    want = jax_plan(starts, GROUP, BLOCK_LANES, KMER, 20000,
                    extent=JAX_CHUNK + 127)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert (got[2] is not None) == (case == "split")
    fast = native.plan_groups_fast(starts, GROUP, BLOCK_LANES, PLAN_EXTENT,
                                   20000)
    if fast is not None:        # the native planner serves the same sites
        b, r, idx = fast
        check_plan(b, r, 20000, KMER)
        slots = (b.astype(np.int64)[:, None] + r).ravel()
        if idx is None:
            np.testing.assert_array_equal(slots[:len(starts)], starts)
        else:
            np.testing.assert_array_equal(slots, starts[idx.ravel()])


def test_wrapper_rejects_bad_inputs():
    t = torch.zeros(8, 4096)
    b = torch.zeros(2, dtype=torch.int32)
    r = torch.zeros(2, GROUP, dtype=torch.int32)
    with pytest.raises(ValueError):
        group_windows_t(t.double(), b, r)
    with pytest.raises(ValueError):
        group_windows_t(t[:4], b, r)
    with pytest.raises(ValueError):
        group_windows_t(t, b.long(), r)
    with pytest.raises(ValueError):
        group_windows_t(t, b, r[:1])
    with pytest.raises(ValueError):
        group_windows_t(t, b, r, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        group_windows_t(t[:, ::2], b, r)
    with pytest.raises(ValueError):
        check_plan(np.array([4000], np.int32), np.zeros((1, GROUP), np.int32),
                   4096, KMER)
    with pytest.raises(ValueError):
        check_plan(np.zeros(1, np.int32),
                   np.array([[0] * 31 + [1700]], np.int32), 4096, KMER)
