"""Row-major window gathers: the port's group_windows, window_slices and
window_rows (plain versions, which the wrappers run on CPU tensors) against
the JAX package's Pallas kernels run in interpret mode.  All three are pure
copies, so bit-equal.  Out-of-contract starts are clamped into the table as
lax.dynamic_slice clamps them; that is pinned against numpy slices, not
against interpret mode, whose out-of-range DMA reads are an artefact of the
interpreter.  The CUDA kernels are held against the same plain versions on
the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hifimeth_tpu.ops.gather import group_windows as jax_group_windows
from hifimeth_tpu.ops.gather import window_rows as jax_window_rows
from hifimeth_tpu.ops.gather import window_slices as jax_window_slices
from hifimeth_tpu_torch.ops.gather import (ROWS_RING_BYTES, group_windows,
                                           plan_groups, window_rows,
                                           window_rows_boxes,
                                           window_rows_plain,
                                           window_rows_route, window_slices)

KMER = 401
N = 4096
GROUP = 32
BLOCK_ROWS = 1024


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(rng, n=N, c=8):
    return rng.standard_normal((n, c)).astype(np.float32)


def _plan(case, rng):
    """Position-sorted window starts and their group plan: `dense` as the
    microbenchmark draws them (~2.5 rows apart) plus a cluster whose base
    clips to N - BLOCK_ROWS; `split` with gaps wider than a block, which
    the greedy planner cuts."""
    if case == "dense":
        starts = np.concatenate([
            KMER + np.cumsum(rng.integers(1, 5, 4 * GROUP)),
            np.sort(rng.integers(N - KMER - 200, N - KMER + 1, GROUP))])
    else:
        starts = np.sort(np.concatenate([
            rng.integers(0, 300, 45), rng.integers(1500, 2100, 50),
            rng.integers(N - KMER - 50, N - KMER + 1, 3)]))
    starts = starts.astype(np.int32)
    bases, rels, idx = plan_groups(starts, GROUP, BLOCK_ROWS, KMER, N)
    assert (idx is None) == (case == "dense")
    assert bases.max() == N - BLOCK_ROWS and rels.max() <= BLOCK_ROWS - KMER
    return starts, bases, rels, idx


@pytest.mark.parametrize("case", ["dense", "split"])
def test_group_windows_bit_equal_to_pallas(case):
    rng = np.random.default_rng(11)
    feats = _table(rng)
    starts, bases, rels, idx = _plan(case, rng)
    want = np.asarray(jax_group_windows(
        jnp.asarray(feats), jnp.asarray(bases), jnp.asarray(rels), GROUP,
        BLOCK_ROWS, KMER, interpret=True))
    got = group_windows(_t(feats), _t(bases), _t(rels), GROUP, BLOCK_ROWS,
                        KMER)
    assert got.shape == (len(bases) * GROUP, KMER, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # every slot is its site's window
    slots = np.arange(len(starts)) if idx is None else idx.ravel()
    for k in (0, len(starts) // 2, len(starts) - 1):
        slot = int(np.flatnonzero(slots == k)[0])
        s = starts[k]
        np.testing.assert_array_equal(got[slot].numpy(), feats[s:s + KMER])
    assert group_windows.launches == 0          # CPU tensors: plain version


@pytest.mark.parametrize("spp", [8, 64])
def test_window_slices_bit_equal_to_pallas(spp):
    rng = np.random.default_rng(spp)
    feats = _table(rng)
    starts = rng.integers(0, N - KMER + 1, 64).astype(np.int32)
    starts[:2] = (0, N - KMER)                 # first and last legal start
    want = np.asarray(jax_window_slices(jnp.asarray(feats),
                                        jnp.asarray(starts), KMER, spp=spp,
                                        interpret=True))
    got = window_slices(_t(feats), _t(starts), KMER, spp=spp)
    assert got.shape == (64, KMER, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert window_slices.launches == 0


@pytest.mark.parametrize("strands,fetch_rows,out_rows", [
    ("mixed", 802, 401), ("fwd", 802, 401), ("rev", 64, 29)])
def test_window_rows_bit_equal_to_pallas(strands, fetch_rows, out_rows):
    rng = np.random.default_rng(fetch_rows + out_rows)
    d, dr = _table(rng), _table(rng)
    starts = rng.integers(0, N - fetch_rows + 1, 32).astype(np.int32)
    starts[0] = N - fetch_rows
    is_rev = {"mixed": rng.integers(0, 2, 32), "fwd": np.zeros(32),
              "rev": np.ones(32)}[strands].astype(np.int32)
    want = np.asarray(jax_window_rows(
        jnp.asarray(d), jnp.asarray(dr), jnp.asarray(starts),
        jnp.asarray(is_rev), fetch_rows, out_rows, interpret=True))
    got = window_rows(_t(d), _t(dr), _t(starts), _t(is_rev), fetch_rows,
                      out_rows)
    assert got.shape == (32, out_rows, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 1):
        src = dr if is_rev[i] else d
        s = starts[i]
        np.testing.assert_array_equal(got[i].numpy(),
                                      src[s:s + fetch_rows:2][:out_rows])
    assert window_rows.launches == 0


@pytest.mark.parametrize("kernel", ["group_windows", "window_slices",
                                    "window_rows"])
def test_out_of_contract_starts_clamp_into_the_table(kernel):
    """A start below 0 reads from row 0, one past the last legal start
    reads from the last legal start: lax.dynamic_slice's clamp."""
    rng = np.random.default_rng(2)
    n = 1027                                   # not a multiple of 4
    feats, other = _table(rng, n), _table(rng, n)
    if kernel == "window_slices":
        starts = np.array([-5, -1000, n - KMER + 1, 1 << 30, 7, 0, 3, 9],
                          np.int32)
        got = window_slices(_t(feats), _t(starts), KMER).numpy()
        want = [feats[min(max(s, 0), n - KMER):][:KMER] for s in starts]
    elif kernel == "window_rows":
        starts = np.array([-5, n - 802 + 3, 1 << 30, 11, -1, 0, 2, 4],
                          np.int32)
        is_rev = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
        got = window_rows(_t(feats), _t(other), _t(starts), _t(is_rev), 802,
                          401).numpy()
        want = [(other if r else feats)[min(max(s, 0), n - 802):][:802:2]
                for s, r in zip(starts, is_rev)]
    else:
        bases = np.array([-7, n - BLOCK_ROWS + 5, 100], np.int32)
        rels = rng.integers(0, BLOCK_ROWS - KMER + 1, (3, GROUP))
        rels[:, :3] = (-3, BLOCK_ROWS - KMER + 1, 1 << 20)
        rels = rels.astype(np.int32)
        got = group_windows(_t(feats), _t(bases), _t(rels), GROUP,
                            BLOCK_ROWS, KMER).numpy()
        b = np.clip(bases, 0, n - BLOCK_ROWS)
        r = np.clip(rels, 0, BLOCK_ROWS - KMER)
        want = [feats[s:s + KMER] for s in (b[:, None] + r).ravel()]
    np.testing.assert_array_equal(got, np.stack(want))


def _tma_stage(table, s, out_rows):
    """What the TMA route lands in shared memory for a site starting at
    clamped row s: window_rows_boxes' boxes of {C, R} over the table's (N //
    2, 2C) row-pair view at pair s // 2, column (s % 2) * C, rows past the
    view zero-filled."""
    c = table.shape[1]
    pairs = table[:table.shape[0] // 2 * 2].reshape(-1, 2 * c)
    n_box, r = window_rows_boxes(out_rows, c)
    stage = np.zeros((n_box * r, c), np.float32)
    p0, col = s // 2, (s % 2) * c
    got = pairs[p0:p0 + n_box * r, col:col + c]
    stage[:len(got)] = got
    return stage


@pytest.mark.parametrize("n_rows", [4096, 5003])
@pytest.mark.parametrize("fetch_rows,out_rows", [(802, 401), (64, 29)])
def test_window_rows_pair_view(n_rows, fetch_rows, out_rows):
    """The TMA route's view: rows s, s+2, ... of a table are rows s // 2,
    s // 2 + 1, ... of its (N // 2, 2C) row-pair view, half s % 2, for
    even and odd starts, the last legal start (odd for N = 5003: its last
    row, which no pair holds, is never read) and clamped ones; the boxes
    cover every stored row and what they load past the view is never
    stored."""
    rng = np.random.default_rng(n_rows + fetch_rows)
    d, dr = _table(rng, n_rows), _table(rng, n_rows)
    last = n_rows - fetch_rows
    starts = np.concatenate([[0, 1, last, last - 1, -7, last + 3],
                             rng.integers(0, last + 1, 10)]).astype(np.int32)
    is_rev = (np.arange(len(starts)) % 2).astype(np.int32)
    got = window_rows_plain(_t(d), _t(dr), _t(starts), _t(is_rev),
                            fetch_rows, out_rows).numpy()
    for i, (s, r) in enumerate(zip(starts, is_rev)):
        s = min(max(int(s), 0), last)
        t = dr if r else d
        want = t[s:s + fetch_rows:2][:out_rows]
        half = s % 2
        pairs = t[:n_rows // 2 * 2].reshape(-1, 16)
        np.testing.assert_array_equal(
            pairs[s // 2:s // 2 + out_rows, half * 8:(half + 1) * 8], want)
        np.testing.assert_array_equal(_tma_stage(t, s, out_rows)[:out_rows],
                                      want)
        np.testing.assert_array_equal(got[i], want)
    assert last + 2 * (out_rows - 1) <= n_rows - 2
    assert window_rows.launches == 0


@pytest.mark.parametrize("case,channels,out_rows,ptrs,want", [
    ("microbenchmark", 8, 401, (1 << 20, 2 << 20, 3 << 20), "tma"),
    ("4 channels", 4, 401, (0, 16, 32), "tma"),
    ("3 channels", 3, 401, (0, 16, 32), "scalar"),
    ("table 4 bytes off", 8, 401, (4, 16, 32), "scalar"),
    ("output 4 bytes off", 8, 401, (0, 16, 36), "scalar"),
    ("box wider than 256", 260, 29, (0, 16, 32), "scalar"),
    ("stage too large", 8, 1700, (0, 16, 32), "scalar"),
])
def test_window_rows_route(case, channels, out_rows, ptrs, want):
    """The route window_rows launches: TMA for whole 16-byte rows that fit
    a box, aligned pointers and two stages within ROWS_RING_BYTES; else
    scalar."""
    assert window_rows_route(channels, out_rows, *ptrs) == want


@pytest.mark.parametrize("out_rows,channels", [
    (401, 8), (29, 8), (333, 8), (256, 8), (257, 8), (401, 4), (401, 12),
    (1600, 8)])
def test_window_rows_boxes(out_rows, channels):
    """Fewest boxes of at most 256 rows that cover out_rows, each a multiple
    of 128 bytes; 401 rows of 8 channels are two boxes of 204."""
    n_box, r = window_rows_boxes(out_rows, channels)
    assert n_box == -(-out_rows // 256) and 1 <= r <= 256
    assert n_box * r >= out_rows and (n_box - 1) * r < out_rows
    assert r * channels * 4 % 128 == 0
    if (out_rows, channels) == (401, 8):
        assert (n_box, r) == (2, 204)
        assert 2 * n_box * r * channels * 4 <= ROWS_RING_BYTES


def _bad_calls():
    f = torch.zeros(2048, 8)
    s = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.int32)
    r = torch.zeros(2, GROUP, dtype=torch.int32)
    meta = torch.device("meta")
    return {
        "slices-dtype": lambda: window_slices(f.double(), s, KMER),
        "slices-starts-dtype": lambda: window_slices(f, s.long(), KMER),
        "slices-spp": lambda: window_slices(f, s[:6], KMER, spp=8),
        "slices-short-table": lambda: window_slices(f[:400], s, KMER),
        "slices-contiguity": lambda: window_slices(f[::2], s, KMER),
        "slices-device": lambda: window_slices(f.to(meta), s.to(meta), KMER),
        "rows-odd-fetch": lambda: window_rows(f, f, s, s, 801, 400),
        "rows-out-rows": lambda: window_rows(f, f, s, s, 802, 402),
        "rows-tables": lambda: window_rows(f, f[:1024], s, s, 802, 401),
        "rows-is-rev": lambda: window_rows(f, f, s, s[:4], 802, 401),
        "group-rels-shape": lambda: group_windows(f, b, r[:, :8], GROUP,
                                                  BLOCK_ROWS, KMER),
        "group-kmer": lambda: group_windows(f, b, r, GROUP, 256, KMER),
        "group-block-bytes": lambda: group_windows(
            torch.zeros(1 << 15, 8), b, r, GROUP, 1 << 14, KMER),
        "group-mixed-devices": lambda: group_windows(f, b.to(meta), r, GROUP,
                                                     BLOCK_ROWS, KMER),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_reject_bad_inputs(case):
    """The JAX arguments' contracts, as ValueError."""
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_microbenchmark_runs_every_variant_on_cpu(capsys):
    """scripts/microbench_torch_gather.py end to end at a tiny size: every
    variant runs, the kernel variants' windows pass its check against the
    plain versions, one line per variant."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from microbench_torch_gather import VARIANTS, main

    got = main(["--variants", ",".join(VARIANTS), "--nb", "2",
                "--site-batch", "64", "--rows", "8192", "--device", "cpu"])
    assert sorted(got) == sorted(VARIANTS)
    out = capsys.readouterr().out
    assert all(f"{v} " in out for v in VARIANTS)
    # the same windows by three routes: the same checksum
    assert got["fetch_slice"]["checksum"] == got["pallas_slice"]["checksum"]
    assert got["pallas_slice"]["checksum"] == got["pallas_slice64"]["checksum"]
