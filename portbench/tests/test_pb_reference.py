"""The plain reference against the port, on the CPU at small sizes, and
the reference's independence from the program."""
import ast
import os

import numpy as np
import pytest
import torch

from portbench import catalog, check, harness, inputs
from portbench.reference import hifimeth as ref

REF_DIR = os.path.dirname(ref.__file__)


@pytest.mark.parametrize("traffic", ["plant-hifi", "human-hifi"])
def test_sites_match_the_port_scan(traffic):
    """The reference's site scan against the port's features/sites.py on
    every read of a small pool."""
    from hifimeth_tpu_torch.features import sites
    pool = inputs.make_pool(catalog.traffic(traffic) | {"n_reads": 6}, 3)
    got = ref.find_sites(pool.seq, pool.offsets, ref.CONTEXTS)
    for i in range(pool.n_reads):
        a, b = pool.offsets[i], pool.offsets[i + 1]
        want = sites.scan_all(pool.seq[a:b])
        for ctx in ref.CONTEXTS:
            pos, strand = got[ctx]
            m = (pos >= a) & (pos < b)
            order = np.argsort(pos[m], kind="stable")
            np.testing.assert_array_equal(pos[m][order] - a, want[ctx][0])
            np.testing.assert_array_equal(strand[m][order], want[ctx][1])


def test_windows_match_the_port_gather():
    """The reference's windows against the port's per-site gather
    (features/windows.py gather_windows) over its packed planes."""
    from hifimeth_tpu_torch.features.read_decode import decode_read
    from hifimeth_tpu_torch.features.windows import (featurize_planes,
                                                     gather_windows)
    from hifimeth_tpu_torch.io.bam import BamRecord
    pool = inputs.make_pool(catalog.traffic("plant-hifi") | {"n_reads": 2},
                            9)
    table = torch.from_numpy(ref.feature_table(pool.seq, pool.kin,
                                               pool.offsets))
    found = ref.find_sites(pool.seq, pool.offsets, ("CHH",))["CHH"]
    for i in range(pool.n_reads):
        a, b = pool.offsets[i], pool.offsets[i + 1]
        rec = BamRecord.from_bytes(memoryview(inputs.record_bytes(
            pool.name(i), *pool.read(i)))[4:])
        read = decode_read(rec)
        planes = torch.from_numpy(np.stack(
            [read.codes, read.fi, read.fp, read.ri, read.rp]))
        m = (found[0] >= a) & (found[0] < b)
        pos = torch.from_numpy(found[0][m])
        st = torch.from_numpy(found[1][m].astype(np.uint8))
        n = len(pos)
        mine = ref.windows(table, pos, st, torch.full((n,), int(a)),
                           torch.full((n,), int(b)))
        theirs = gather_windows(featurize_planes(planes), pos - int(a), st,
                                torch.zeros(n, dtype=torch.int64),
                                torch.full((n,), int(b - a)))
        assert torch.equal(mine, theirs.transpose(1, 2))


def test_net_matches_the_port_model():
    """The reference's DNAModNet against the port's model/cnn.py on the
    shipped weights, float32 on the CPU."""
    from hifimeth_tpu_torch.model.cnn import load_model_npz
    x = torch.rand(16, 8, ref.KMER, generator=torch.Generator().manual_seed(1))
    for ctx in ref.CONTEXTS:
        path = os.path.join(harness.models_dir(), f"{ctx}.npz")
        want = load_model_npz(path, "cpu")(x)
        got = ref.forward(ref.load_net(path, "cpu"), x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("contexts", [("CpG",), ref.CONTEXTS])
def test_call_pool_matches_the_port_call(contexts, tmp_path, cpu_call):
    """Every tag of the port's `call` on a small pool equals the
    reference's: MM byte for byte, each ML byte in its bin."""
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    pool = inputs.make_pool(catalog.traffic("plant-hifi") | {
        "n_reads": 3, "length": {"median": 1500, "sigma": 0.3, "min": 1000,
                                 "max": 3000}}, 21)
    s = inputs.PoolStream(inputs.encode_pool(pool), limit=pool.n_reads)
    out = str(tmp_path / "o.bam")
    run_call(s, out, CallConfig(device="cpu", contexts=contexts, **cpu_call))
    expected = ref.call_pool(pool.seq, pool.kin, pool.offsets, contexts,
                             harness.models_dir())
    v = check.compare(check.read_records(out), s.served, pool.name,
                      expected, {"ml_gap_u8": 1e-3})
    assert v["correct"], v
    for (_, mm, ml), (mm_ref, _, ml_ref) in zip(check.read_records(out),
                                                expected):
        assert mm == mm_ref
        assert np.abs(ml.astype(int) - ml_ref.astype(int)).max() <= 1


def test_mm_string():
    seq = np.frombuffer(b"ACGCCGTGG", np.uint8)
    # C at 1, 3, 4; G at 2, 5, 7, 8
    assert ref.mm_string(seq, np.array([1, 4]), np.array([7])) == \
        "C+m,0,1;G-m,2;"
    assert ref.mm_string(seq, np.array([], int), np.array([], int)) == \
        "C+m;G-m;"


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0])
    got = ref._tf32(x)
    assert got[0] == 1.0 and got[3] == -3.0
    assert got[1] == 1.0 + 2**-10          # a half rounds away from zero
    assert got[2] == 1.0 + 2**-10


def test_reference_imports_nothing_of_the_program():
    """No module under reference/ imports hifimeth_tpu_torch, hifimeth_tpu,
    jax or any other part of the benchmark."""
    for f in os.listdir(REF_DIR):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{f}: relative import"
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("__future__", "os", "numpy",
                                           "torch"), f"{f} imports {n}"
