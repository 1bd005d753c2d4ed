"""The port's ONNX export/import and `import-model`/`export-model` against the
JAX package's.

Tolerances: none.  An export is byte-equal to the JAX package's for each
shipped model; an import gives bit-equal arrays (same dtype, same bytes) in
both packages and equal to the npz it was exported from; `import-model`
writes the same arrays and the same kmer.txt as the JAX import_models.
"""
import os

import numpy as np
import pytest

from hifimeth_tpu.model import cnn as jax_cnn
from hifimeth_tpu.model.onnx_export import export_onnx as jax_export_onnx
from hifimeth_tpu.tools.import_model import import_models as jax_import_models
from hifimeth_tpu_torch.cli import main
from hifimeth_tpu_torch.model import cnn, onnx_export
from hifimeth_tpu_torch.model.onnx_export import export_onnx
from hifimeth_tpu_torch.tools.import_model import import_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
CONTEXTS = ("CpG", "CHG", "CHH")


def _flat(params):
    return cnn.params_to_numpy(params)


def assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert g.dtype == w.dtype, k
        assert g.tobytes() == w.tobytes(), k


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_export_bytes_equal_and_import_bit_equal(ctx, tmp_path):
    """Each shipped model exported by both packages: the same bytes; the
    file imported by each package: the npz's arrays, bit for bit."""
    npz = os.path.join(MODELS, f"{ctx}.npz")
    mine, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_onnx(cnn.load_params_npz(npz), mine)
    jax_export_onnx(jax_cnn.load_params_npz(npz), theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    want = _npz_arrays(npz)
    for path in (mine, theirs):
        assert_bit_equal(_flat(cnn.load_reference_onnx(path)), want)
        assert_bit_equal(jax_cnn.params_to_numpy(
            jax_cnn.load_reference_onnx(path)), want)


def _chh_layout_onnx(params, path, kmer=401):
    """A graph in the CHH exporter's layout: every weight a Constant node
    (a tensor attribute), the FCs as MatMul + Add, a BatchNormalization
    with real statistics in front."""
    e = onnx_export
    consts = []

    def const(name, arr):
        attr = (e._str_field(1, "value") + e._len_field(5, e._tensor(name, arr))
                + e._int_field(20, 4))
        consts.append(e._node("Constant", [], [name], e._len_field(5, attr)))
        return name

    scale = np.asarray(params["bn0"]["scale"], np.float32)
    shift = np.asarray(params["bn0"]["shift"], np.float32)
    var = np.full_like(scale, 0.25)
    mean = np.linspace(-1, 1, len(scale)).astype(np.float32)
    # gamma/beta such that the folded scale/shift are the model's
    gamma = (scale * np.sqrt(var + 1e-5)).astype(np.float32)
    beta = (shift + mean * scale).astype(np.float32)
    nodes = [e._node("Transpose", ["input"], ["x_t"],
                     e._len_field(5, e._attr_ints("perm", [0, 2, 1])))]
    bn_in = [const(n, a) for n, a in (("g", gamma), ("be", beta),
                                      ("mu", mean), ("va", var))]
    nodes.append(e._node("BatchNormalization", ["x_t", *bn_in], ["h0"],
                         e._len_field(5, e._attr_float("epsilon", 1e-5))))
    h = "h0"
    for i, conv in enumerate(params["convs"]):
        w = np.ascontiguousarray(np.asarray(conv["w"]).transpose(2, 1, 0))
        wn = const(f"W{i}", w)
        bn_ = const(f"B{i}", np.asarray(conv["b"], np.float32))
        attrs = (e._len_field(5, e._attr_ints("kernel_shape", [w.shape[2]]))
                 + e._len_field(5, e._attr_ints("pads", list(conv["pad"])))
                 + e._len_field(5, e._attr_ints("strides", [conv["stride"]])))
        nodes.append(e._node("Conv", [h, wn, bn_], [f"c{i}"], attrs))
        nodes.append(e._node("Relu", [f"c{i}"], [f"r{i}"]))
        h = f"r{i}"
    nodes.append(e._node("Flatten", [h], ["flat"],
                         e._len_field(5, e._attr_int("axis", 1))))
    src = "flat"
    for i, k in enumerate(("fc1", "fc2")):
        wn = const(f"M{i}", np.asarray(params[k]["w"], np.float32))
        bn_ = const(f"A{i}", np.asarray(params[k]["b"], np.float32))
        nodes.append(e._node("MatMul", [src, wn], [f"mm{i}"]))
        dst = "output" if i else "fco1"
        nodes.append(e._node("Add", [f"mm{i}", bn_], [dst]))
        if not i:
            nodes.append(e._node("Relu", ["fco1"], ["fcr1"]))
            src = "fcr1"
    graph = b"".join(e._len_field(1, n) for n in consts + nodes)
    graph += e._str_field(2, "chh-layout")
    graph += e._len_field(11, e._value_info("input", ["B", kmer, 8]))
    graph += e._len_field(12, e._value_info("output", ["B", 2]))
    model = (e._int_field(1, 6) + e._len_field(7, graph)
             + e._len_field(8, e._str_field(1, "") + e._int_field(2, 11)))
    with open(path, "wb") as f:
        f.write(model)
    return gamma, beta, mean, var


def test_chh_layout_imports_equal(tmp_path):
    """Constant-node weights and MatMul/Add FCs: both packages import the
    same params, the model's own (bn0 folded from its statistics)."""
    params = cnn.load_params_npz(os.path.join(MODELS, "CHH.npz"))
    path = str(tmp_path / "chh.onnx")
    gamma, beta, mean, var = _chh_layout_onnx(params, path)
    got = _flat(cnn.load_reference_onnx(path))
    assert_bit_equal(got, jax_cnn.params_to_numpy(
        jax_cnn.load_reference_onnx(path)))
    want = _flat(params)
    scale, shift = cnn.fold_batchnorm(gamma, beta, mean, var, 1e-5)
    want["bn0.scale"], want["bn0.shift"] = scale, shift
    assert_bit_equal(got, want)
    np.testing.assert_allclose(scale, params["bn0"]["scale"], rtol=1e-6)
    np.testing.assert_allclose(shift, params["bn0"]["shift"], rtol=1e-5,
                               atol=1e-6)


def test_fold_batchnorm_equal():
    rng = np.random.default_rng(0)
    g, b, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    v = rng.random(8).astype(np.float32)
    for got, want in zip(cnn.fold_batchnorm(g, b, m, v, 1e-5),
                         jax_cnn.fold_batchnorm(g, b, m, v, 1e-5)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kmer_txt", [None, "81\n"])
def test_import_model_matches_jax(tmp_path, kmer_txt):
    """import-model over a directory of the three exported models (with
    and without kmer.txt; CHG missing once): the JAX import_models' arrays
    and kmer.txt."""
    src = tmp_path / "onnx"
    src.mkdir()
    ctxs = CONTEXTS if kmer_txt is None else ("CpG", "CHH")
    for ctx in ctxs:
        export_onnx(cnn.load_params_npz(os.path.join(MODELS, f"{ctx}.npz")),
                    str(src / f"{ctx}.onnx"))
    if kmer_txt is not None:
        (src / "kmer.txt").write_text(kmer_txt)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    import_models(str(src), str(mine))
    jax_import_models(str(src), str(theirs))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    assert (mine / "kmer.txt").read_text() == (theirs / "kmer.txt").read_text()
    for ctx in ctxs:
        assert_bit_equal(_npz_arrays(mine / f"{ctx}.npz"),
                         _npz_arrays(theirs / f"{ctx}.npz"))
        assert_bit_equal(_npz_arrays(mine / f"{ctx}.npz"),
                         _npz_arrays(os.path.join(MODELS, f"{ctx}.npz")))


def test_save_params_npz_loads_in_both(tmp_path):
    params = cnn.load_params_npz(os.path.join(MODELS, "CpG.npz"))
    path = str(tmp_path / "m.npz")
    cnn.save_params_npz(path, params)
    assert_bit_equal(_npz_arrays(path), _npz_arrays(os.path.join(MODELS,
                                                                 "CpG.npz")))
    assert_bit_equal(jax_cnn.params_to_numpy(jax_cnn.load_params_npz(path)),
                     _flat(params))


def test_cli_export_and_import_model(tmp_path, capsys):
    onnx = tmp_path / "CHG.onnx"
    assert main(["export-model", os.path.join(MODELS, "CHG.npz"),
                 str(onnx)]) == 0
    out = tmp_path / "imported"
    assert main(["import-model", str(tmp_path), str(out)]) == 0
    assert_bit_equal(_npz_arrays(out / "CHG.npz"),
                     _npz_arrays(os.path.join(MODELS, "CHG.npz")))
    assert (out / "kmer.txt").read_text() == "401\n"
    capsys.readouterr()
    assert main(["export-model", str(onnx)]) == 1
    assert main(["import-model", str(tmp_path)]) == 1
    assert "USAGE" in capsys.readouterr().err
