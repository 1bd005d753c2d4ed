"""`import-model`: convert reference ONNX models to .npz parameter files.

Users migrating from the reference tool point this at its models/ directory
(CpG.onnx, CHG.onnx and CHH.onnx, cf. reference mod_main.cpp:69-98); the
inference params are written as <ctx>.npz next to a kmer.txt, the layout
`call -m DIR` reads.  The same files as the JAX package's import_models.
"""
from __future__ import annotations

import os

from ..constants import CONTEXTS, KMER_SIZE
from ..model.cnn import load_reference_onnx, save_params_npz
from ..utils.logging import log


def import_models(src_dir: str, dst_dir: str, contexts=CONTEXTS) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    for ctx in contexts:
        src = os.path.join(src_dir, f"{ctx}.onnx")
        if not os.path.exists(src):
            log("skip %s: %s not found", ctx, src)
            continue
        params = load_reference_onnx(src)
        dst = os.path.join(dst_dir, f"{ctx}.npz")
        save_params_npz(dst, params)
        n = sum(int(p["w"].size + p["b"].size) for p in params["convs"])
        n += int(params["fc1"]["w"].size + params["fc1"]["b"].size)
        n += int(params["fc2"]["w"].size + params["fc2"]["b"].size)
        log("imported %s -> %s (%d params)", src, dst, n)
    kmer_src = os.path.join(src_dir, "kmer.txt")
    kmer = KMER_SIZE
    if os.path.exists(kmer_src):
        with open(kmer_src) as f:
            kmer = int(f.read().strip())
    with open(os.path.join(dst_dir, "kmer.txt"), "w") as f:
        f.write(f"{kmer}\n")
