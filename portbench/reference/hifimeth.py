"""Plain reference of HiFiMeth's read-level `call`, in NumPy and PyTorch.

What the published tool (xiaochuanle/hifimeth v1.1.0) computes for one
unmapped HiFi read with kinetics, written from its description and kept
apart from the program under test (it imports nothing of it):

1. candidate sites on the read's forward sequence: CpG at every C of a
   "CG"; CHG at every C of C[ACT]G; CHH at every C of C[ACT][ACT] (forward
   strand) and at every G of [AGT][AGT]G (reverse strand).  CpG and CHG
   are called on the forward strand only;
2. each site's window of 401 bases centred on it, 8 features a base: the
   one-hot base (A, C, G, T) and the same-strand IPD and PW and the
   opposite-strand IPD and PW, each codeV1 byte decoded to frames and
   divided by 952.  ri and rp are stored in the reverse strand's order, so
   base p of a read of length L has ri[L - 1 - p].  A reverse-strand
   window runs from the right end to the left, with complemented bases and
   (ri, rp) as the same-strand pair.  Positions outside the read are 0;
3. DNAModNet in float32: the input BatchNorm (folded to a scale and shift
   per channel), 8 stride-2 convolutions each followed by ReLU, flatten
   channel-major, FC 256, ReLU, FC 2;
4. ML = min(255, floor(255 * softmax(logits)[1])), one byte a site;
5. MM = "C+m" followed by ",<d>" for each forward call and "G-m" followed
   by ",<d>" for each reverse call, each series sorted by position and
   ended by ";", where d counts the bases of the series (C, or G) skipped
   since the previous call; ML holds the forward calls' bytes then the
   reverse calls'.

The weights come from the shipped `models/<context>.npz` files, read here
with NumPy.  `precision="tf32"` computes the convolutions and products
with TF32 operands, the lower precision the control of `correct` uses: on
the card through PyTorch's TF32 switches, on the CPU by rounding every
operand to TF32's 10 mantissa bits.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

KMER = 401
CONTEXTS = ("CpG", "CHG", "CHH")
#: channel order of a reverse-strand window: bases complemented (A<->T,
#: C<->G), kinetics (fi, fp, ri, rp) -> (ri, rp, fi, fp)
REV_PERM = (3, 2, 1, 0, 6, 7, 4, 5)


def codev1_norm() -> np.ndarray:
    """codeV1 byte -> frames / 952 (PacBio's lossy kinetics code)."""
    v = np.arange(256)
    frames = np.select([v < 64, v < 128, v < 192],
                       [v, (v - 64) * 2 + 64, (v - 128) * 4 + 192],
                       (v - 192) * 8 + 448)
    return (frames.astype(np.float32) / np.float32(952)).astype(np.float32)


# ---------------------------------------------------------------------------
# Sites


def find_sites(seq: np.ndarray, offsets: np.ndarray, contexts):
    """Every candidate site of every read of a concatenated pool.

    seq: (total,) ASCII; offsets: (n + 1,) read bounds.  Returns
    {context: (positions, strands)}, positions into `seq`, strands 0
    (forward) or 1 (reverse), a motif never crossing a read's end."""
    n = len(seq)
    rid = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    is_c = seq == ord("C")
    is_g = seq == ord("G")
    is_h = np.isin(seq, np.frombuffer(b"ACT", np.uint8))
    is_d = np.isin(seq, np.frombuffer(b"AGT", np.uint8))

    def shifted(a, k):               # a[i + k], False past the end
        out = np.zeros(n, bool)
        out[:n - k] = a[k:]
        return out

    same1 = np.zeros(n, bool)                # i and i + 1 in one read
    same1[:n - 1] = rid[1:] == rid[:-1]
    same2 = np.zeros(n, bool)                # i and i + 2 in one read
    same2[:n - 2] = rid[2:] == rid[:-2]
    out = {}
    for ctx in contexts:
        if ctx == "CpG":
            fwd = np.flatnonzero(is_c & shifted(is_g, 1) & same1)
            rev = np.empty(0, np.int64)
        elif ctx == "CHG":
            fwd = np.flatnonzero(is_c & shifted(is_h, 1) & shifted(is_g, 2)
                                 & same2)
            rev = np.empty(0, np.int64)
        elif ctx == "CHH":
            fwd = np.flatnonzero(is_c & shifted(is_h, 1) & shifted(is_h, 2)
                                 & same2)
            rev = np.flatnonzero(is_d & shifted(is_d, 1) & shifted(is_g, 2)
                                 & same2) + 2
        else:
            raise ValueError(f"unknown context {ctx!r}")
        pos = np.concatenate([fwd, rev]).astype(np.int64)
        strand = np.concatenate([np.zeros(len(fwd), np.int8),
                                 np.ones(len(rev), np.int8)])
        out[ctx] = (pos, strand)
    return out


# ---------------------------------------------------------------------------
# Features


def feature_table(seq: np.ndarray, kin: np.ndarray,
                  offsets: np.ndarray) -> np.ndarray:
    """(total, 8) float32: one-hot base, fi, fp, and ri, rp turned to the
    forward order of each read.  kin rows are fi, ri, fp, rp."""
    total = len(seq)
    lens = np.diff(offsets)
    starts = np.repeat(offsets[:-1], lens)
    ends = np.repeat(offsets[1:], lens)
    p = np.arange(total)
    mirror = starts + ends - 1 - p           # the same base, counted from
    lut = codev1_norm()                       # the read's other end
    t = np.zeros((total, 8), np.float32)
    for c, b in enumerate(b"ACGT"):
        t[:, c] = seq == b
    fi, ri, fp, rp = kin
    t[:, 4] = lut[fi]
    t[:, 5] = lut[fp]
    t[:, 6] = lut[ri[mirror]]
    t[:, 7] = lut[rp[mirror]]
    return t


def windows(table: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor,
            rstart: torch.Tensor, rend: torch.Tensor) -> torch.Tensor:
    """(B, 8, KMER) windows of the sites at `pos` (see the module notes)."""
    j = torch.arange(KMER, device=table.device) - KMER // 2
    rev = (strand != 0)[:, None]
    p = pos[:, None] + torch.where(rev, -j, j)
    inside = (p >= rstart[:, None]) & (p < rend[:, None])
    w = table[p.clamp(0, table.shape[0] - 1)]               # (B, KMER, 8)
    perm = torch.tensor(REV_PERM, device=table.device)
    w = torch.where(rev[..., None], w[..., perm], w)
    w = w * inside[..., None].to(w.dtype)
    return w.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# DNAModNet


def load_net(path: str, device) -> dict:
    """A shipped model file -> its tensors on `device`: bn0 scale and
    shift, each conv's (Cout, Cin, K) weight, bias, stride and (lo, hi)
    padding, the FCs' (out, in) weights and biases."""
    with np.load(path) as z:
        f = {k: z[k] for k in z.files}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    convs = []
    i = 0
    while f"convs.{i}.w" in f:
        convs.append({"w": t(f[f"convs.{i}.w"].transpose(2, 1, 0)),
                      "b": t(f[f"convs.{i}.b"]),
                      "stride": int(f[f"convs.{i}.stride"]),
                      "pad": tuple(int(v) for v in f[f"convs.{i}.pad"])})
        i += 1
    return {"scale": t(f["bn0.scale"]), "shift": t(f["bn0.shift"]),
            "convs": convs, "fc1_w": t(f["fc1.w"].T), "fc1_b": t(f["fc1.b"]),
            "fc2_w": t(f["fc2.w"].T), "fc2_b": t(f["fc2.b"])}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def forward(net: dict, x: torch.Tensor, precision: str = "float32"):
    """(B, 8, KMER) float32 windows -> (B, 2) float32 logits."""
    r = _tf32 if precision == "tf32" and not x.is_cuda else (lambda v: v)
    h = x * net["scale"][:, None] + net["shift"][:, None]
    for c in net["convs"]:
        h = F.conv1d(F.pad(r(h), c["pad"]), r(c["w"]), c["b"],
                     stride=c["stride"])
        h = F.relu(h)
    h = F.relu(F.linear(r(h.flatten(1)), r(net["fc1_w"]), net["fc1_b"]))
    return F.linear(r(h), r(net["fc2_w"]), net["fc2_b"])


class _Precision:
    """TF32 off, or on for the control, for the card's convolutions and
    products; the switches are put back on exit."""

    def __init__(self, precision: str):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision must be float32 or tf32, got "
                             f"{precision!r}")
        self.on = precision == "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


# ---------------------------------------------------------------------------
# The pool's calls


def mm_string(seq: np.ndarray, fwd: np.ndarray, rev: np.ndarray) -> str:
    """The MM tag of a read's sorted forward (C) and reverse (G) calls,
    positions in the read."""
    parts = []
    for base, code, offs in ((b"C", "C+m", fwd), (b"G", "G-m", rev)):
        rank = np.cumsum(seq == base[0]) - 1            # rank of each base
        r = rank[offs]
        d = np.diff(r, prepend=-1) - 1
        parts.append(code + "".join(f",{v}" for v in d.tolist()) + ";")
    return "".join(parts)


def call_pool(seq: np.ndarray, kin: np.ndarray, offsets: np.ndarray,
              contexts, model_dir: str, device="cpu",
              precision: str = "float32", block: int = 8192) -> list:
    """Every read's expected tags: a list, per read, of (MM string or
    None, p1 (float64) of its ML entries in ML order, ML bytes)."""
    device = torch.device(device)
    sites = find_sites(seq, offsets, contexts)
    table = torch.from_numpy(feature_table(seq, kin, offsets)).to(device)
    rid_all = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    per_ctx = {}
    with torch.inference_mode(), _Precision(precision):
        for ctx in contexts:
            net = load_net(os.path.join(model_dir, f"{ctx}.npz"), device)
            pos, strand = sites[ctx]
            rid = rid_all[pos]
            logits = []
            for o in range(0, len(pos), block):
                sl = slice(o, o + block)
                pt = torch.from_numpy(pos[sl]).to(device)
                st = torch.from_numpy(strand[sl]).to(device)
                rs = torch.from_numpy(offsets[rid[sl]]).to(device)
                re = torch.from_numpy(offsets[rid[sl] + 1]).to(device)
                x = windows(table, pt, st, rs, re)
                logits.append(forward(net, x, precision).double().cpu())
            lg = (torch.cat(logits).numpy() if logits
                  else np.zeros((0, 2)))
            p1 = 1.0 / (1.0 + np.exp(lg[:, 0] - lg[:, 1]))
            per_ctx[ctx] = (pos, strand, rid, p1)
    pos = np.concatenate([v[0] for v in per_ctx.values()])
    strand = np.concatenate([v[1] for v in per_ctx.values()])
    rid = np.concatenate([v[2] for v in per_ctx.values()])
    p1 = np.concatenate([v[3] for v in per_ctx.values()])
    # ML order: by read, forward calls before reverse ones, by position
    order = np.lexsort((pos, strand, rid))
    pos, strand, rid, p1 = pos[order], strand[order], rid[order], p1[order]
    bounds = np.searchsorted(rid, np.arange(len(offsets)))
    ml = np.minimum(255, np.floor(255.0 * p1)).astype(np.uint8)
    out = []
    for r in range(len(offsets) - 1):
        a, b = bounds[r], bounds[r + 1]
        if a == b:
            out.append((None, p1[a:b], ml[a:b]))
            continue
        s = seq[offsets[r]:offsets[r + 1]]
        rel = pos[a:b] - offsets[r]
        fwd = rel[strand[a:b] == 0]
        rev = rel[strand[a:b] == 1]
        out.append((mm_string(s, fwd, rev), p1[a:b], ml[a:b]))
    return out
