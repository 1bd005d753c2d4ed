"""Device feature pipeline: packed read planes -> feature table -> per-site
windows -> CNN -> u8 probabilities.

Reads are packed host-side into a flat u8 buffer of 5 planes (2-bit codes,
fi, fp, ri, rp, all in native-forward coordinates, see
features/read_decode.py).  On the device:

 1. `featurize_planes_t` expands the buffer once into an (8, N) float32
    table (one-hot + codeV1-normalized kinetics), O(bases), shared by the
    ~100 overlapping windows that cover each base;
 2. `call_sites_group` cuts each group-planned site's window out of the
    table with the gather kernel (ops/gather.group_windows_t) and runs the
    per-context CNN on them.

The slice and folded paths (`call --gather-impl slice|folded`) keep the
JAX package's XLA gathers instead: an (N, 8) position-major table
(`featurize_planes`) or its (N/16, 128) fold (`featurize_planes_folded`),
per-site windows cut by indexing with each site's read bounds masked
(`gather_windows_slice`, `gather_windows_folded`), and the CNN per batch
(`call_sites_step`, one batch; `call_sites_batched`, a chunk of them; the
engine's programs run one step a batch).  They have no kernel in either
package.

`gather_windows` and `call_sites` are the JAX package's reference per-site
path: one window per site by plain indexing (no plan, no kernel), against
which the planned paths are held.

The trainer's batches (`gather_and_featurize`) skip the table: each window
reads the raw u8 planes of its positions and featurizes them, as in the
JAX package's training pipeline.

codeV1 decodes through the 256-entry CODEV1_TO_FRAME_NORM table on every
device, so the table equals the host extractor's values bit for bit.
"""
from __future__ import annotations

import torch

from ..constants import CODEV1_TO_FRAME_NORM, KMER_SIZE
from ..model.cnn import DNAModNet, logits_to_scaled_probs
from ..ops.gather import REV_CHANNEL_PERM, group_windows_t

_CODEV1_NORM = torch.from_numpy(CODEV1_TO_FRAME_NORM)
#: positions per row of the folded table
FOLD = 16


def featurize_planes_t(planes: torch.Tensor) -> torch.Tensor:
    """(5, N) u8 packed planes -> (8, N) float32 channel-major table.

    Seq code c in 0..3 sets one-hot channel c; any other code (the packer's
    255 fill, IUPAC codes > 3) gives an all-zero one-hot."""
    out = torch.empty((8, planes.shape[1]), dtype=torch.float32,
                      device=planes.device)
    _featurize_into(planes, out)
    return out


def featurize_planes_t_seg(segments, cap: int,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Featurize the (5, w_i) plane pieces the engine shipped, which cover
    a prefix of the (5, cap) plane buffer in order, into an (8, cap) table
    whose tail past them is zero - what the packer's 255/0 fill featurizes
    to - so the result equals featurize_planes_t over the whole buffer.
    With `out` (an (8, cap) float32 table on the planes' device, such as
    the engine's persistent table that its captured programs read) the
    table is written there and returned."""
    if not segments:
        raise ValueError("no plane segments to featurize")
    m = sum(s.shape[1] for s in segments)
    if m > cap:
        raise ValueError(f"segments of {m} lanes exceed capacity {cap}")
    planes = segments[0] if len(segments) == 1 else torch.cat(segments, 1)
    if out is None:
        out = torch.empty((8, cap), dtype=torch.float32, device=planes.device)
    elif (tuple(out.shape) != (8, cap) or out.dtype != torch.float32
          or out.device != planes.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous (8, {cap}) float32 table "
                         f"on {planes.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    out[:, m:].zero_()
    _featurize_into(planes, out[:, :m])
    return out


_LUTS: dict = {}


def _codev1_lut(device: torch.device) -> torch.Tensor:
    """CODEV1_TO_FRAME_NORM on `device`, copied there once per process (the
    copy is waited for, so any stream may read the table at once)."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = _CODEV1_NORM.to(device)
        if lut.is_cuda:
            torch.cuda.synchronize(device)
        _LUTS[device] = lut
    return lut


def _featurize_into(planes: torch.Tensor, out: torch.Tensor) -> None:
    codes = planes[0]
    arange = torch.arange(4, dtype=codes.dtype, device=codes.device)
    out[:4] = codes[None, :] == arange[:, None]
    out[4:] = _codev1_lut(planes.device)[planes[1:5].to(torch.int64)]


def featurize_planes(planes: torch.Tensor) -> torch.Tensor:
    """(5, N) u8 packed planes -> (N, 8) float32 position-major table (the
    transpose of featurize_planes_t's)."""
    return featurize_planes_seg([planes], planes.shape[1])


def featurize_planes_seg(segments, cap: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Featurize the (5, w_i) plane pieces that cover a prefix of the
    plane buffer in order into a (cap, 8) table whose tail past them is
    zero: the transpose of featurize_planes_t_seg's table.  With `out` (a
    contiguous (cap, 8) float32 table on the pieces' device, such as the
    engine's persistent table that the slice/folded programs read) the
    table is written there and returned."""
    table_t = featurize_planes_t_seg(segments, cap)
    if out is None:
        return table_t.T.contiguous()
    if (tuple(out.shape) != (cap, 8) or out.dtype != torch.float32
            or out.device != table_t.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({cap}, 8) float32 table "
                         f"on {table_t.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out.copy_(table_t.T)


def featurize_planes_folded(planes: torch.Tensor,
                            fold: int = FOLD) -> torch.Tensor:
    """(5, N) u8 packed planes -> (N/fold, fold*8) folded table: row r holds
    positions [r*fold, (r+1)*fold).  N must be a multiple of `fold`."""
    return fold_table(featurize_planes(planes), fold)


def fold_table(feats: torch.Tensor, fold: int = FOLD) -> torch.Tensor:
    """(N, C) table -> (N/fold, fold*C) view of the same memory."""
    if fold < 1 or fold & (fold - 1):
        raise ValueError(f"fold must be a power of two, got {fold}")
    if feats.shape[0] % fold:
        raise ValueError(f"{feats.shape[0]} positions are not a multiple of "
                         f"fold {fold}")
    return feats.view(feats.shape[0] // fold, fold * feats.shape[1])


_PERMS: dict = {}


def _rev_perm(device: torch.device, channels: int) -> torch.Tensor:
    """REV_CHANNEL_PERM on the first 8 of `channels` channels (the rest in
    place) as an int64 index on `device`, made there once per process and
    waited for: a list index would copy a new host tensor to the device on
    every call, which a CUDA graph capture refuses."""
    key = (device, channels)
    perm = _PERMS.get(key)
    if perm is None:
        perm = torch.tensor(list(REV_CHANNEL_PERM) + list(range(8, channels)),
                            dtype=torch.int64).to(device)
        if perm.is_cuda:
            torch.cuda.synchronize(device)
        _PERMS[key] = perm
    return perm


def _mask_and_orient(w: torch.Tensor, centers: torch.Tensor,
                     strands: torch.Tensor, rstart: torch.Tensor,
                     rend: torch.Tensor, kmer: int) -> torch.Tensor:
    """Zero the window rows outside each site's read [rstart, rend) (the
    reference's window zero padding, eval_kmer_features.cpp:40) and turn
    reverse-strand windows: flipped rows, complement/swap channel
    permutation (REV_CHANNEL_PERM on the first 8 channels)."""
    j = torch.arange(kmer, dtype=torch.int32, device=w.device) - kmer // 2
    pos = centers.to(torch.int32)[:, None] + j[None, :]
    valid = (pos >= rstart[:, None]) & (pos < rend[:, None])
    w = w * valid[..., None].to(w.dtype)
    w_rev = w.flip(1)[..., _rev_perm(w.device, w.shape[-1])]
    return torch.where((strands != 0)[:, None, None], w_rev, w)


def gather_windows(feats: torch.Tensor, centers: torch.Tensor,
                   strands: torch.Tensor, rstart: torch.Tensor,
                   rend: torch.Tensor,
                   kmer_size: int = KMER_SIZE) -> torch.Tensor:
    """The reference per-site gather (the JAX package's gather_windows):
    (N, 8) table -> (B, kmer, 8) float32 windows around each site's center,
    descending on the reverse strand with the complement/swap channel
    permutation, zero outside the site's read [rstart, rend) (windows never
    cross read boundaries, eval_kmer_features.cpp:40).  Plain indexing on
    the table's device; no kernel."""
    j = torch.arange(kmer_size, dtype=torch.int64,
                     device=feats.device) - kmer_size // 2
    is_rev = (strands != 0)[:, None]
    pos = centers.to(torch.int64)[:, None] + torch.where(is_rev, -j, j)
    valid = (pos >= rstart[:, None]) & (pos < rend[:, None])
    w = feats[pos.clamp(0, feats.shape[0] - 1)]
    w = torch.where(is_rev[..., None], w[..., list(REV_CHANNEL_PERM)], w)
    return w * valid[..., None].to(w.dtype)


def call_sites(model: DNAModNet, feats: torch.Tensor, centers: torch.Tensor,
               strands: torch.Tensor, rstart: torch.Tensor,
               rend: torch.Tensor, kmer_size: int = KMER_SIZE) -> torch.Tensor:
    """gather_windows -> the CNN -> (B,) u8 scaled probs (the JAX package's
    call_sites)."""
    w = gather_windows(feats, centers, strands, rstart, rend, kmer_size)
    return logits_to_scaled_probs(model(w.transpose(1, 2).contiguous()))


def _window_rows(first: torch.Tensor, kmer: int) -> torch.Tensor:
    return first[:, None] + torch.arange(kmer, device=first.device)


def gather_windows_slice(feats: torch.Tensor, centers: torch.Tensor,
                         strands: torch.Tensor, rstart: torch.Tensor,
                         rend: torch.Tensor,
                         kmer: int = KMER_SIZE) -> torch.Tensor:
    """(N, C) table -> (B, kmer, C) windows: kmer consecutive rows from
    center - kmer//2, that start clamped into [0, N - kmer] as
    lax.dynamic_slice clamps it (a padded site, center 0, reads rows [0,
    kmer) and is masked to zero by its empty read bounds), then masked and
    oriented per strand."""
    first = (centers.to(torch.int64) - kmer // 2).clamp(0, feats.shape[0] - kmer)
    w = feats[_window_rows(first, kmer)]
    return _mask_and_orient(w, centers, strands, rstart, rend, kmer)


def gather_windows_folded(folded: torch.Tensor, centers: torch.Tensor,
                          strands: torch.Tensor, rstart: torch.Tensor,
                          rend: torch.Tensor, kmer: int = KMER_SIZE,
                          fold: int = FOLD) -> torch.Tensor:
    """(N/fold, fold*C) folded table -> (B, kmer, C) windows, bit-equal to
    the JAX package's gather_windows_folded: the window's first folded row
    r0 = start // fold is clipped into [0, R - frows] (frows rows cover a
    window at any phase), and the phase d = start - r0*fold is applied
    through its low log2(fold) bits, which is what the JAX select tree
    shifts by.  For in-table starts that is the window at `start`; for a
    padded site's negative start it is a window inside the table that the
    read-bounds mask zeroes."""
    if fold < 1 or fold & (fold - 1):
        raise ValueError(f"fold must be a power of two, got {fold}")
    c = folded.shape[1] // fold
    frows = (kmer + 2 * (fold - 1)) // fold
    if folded.shape[0] < frows:
        raise ValueError(f"folded table of {folded.shape[0]} rows is shorter "
                         f"than one window's {frows}")
    start = centers.to(torch.int64) - kmer // 2
    r0 = torch.div(start, fold, rounding_mode="floor").clamp(
        0, folded.shape[0] - frows)
    phase = (start - r0 * fold) & (fold - 1)
    w = folded.reshape(-1, c)[_window_rows(r0 * fold + phase, kmer)]
    return _mask_and_orient(w, centers, strands, rstart, rend, kmer)


_BATCHED_GATHERS = {"slice": gather_windows_slice,
                    "folded": gather_windows_folded}


def call_sites_step(model: DNAModNet, feats: torch.Tensor,
                    centers: torch.Tensor, strands: torch.Tensor,
                    rstart: torch.Tensor, rend: torch.Tensor,
                    kmer: int = KMER_SIZE, gather_impl: str = "slice",
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One batch of sites (one lax.map step of the JAX package's
    call_sites_batched): windows by the slice gather over the (N, 8)
    table or the folded gather over its fold, the CNN on them, (n,) u8
    scaled probs.  With `out` ((n,) u8) the probs are written there and
    `out` is returned, so a captured program's body leaves no allocation
    behind (engine/programs.py)."""
    if gather_impl not in _BATCHED_GATHERS:
        raise ValueError(f"gather_impl must be slice or folded, got "
                         f"{gather_impl!r}")
    w = _BATCHED_GATHERS[gather_impl](feats, centers, strands, rstart, rend,
                                      kmer)
    # NWC -> the NCW layout DNAModNet takes
    probs = logits_to_scaled_probs(model(w.transpose(1, 2).contiguous()))
    return probs if out is None else out.copy_(probs)


def call_sites_batched(model: DNAModNet, feats: torch.Tensor,
                       centers: torch.Tensor, strands: torch.Tensor,
                       rstart: torch.Tensor, rend: torch.Tensor,
                       site_batch: int, kmer: int = KMER_SIZE,
                       gather_impl: str = "slice") -> torch.Tensor:
    """All sites of one chunk, site_batch at a time (call_sites_step each),
    u8 scaled probs (n,) in site order.  n must be a multiple of
    site_batch (the engine pads with center-0 sites)."""
    if gather_impl not in _BATCHED_GATHERS:
        raise ValueError(f"gather_impl must be slice or folded, got "
                         f"{gather_impl!r}")
    n = centers.shape[0]
    if site_batch < 1 or n % site_batch:
        raise ValueError(f"{n} sites are not a multiple of site_batch "
                         f"{site_batch}")
    parts = [torch.empty(0, dtype=torch.uint8, device=feats.device)]
    for o in range(0, n, site_batch):
        sl = slice(o, o + site_batch)
        parts.append(call_sites_step(model, feats, centers[sl], strands[sl],
                                     rstart[sl], rend[sl], kmer,
                                     gather_impl))
    return torch.cat(parts)


def call_sites_grid(model: DNAModNet, feats: torch.Tensor,
                    centers: torch.Tensor, strands: torch.Tensor,
                    rstart: torch.Tensor, rend: torch.Tensor,
                    kmer: int = KMER_SIZE) -> torch.Tensor:
    """One device's share of a data-parallel flush: (nb, share) site grids
    -> (nb, share) u8 scaled probs, each row one step of the slice gather
    over the (N, C) table and the CNN (the JAX package's call_sites_grid,
    whose (nb, site_batch) grid is split on its second axis over the
    devices)."""
    nb, share = centers.shape
    return call_sites_batched(
        model, feats, centers.reshape(-1), strands.reshape(-1),
        rstart.reshape(-1), rend.reshape(-1), site_batch=share,
        kmer=kmer).reshape(nb, share)


def call_sites_group(model: DNAModNet, table: torch.Tensor,
                     bases: torch.Tensor, rels: torch.Tensor, rev: bool,
                     kmer: int = KMER_SIZE,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """One batch of planned groups -> (ng*G,) u8 scaled probs in slot order.
    The windows come out of the gather in the model's compute dtype, as the
    JAX package's call_sites_pallas asks group_windows_t for them.  With
    `out` ((ng*G,) u8) the probs are written there and `out` is returned,
    so a captured program's body leaves no allocation behind
    (engine/programs.py).

    No per-site read-bounds mask: the engine packs reads with a >= kmer//2
    zero-feature gap, so window lanes past a read's edge read exact zeros
    from the table, the reference's window zero padding
    (eval_kmer_features.cpp:40)."""
    w = group_windows_t(table, bases, rels, rev=rev, kmer=kmer,
                        out_dtype=model.compute_dtype)
    probs = logits_to_scaled_probs(model(w))
    return probs if out is None else out.copy_(probs)


#: reverse-strand kinetics channel order: (fi, fp, ri, rp) -> (ri, rp, fi, fp)
_REV_KINETICS = [2, 3, 0, 1]


def gather_and_featurize(planes_t: torch.Tensor, centers: torch.Tensor,
                         strands: torch.Tensor, rstart: torch.Tensor,
                         rend: torch.Tensor,
                         kmer_size: int = KMER_SIZE) -> torch.Tensor:
    """(N, 5) u8 read-major planes -> (B, kmer, 8) float32 site windows, the
    trainer's batch (the JAX package's gather_and_featurize).

    Each window reads the raw u8 bytes of kmer positions, ascending from
    center - kmer//2 on the forward strand and descending from center +
    kmer//2 on the reverse one, and featurizes them: on the reverse strand
    the 2-bit codes are complemented where code < 4 and the kinetics swap
    to (ri, rp, fi, fp).  Positions outside the site's read [rstart, rend)
    are zero.  Plain PyTorch indexing on the planes' device; no kernel."""
    dev = planes_t.device
    j = torch.arange(kmer_size, dtype=torch.int64, device=dev) - kmer_size // 2
    is_rev = (strands != 0)[:, None]
    pos = centers.to(torch.int64)[:, None] + torch.where(is_rev, -j, j)
    valid = (pos >= rstart[:, None]) & (pos < rend[:, None])
    w = planes_t[pos.clamp(0, planes_t.shape[0] - 1)]      # (B, kmer, 5) u8
    codes = w[..., 0]
    codes = torch.where(is_rev & (codes < 4), 3 - codes, codes)
    arange = torch.arange(4, dtype=codes.dtype, device=dev)
    onehot = (codes[..., None] == arange).to(torch.float32)
    kin = _codev1_lut(dev)[w[..., 1:5].to(torch.int64)]    # (B, kmer, 4)
    kin = torch.where(is_rev[..., None], kin[..., _REV_KINETICS], kin)
    out = torch.cat([onehot, kin], dim=-1)
    return out * valid[..., None].to(out.dtype)
