"""featurize_planes_t / featurize_planes_t_seg: the port's (8, N) table is
bit-equal to the JAX package's on the CPU backend (both decode codeV1 through
the 256-entry CODEV1_TO_FRAME_NORM table), including the packer's 255 fill
and non-ACGT codes (4)."""
import numpy as np
import pytest
import torch

from hifimeth_tpu.features.windows import featurize_planes_t as jax_feat
from hifimeth_tpu.features.windows import featurize_planes_t_seg as jax_seg
from hifimeth_tpu_torch.features.windows import (featurize_planes_t,
                                                 featurize_planes_t_seg)


def _planes(rng, n):
    planes = rng.integers(0, 256, (5, n)).astype(np.uint8)
    planes[0] = rng.choice(np.array([0, 1, 2, 3, 4, 15, 255], np.uint8), n)
    planes[1:, :256] = np.arange(256, dtype=np.uint8)   # every codeV1 byte
    return planes


def test_table_bit_equal_to_jax():
    planes = _planes(np.random.default_rng(0), 3000)
    want = np.asarray(jax_feat(planes))
    got = featurize_planes_t(torch.from_numpy(planes)).numpy()
    assert got.dtype == np.float32 and got.shape == (8, 3000)
    np.testing.assert_array_equal(got, want)
    assert got[:4, planes[0] > 3].sum() == 0


@pytest.mark.parametrize("n_seg", [1, 3])
def test_segmented_table_bit_equal_to_jax(n_seg):
    seg, cap = 512, 2048
    planes = _planes(np.random.default_rng(n_seg), n_seg * seg)
    segments = tuple(planes[:, i * seg:(i + 1) * seg] for i in range(n_seg))
    want = np.asarray(jax_seg(segments, cap=cap))
    got = featurize_planes_t_seg([torch.from_numpy(s.copy()) for s in segments],
                                 cap).numpy()
    assert got.shape == (8, cap)
    np.testing.assert_array_equal(got, want)
    assert not got[:, n_seg * seg:].any()
    with pytest.raises(ValueError):
        featurize_planes_t_seg([torch.from_numpy(planes)], n_seg * seg - 1)
