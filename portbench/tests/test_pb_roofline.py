"""The operation and byte counts, pinned to a hand count."""
import os

import pytest

from portbench import catalog, harness, roofline


def hand_count(k1: int) -> int:
    """conv1 kernel k1, then 7 convs of kernel 3, all stride 2 and padding
    1 each side, on a 401-column window; FC 128 -> 256 -> 2."""
    chans = [8, 128, 128, 128, 96, 96, 96, 64, 64]
    length, flops = 401, 0
    for i in range(8):
        k = k1 if i == 0 else 3
        length = (length + 2 - k) // 2 + 1
        flops += 2 * chans[i] * chans[i + 1] * k * length
    assert length == 2                    # 64 channels x 2 = fc1's 128 inputs
    return flops + 2 * 128 * 256 + 2 * 256 * 2


@pytest.mark.parametrize("ctx,k1,want", [("CpG", 11, 22_297_600),
                                         ("CHG", 11, 22_297_600),
                                         ("CHH", 13, 22_881_280)])
def test_flops_per_site(ctx, k1, want):
    path = os.path.join(harness.models_dir(), f"{ctx}.npz")
    assert hand_count(k1) == want
    assert roofline.net_flops(path) == want
    for name in catalog.discover()["configs"]:
        fps = catalog.config(name)["flops_per_site"]
        if ctx in fps:
            assert fps[ctx] == want


def test_gather_bytes():
    # a window of 401 x 8 float32 written, a table row of 8 float32 read
    assert roofline.gather_bytes(1, 0) == 401 * 8 * 4 == 12_832
    assert roofline.gather_bytes(0, 1) == 32
    assert roofline.gather_bytes(8192, 10**6) == 8192 * 12_832 + 32 * 10**6


def test_model_flops():
    fps = {"CpG": 22_297_600, "CHH": 22_881_280}
    assert roofline.model_flops({"CpG": 2, "CHH": 1}, fps) == \
        2 * 22_297_600 + 22_881_280
