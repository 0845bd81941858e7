"""The port's CUDA kernels on the card: each held byte for byte against its
plain PyTorch version on the same input, every engine against numpy's
stable sort, and the wrappers' launch counts and input checks.

Every test here is marked ``gpu`` and skips where there is no card. The
file imports neither jax nor uda_tpu, so it also runs where only the port
is installed; on the card run it without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from port_helpers import cuda_device, oracle, records, words  # noqa: F401
from uda_tpu_torch import interop
from uda_tpu_torch.models import terasort as tts
from uda_tpu_torch.ops import _build, pallas_fold, pallas_sort
from uda_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.gpu


def _on_card(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return interop.words_from_numpy(x, dev)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(interop.words_to_numpy(a),
                          interop.words_to_numpy(b))


@pytest.mark.parametrize("rows,nk,tb,tile", [(8, 3, 7, 1024),
                                             (32, 3, 31, 256),
                                             (8, 7, 7, 2048),
                                             (32, 30, 31, 128)])
def test_k2_k1_match_plain(cuda_device, rows, nk, tb, tile):
    """K2 and every K1 pass against their plain versions."""
    x_np = words(rows + nk, rows, 1 << 15, nk)
    x = _on_card(x_np, cuda_device)
    y = pallas_sort.tile_sort(x, tile, nk, tb)
    assert _same(y, pallas_sort.tile_sort_plain(x, tile, nk, tb))
    run = tile
    while run < x.shape[1]:
        z = pallas_sort.merge_pass(y, run, tile, nk, tb)
        assert _same(z, pallas_sort.merge_pass_plain(y, run, tile, nk, tb))
        y, run = z, 2 * run
    np.testing.assert_array_equal(interop.words_to_numpy(y),
                                  oracle(x_np, nk, tb))


@pytest.mark.parametrize("nk,tile", [(3, 1024), (1, 256), (2, 4096)])
def test_k3_k4_match_plain(cuda_device, nk, tile):
    """K3 and every K4 pass against their plain versions."""
    x_np = words(nk, 4, 1 << 15, nk)
    x = _on_card(x_np, cuda_device)
    y = pallas_fold.tile_sort_folded(x, tile, nk)
    assert _same(y, pallas_fold.tile_sort_folded_plain(x, tile, nk))
    run = tile
    while run < x.shape[1]:
        z = pallas_fold.merge_pass_folded(y, run, tile, nk)
        assert _same(z, pallas_fold.merge_pass_folded_plain(y, run, tile,
                                                             nk))
        y, run = z, 2 * run
    np.testing.assert_array_equal(interop.words_to_numpy(y),
                                  oracle(x_np, nk, 3))


def test_every_engine(cuda_device):
    w = records(21, 200_000)
    want = w[np.lexsort([w[:, 2], w[:, 1], w[:, 0]])]
    for path in tsort.ALL_SORT_PATHS + ("auto",):
        got = tts.single_chip_sort(w, path=path)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(interop.words_to_numpy(got), want)
    viol, ck_in, ck_out = tts.bench_step(0, 1 << 18, 2, "keys8")
    assert int(viol) == 0 and int(ck_in) == int(ck_out)


def test_launch_counts(cuda_device):
    x = _on_card(words(1, 8, 1 << 14, 3), cuda_device)
    _build.reset_launches()
    pallas_sort.sort_lanes(x, 3, tb_row=7, tile=1024)
    pallas_fold.sort_lanes_folded(x, 3, tile=1024)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"tile_sort": 1, "merge_pass": 4,
                                     "tile_sort_folded": 1,
                                     "merge_pass_folded": 4}


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = _on_card(words(2, 8, 1 << 14, 3), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        pallas_sort.tile_sort(x[:, ::2], 1024, 3, 7)
    with pytest.raises(ValueError, match="shared memory"):
        pallas_sort.tile_sort(x, 1 << 14, 7, 7)
    with pytest.raises(ValueError, match="4 rows"):
        pallas_fold.tile_sort_folded(x, 1024, 3)
