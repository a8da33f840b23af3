"""`select_kernels.lex_topk`, the one (dist, id) top-k behind every merge of
the port (K2's dense path, K3's segments, K4's re-rank, the tournament,
refine, the probed scan, the segment and shard merges), held row by row to
the JAX package's numpy `ivf.topk_lex`."""

import numpy as np
import pytest
import torch

from local_search_quantization_tpu import ivf as jivf
from local_search_quantization_torch import ivf as tivf
from local_search_quantization_torch.ops import adc as tadc
from local_search_quantization_torch.ops import select_kernels as sk


def _oracle(d: np.ndarray, ids: np.ndarray, k: int):
    """`ivf.topk_lex` of the JAX package, row by row; a slot whose id is
    below 0 is no candidate."""
    rows = [jivf.topk_lex(np.where(i >= 0, r, np.inf).astype(np.float32), i.astype(np.int64), k)
            for r, i in zip(d, ids)]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def _distinct_ids(rng, nq, c):
    return np.stack([rng.permutation(20 * c)[:c] for _ in range(nq)])


def _negative(rng):
    return -rng.integers(1, 40, (6, 50)).astype(np.float32) / 4, _distinct_ids(rng, 6, 50), 10


def _mixed_sign(rng):
    return rng.normal(size=(5, 64)).astype(np.float32) * 3, _distinct_ids(rng, 5, 64), 17


def _signed_zeros(rng):
    d = rng.choice(np.array([-0.0, 0.0, -1.0, 1.0], np.float32), (4, 40))
    return d, _distinct_ids(rng, 4, 40), 25


def _tie_at_kth(rng):
    # Three values over 60 slots: a tie block straddles every k-th slot.
    return rng.integers(0, 3, (5, 60)).astype(np.float32), _distinct_ids(rng, 5, 60), 23


def _inf_rows(rng):
    d = rng.integers(-3, 4, (6, 30)).astype(np.float32)
    d[rng.random((6, 30)) < 0.4] = np.inf
    d[2] = np.inf  # a row with no candidate
    return d, _distinct_ids(rng, 6, 30), 12


def _minus_one_ids(rng):
    d = rng.integers(-3, 4, (6, 30)).astype(np.float32)
    ids = _distinct_ids(rng, 6, 30)
    ids[rng.random((6, 30)) < 0.3] = -1  # finite distances that must not win
    return d, ids, 15


def _k_above_width(rng):
    d = rng.integers(-2, 3, (3, 5)).astype(np.float32)
    d[1, 3] = np.inf
    return d, _distinct_ids(rng, 3, 5), 9


CASES = {"negative": _negative, "mixed sign": _mixed_sign, "+-0.0": _signed_zeros,
         "ties across the k-th": _tie_at_kth, "+inf rows": _inf_rows, "-1 ids": _minus_one_ids,
         "k above the width": _k_above_width}


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_lex_topk_is_the_numpy_topk_lex_row_by_row(case, id_dtype):
    rng = np.random.default_rng(len(case))
    d, ids, k = CASES[case](rng)
    got_d, got_i = sk.lex_topk(torch.as_tensor(d), torch.as_tensor(ids).to(id_dtype), k)
    want_d, want_i = _oracle(d, ids, k)
    assert got_d.shape == got_i.shape == (d.shape[0], k) and got_i.dtype == id_dtype
    # Bit for bit: -0.0 comes back as -0.0, ranked with +0.0 by id.
    np.testing.assert_array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("k", [4, 12, 30])
def test_lex_topk_merges_two_lists_as_the_numpy_merge(k):
    """Two per-query lists with sentinel tails merge as `ivf.merge_knn` of the
    JAX package merges them (the merge of `merge_knn_device`; both keep at
    most the 24 columns the lists hold)."""
    rng = np.random.default_rng(k)

    def side(lo):
        d = np.sort(rng.integers(-2, 2, (6, 12)).astype(np.float32), axis=1)
        i = rng.permutation(1000)[:72].reshape(6, 12).astype(np.int64) + lo
        d[:, 9:] = np.inf
        i[:, 9:] = -1
        return d, i

    a, b = side(0), side(5000)
    want = jivf.merge_knn(tadc.KNNResult(*a), tadc.KNNResult(*b), k)
    d, i = sk.lex_topk(torch.as_tensor(np.concatenate([a[0], b[0]], 1)),
                       torch.as_tensor(np.concatenate([a[1], b[1]], 1)), min(k, 24))
    np.testing.assert_array_equal(d.numpy(), want.dists)
    np.testing.assert_array_equal(i.numpy(), want.ids)
    got = tivf.merge_knn_device(tadc.KNNResult(torch.as_tensor(a[0]), torch.as_tensor(a[1])),
                                tadc.KNNResult(torch.as_tensor(b[0]), torch.as_tensor(b[1])), k)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)


def test_k2_keys_signed_order_is_not_the_lex_order():
    """K2's keys are the bit patterns of unsigned keys: as signed int64 they
    put every positive distance before every negative one, so they cannot
    rank a merge (LSQ distances, -2 q.c + norm, are mostly negative).
    `lex_topk`'s signed keys, and K2's keys in unsigned order, can."""
    d = torch.tensor([[-1.0, 2.0, -3.0, 0.5]])
    ids = torch.tensor([[0, 1, 2, 3]])
    lex = [2, 0, 3, 1]
    assert torch.argsort(sk._k2_keys(d, ids), dim=1)[0].tolist() != lex
    assert torch.argsort(sk._k2_keys(d, ids) ^ sk._SIGN64, dim=1)[0].tolist() == lex
    assert sk.lex_topk(d, ids, 4)[1][0].tolist() == lex
