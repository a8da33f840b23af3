"""Golden end-to-end recall gates on the port, on the CPU.

The same corpus, configurations and gates as tests/test_golden_recall.py
(imported from there, not copied): PQ, OPQ, ChainQ and LSQ-8/16, with LSQ
both in condition mode "kernel" (K1's plain version) and "fused" (K5's).
The port draws from its own random streams (torch.Generator, not
jax.random), so its recall is held to the JAX package's GOLDEN values within
the same BAND; where a value of the port's falls outside it, PORT_PINS holds
the port's own measured value, beside JAX's.
"""

import pytest
import torch

import test_golden_recall as golden
from local_search_quantization_torch.models import (
    quantize_opq,
    quantize_pq,
    train_chainq,
    train_lsq,
    train_opq,
    train_pq,
)
from local_search_quantization_torch.ops import adc, icm, norms, viterbi
from local_search_quantization_torch.utils.config import (
    ChainQConfig,
    LSQConfig,
    OPQConfig,
    PQConfig,
)
from local_search_quantization_torch.utils.synth import random_codes

torch.set_num_threads(2)

# method -> {recall@N: the port's pinned value} where it lies outside
# golden.BAND of golden.GOLDEN (JAX's value in the comment beside it).
# Measured on the CPU with the port's own random streams: its OPQ draws
# other initial centers, so its ChainQ and LSQ objectives end ~1.2% above
# JAX's (LSQ train 9995 against 9876; base LSQ-16 14982 against 14785), and
# recall@1 over the 250 queries lands 10-15 queries lower. Recall@10 and
# @100 stay inside JAX's band. The init explains the gap:
# tests/test_torch_golden_init.py starts both packages from JAX's OPQ, and
# then ChainQ agrees to float32 rounding and every LSQ objective lands
# within 0.3% of JAX's (9884 against 9876).
PORT_PINS: dict[str, dict[int, float]] = {
    "LSQ-8 (kernel)": {1: 0.324},  # JAX 0.376
    "LSQ-16 (kernel)": {1: 0.332},  # JAX 0.372
    "LSQ-8 (fused)": {1: 0.332},  # JAX 0.376
    "LSQ-16 (fused)": {1: 0.312},  # JAX 0.372
}


def check(method, rec):
    for n, jax_value in golden.GOLDEN[method.split(" ")[0]].items():
        want = PORT_PINS.get(method, {}).get(n, jax_value)
        got = rec[n]
        assert abs(got - want) <= golden.BAND, (
            f"port {method} r@{n} = {got:.4f}, pinned {want:.4f} (JAX golden "
            f"{jax_value:.4f}, band +/-{golden.BAND})")


@pytest.fixture(scope="module")
def data():
    return golden.data.__wrapped__()


@pytest.fixture(scope="module")
def chain7(data):
    """OPQ (m=7) -> ChainQ, the init of the ChainQ and LSQ gates."""
    X = torch.as_tensor(data.train)
    opq7 = train_opq(X, OPQConfig(m=7, h=64, niter=6, seed=0))
    return train_chainq(X, opq7.B, opq7.R, ChainQConfig(m=7, h=64, niter=6))


def _query(data, B, C, cbnorms, R=None):
    bn = norms.quantize_norms(B, C, cbnorms)
    res = adc.linscan_lsq(B, torch.as_tensor(data.query), C, cbnorms[bn.long()],
                          k=100, R=R)
    return golden.recall_at(data.gt, res.ids.numpy())


def test_port_golden_pq(data):
    pq = train_pq(torch.as_tensor(data.train), PQConfig(m=8, h=64, kmeans_maxiter=30,
                                                        seed=0))
    Bb = quantize_pq(torch.as_tensor(data.base), pq.C_sub)
    res = adc.linscan_pq(Bb, torch.as_tensor(data.query), pq.C_sub, k=100)
    check("PQ", golden.recall_at(data.gt, res.ids.numpy()))


def test_port_golden_opq(data):
    opq = train_opq(torch.as_tensor(data.train), OPQConfig(m=8, h=64, niter=6, seed=0))
    Bb = quantize_opq(torch.as_tensor(data.base), opq.R, opq.C_sub)
    res = adc.linscan_opq(Bb, torch.as_tensor(data.query), opq.C_sub, opq.R, k=100)
    check("OPQ", golden.recall_at(data.gt, res.ids.numpy()))


def test_port_golden_chainq(data, chain7):
    RXb = torch.as_tensor(data.base) @ chain7.R
    B = viterbi.viterbi_encode(RXb, chain7.C)
    cbn, _ = norms.train_norm_codebook(B, chain7.C, 64)
    check("ChainQ", _query(data, B, chain7.C, cbn, R=chain7.R))


@pytest.mark.parametrize("mode", ["kernel", "fused"])
def test_port_golden_lsq_milestones(data, chain7, mode):
    m, h = 7, 64
    cfg = LSQConfig(m=m, h=h, niter=6, seed=0, condition_mode=mode)
    lsq = train_lsq(torch.as_tensor(data.train), chain7.B, chain7.R, cfg)
    B0 = random_codes(0, data.base.shape[0], m, h)
    enc = icm.encode_chunked(torch.Generator().manual_seed(1), data.base, B0, lsq.C,
                             ilsiter=16, icmiter=cfg.icmiter, npert=cfg.npert,
                             milestones=(8, 16), chunk=1 << 14, condition_mode=mode)
    for s, rounds in enumerate((8, 16)):
        check(f"LSQ-{rounds} ({mode})",
              _query(data, enc.milestone_B[s], lsq.C, lsq.cbnorms))
