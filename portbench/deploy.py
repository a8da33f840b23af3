"""A configuration's deployment: its corpus, made on the device, and the
port's index built from it through the normal entry point, `Index.build`.

The corpus (cluster model, train, base and query rows) and the index's
training seed are the configuration's own: their streams are seeded by the
configuration's name, so every run of a cell holds the same data and does
the same work. A run's `--seed` draws what the traffic does with it: the
order of the queries, the arrivals, the rows added, the samples checked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench import corpus
from portbench.common import stream_seed


class Corpus(NamedTuple):
    model: corpus.Model
    train: torch.Tensor  # [n_train, d] f32 on the device
    base: torch.Tensor  # [n_base, d]
    query: torch.Tensor  # [n_query, d]


def gen(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def data_gen(cfg: dict, stream: str, device) -> torch.Generator:
    """A generator of the configuration's own data, the same in every run."""
    return gen(0, f"{cfg['name']}:{stream}", device)


def make_corpus(cfg: dict, device) -> Corpus:
    model = corpus.make_model(data_gen(cfg, "model", device), cfg["d"], cfg["n_base"], device)
    train, _ = corpus.draw(model, data_gen(cfg, "train", device), cfg["n_train"])
    base, cids = corpus.draw(model, data_gen(cfg, "base", device), cfg["n_base"])
    query = corpus.queries(model, data_gen(cfg, "query", device), base, cids, cfg["n_query"])
    return Corpus(model, train, base, query)


def build_index(cfg: dict, data: Corpus, device):
    """`Index.build` with the configuration's method and sizes; it takes host
    arrays, so train and base make a trip through the host."""
    from local_search_quantization_torch.index import Index

    return Index.build(data.train.cpu().numpy(), data.base.cpu().numpy(),
                       method=cfg["method"], m=cfg["m"], h=cfg["h"],
                       niter=cfg["niter"], ilsiter=cfg["ilsiter"],
                       seed=stream_seed(0, f"{cfg['name']}:index") % (1 << 31),
                       device=device)


def index_state(idx) -> dict:
    """What the reference reads of the program's index, through its public
    attributes: the codes and the trained codebooks and norm codebook, on
    the host."""
    return {"B": idx.B, "C": idx.model.C.detach().cpu(),
            "cbnorms": idx.model.cbnorms.detach().cpu()}
