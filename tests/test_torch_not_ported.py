"""Every "not ported" error of the port names the module that brings the
feature, never a queue number of ROADMAP.md: the queues are renumbered each
time the roadmap is rewritten, so a number goes stale where a name does not.
"""

import json
import re

import numpy as np
import pytest
import torch

from local_search_quantization_torch.index import Index
from local_search_quantization_torch.ops.solver import update_codebooks

torch.set_num_threads(1)

QUEUE_NUMBER = re.compile(r"queue\w*\s*\d", re.IGNORECASE)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    xt = rng.normal(size=(200, 8)).astype(np.float32)
    return Index.build(xt, xt[:120], "pq", m=2, h=8, niter=1, seed=0, device="cpu")


def _saved(index, path, *, method):
    index.save(str(path))
    meta = json.loads((path / "meta.json").read_text())
    meta["method"] = method
    (path / "meta.json").write_text(json.dumps(meta))
    return str(path)


CASES = {
    "Index(method='rvq')": lambda ix, tmp: Index("rvq", ix.model, ix.B, device="cpu"),
    "Index.build('rvq')": lambda ix, tmp: Index.build(
        np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32), "rvq", device="cpu"),
    "Index.load of an RVQ index": lambda ix, tmp: Index.load(
        _saved(ix, tmp, method="rvq"), device="cpu"),
    "search(mesh=)": lambda ix, tmp: ix.search(np.zeros((1, 8), np.float32), k=3,
                                               mesh=object()),
    "update_codebooks(method='lsqr')": lambda ix, tmp: update_codebooks(
        torch.zeros((4, 8)), torch.zeros((4, 2), dtype=torch.int64), 8, method="lsqr"),
}
MODULES = {"Index(method='rvq')": "RVQ", "Index.build('rvq')": "RVQ",
           "Index.load of an RVQ index": "RVQ", "search(mesh=)": "parallel/",
           "update_codebooks(method='lsqr')": "batched LSQR"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_not_ported_errors_name_a_module_and_no_queue_number(case, index, tmp_path):
    with pytest.raises(NotImplementedError) as err:
        CASES[case](index, tmp_path)
    msg = str(err.value)
    assert "not ported" in msg and "ROADMAP.md" in msg
    assert f"module {MODULES[case]}" in msg, msg
    assert not QUEUE_NUMBER.search(msg), msg
